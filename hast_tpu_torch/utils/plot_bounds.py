"""Optional k-mer depth histogram plot (hast_tpu/utils/plot_bounds.py,
copied).

Mirrors HAST's 00.build_unshare_kmers_by_jellyfish/
draw_bounds.py: two-panel plot of maternal/paternal k-mer depth
histograms with MIN/MAX/LOWER/UPPER vlines.  Gated on matplotlib being
importable (it is an optional dependency, like in the reference).
"""

from __future__ import annotations

import os


def _read_bounds(path: str) -> dict[str, int]:
    out = {}
    with open(path) as f:
        for line in f:
            key, _, val = line.partition("=")
            out[key.strip()] = int(val)
    return out


def render_bounds_figure(workdir: str = ".",
                         histo_suffix: str = ".kmercount.histo"):
    """Build the two-panel figure (not saved) — the testable core.

    Panel/vline semantics follow draw_bounds.py:50-76 exactly: per
    parent a depth/count line plot plus 4 vlines (MIN '--' red,
    MAX '--' green, LOWER '-.' red, UPPER '-.' green) with
    "<NAME> INDEX <value> " labels, xlim (1, 150), legend, and the
    "<parent> kmer-depth count" title.
    """
    import matplotlib
    matplotlib.use("agg")
    import matplotlib.pyplot as plt
    import numpy as np

    fig = plt.figure()
    for i, parent in enumerate(("maternal", "paternal")):
        xy = np.loadtxt(os.path.join(workdir, parent + histo_suffix),
                        dtype=int, ndmin=2)
        b = _read_bounds(os.path.join(workdir, parent + ".bounds.txt"))
        plt.subplot(2, 1, i + 1)
        plt.plot(xy[:, 0], xy[:, 1])
        plt.axvline(x=b["MIN_INDEX"], ls="--", c="r",
                    label="MIN INDEX %d " % b["MIN_INDEX"])
        plt.axvline(x=b["MAX_INDEX"], ls="--", c="g",
                    label="MAX INDEX %d " % b["MAX_INDEX"])
        plt.axvline(x=b["LOWER_INDEX"], ls="-.", c="r",
                    label="LOWER INDEX %d " % b["LOWER_INDEX"])
        plt.axvline(x=b["UPPER_INDEX"], ls="-.", c="g",
                    label="UPPER INDEX %d " % b["UPPER_INDEX"])
        plt.legend(loc="best")
        plt.xlim(1, 150)
        plt.xlabel("kmer depth")
        plt.ylabel("count")
        plt.title(f"{parent} kmer-depth count")
    plt.subplots_adjust(hspace=0.4)
    return fig


def plot_bounds(workdir: str = ".", out_png: str = "test.png",
                histo_suffix: str = ".kmercount.histo") -> str | None:
    """Render the two-panel bounds plot; returns the png path or None
    if matplotlib is unavailable."""
    try:
        fig = render_bounds_figure(workdir, histo_suffix)
    except ImportError:
        return None
    import matplotlib.pyplot as plt

    path = os.path.join(workdir, out_png)
    fig.savefig(path)
    plt.close(fig)
    return path
