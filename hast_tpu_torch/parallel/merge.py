"""Merge of per-shard classify results (port of hast_tpu/parallel/merge.py,
the reference mergeResult with the JAX package's fixed semantics).

The reference's mergeResult adds both haplotype counts into hap 0
(mergeResult.cpp:28-29).  The specification kept here is classify's own
single run: counts re-accumulate per barcode, and the decision is getHap
with the marker set sizes and weights of the original run, so the merged
output equals one classify over all the inputs.  Host only.
"""

from __future__ import annotations

from hast_tpu_torch.pipeline.classify import get_hap


def load_phased_counts(path: str, into: dict[bytes, list[int]] | None = None
                       ) -> dict[bytes, list[int]]:
    """Accumulate barcode -> [c0, c1] from a phased.barcodes file."""
    counts = into if into is not None else {}
    with open(path, "rb") as f:
        for line in f:
            cols = line.rstrip(b"\n").split(b"\t")
            if len(cols) < 4:
                continue
            c = counts.setdefault(cols[0], [0, 0])
            c[0] += int(cols[2])
            c[1] += int(cols[3])
    return counts


def merge_phased_files(paths: list[str], out, size0: int, size1: int,
                       w0: float = 1.0, w1: float = 1.0) -> None:
    """Merge shard outputs and decide again; equals a single classify.

    size0/size1 are the marker set sizes after adaptor erasure of the
    original runs (classify logs them; load_marker_table and
    erase_adaptors recompute them from the mer files).
    """
    counts: dict[bytes, list[int]] = {}
    for p in paths:
        load_phased_counts(p, counts)
    for bc in sorted(counts):
        c0, c1 = counts[bc]
        out.write(b"%s\t%d\t%d\t%d\n" % (
            bc, get_hap(bc, c0, c1, size0, size1, w0, w1), c0, c1))
