"""Stage 00: parental unique-marker construction (port of
hast_tpu/pipeline/markers.py).

The reference jellyfish pipeline (build_unshared_kmers.sh) and its
counterparts here:

  count -C per parent              (:188-221)   count_files(_device)
  histo + find_bounds.awk                       histo_rows + find_bounds
  dump -L lo -U up                 (:257-268)   filter_range / K8 bounds
  2*mat.fa + 1*pat.fa count trick  (:271-283)   difference / K8 search
  unique∩filter re-count           (:285-298)   the same K8 call
  *.unique.filter.mer text dump    (:290-291)   dump_words

A k-mer of parent A is "unique" iff absent from parent B's count table,
and the markers of A are unique(A) ∩ count-range(A).  Engine ``device``
(the default) keeps both count tables on the device and fetches only the
markers; engine ``host`` fetches each table and snapshots it per
sub-step (``.counts.npz``), for the reference's finer resume.  Both
read a file one way, KC._FileRead (the native reader, else the python
reader).  With n_parts > 1 both count in key-range passes, and both
read each parent once, into a spill beside the outputs (KC.PackedSpill)
that the boundary sample and every pass read; the device engine writes
both parents' spills at once, a reader a file, a reader batch from each
in turn.  On ``--device cpu`` both run the kernels' plain PyTorch twins.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Sequence

import numpy as np

from hast_tpu_torch.io import fastq as FQ
from hast_tpu_torch.ops import kmer_count as KC
from hast_tpu_torch.pipeline import classify as C
from hast_tpu_torch.utils.checkpoint import step
from hast_tpu_torch.utils.profiling import PhaseTimer, span

DEFAULT_K = 21
DEFAULT_LOWER = 9
DEFAULT_UPPER = 33
HIGH = 10000        # jellyfish histo's default high bin


def _count_parts(n_parts: int | None) -> int:
    """n_parts as given, else HAST_COUNT_PARTS, else 1 (the JAX package's
    order)."""
    if n_parts is None:
        return int(os.environ.get("HAST_COUNT_PARTS", "1"))
    return n_parts


def count_files(paths: Sequence[str], k: int,
                batch_size: int = FQ.DEFAULT_BATCH, n_parts: int | None = None,
                device="cuda", spill_dir: str | None = None
                ) -> KC.CountTable:
    """Count canonical k-mers over fasta/fastq files (jellyfish count -C)
    into a host table, a file at a time (KC.count_file).  n_parts > 1
    counts in key-range passes from a spill of the files in spill_dir
    (_count_ranges); None reads HAST_COUNT_PARTS (default 1)."""
    n_parts = _count_parts(n_parts)
    if n_parts > 1:
        return _count_ranges(paths, k, batch_size, n_parts, device,
                             spill_dir)
    counter = KC.Counter(k)
    for path in paths:
        counter.add_table(KC.count_file(path, k, batch_size, device=device))
    return counter.finalize()


def _count_ranges(paths, k, batch_size, n_parts, device,
                  spill_dir) -> KC.CountTable:
    """The files read once into a spill in spill_dir (KC.PackedSpill),
    split at the quantiles of its sample and counted a key range a pass,
    each pass with a resident run of ~1/n_parts of the distinct set; the
    ranges are disjoint, so their tables concatenate.  The spill is
    removed whether the count succeeds or fails."""
    if spill_dir is None:
        raise ValueError("counting in key-range passes needs a spill "
                         "directory")
    spill = KC.PackedSpill(os.path.join(spill_dir, "count.reads.spill"),
                           paths, k, batch_size)
    try:
        boundaries = spill.sample_boundaries(n_parts, device=device)
        parts: list[KC.CountTable] = []
        for p in range(n_parts):
            with span("markers.count_pass"):
                t = spill.count_pass((boundaries[p], boundaries[p + 1]),
                                     device=device).fetch()
            print(f"  count pass {p + 1}/{n_parts}: {t.n_distinct} "
                  "distinct k-mers resident", file=sys.stderr)
            parts.append(t)
    finally:
        spill.remove()
    words = np.concatenate([t.words for t in parts])
    counts = np.concatenate([t.counts for t in parts])
    if not np.all(words[1:] > words[:-1]):
        raise RuntimeError("key-range passes overlap")
    return KC.CountTable(words, counts, k)


def count_files_device(paths: Sequence[str], k: int,
                       batch_size: int = FQ.DEFAULT_BATCH, device="cuda"
                       ) -> KC.DeviceCountTable:
    """Count canonical k-mers keeping the table on the device: the files'
    runs union-sum with DeviceCounter.merge_device."""
    total = KC.DeviceCounter(k, device)
    for path in paths:
        total.merge_device(KC.count_file(path, k, batch_size,
                                         finalize=False, device=device))
    return total.finalize_device()


def count_files_device_pair(a_paths: Sequence[str],
                            b_paths: Sequence[str], k: int,
                            batch_size: int = FQ.DEFAULT_BATCH,
                            device="cuda"):
    """Count both parents on two threads, so that one parent's reader and
    host packing run while the other's folds hold the device.  Each
    parent's stream and fold are its own, so the tables equal those of
    counting one after the other.  Returns (a_table, b_table)."""
    out: dict = {}

    def work(tag, paths):
        try:
            out[tag] = count_files_device(paths, k, batch_size, device)
        except BaseException as e:   # re-raised on the caller's thread
            out[tag] = e

    t = threading.Thread(target=work, args=("a", a_paths),
                         name="hast-count-a")
    t.start()
    work("b", b_paths)
    t.join()
    for tag in ("a", "b"):
        if isinstance(out[tag], BaseException):
            raise out[tag]
    return out["a"], out["b"]


def histo_rows(table, high: int = HIGH):
    """(count_value, n_kmers) rows exactly as `jellyfish histo` prints:
    non-zero bins only, counts > high lumped into the high+1 row."""
    return _rows_from_hist(table.histo(high=high))


def _rows_from_hist(hist) -> list[tuple[int, int]]:
    return [(v, int(hist[v])) for v in range(1, len(hist)) if hist[v] > 0]


def find_bounds(rows) -> dict[str, int]:
    """find_bounds.awk byte for byte on jellyfish histo rows.

    State 0 walks down to the first local minimum: a row whose freq does
    not set a new minimum flips to state 1 without being considered for
    the max; state 1 then tracks the running maximum.
    LOWER = MIN_INDEX+1, UPPER = 3*MAX_INDEX - 2*MIN_INDEX - 1.
    """
    MIN = MIN_INDEX = MAX = MAX_INDEX = 0
    state = 0
    for i, c in rows:
        if state == 0:
            if MIN == 0 or c < MIN:
                MIN, MIN_INDEX = c, i
            else:
                state = 1
        else:
            if MAX == 0 or c > MAX:
                MAX, MAX_INDEX = c, i
    return {
        "MIN_INDEX": MIN_INDEX,
        "MAX_INDEX": MAX_INDEX,
        "LOWER_INDEX": MIN_INDEX + 1,
        "UPPER_INDEX": 3 * MAX_INDEX - 2 * MIN_INDEX - 1,
    }


def write_bounds(bounds: dict[str, int], path: str) -> None:
    """maternal.bounds.txt / paternal.bounds.txt format."""
    with open(path, "w") as f:
        for key in ("MIN_INDEX", "MAX_INDEX", "LOWER_INDEX", "UPPER_INDEX"):
            f.write(f"{key}={bounds[key]}\n")


def write_histo(rows, path: str) -> None:
    with open(path, "w") as f:
        for v, c in rows:
            f.write(f"{v} {c}\n")


def _write_histos(m_rows, p_rows, auto_bounds: bool, j) -> None:
    """Both parents' .kmercount.histo, and .bounds.txt with auto_bounds."""
    write_histo(m_rows, j("maternal.kmercount.histo"))
    write_histo(p_rows, j("paternal.kmercount.histo"))
    if auto_bounds:
        write_bounds(find_bounds(m_rows), j("maternal.bounds.txt"))
        write_bounds(find_bounds(p_rows), j("paternal.bounds.txt"))


def _bounds_in_use(m_rows, p_rows, auto_bounds: bool, bounds, log):
    """(m_lower, m_upper, p_lower, p_upper): the histos' with
    auto_bounds, else the given ones; logged as the reference does."""
    if auto_bounds:
        mb, pb = find_bounds(m_rows), find_bounds(p_rows)
        bounds = (mb["LOWER_INDEX"], mb["UPPER_INDEX"],
                  pb["LOWER_INDEX"], pb["UPPER_INDEX"])
    _log_bounds(bounds, log)
    return bounds


def _log_bounds(bounds, log) -> None:
    m_lower, m_upper, p_lower, p_upper = bounds
    print(f"  the real used kmer-count bounds of maternal is "
          f"[ {m_lower} , {m_upper} ] ", file=log)
    print(f"  the real used kmer-count bounds of paternal is "
          f"[ {p_lower} , {p_upper} ] ", file=log)


def _count_lines(path: str) -> int:
    with open(path, "rb") as f:
        return sum(1 for _ in f)


def build_unshared_markers(
    paternal: Sequence[str], maternal: Sequence[str], out_dir: str = ".",
    k: int = DEFAULT_K, auto_bounds: bool = False,
    p_lower: int = DEFAULT_LOWER, p_upper: int = DEFAULT_UPPER,
    m_lower: int = DEFAULT_LOWER, m_upper: int = DEFAULT_UPPER,
    batch_size: int = FQ.DEFAULT_BATCH, log=sys.stderr,
    n_parts: int | None = None, engine: str | None = None, device="cuda",
) -> dict[str, str]:
    """Stage 00: parent counting -> bounds -> unique.filter.mer files.

    Returns the paths of the two marker files (the stage 00/01
    interface).  engine "device" (also "auto"): one all-or-nothing
    checkpoint, both tables resident, only the markers fetched.  engine
    "host": per-substep checkpoints with ``.counts.npz`` snapshots.  In
    either, n_parts > 1 counts in key-range passes from spills in
    out_dir.  None reads
    HAST_STAGE00_ENGINE (default auto) and HAST_COUNT_PARTS (default 1),
    as the JAX package does; `run` has no flag for either.
    """
    n_parts = _count_parts(n_parts)
    if engine is None:
        engine = os.environ.get("HAST_STAGE00_ENGINE", "auto")
    bounds = (m_lower, m_upper, p_lower, p_upper)
    if engine in ("auto", "device"):
        return _build_unshared_markers_device(
            paternal, maternal, out_dir, k, auto_bounds, bounds,
            batch_size, log, n_parts, device)
    if engine != "host":
        raise ValueError(f"engine must be auto, device or host, got "
                         f"{engine!r}")

    timer = PhaseTimer(log=log)
    j = lambda name: os.path.join(out_dir, name)  # noqa: E731
    print("extract unique mers (host count tables) ...", file=log)

    mat = pat = None
    with step("00.1_count_maternal", out_dir, log=log) as todo:
        if todo:
            with timer.phase("count_maternal"):
                mat = count_files(maternal, k, batch_size, n_parts, device,
                                  out_dir)
            timer.add_items("count_maternal", mat.total)
            mat.save(j("maternal.counts.npz"))
    if mat is None:
        mat = KC.CountTable.load(j("maternal.counts.npz"))
    with step("00.2_count_paternal", out_dir, log=log) as todo:
        if todo:
            with timer.phase("count_paternal"):
                pat = count_files(paternal, k, batch_size, n_parts, device,
                                  out_dir)
            timer.add_items("count_paternal", pat.total)
            pat.save(j("paternal.counts.npz"))
    if pat is None:
        pat = KC.CountTable.load(j("paternal.counts.npz"))
    for name, t in (("maternal", mat), ("paternal", pat)):
        print(f"  {name}: {t.n_distinct} distinct / {t.total} total "
              f"{k}-mers", file=log)

    m_rows, p_rows = histo_rows(mat), histo_rows(pat)
    with step("00.3_bounds", out_dir, log=log) as todo:
        if todo:
            _write_histos(m_rows, p_rows, auto_bounds, j)
    m_lower, m_upper, p_lower, p_upper = _bounds_in_use(
        m_rows, p_rows, auto_bounds, bounds, log)

    paths = {
        "paternal": j("paternal.unique.filter.mer"),
        "maternal": j("maternal.unique.filter.mer"),
    }
    with step("00.4_markers", out_dir, log=log) as todo:
        if todo:
            with timer.phase("marker_algebra"):
                pat_final = pat.difference(mat).filter_range(p_lower,
                                                             p_upper)
                mat_final = mat.difference(pat).filter_range(m_lower,
                                                             m_upper)
            n_p = pat_final.dump_mer_text(paths["paternal"])
            n_m = mat_final.dump_mer_text(paths["maternal"])
        else:
            n_p = _count_lines(paths["paternal"])
            n_m = _count_lines(paths["maternal"])
    print(f"final paternal unique kmer is : {n_p}", file=log)
    print(f"final maternal unique kmer is : {n_m}", file=log)
    timer.report()
    return paths


def _build_unshared_markers_device(paternal, maternal, out_dir, k,
                                   auto_bounds, bounds, batch_size, log,
                                   n_parts: int, device) -> dict[str, str]:
    """Device-resident stage 00 (see build_unshared_markers).

    Everything between the reader and the `.mer`/`.histo`/`.bounds.txt`
    text happens on the device: the host receives the histograms and the
    final marker words only.

    n_parts > 1: the key space splits into quantile ranges shared by
    both parents, and the run is two sweeps of n_parts passes each --
    sweep A sums the per-range histograms (the bounds need all ranges),
    sweep B counts each range with both parents resident and fetches
    that range's markers.
    """
    timer = PhaseTimer(log=log)
    j = lambda name: os.path.join(out_dir, name)  # noqa: E731
    print("extract unique mers (device-resident count tables) ...",
          file=log)
    paths = {
        "paternal": j("paternal.unique.filter.mer"),
        "maternal": j("maternal.unique.filter.mer"),
    }
    with step("00.device_markers", out_dir, log=log) as todo:
        if not todo:
            n_p = _count_lines(paths["paternal"])
            n_m = _count_lines(paths["maternal"])
        elif n_parts <= 1:
            with timer.phase("count_parents"):
                mat, pat = count_files_device_pair(maternal, paternal, k,
                                                   batch_size, device)
            totals = {"maternal": mat.total, "paternal": pat.total}
            timer.add_items("count_parents", sum(totals.values()))
            for name, t in (("maternal", mat), ("paternal", pat)):
                print(f"  {name}: {t.n_distinct} distinct / "
                      f"{totals[name]} total {k}-mers", file=log)
            with timer.phase("bounds"):
                m_rows, p_rows = histo_rows(mat), histo_rows(pat)
                _write_histos(m_rows, p_rows, auto_bounds, j)
                m_lower, m_upper, p_lower, p_upper = _bounds_in_use(
                    m_rows, p_rows, auto_bounds, bounds, log)
            with timer.phase("marker_algebra"):
                p_words, m_words = KC.device_marker_algebra(
                    pat, mat, p_lower, p_upper, m_lower, m_upper)
            n_p = KC.dump_words(p_words, k, paths["paternal"])
            n_m = KC.dump_words(m_words, k, paths["maternal"])
        else:
            n_p, n_m = _markers_partitioned(paternal, maternal, k,
                                            auto_bounds, bounds,
                                            batch_size, log, n_parts,
                                            device, timer, j, paths)
    print(f"final paternal unique kmer is : {n_p}", file=log)
    print(f"final maternal unique kmer is : {n_m}", file=log)
    timer.report()
    return paths


def _markers_partitioned(paternal, maternal, k, auto_bounds, bounds,
                         batch_size, log, n_parts, device, timer, j, paths):
    """The two sweeps of the n_parts > 1 device engine; returns the
    marker counts (paternal, maternal).

    Each parent's files are read once, into a spill of packed rows
    beside the outputs (KC.PackedSpill, as meryl splits its input once),
    a lane a file: as many files' readers open at once as classify keeps
    (C._reader_width of all the files), the parents' first files first
    (maternal R1, paternal R1, maternal R2, paternal R2), a batch from
    each in turn; the boundary sample and every pass read the spills,
    which are removed when the step ends, whether it succeeds or fails."""
    spills: dict[str, KC.PackedSpill] = {}
    parents = (("maternal", maternal), ("paternal", paternal))
    try:
        with timer.phase("spill"):
            written = KC.PackedSpill.write_in_turn(
                [(j(f"{name}.reads.spill"), files)
                 for name, files in parents],
                k, batch_size,
                width=C._reader_width(sum(len(f) for _, f in parents)))
            spills = {name: s for (name, _), s in zip(parents, written)}
        return _sweeps(spills, k, auto_bounds, bounds, log, n_parts, device,
                       timer, j, paths)
    finally:
        for spill in spills.values():
            spill.remove()


def _sweeps(spills, k, auto_bounds, bounds, log, n_parts, device, timer, j,
            paths):
    """Sweep A sums each parent's histograms over the key ranges, sweep
    B counts each range of both parents and keeps its markers."""
    # a range pass keeps ~1/n_parts of the stream, so bigger, fewer folds
    # fit the same memory
    fold_above = min(192_000_000, KC.FOLD_ABOVE * n_parts)

    def count_range(name, lo_b, hi_b) -> KC.DeviceCountTable:
        """One key-range pass over a parent's spill."""
        with span("markers.count_pass"):
            return spills[name].count_pass((lo_b, hi_b), fold_above, device)

    boundaries = spills["maternal"].sample_boundaries(n_parts, device=device)
    parents = ("maternal", "paternal")
    hists = {name: np.zeros(HIGH + 2, np.int64) for name in parents}
    stats = {name: [0, 0] for name in parents}
    with timer.phase("histo_sweep"):
        for p in range(n_parts):
            for name in parents:
                t0 = time.perf_counter()
                t = count_range(name, boundaries[p], boundaries[p + 1])
                hists[name] += t.histo(high=HIGH)
                stats[name][0] += t.n_distinct
                stats[name][1] += t.total
                print(f"  count pass {p + 1}/{n_parts} {name}: "
                      f"{t.n_distinct} distinct resident, "
                      f"{time.perf_counter() - t0:.1f}s", file=log)
                del t
    for name in parents:
        print(f"  {name}: {stats[name][0]} distinct / {stats[name][1]} "
              f"total {k}-mers", file=log)
    with timer.phase("bounds"):
        m_rows = _rows_from_hist(hists["maternal"])
        p_rows = _rows_from_hist(hists["paternal"])
        _write_histos(m_rows, p_rows, auto_bounds, j)
        m_lower, m_upper, p_lower, p_upper = _bounds_in_use(
            m_rows, p_rows, auto_bounds, bounds, log)
    p_parts, m_parts = [], []
    with timer.phase("marker_sweep"):
        for p in range(n_parts):
            dmat = count_range("maternal", boundaries[p], boundaries[p + 1])
            dpat = count_range("paternal", boundaries[p], boundaries[p + 1])
            pw, mw = KC.device_marker_algebra(dpat, dmat, p_lower, p_upper,
                                              m_lower, m_upper)
            print(f"  marker pass {p + 1}/{n_parts}: {pw.size}+{mw.size} "
                  "markers", file=log)
            p_parts.append(pw)
            m_parts.append(mw)
            del dmat, dpat
    return (KC.dump_words(np.concatenate(p_parts), k, paths["paternal"]),
            KC.dump_words(np.concatenate(m_parts), k, paths["maternal"]))
