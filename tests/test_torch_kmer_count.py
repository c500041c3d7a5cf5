"""hast_tpu_torch.ops.kmer_count against hast_tpu.ops.kmer_count.

The twins of K4-K8 and K12 (what the wrappers run on CPU tensors) are held
against the JAX kernels they replace on the same numpy-seeded inputs:
count_windows against count_kernel_multi, its _clean and _range forms
and chunk_sorted_kmers; sort_pairs against lax.sort; fold_runs against
_merge_rle_kernel; shrink_run against _shrink; count_stats against
_histo_kernel and _total_kernel; marker_filter against
device_marker_algebra.  Then the counters built on
them: DeviceCounter (merge_device included), the key-range passes over
a spill with bounds at and beyond 2^63, the file counter and the spill's
boundary sample.  Every value is an integer and the kernels use integer
atomics, so the tolerance is exact equality throughout; the kernels are
held against the twins on the card (marked cuda).
"""

import itertools

import numpy as np
import pytest
import torch

from hast_tpu_torch.ops import _build
from hast_tpu_torch.ops import encode as E
from hast_tpu_torch.ops import kmer_count as KC
from hast_tpu_torch.utils import synthetic as S

SENT = KC.SENT
U32 = 0xFFFFFFFF


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def jax_modules():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from hast_tpu.ops import kmer_count as JKC
    return jax, jnp, JKC


def ref_keys(hi, lo) -> np.ndarray:
    """JAX (hi, lo) uint32 pairs -> the port's int64 keys."""
    hi = np.asarray(hi).astype(np.int64)
    lo = np.asarray(lo).astype(np.int64)
    return np.where((hi == U32) & (lo == U32), SENT, (hi << 32) | lo)


def ascii_reads(seed: int, k: int, n: int = 48, L: int = 64,
                alphabet: bytes = b"ACGTacgt" * 3 + b"N"):
    """Zero-padded ASCII reads: N bases, lowercase, and lengths 0, < k, k
    and the full stride."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    seqs = letters[rng.integers(0, letters.size, (n, L))]
    lengths = rng.integers(0, L + 1, n).astype(np.int32)
    lengths[:4] = (0, k - 1, k, L)
    seqs[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return seqs, lengths


def packed_reads(seqs, lengths):
    """(packed, good, lengths) tensors; good is None for a stride of an
    odd number of bytes, which takes no mask."""
    return (torch.from_numpy(E.pack_codes_np(seqs)),
            torch.from_numpy(KC.pack_good_np(seqs))
            if seqs.shape[1] % 8 == 0 else None,
            torch.from_numpy(lengths))


def batches_of(seed: int, k: int, n_batches: int = 5, B: int = 64,
               L: int = 72, alphabet: bytes = b"ACGT" * 6 + b"N"):
    """ReadBatch-like objects with duplicate rows, so counts exceed 1."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    out = []
    for _ in range(n_batches):
        seqs = letters[rng.integers(0, letters.size, (B, L))]
        seqs[1::3] = seqs[0]
        lengths = rng.integers(k, L + 1, B).astype(np.int32)
        out.append(type("B", (), dict(seqs=seqs, lengths=lengths))())
    return out


# ---------------------------------------------------------------------------
# K4 count_windows
# ---------------------------------------------------------------------------

RANGES = {
    "middle": None,                                    # quartiles
    "to_top": None,                                    # median, 2^64 - 1
    "above_int64": ((1 << 63) + 5, (1 << 64) - 1),     # empty: all >= 2^63
    "from_zero": (0, (1 << 64) // 2),                  # hi = 2^63
}


# variant: what count_windows is asked for, on ascii_reads (stride 16
# bytes), or "<variant>_lp<stride>" on window_edge_reads of that stride:
# strides that are not a multiple of 4 (a mask needs an even one), reads
# of length 0, k - 1, k and the full stride, N at a window's first and
# last base
@pytest.mark.parametrize("k", [15, 17, 21, 31])
@pytest.mark.parametrize("variant", ["masked", "clean", "range", "sorted",
                                     "masked_lp26", "masked_lp30",
                                     "range_lp30", "clean_lp25"])
def test_count_windows_twin_matches_jax(k, variant):
    jax, jnp, JKC = jax_modules()
    if "_lp" in variant:
        variant, lp = variant.split("_lp")
        seqs, lengths = S.window_edge_reads(k, k, int(lp))
        if variant == "clean":
            seqs[seqs == ord("N")] = ord("A")
    else:
        seqs, lengths = ascii_reads(k, k, **(dict(alphabet=b"ACGTacgt")
                                             if variant == "clean" else {}))
    packed, good, lens = packed_reads(seqs, lengths)
    jp, jg, jl = (None if x is None else jnp.asarray(x.numpy()[None])
                  for x in (packed, good, lens))
    before = dict(_build.LAUNCHES)
    if variant == "masked":
        got = KC.count_windows(packed, lens, k, good)
        want = [ref_keys(*JKC.count_kernel_multi(jp, jg, jl, k,
                                                 sort=False))[0]]
    elif variant == "clean":
        got = KC.count_windows(packed, lens, k)
        want = [ref_keys(*JKC.count_kernel_multi_clean(jp, jl, k,
                                                       sort=False))[0]]
    elif variant == "range":
        real = KC.count_windows(packed, lens, k, good).numpy()
        real = np.sort(real[real != SENT])
        ranges = dict(RANGES, middle=(int(real[real.size // 4]),
                                      int(real[3 * real.size // 4])),
                      to_top=(int(real[real.size // 2]), (1 << 64) - 1))
        got, want = [], []
        for lo_b, hi_b in ranges.values():
            got.append(KC.count_windows(packed, lens, k, good,
                                        (lo_b, hi_b)).numpy())
            want.append(ref_keys(*JKC.count_kernel_multi_range(
                jp, jg, jl, k, jnp.uint32(lo_b >> 32),
                jnp.uint32(lo_b & U32), jnp.uint32(hi_b >> 32),
                jnp.uint32(hi_b & U32), sort=False))[0])
        assert (got[0] != SENT).any() and (got[1] != SENT).any()
        assert (got[2] == SENT).all()
        got = np.concatenate(got)
    else:
        keys = KC.count_windows(packed, lens, k, good)
        got, _ = KC.sort_pairs(keys, None, k)
        want = [ref_keys(*JKC.chunk_sorted_kmers(
            jnp.asarray(seqs), jnp.asarray(lengths), k))]
    assert dict(_build.LAUNCHES) == before     # CPU tensors take the twins
    got = np.asarray(got)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.concatenate(want))
    assert (got != SENT).any() and (got == SENT).any()


def test_count_windows_rejects_bad_input():
    packed = torch.zeros((2, 8), dtype=torch.uint8)
    lengths = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="good"):
        KC.count_windows(packed, lengths, 21, torch.zeros((2, 3),
                                                          dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint64"):
        KC.count_windows(packed, lengths, 21, key_range=(0, 1 << 64))
    with pytest.raises(ValueError, match="CUDA"):
        KC.count_windows(packed.to("meta"), lengths.to("meta"), 21)
    assert KC.count_windows(torch.zeros((3, 2), dtype=torch.uint8),
                            torch.full((3,), 8, dtype=torch.int32),
                            15).numel() == 0


# ---------------------------------------------------------------------------
# K5 sort_pairs, K6 fold_runs
# ---------------------------------------------------------------------------


def dup_heavy_keys(seed: int, k: int, n: int = 4000):
    """Few distinct real keys drawn many times, sentinels mixed in, and
    int32 counts."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << (2 * k), 300, dtype=np.int64)
    pool[:2] = (0, (1 << (2 * k)) - 1)
    keys = pool[rng.integers(0, pool.size, n)]
    keys[rng.random(n) < 0.2] = SENT
    counts = rng.integers(1, 50, n).astype(np.int32)
    return keys, counts


def split_ref(keys):
    sent = keys == SENT
    hi = np.where(sent, U32, keys >> 32).astype(np.uint32)
    lo = np.where(sent, U32, keys & U32).astype(np.uint32)
    return hi, lo


@pytest.mark.parametrize("k", [15, 21, 31])
def test_sort_pairs_twin_matches_lax_sort(k):
    jax, jnp, _ = jax_modules()
    keys, counts = dup_heavy_keys(k, k)
    got_k, got_c = KC.sort_pairs(torch.from_numpy(keys),
                                 torch.from_numpy(counts), k)
    hi, lo = split_ref(keys)
    whi, wlo, wc = jax.lax.sort((jnp.asarray(hi), jnp.asarray(lo),
                                 jnp.asarray(counts)), num_keys=2)
    np.testing.assert_array_equal(got_k.numpy(), ref_keys(whi, wlo))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(wc))
    alone, none = KC.sort_pairs(torch.from_numpy(keys), None, k)
    assert none is None and torch.equal(alone, got_k)


@pytest.mark.parametrize("k", [15, 21, 31])
def test_sort_pairs_twin_on_edge_cases(k):
    """The twin (what the card's kernel is held to) on the look-back
    sort's edge cases equals numpy's stable argsort."""
    from hast_tpu_torch.utils import synthetic as S
    cases = S.sort_edge_cases(k, k, KC.SORT_TILE)
    assert {len(keys) for _, keys in cases} >= {
        1, KC.SORT_TILE - 1, KC.SORT_TILE, KC.SORT_TILE + 1}
    for name, keys in cases:
        counts = np.arange(keys.size, dtype=np.int32)
        got_k, got_c = KC.sort_pairs(torch.from_numpy(keys),
                                     torch.from_numpy(counts), k)
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(got_k.numpy(), keys[order], name)
        np.testing.assert_array_equal(got_c.numpy(), counts[order], name)


def fold_edge_keys(case: str, k: int):
    """The runs a look-back fold gets wrong: one key repeated across more
    than one 4,096-element tile (3 x 4,096 + 1 copies, between other
    keys), a run of one key, n = 1, and count sums that wrap int32."""
    rng = np.random.default_rng(k)
    top = (1 << (2 * k)) - 1
    if case == "repeated":
        keys = np.concatenate([rng.integers(0, top, 500),
                               np.full(3 * 4096 + 1, top // 3),
                               rng.integers(0, top, 500),
                               np.full(300, SENT)])
    elif case == "one-key":
        keys = np.full(5000, top)
    elif case == "n1":
        keys = np.array([top // 2])
    else:   # "wrap": sums past 2^31 - 1 and below -2^31
        keys = np.repeat(rng.integers(0, top, 40), 100)
    keys = keys.astype(np.int64)
    counts = rng.integers(1, 50, keys.size).astype(np.int32)
    if case == "wrap":
        counts = rng.integers(2**30, 2**31 - 1, keys.size).astype(np.int32)
        counts[keys.size // 2:] *= -1
    return keys, counts


# the duplicate-heavy runs keep their ids ("21"); the edge runs add cases
# of the same test ("21-repeated")
FOLD_CASES = [pytest.param(k, case, id=f"{k}{'-' + case if case else ''}")
              for case in ("", "repeated", "one-key", "n1", "wrap")
              for k in (15, 21, 31)]


@pytest.mark.parametrize("k,case", FOLD_CASES)
def test_fold_runs_twin_matches_merge_rle(k, case):
    _, jnp, JKC = jax_modules()
    keys, counts = (fold_edge_keys(case, k) if case
                    else dup_heavy_keys(100 + k, k))
    skeys, scounts = KC.sort_pairs(torch.from_numpy(keys),
                                   torch.from_numpy(counts), k)
    out_k, out_c, n_unique = KC.fold_runs(skeys, scounts)
    hi, lo = split_ref(keys)
    whi, wlo, wc, wn = JKC._merge_rle_kernel(jnp.asarray(hi),
                                             jnp.asarray(lo),
                                             jnp.asarray(counts))
    n = int(wn)
    assert int(n_unique) == n
    assert 0 < n < keys.size // 2 if case != "n1" else n == 1
    if case == "wrap":
        assert (out_c.numpy()[:n].astype(np.int64)
                != np.bincount(np.unique(keys, return_inverse=True)[1],
                               counts.astype(np.int64))).any()
    np.testing.assert_array_equal(out_k.numpy(), ref_keys(whi, wlo))
    np.testing.assert_array_equal(out_c.numpy(), np.asarray(wc))
    assert (out_k.numpy()[n:] == SENT).all() and (out_c.numpy()[n:] == 0
                                                  ).all()


def test_fold_runs_edges():
    empty = torch.zeros(0, dtype=torch.int64)
    k, c, n = KC.fold_runs(empty, torch.zeros(0, dtype=torch.int32))
    assert k.numel() == 0 and c.numel() == 0 and int(n) == 0
    only_pads = torch.full((5,), SENT, dtype=torch.int64)
    k, c, n = KC.fold_runs(only_pads, torch.ones(5, dtype=torch.int32))
    assert int(n) == 0 and (k == SENT).all() and (c == 0).all()


# ---------------------------------------------------------------------------
# K7 count_stats
# ---------------------------------------------------------------------------


def count_stats_params(highs, fixed) -> list:
    """(high, case) parameters: the random draw (case None, id "<high>")
    at each high in `fixed`, then every synthetic.count_stats_edge_cases
    case at each high in `highs` (id "<high>-<case>")."""
    return ([pytest.param(h, None, id=str(h)) for h in fixed]
            + [pytest.param(h, c, id=f"{h}-{c}") for h in highs
               for c in S.count_stats_edge_cases(0, 100, n=8)])


@pytest.mark.parametrize("high, case", count_stats_params((0, 100, 10000),
                                                          (100, 10000)))
def test_count_stats_twin_matches_histo_and_total(high, case):
    _, jnp, JKC = jax_modules()
    if case is None:
        rng = np.random.default_rng(high)
        counts = rng.integers(1, 3 * high, 5000).astype(np.int32)
        counts[rng.random(counts.size) < 0.3] = 0           # pads
        counts[:3] = (high, high + 1, 2**31 - 1)
    else:
        counts = S.count_stats_edge_cases(high, high)[case]
    bins, total = KC.count_stats(torch.from_numpy(counts), high)
    want = np.asarray(JKC._histo_kernel(jnp.asarray(counts), high))
    lo, hi = JKC._total_kernel(jnp.asarray(counts))
    want_total = (np.asarray(lo).astype(np.int64).sum()
                  + (np.asarray(hi).astype(np.int64).sum() << 14))
    assert bins.dtype == torch.int64 and total.dtype == torch.int64
    np.testing.assert_array_equal(bins.numpy(), want)
    assert int(total) == want_total == counts.astype(np.int64).sum()


# ---------------------------------------------------------------------------
# K8 marker_filter, DeviceCountTable
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tables():
    """Two parents counted by the JAX DeviceCounter, as resident tables."""
    _, _, JKC = jax_modules()
    k = 21
    mat = JKC.count_batches(batches_of(21, k), k,
                            finalize=False).finalize_device()
    pat = JKC.count_batches(batches_of(22, k), k,
                            finalize=False).finalize_device()
    return pat, mat


@pytest.mark.parametrize("bounds", [(1, 3, 1, 3), (2, 10, 1, 1),
                                    (1, 10**6, 1, 10**6), (0, 2**31 - 1,
                                                           0, 2)])
def test_marker_algebra_matches_jax(jax_tables, bounds):
    _, _, JKC = jax_modules()
    pat, mat = jax_tables
    tpat = KC.DeviceCountTable.from_reference(pat, "cpu")
    tmat = KC.DeviceCountTable.from_reference(mat, "cpu")
    assert tpat.keys.numel() > tpat.n_valid        # padded, as in JAX
    before = _build.TWIN_CALLS["marker_filter_ref"]
    got = KC.device_marker_algebra(tpat, tmat, *bounds)
    assert _build.TWIN_CALLS["marker_filter_ref"] == before + 1
    want = JKC.device_marker_algebra(pat, mat, *bounds)
    for g, w in zip(got, want):
        assert g.dtype == np.uint64
        np.testing.assert_array_equal(g, w)
    assert got[0].size and got[1].size


def test_marker_filter_lone_sentinel_at_lower_zero():
    """A lone pad row and lower = 0 keep no pad (test_stage00_parity's
    case), in the twin and in JAX."""
    _, jnp, JKC = jax_modules()
    S = np.uint32(U32)
    ref_p = JKC.DeviceCountTable(
        jnp.asarray(np.array([0, 1, S], np.uint32)),
        jnp.asarray(np.array([5, 6, S], np.uint32)),
        jnp.asarray(np.array([3, 2, 0], np.int32)), 2, 21)
    ref_m = JKC.DeviceCountTable(
        jnp.asarray(np.array([0, 2, 3], np.uint32)),
        jnp.asarray(np.array([5, 7, 8], np.uint32)),
        jnp.asarray(np.array([4, 1, 1], np.int32)), 3, 21)
    pat = KC.DeviceCountTable.from_reference(ref_p, "cpu")
    mat = KC.DeviceCountTable.from_reference(ref_m, "cpu")
    assert int(pat.keys[2]) == SENT
    p, m = KC.device_marker_algebra(pat, mat, 0, 100, 0, 100)
    assert p.tolist() == [(1 << 32) | 6]
    assert m.tolist() == [(2 << 32) | 7, (3 << 32) | 8]
    wp, wm = JKC.device_marker_algebra(ref_p, ref_m, 0, 100, 0, 100)
    np.testing.assert_array_equal(p, wp)
    np.testing.assert_array_equal(m, wm)


def jax_halves(keys: np.ndarray):
    """The port's int64 keys -> JAX (hi, lo) uint32, INT64_MAX as
    (0xFFFFFFFF, 0xFFFFFFFF)."""
    sent = keys == SENT
    return (np.where(sent, U32, keys >> 32).astype(np.uint32),
            np.where(sent, U32, keys & U32).astype(np.uint32))


def marker_case_tensors(a, b, device="cpu"):
    """marker_edge_cases' (a, b) as the twin's and the kernel's arguments;
    a case whose a is b passes the same tensors twice."""
    ta = [torch.from_numpy(a[0]).to(device),
          torch.from_numpy(a[1]).to(device), a[2]]
    tb = ta if b is a else [torch.from_numpy(b[0]).to(device),
                            torch.from_numpy(b[1]).to(device), b[2]]
    return [*ta, *tb]


@pytest.mark.parametrize("case", range(10))
@pytest.mark.parametrize("bounds", [(1, 11, 2, 9),
                                    (0, 2**31 - 1, 0, 2**31 - 1)])
def test_marker_filter_twin_on_edge_cases_matches_jax(case, bounds):
    """marker_edge_cases (shared keys at, across and after every tile
    edge of the merged order, empty sides, all or no key shared, a and b
    the same arrays, unequal lengths) through the twin and through
    _unique_filter_kernel + _compact_kernel; lower = 0 with pads keeps
    no pad."""
    _, jnp, JKC = jax_modules()
    cases = S.marker_edge_cases(9, KC.MARKER_TILE)
    assert len(cases) == 10
    name, a, b = cases[case]
    got = KC.marker_filter_ref(*marker_case_tensors(a, b), bounds)
    keep = JKC._unique_filter_kernel(
        *(jnp.asarray(x) for x in (*jax_halves(a[0]), a[1],
                                   *jax_halves(b[0]), b[1])),
        *(np.int32(x) for x in bounds))
    for (keys, _, _), k, out, n in zip((a, b), keep, got[0::2], got[1::2]):
        hi, lo, want_n = JKC._compact_kernel(*(jnp.asarray(x) for x in
                                               jax_halves(keys)), k)
        np.testing.assert_array_equal(out.numpy(), ref_keys(hi, lo), name)
        assert int(n) == int(want_n), name


def test_device_table_round_trips_and_matches_jax(jax_tables):
    _, _, JKC = jax_modules()
    pat, _ = jax_tables
    t = KC.DeviceCountTable.from_reference(pat, "cpu")
    hi, lo, counts, n_valid, k = t.to_reference()
    np.testing.assert_array_equal(hi, np.asarray(pat.hi))
    np.testing.assert_array_equal(lo, np.asarray(pat.lo))
    np.testing.assert_array_equal(counts, np.asarray(pat.counts))
    assert (n_valid, k) == (pat.n_valid, pat.k)
    assert t.total == pat.total and t.n_distinct == pat.n_distinct
    np.testing.assert_array_equal(t.histo(), pat.histo())
    f, wf = t.fetch(), pat.fetch()
    np.testing.assert_array_equal(f.words, wf.words)
    np.testing.assert_array_equal(f.counts, wf.counts)
    ct = KC.CountTable.from_reference(wf)
    back = JKC.CountTable(*ct.to_reference())
    np.testing.assert_array_equal(back.words, wf.words)
    np.testing.assert_array_equal(back.counts, wf.counts)
    assert back.k == wf.k


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------


def test_device_counter_matches_jax_counters():
    """The port's DeviceCounter == the JAX DeviceCounter and host Counter
    on duplicate-heavy batches with N bases, folding several times."""
    _, _, JKC = jax_modules()
    k = 21
    batches = batches_of(11, k, n_batches=7)
    got = KC.count_batches(batches, k, super_batch=2, device="cpu")
    small = KC.DeviceCounter(k, "cpu", fold_above=5000)
    for b in batches:
        packed, good, lengths = (torch.from_numpy(x) for x in
                                 KC._assemble_ascii([b]))
        small.add_sorted_chunk(KC.count_windows(packed, lengths, k, good))
    folded = small.finalize()
    assert small.n_folds >= 2
    for want in (JKC.count_batches(batches, k, super_batch=2,
                                   engine="device"),
                 JKC.count_batches(batches, k, super_batch=2,
                                   engine="host")):
        for t in (got, folded):
            np.testing.assert_array_equal(t.words, want.words)
            np.testing.assert_array_equal(t.counts, want.counts)
    assert got.total > got.n_distinct > 0


def test_merge_device_union_sums():
    _, _, JKC = jax_modules()
    k = 21
    r = np.random.default_rng(9)
    seqs = np.frombuffer(b"ACGT", np.uint8)[r.integers(0, 4, (64, 60))]
    b1 = type("B", (), dict(seqs=seqs[:32],
                            lengths=np.full(32, 60, np.int32)))()
    b2 = type("B", (), dict(seqs=seqs[16:],
                            lengths=np.full(48, 60, np.int32)))()
    c1 = KC.count_batches([b1], k, finalize=False, device="cpu")
    c1.merge_device(KC.count_batches([b2], k, finalize=False,
                                     device="cpu"))
    got = c1.finalize_device().fetch()
    want = JKC.count_batches([b1, b2], k)
    np.testing.assert_array_equal(got.words, want.words)
    np.testing.assert_array_equal(got.counts, want.counts)
    empty = KC.DeviceCounter(k, "cpu").finalize_device()
    assert empty.n_valid == 0 and empty.keys.numel() == 0


def fastq_of(batches, path) -> str:
    """The batches' reads, each cut to its length, as a fastq."""
    with open(path, "wb") as f:
        for b in batches:
            for i, (seq, n) in enumerate(zip(b.seqs, b.lengths)):
                f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq[:n].tobytes(),
                                                 b"I" * int(n)))
    return str(path)


def count_spill(path: str, k: int, bounds, device, **kw) -> KC.CountTable:
    """A spill of the file counted a key range a pass, the ranges'
    tables concatenated."""
    spill = KC.PackedSpill(path + ".spill", [path], k, **kw)
    try:
        parts = [spill.count_pass((bounds[p], bounds[p + 1]),
                                  device=device).fetch()
                 for p in range(len(bounds) - 1)]
    finally:
        spill.remove()
    return KC.CountTable(np.concatenate([t.words for t in parts]),
                         np.concatenate([t.counts for t in parts]), k)


def spill_bounds(path: str, k: int, n_parts: int, **kw) -> np.ndarray:
    """The split points of a spill of the file."""
    spill = KC.PackedSpill(path + ".spill", [path], k, 64)
    try:
        return spill.sample_boundaries(n_parts, device="cpu", **kw)
    finally:
        spill.remove()


@pytest.mark.parametrize("n_parts", [4, 8])
def test_partitioned_count_with_bounds_beyond_int64(tmp_path, n_parts):
    """An empty sample gives even bounds, half of them >= 2^63 and the
    last 2^64 - 1; the passes over a spill must still cover every key
    exactly once, as they must with its sampled bounds."""
    _, _, JKC = jax_modules()
    k = 21
    bounds = KC._sample_bounds([], k, n_parts, device="cpu")
    np.testing.assert_array_equal(bounds,
                                  JKC.estimate_boundaries([], k, n_parts))
    assert int(bounds[n_parts // 2]) >= 1 << 63
    batches = batches_of(3, k, n_batches=3)
    path = fastq_of(batches, tmp_path / "r.fq")
    want = KC.count_batches(batches, k, device="cpu")
    got = count_spill(path, k, bounds, "cpu")
    np.testing.assert_array_equal(got.words, want.words)
    np.testing.assert_array_equal(got.counts, want.counts)
    sampled = count_spill(path, k, spill_bounds(path, k, n_parts), "cpu")
    np.testing.assert_array_equal(sampled.words, want.words)
    np.testing.assert_array_equal(sampled.counts, want.counts)


def test_boundaries_match_jax(tmp_path):
    """The spill's sampler on a fastq of four batches of 64 reads
    against hast_tpu's estimate_boundaries over all of them and its
    sample_boundaries; a fastq of reads shorter than k (a sample with no
    key) against the even bounds of an empty one."""
    _, _, JKC = jax_modules()
    k = 21
    batches = batches_of(5, k, n_batches=4, alphabet=b"ACGTNacgt")
    path = fastq_of(batches, tmp_path / "r.fq")
    for n_parts in (2, 3, 5):
        np.testing.assert_array_equal(
            spill_bounds(path, k, n_parts, n_sample=4, scan_cap=4),
            JKC.estimate_boundaries(batches, k, n_parts))
    np.testing.assert_array_equal(
        spill_bounds(path, k, 3, n_sample=2, scan_cap=4),
        JKC.sample_boundaries(lambda: iter(batches), k, 3, n_sample=2,
                              scan_cap=4))
    short = batches_of(6, k, n_batches=2)
    for b in short:
        b.lengths = 1 + b.lengths % (k - 1)
    short_path = fastq_of(short, tmp_path / "short.fq")
    for n_parts in (2, 5):
        np.testing.assert_array_equal(
            spill_bounds(short_path, k, n_parts),
            JKC.estimate_boundaries([], k, n_parts))


@pytest.mark.parametrize("with_n", [False, True])
def test_count_file_native_matches_jax(tmp_path, with_n):
    """The native reader's packed batches (clean ones go without their
    mask) and key-range passes against the JAX package's."""
    _, _, JKC = jax_modules()
    from hast_tpu_torch.io import native as N
    if N.get_lib() is None:
        pytest.skip("libhastio.so unavailable")
    k = 21
    rng = np.random.default_rng(17)
    letters = np.frombuffer(b"ACGTN" if with_n else b"ACGT", np.uint8)
    path = tmp_path / "r.fq"
    with open(path, "wb") as f:
        for i in range(700):
            L = int(rng.integers(10, 140))
            seq = letters[rng.integers(0, letters.size, L)].tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * L))
    for key_range in (None, (1 << 35, (1 << 64) - 1)):
        got = KC.count_file(str(path), k, batch_size=128, super_batch=2,
                            key_range=key_range, device="cpu")
        want = JKC.count_file_native(str(path), k, batch_size=128,
                                     super_batch=2, key_range=key_range)
        np.testing.assert_array_equal(got.words, want.words)
        np.testing.assert_array_equal(got.counts, want.counts)
        assert got.n_distinct > 0


def test_load_library_builds_once_across_threads(monkeypatch):
    """count_files_device_pair's two threads may both reach the first
    kernel launch: the library must be built and bound once."""
    import threading
    import time
    import types
    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.05)
        return "libhast_kernels-test.so"

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        _build.load_library())) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1
    assert len(got) == 4 and all(lib is got[0] for lib in got)
    assert got[0].hast_sort_pairs.restype is _build.ctypes.c_int


@pytest.mark.parametrize("current", [0, 1])
def test_on_card_switches_only_to_another_card(monkeypatch, current):
    """A launch on cuda:1's tensors makes cuda:1 current for the call when
    another card is current, and enters no device switch when it already
    is; either way the entry gets cuda:1's current raw stream, as torch
    reports it for that card."""
    import contextlib
    import types
    entered, calls = [], []

    @contextlib.contextmanager
    def fake_device(dev):
        entered.append(dev)
        yield

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0x1000 + index, raising=False)
    monkeypatch.setattr(_build, "_lib", types.SimpleNamespace(
        hast_fake=lambda *args: calls.append(args) or 0))
    _build.launch("fake", torch.device("cuda", 1), 5)
    assert calls == [(5, 0x1001)]
    assert entered == ([] if current == 1 else [torch.device("cuda", 1)])
    del _build.LAUNCHES["fake"]


@pytest.mark.parametrize("current", [0, 1])
def test_launch_switches_only_to_another_card(monkeypatch, current):
    """_build.launch on cuda:1 passes the arguments and cuda:1's current
    stream to the entry, switches the device only when another card is
    current, counts the launch and raises on a refused one."""
    import contextlib
    import types
    entered, calls = [], []

    @contextlib.contextmanager
    def fake_device(dev):
        entered.append(dev)
        yield

    def entry(*args):
        calls.append(args)
        return 0 if args[0] == "ok" else 9

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(_build, "raw_stream", lambda index: 0x1000 + index)
    monkeypatch.setattr(_build, "_lib", types.SimpleNamespace(hast_fake=entry))
    dev = torch.device("cuda", 1)
    launches = _build.LAUNCHES["fake"]
    _build.launch("fake", dev, "ok", 7)
    assert calls == [("ok", 7, 0x1001)]
    assert _build.LAUNCHES["fake"] == launches + 1
    with pytest.raises(RuntimeError, match="fake failed to launch"):
        _build.launch("fake", dev, "refused")
    assert _build.LAUNCHES["fake"] == launches + 1
    assert entered == ([] if current == 1 else [dev, dev])
    del _build.LAUNCHES["fake"]


def test_batch_is_clean_and_pack_good():
    seqs = np.frombuffer(b"ACGTacgtNACG" + b"\0" * 4 + b"ACGTacgtACG"
                         + b"\0" * 5, np.uint8).reshape(2, 16)
    good = KC.pack_good_np(seqs)
    assert good.tolist() == [[0xFF, 0x0E], [0xFF, 0x07]]
    assert not KC.batch_is_clean(good, np.array([12, 11], np.int32))
    assert KC.batch_is_clean(good[1:], np.array([11], np.int32))


@pytest.mark.parametrize("n", [0, 1, 777, 4096])
def test_shrink_run_twin_matches_jax(n):
    """K12's twin (what the wrapper runs on CPU tensors) against JAX's
    _shrink on a folded run's keys and counts."""
    jax, jnp, JKC = jax_modules()
    keys, counts = dup_heavy_keys(n + 3, 21, n=4096)
    hi = jnp.asarray((keys >> 32).astype(np.uint32))
    lo = jnp.asarray((keys & U32).astype(np.uint32))
    jhi, jlo, jc = JKC._shrink(hi, lo, jnp.asarray(counts), n)
    twin_calls = _build.TWIN_CALLS["shrink_run_ref"]
    got_keys, got_counts = KC.shrink_run(torch.from_numpy(keys),
                                         torch.from_numpy(counts), n)
    assert _build.TWIN_CALLS["shrink_run_ref"] == twin_calls + 1
    np.testing.assert_array_equal(got_keys.numpy(), ref_keys(jhi, jlo))
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(jc))
    assert got_keys.numel() == n and got_keys.is_contiguous()


def test_shrink_run_rejects_bad_input():
    keys = torch.zeros(8, dtype=torch.int64)
    counts = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        KC.shrink_run(keys, counts, 9)
    with pytest.raises(ValueError, match="counts"):
        KC.shrink_run(keys, counts[:4], 2)
    with pytest.raises(ValueError, match="CUDA"):
        KC.shrink_run(keys.to("meta"), counts.to("meta"), 2)


# ---------------------------------------------------------------------------
# the kernels against their twins, on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("k", [15, 17, 21, 31])
def test_count_windows_kernel_matches_twin(card, k):
    """3,000 reads of stride 32 bytes, window_edge_reads at strides 25,
    26 and 30, and 4096 // n_win - 1, + 0 and + 1 reads of some 64
    windows (one tile of the kernel is 4,096 windows), with and without
    the mask (even strides) and key ranges up to 2^64 - 1: bit-exact, one
    C call each."""
    batches = [ascii_reads(k, k, n=3000, L=128)]
    batches += [S.window_edge_reads(k, k, lp) for lp in (25, 26, 30)]
    lp = (63 + k + 3) // 4
    tile_reads = 4096 // (4 * lp - k + 1)
    edge = S.window_edge_reads(k + 1, k, lp, n=tile_reads + 1)
    batches += [(edge[0][:n], edge[1][:n])
                for n in (tile_reads - 1, tile_reads, tile_reads + 1)]
    for seqs, lengths in batches:
        packed, good, lens = (None if x is None else x.to(card)
                              for x in packed_reads(seqs, lengths))
        for g in (None,) if good is None else (None, good):
            for key_range in (None, (1 << 30, (1 << 64) - 1),
                              (1 << 63, (1 << 64) - 1),
                              ((1 << 63) + 1, (1 << 64) - 1)):
                launches = _build.LAUNCHES["count_windows"]
                got = KC.count_windows(packed, lens, k, g, key_range)
                assert _build.LAUNCHES["count_windows"] == launches + 1
                assert torch.equal(got, KC.count_windows_ref(
                    packed, lens, k, g, key_range))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [15, 17, 21, 31])
def test_sort_and_fold_kernels_match_twins(card, k):
    """Also the fold's buffer reuse: the sort in the input and one
    scratch pair (5 passes at k = 17, an even number at the others), the
    fold into the pair the sort left free."""
    keys, counts = dup_heavy_keys(k, k, n=300_000)
    keys, counts = torch.from_numpy(keys).to(card), \
        torch.from_numpy(counts).to(card)
    got = KC.sort_pairs(keys, counts, k)
    want = KC.sort_pairs_ref(keys, counts, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(KC.sort_pairs(keys, None, k)[0], want[0])
    folded = KC.fold_runs(*got)
    wfold = KC.fold_runs_ref(*want)
    for g, w in zip(folded, wfold):
        assert torch.equal(g, w)

    inp = (keys.clone(), counts.clone())
    scratch = (torch.empty_like(keys), torch.empty_like(counts))
    got = KC.sort_pairs(*inp, k, scratch=scratch)
    even = KC.sort_passes(k) % 2 == 0
    assert got[0] is (inp[0] if even else scratch[0])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    free = scratch if even else inp
    folded = KC.fold_runs(*got, out=free)
    assert folded[0] is free[0] and folded[1] is free[1]
    for g, w in zip(folded, wfold):
        assert torch.equal(g, w)


def card_kernels(fn, want: int) -> dict:
    """Names and launch counts of the device work of one call of fn
    (torch.profiler), kernels and memsets alike.  The profiler now and
    then drops a record, so a call that shows fewer than `want` launches
    is profiled again (up to three times); a call never shows more."""
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen = {e.key: e.count for e in prof.key_averages()
                if getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0)) > 0}
        if sum(seen.values()) >= want:
            break
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("k", [15, 17, 21, 31])
def test_fold_kernel_on_edge_cases(card, k):
    """The runs of fold_edge_keys, the empty and all-sentinel runs and a
    duplicate-heavy run of 2^22 + 4,097 keys (the look-back crosses two
    thousand tiles), bit-exact against the twin, with and without out=;
    one C entry a call, and on the card its two kernels and nothing
    else."""
    rng = np.random.default_rng(k)
    long_keys = rng.integers(0, 1 << 20, (1 << 22) + 4097).astype(np.int64)
    long_keys[rng.random(long_keys.size) < 0.05] = SENT
    runs = [fold_edge_keys(case, k)
            for case in ("repeated", "one-key", "n1", "wrap")]
    runs += [(np.zeros(0, np.int64), np.zeros(0, np.int32)),
             (np.full(5, SENT), np.ones(5, np.int32)),
             (long_keys, rng.integers(1, 60, long_keys.size).astype(
                 np.int32))]
    for keys, counts in runs:
        keys = torch.from_numpy(np.sort(keys)).to(card)
        counts = torch.from_numpy(counts).to(card)
        want = KC.fold_runs_ref(keys, counts)
        launches = _build.LAUNCHES["fold_runs"]
        got = KC.fold_runs(keys, counts)
        assert _build.LAUNCHES["fold_runs"] == launches + (keys.numel() > 0)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        out = (torch.full_like(keys, 7), torch.full_like(counts, 7))
        got = KC.fold_runs(keys, counts, out=out)
        assert got[0] is out[0] and got[1] is out[1]
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    kernels = card_kernels(lambda: KC.fold_runs(keys, counts), 2)
    assert sorted(kernels.values()) == [1, 1], kernels
    assert sorted(name for name in kernels if "fold_t" in name) == sorted(
        kernels), kernels


@pytest.mark.cuda
@pytest.mark.parametrize("k", [15, 17, 21, 31])
def test_sort_kernel_on_edge_cases(card, k, monkeypatch):
    """The inputs a one-sweep sort gets wrong (synthetic.sort_edge_cases:
    sizes off the tile, all equal, sorted, a sentinel tail, three keys
    drawn many times with counts that differ, one digit varying so that
    the other passes are skipped), bit-exact against the twin, with and
    without payload and with the scratch pair, with counts below 2^30
    and below 100 (which ride packed above the keys' bits from the second
    pass to the last at k <= 23); once with the default portion
    and once in portions of two tiles, so that every portion past the
    first takes its digits' offsets from the earlier ones."""
    from hast_tpu_torch.utils import synthetic as S
    even = KC.sort_passes(k) % 2 == 0
    for portion, high in itertools.product(
            (KC._SORT_PORTION, 2 * KC.SORT_TILE), (1 << 30, 100)):
        monkeypatch.setattr(KC, "_SORT_PORTION", portion)
        for name, keys in S.sort_edge_cases(k, k, KC.SORT_TILE,
                                            KC.SORT_DIGIT_BITS):
            rng = np.random.default_rng(keys.size)
            keys = torch.from_numpy(keys).to(card)
            counts = torch.from_numpy(rng.integers(
                0, high, keys.numel()).astype(np.int32)).to(card)
            want = KC.sort_pairs_ref(keys, counts, k)
            launches = _build.LAUNCHES["sort_pairs"]
            got = KC.sort_pairs(keys, counts, k)
            assert _build.LAUNCHES["sort_pairs"] == launches + 1
            assert torch.equal(got[0], want[0]), (name, portion, high)
            assert torch.equal(got[1], want[1]), (name, portion, high)
            assert torch.equal(KC.sort_pairs(keys, None, k)[0], want[0])
            inp = (keys.clone(), counts.clone())
            scratch = (torch.empty_like(keys), torch.empty_like(counts))
            got = KC.sort_pairs(*inp, k, scratch=scratch)
            assert got[0] is (inp[0] if even else scratch[0])
            assert torch.equal(got[0], want[0]), (name, portion, high)
            assert torch.equal(got[1], want[1]), (name, portion, high)


@pytest.mark.cuda
@pytest.mark.parametrize("counts", ["int32", "small"])
@pytest.mark.parametrize("k", [15, 21, 31])
def test_sort_kernel_across_portions(card, k, counts, monkeypatch):
    """The library's tile and digit are kmer_count's.  3 x 2^20 + 5 pairs
    (off the tile) of keys drawn from n / 4 values, so that equal keys
    carry different counts, in portions of 2^20 keys: each pass's
    look-back spans 256 tiles a portion, and the next portion reads the
    same status words under a later epoch.  Counts over all of int32
    (packed above the keys only at k = 15, negative ones included) or
    below 60 (packed at k = 15 and 21).  Bit-exact against the twin,
    with and without payload."""
    assert _build.sort_geometry() == (KC.SORT_TILE, KC.SORT_DIGIT_BITS)
    monkeypatch.setattr(KC, "_SORT_PORTION", 1 << 20)
    rng = np.random.default_rng(k)
    n = 3 * (1 << 20) + 5
    pool = rng.integers(0, 1 << (2 * k), n // 4, dtype=np.int64)
    keys = pool[rng.integers(0, pool.size, n)]
    keys[rng.random(n) < 0.1] = SENT
    keys = torch.from_numpy(keys).to(card)
    low, high = (-1 << 31, 1 << 31) if counts == "int32" else (0, 60)
    counts = torch.from_numpy(rng.integers(low, high, n).astype(
        np.int32)).to(card)
    want = KC.sort_pairs_ref(keys, counts, k)
    got = KC.sort_pairs(keys, counts, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(KC.sort_pairs(keys, None, k)[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n_parts", [1, 4, 8])
def test_counting_on_card_matches_cpu(card, tmp_path, n_parts):
    """The DeviceCounter on the card, folding several times (n_parts 1),
    and the key-range passes over a spill with an empty sample's even
    bounds, half of them >= 2^63 and the last 2^64 - 1 (n_parts 4, 8),
    equal the CPU count."""
    k = 21
    batches = batches_of(3, k, n_batches=7)
    want = KC.count_batches(batches, k, super_batch=2, device="cpu")
    launches = _build.LAUNCHES["count_windows"]
    if n_parts == 1:
        counter = KC.count_batches(batches, k, super_batch=2,
                                   finalize=False, fold_above=5000,
                                   device=card)
        assert counter.n_folds >= 2
        got = counter.finalize()
    else:
        bounds = KC._sample_bounds([], k, n_parts, device=card)
        got = count_spill(fastq_of(batches, tmp_path / "r.fq"), k, bounds,
                          card, batch_size=64, super_batch=2)
    assert _build.LAUNCHES["count_windows"] >= launches + 4 * n_parts
    np.testing.assert_array_equal(got.words, want.words)
    np.testing.assert_array_equal(got.counts, want.counts)


@pytest.mark.cuda
@pytest.mark.parametrize("high, case", count_stats_params(
    (0, 30, 62, 63, 100, 10000, "limit", "limit+1"), (100, 10000, 20000)))
def test_count_stats_kernel_matches_twin(card, high, case):
    """The random draw, and the edge cases at 2^20 + 3 counts: at high 0
    (the main path's .total) and 30, where every bin is a lane's own, on
    both sides of the last such high (62, 63), and on both sides of the
    shared form's limit as the library has it ("limit", "limit+1"); each
    also as the views [1:], [2:] and [3:], which start off a 16-byte
    boundary; one C call a call."""
    if isinstance(high, str):
        high = _build.count_stats_shared_high() + (high == "limit+1")
    if case is None:
        rng = np.random.default_rng(high)
        counts = rng.integers(0, 3 * high, 1_000_000).astype(np.int32)
    else:
        counts = S.count_stats_edge_cases(high, high, n=(1 << 20) + 3)[case]
    counts = torch.from_numpy(counts).to(card)
    for view in (counts, counts[1:], counts[2:], counts[3:]):
        launches = _build.LAUNCHES["count_stats"]
        got = KC.count_stats(view, high)
        assert _build.LAUNCHES["count_stats"] == launches + 1
        for g, w in zip(got, KC.count_stats_ref(view, high)):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_marker_filter_kernel_matches_twin(card):
    """Two runs of 150,000 and 120,000 keys with 1,000 pads each;
    marker_edge_cases over four tiles; runs with no rows; merged lengths
    one under, at and one over one tile and one persistent wave (every
    block of the grid takes one tile): bit-exact, twice in a row (the
    status words are zero again), one C call a call.  chip_smoke.py holds
    a call to its two kernels and nothing else: in this process the
    profiler, after the fold tests' profiles, showed the tail alone."""
    rng = np.random.default_rng(8)
    pool = np.unique(rng.integers(0, 1 << 42, 400_000, dtype=np.int64))
    a = np.sort(rng.choice(pool, 150_000, replace=False))
    b = np.sort(rng.choice(pool, 120_000, replace=False))
    runs = []
    for keys in (a, b):
        pad = np.full(1000, SENT, np.int64)
        counts = np.concatenate([rng.integers(1, 60, keys.size),
                                 np.zeros(pad.size)]).astype(np.int32)
        runs.append((np.concatenate([keys, pad]), counts, keys.size))
    cases = [tuple(runs)]
    cases += [(a, b) for _, a, b in S.marker_edge_cases(5, KC.MARKER_TILE)]
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int32), 0)
    cases += [(empty, empty), (empty, cases[1][1])]
    wave = (torch.cuda.get_device_properties(card).multi_processor_count
            * 3 * KC.MARKER_TILE)
    for m in (KC.MARKER_TILE, wave):
        pool = np.unique(rng.integers(0, 1 << 42, 2 * m, dtype=np.int64))
        for n in (m - 1, m, m + 1):
            a = np.sort(rng.choice(pool, n // 2, replace=False))
            rest = np.setdiff1d(pool, a)
            b = np.union1d(a[::3], rng.choice(rest, n - n // 2 - a[::3].size,
                                               replace=False))
            cases.append(tuple((x, rng.integers(1, 12, x.size).astype(
                np.int32), x.size) for x in (a, b)))
            assert a.size + b.size == n
    for a, b in cases:
        args = marker_case_tensors(a, b, card)
        for bounds in ((9, 33, 9, 33), (1, 11, 2, 9),
                       (0, 2**31 - 1, 0, 2**31 - 1)):
            want = KC.marker_filter_ref(*args, bounds)
            for _ in range(2):
                launches = _build.LAUNCHES["marker_filter"]
                got = KC.marker_filter(*args, bounds)
                assert _build.LAUNCHES["marker_filter"] == launches + 1
                for g, w in zip(got, want):
                    assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 300_001])
def test_shrink_run_kernel_matches_twin(card, n):
    keys, counts = dup_heavy_keys(5, 21, n=400_000)
    keys, counts = torch.from_numpy(keys).to(card), \
        torch.from_numpy(counts).to(card)
    launches = _build.LAUNCHES["shrink_run"]
    got = KC.shrink_run(keys, counts, n)
    assert _build.LAUNCHES["shrink_run"] == launches + (1 if n else 0)
    for g, w in zip(got, KC.shrink_run_ref(keys, counts, n)):
        assert torch.equal(g, w)
