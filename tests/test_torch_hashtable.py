"""hast_tpu_torch.ops.hashtable against hast_tpu.ops.hashtable.

The port's host build must give the JAX package's table bit for bit
(native and numpy placement, quot and full), its K2 twin (probe_ref, what
the wrapper runs on CPU tensors) must return the JAX probes' payloads on
present and absent keys, through every branch of the quotient split, and
remove_keys must clear the same slots.  Exact equality throughout: every
value is an integer.  The kernel is compared with the twin on the card
(marked cuda).
"""

import numpy as np
import pytest
import torch

from hast_tpu.io import native as JN
from hast_tpu_torch.io import native as N
from hast_tpu_torch.ops import _build
from hast_tpu_torch.ops import encode as E
from hast_tpu_torch.ops import hashtable as H


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def marker_keys(seed: int, n: int, k: int):
    """n random canonical keys (with a few duplicates) and payloads 1..3."""
    rng = np.random.default_rng(seed)
    hi, lo = E.canonical_kmers_np(rng.integers(0, 4, (n, k), np.int32), k)
    hi, lo = hi[:, 0].copy(), lo[:, 0].copy()
    hi[n // 2:n // 2 + 20], lo[n // 2:n // 2 + 20] = hi[:20], lo[:20]
    return hi, lo, rng.integers(1, 4, n).astype(np.uint32)


def queries(seed: int, hi, lo, k: int):
    """The stored keys plus as many random (mostly absent) ones."""
    rng = np.random.default_rng(seed)
    qh, ql = E.canonical_kmers_np(rng.integers(0, 4, (hi.size, k), np.int32),
                                  k)
    return np.concatenate([hi, qh[:, 0]]), np.concatenate([lo, ql[:, 0]])


def words(hi, lo) -> torch.Tensor:
    return torch.from_numpy((hi.astype(np.int64) << 32) | lo)


def numpy_placement(monkeypatch):
    for mod in (N, JN):
        monkeypatch.setattr(mod, "sort_dedup_or", lambda *a: None)
        monkeypatch.setattr(mod, "build_quot", lambda *a, **kw: None)
        monkeypatch.setattr(mod, "place2", lambda *a, **kw: None)


@pytest.mark.parametrize("placement", ["native", "numpy"])
@pytest.mark.parametrize("fmt,k", [("quot", 21), ("full", 21), ("full", 31),
                                   ("quot", 9)])
def test_build_table_matches_jax(monkeypatch, placement, fmt, k):
    pytest.importorskip("jax")
    from hast_tpu.ops import hashtable as JH

    if placement == "numpy":
        numpy_placement(monkeypatch)
    elif N.get_lib() is None:
        pytest.skip("libhastio.so unavailable")
    hi, lo, pay = marker_keys(k, 3000, k)
    got = H.build_table(hi, lo, pay, k, load=0.7, set_sizes=(5, 6), fmt=fmt)
    want = JH.build_table(hi, lo, pay, k, load=0.7, set_sizes=(5, 6),
                          fmt=fmt)
    assert (got.fmt, got.n_buckets, got.n_keys, got.set_sizes, got.k) == \
        (want.fmt, want.n_buckets, want.n_keys, want.set_sizes, want.k)
    assert got.data.dtype == torch.int32
    np.testing.assert_array_equal(got.data_np(), want.data)


@pytest.mark.parametrize("n,load,want", [
    (10 ** 8 + 1, 0.7, ("quot", 2 ** 26)),      # 5e7 markers a haplotype
    (4 * 10 ** 8 + 1, 0.7, ("quot", 2 ** 28)),  # 2e8 markers a haplotype
    (2 ** 20, 0.35, ("quot", 2 ** 20)),
    (3000, 0.7, ("full", 4096)),                # quotient too wide for a slot
])
def test_table_shape_sizes_a_table_without_building_it(n, load, want):
    """build_table's size rule at k 21, for key counts too large to build
    in a test: the loader's load 0.7 puts two sets of 5e7 markers in 2^26
    quot rows (1 GiB) and two of 2e8 in 2^28 (4 GiB)."""
    assert H.table_shape(n, 21, load) == want


@pytest.mark.parametrize("fmt,k,n", [
    ("quot", 21, 3000),    # bbits < k
    ("quot", 11, 4000),    # bbits == k
    ("quot", 9, 4000),     # bbits > k
    ("full", 15, 3000), ("full", 21, 3000), ("full", 31, 3000)])
def test_probe_twin_matches_jax(fmt, k, n):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from hast_tpu.ops import hashtable as JH

    hi, lo, pay = marker_keys(100 + k, n, k)
    ref = JH.build_table(hi, lo, pay, k, load=0.7, fmt=fmt)
    bbits = ref.n_buckets.bit_length() - 1
    if fmt == "quot":
        assert ref.fmt == "quot"
        assert {21: bbits < k, 11: bbits == k, 9: bbits > k}[k]
    table = H.from_reference(ref.data, ref.n_buckets, ref.max_probe, ref.k,
                             ref.n_keys, ref.set_sizes, ref.fmt,
                             device="cpu")
    q_hi, q_lo = queries(k, hi, lo, k)
    got = H.probe(table, words(q_hi, q_lo)).numpy()
    if fmt == "quot":
        want = JH.probe_quot(jnp.asarray(ref.data), jnp.asarray(q_hi),
                             jnp.asarray(q_lo), k)
    else:
        want = JH.probe(jnp.asarray(ref.data), jnp.asarray(q_hi),
                        jnp.asarray(q_lo), ref.max_probe)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, JH.probe_np(ref, q_hi, q_lo))
    np.testing.assert_array_equal(H.probe_np(table, q_hi, q_lo), got)
    assert (got[:n] > 0).all() and (got[n:] == 0).any()


@pytest.mark.parametrize("k,bbits", [(21, 20), (21, 21), (21, 24), (9, 11),
                                     (31, 1), (15, 0), (6, 8)])
def test_quotient_split_matches_jax(k, bbits):
    """(b1, q) and b2 of the Feistel split, every bbits branch, against
    the JAX package's numpy twin, from the port's numpy and torch code."""
    pytest.importorskip("jax")
    from hast_tpu.ops import hashtable as JH

    rng = np.random.default_rng(k * 100 + bbits)
    w = rng.integers(0, 1 << (2 * k), 5000, dtype=np.int64)
    hi, lo = (w >> 32).astype(np.uint32), (w & 0xFFFFFFFF).astype(np.uint32)
    b1, q = JH._quot_bucket_q(hi, lo, k, bbits)
    b2 = JH._quot_alt(b1, q, bbits)
    nb1, nq = H._quot_bucket_q(hi, lo, k, bbits)
    np.testing.assert_array_equal(nb1, b1)
    np.testing.assert_array_equal(nq, q)
    np.testing.assert_array_equal(H._quot_alt(nb1, nq, bbits), b2)
    tb1, tq = H._quot_bucket_q_t(torch.from_numpy(w >> 32),
                                 torch.from_numpy(w & 0xFFFFFFFF), k, bbits)
    np.testing.assert_array_equal(tb1.numpy(), b1.astype(np.int64))
    np.testing.assert_array_equal(tq.numpy(), q.astype(np.int64))
    for rnd in (0, 1):
        np.testing.assert_array_equal(
            H._kmer_hash_t(rnd, torch.from_numpy(w >> 32),
                           torch.from_numpy(w & 0xFFFFFFFF)).numpy(),
            JH._hash_round(rnd, hi, lo).astype(np.int64))


@pytest.mark.parametrize("fmt", ["quot", "full"])
def test_remove_keys_matches_jax(fmt):
    pytest.importorskip("jax")
    from hast_tpu.ops import hashtable as JH
    from hast_tpu.pipeline.classify import ADAPTOR_F

    k = 21
    hi, lo, pay = marker_keys(7, 2000, k)
    a = np.frombuffer(ADAPTOR_F.encode(), np.uint8)
    ahi, alo = E.canonical_kmers_np(E.encode_np(a)[None, :], k)
    ahi, alo = ahi[0], alo[0]
    # plant the adaptor's k-mers: some in hap0, some in hap1, some in both
    hi = np.concatenate([hi, ahi[:10], ahi[5:15]])
    lo = np.concatenate([lo, alo[:10], alo[5:15]])
    pay = np.concatenate([pay, np.ones(10, np.uint32),
                          np.full(10, 2, np.uint32)])
    ref = JH.build_table(hi, lo, pay, k, load=0.7, set_sizes=(1000, 1000),
                         fmt=fmt)
    table = H.from_reference(ref.data.copy(), ref.n_buckets, ref.max_probe,
                             k, ref.n_keys, ref.set_sizes, ref.fmt,
                             device="cpu")
    want = JH.remove_keys(ref, ahi, alo, payload_mask=3)
    got = H.remove_keys(table, ahi, alo, payload_mask=3)
    assert got == want and len(got) >= 15
    assert table.set_sizes == ref.set_sizes
    np.testing.assert_array_equal(table.data_np(), ref.data)
    assert (H.probe_np(table, ahi, alo) == 0).all()
    with pytest.raises(ValueError, match="shape|rows"):
        H.from_reference(ref.data[:-1], ref.n_buckets, 2, k, 0,
                         device="cpu")


def test_probe_rejects_bad_input():
    hi, lo, pay = marker_keys(1, 100, 21)
    table = H.build_table(hi, lo, pay, 21)
    with pytest.raises(ValueError, match="int64"):
        H.probe(table, words(hi, lo).to(torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        H.probe(table.to("meta"), words(hi, lo).to("meta"))
    with pytest.raises(ValueError, match="host table"):
        H.remove_keys(table.to("meta"), hi, lo, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,k", [("quot", 21), ("quot", 9), ("full", 31)])
def test_probe_kernel_matches_twin(card, fmt, k):
    hi, lo, pay = marker_keys(200 + k, 20000, k)
    table = H.build_table(hi, lo, pay, k, load=0.7, fmt=fmt).to(card)
    q = words(*queries(k, hi, lo, k)).to(card)
    launches = _build.LAUNCHES["probe"]
    got = H.probe(table, q)
    assert _build.LAUNCHES["probe"] == launches + 1
    assert torch.equal(got, H.probe_ref(table, q))
    assert bool((got[:hi.size] > 0).all())
