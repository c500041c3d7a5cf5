"""K16 broadcast_probe and its twin against the JAX Pallas broadcast join.

The JAX kernel lives outside its package (docs/experimental/probe_pallas.py)
and is loaded by path, as tests/test_probe_pallas.py loads it, and run in
interpret mode on the CPU.  Every case compares arrays exactly: the port's
twin and its wrapper on CPU tensors against `pallas_broadcast_probe(...,
interpret=True)` on the same numpy inputs.  JAX is imported inside
the tests, so that the `cuda` test runs where JAX is absent.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from hast_tpu_torch.ops import _build
from hast_tpu_torch.ops import broadcast_probe as BP
from hast_tpu_torch.ops import encode as E
from hast_tpu_torch.ops import hashtable as H

PAD_KEY = (0x3FFFFFFF, 0xFFFFFFFF)


@functools.cache
def _pallas():
    """docs/experimental/probe_pallas.py, loaded by its path."""
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(
        "probe_pallas_experimental",
        pathlib.Path(__file__).parent.parent / "docs" / "experimental"
        / "probe_pallas.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def jax_probe(thi, tlo, qhi, qlo, chunk=2048) -> np.ndarray:
    pallas = _pallas()
    import jax.numpy as jnp
    return np.asarray(pallas.pallas_broadcast_probe(
        jnp.asarray(thi, jnp.uint32), jnp.asarray(tlo, jnp.uint32),
        jnp.asarray(qhi, jnp.uint32), jnp.asarray(qlo, jnp.uint32),
        chunk=chunk, interpret=True))


def assert_port_equals_jax(thi, tlo, qhi, qlo, chunk=2048) -> np.ndarray:
    want = jax_probe(thi, tlo, qhi, qlo, chunk)
    args = (_t(thi), _t(tlo), _t(qhi), _t(qlo))
    twin = BP.broadcast_probe_ref(*args, chunk=chunk)
    got = BP.broadcast_probe(*args, chunk=chunk)
    assert twin.dtype == got.dtype == torch.int32
    np.testing.assert_array_equal(twin.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want)
    return want


def _keys(rng, n: int):
    seqs = rng.integers(0, 4, size=(n, 21), dtype=np.int32)
    hi, lo = E.canonical_kmers_np(seqs, 21)
    return hi[:, 0], lo[:, 0]


def _panel():
    """tests/test_probe_pallas.py's inputs: a full table of 3,000 keys,
    500 of them queried beside 500 random keys."""
    rng = np.random.default_rng(0)
    hi, lo = _keys(rng, 3000)
    pay = rng.integers(1, 4, 3000).astype(np.uint32)
    q2hi, q2lo = _keys(rng, 500)
    return hi, lo, pay, np.concatenate([hi[:500], q2hi]), \
        np.concatenate([lo[:500], q2lo])


def test_full_table_matches_pallas_and_probe():
    pallas = _pallas()
    from hast_tpu.ops import hashtable as JH
    hi, lo, pay, qhi, qlo = _panel()
    jt = JH.build_table(hi, lo, pay, 21)
    table = H.build_table(hi, lo, pay, 21)
    assert table.fmt == jt.fmt == "full"
    thi, tlo = BP.table_key_arrays(table)
    jhi, jlo = pallas.table_key_arrays(jt)
    np.testing.assert_array_equal(thi.numpy().view(np.uint32), jhi)
    np.testing.assert_array_equal(tlo.numpy().view(np.uint32), jlo)
    want = assert_port_equals_jax(jhi, jlo, qhi, qlo)
    np.testing.assert_array_equal(want, JH.probe_np(jt, qhi, qlo))
    assert (want > 0).sum() == 500


def test_table_key_arrays_refuses_a_quot_table():
    rng = np.random.default_rng(1)
    hi, lo = _keys(rng, 200)
    table = H.build_table(hi, lo, np.ones(200, np.uint32), 21, fmt="quot")
    with pytest.raises(ValueError, match="full-format"):
        BP.table_key_arrays(table)


@pytest.mark.parametrize("chunk", [2048, 512, 128])
def test_ragged_table_matches_pallas(chunk):
    """n = 3,001 is a multiple of none of the chunks: the JAX function pads
    with EMPTY slots, which only the pad key matches (payload 3)."""
    rng = np.random.default_rng(chunk)
    hi, lo = _keys(rng, 3001)
    thi = hi | (rng.integers(0, 4, hi.size).astype(np.uint32) << 30)
    qhi = np.concatenate([hi[::3], _keys(rng, 700)[0], [PAD_KEY[0]]])
    qlo = np.concatenate([lo[::3], _keys(rng, 700)[1], [PAD_KEY[1]]])
    want = assert_port_equals_jax(thi, lo, qhi, qlo, chunk)
    assert want[-1] == 3
    assert (want[:hi[::3].size] == thi[::3] >> 30).all()


def test_duplicate_keys_take_the_largest_payload():
    """The same key with payloads 1 and 2 gives 2 (a maximum, not the OR
    a table build would make of them); 2 and 3 give 3; 0 and 1 give 1."""
    rng = np.random.default_rng(5)
    hi, lo = _keys(rng, 3)
    pays = np.array([1, 2, 3, 2, 0, 1], np.uint32)
    thi = np.repeat(hi, 2) | (pays << 30)
    tlo = np.repeat(lo, 2)
    order = rng.permutation(thi.size)
    want = assert_port_equals_jax(thi[order], tlo[order], hi, lo, chunk=4)
    np.testing.assert_array_equal(want, [2, 3, 1])


@pytest.mark.parametrize("n", [2048, 2047])
def test_pad_key_depends_on_the_padding(n):
    """(0x3FFFFFFF, 0xFFFFFFFF) matches EMPTY: 3 when the table is padded,
    0 when n is a multiple of chunk and holds no EMPTY slot."""
    rng = np.random.default_rng(n)
    hi, lo = _keys(rng, n)
    thi = hi | np.uint32(1 << 30)
    want = assert_port_equals_jax(thi, lo, [PAD_KEY[0], hi[0]],
                                  [PAD_KEY[1], lo[0]])
    np.testing.assert_array_equal(want, [3 if n % 2048 else 0, 1])


def test_pad_key_hits_the_empty_slots_of_a_full_table():
    hi, lo, pay, _, _ = _panel()
    thi, tlo = BP.table_key_arrays(H.build_table(hi, lo, pay, 21))
    assert thi.numel() % 2048 == 0
    want = assert_port_equals_jax(thi.numpy().view(np.uint32),
                                  tlo.numpy().view(np.uint32),
                                  [PAD_KEY[0]], [PAD_KEY[1]])
    np.testing.assert_array_equal(want, [3])


def test_empty_query_set():
    """No query, no payload.  The JAX function cannot run this case: its
    interpret mode divides by the zero-length query block while padding
    it (a quirk the port does not copy); the port returns (0,) int32."""
    hi, lo, pay, _, _ = _panel()
    thi = hi | (pay << 30)
    empty = np.zeros(0, np.uint32)
    with pytest.raises(ZeroDivisionError):
        jax_probe(thi, lo, empty, empty)
    args = (_t(thi), _t(lo), _t(empty), _t(empty))
    for fn in (BP.broadcast_probe_ref, BP.broadcast_probe):
        got = fn(*args)
        assert got.shape == (0,) and got.dtype == torch.int32


def test_wrapper_refuses_bad_inputs():
    a = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        BP.broadcast_probe(a.long(), a, a, a)
    with pytest.raises(ValueError, match="lengths"):
        BP.broadcast_probe(a, a[:3], a, a)
    with pytest.raises(ValueError, match="chunk"):
        BP.broadcast_probe(a, a, a, a, chunk=0)


def test_twin_blocks_large_query_sets():
    """More queries than one twin block holds: the blocks' results join."""
    hi, lo, pay, _, _ = _panel()
    thi = hi | (pay << 30)
    rng = np.random.default_rng(9)
    pick = rng.integers(0, hi.size, (BP._BLOCK_PAIRS // 2048) * 3 + 17)
    got = BP.broadcast_probe_ref(_t(thi), _t(lo), _t(hi[pick]), _t(lo[pick]))
    np.testing.assert_array_equal(got.numpy(), pay[pick])


@pytest.mark.cuda
def test_kernel_matches_twin_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K16 has no CPU mode)")
    hi, lo, pay, qhi, qlo = _panel()
    thi, tlo = BP.table_key_arrays(H.build_table(hi, lo, pay, 21))
    qhi = np.concatenate([qhi, [PAD_KEY[0]]])
    qlo = np.concatenate([qlo, [PAD_KEY[1]]])
    for table_hi, table_lo, chunk in ((thi, tlo, 2048),
                                      (thi[:3001], tlo[:3001], 512)):
        args = [x.cuda() for x in (table_hi.contiguous(),
                                   table_lo.contiguous(), _t(qhi), _t(qlo))]
        _build.LAUNCHES.clear()
        got = BP.broadcast_probe(*args, chunk=chunk)
        assert _build.LAUNCHES["broadcast_probe"] == 1
        want = BP.broadcast_probe_ref(*args, chunk=chunk)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert int(got[-1]) == 3
