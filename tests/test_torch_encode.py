"""hast_tpu_torch.ops.encode against hast_tpu.ops.encode.

K1's twin (canonical_windows_ref, what the wrapper runs on CPU tensors)
is held against the JAX package's canonical_kmers + window_valid on the
same numpy-seeded packed reads; the host codec copies against theirs.
All values are integers, so the tolerance is exact equality.  The kernel
itself is compared with the twin on the card (marked cuda).
"""

import pathlib

import numpy as np
import pytest
import torch

from hast_tpu_torch.ops import _build
from hast_tpu_torch.ops import encode as E

GOLD = pathlib.Path(__file__).parent / "golden" / "stage01"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def packed_batch(seed: int, n: int = 64, lp: int = 28, k: int = 21):
    """Random packed reads; lengths cover 0, < k, == k and the full stride."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (n, lp), np.uint8)
    lengths = rng.integers(0, 4 * lp + 1, n).astype(np.int32)
    lengths[:4] = (0, k - 1, k, 4 * lp)
    return packed, lengths


def unpack_np(packed: np.ndarray) -> np.ndarray:
    return ((packed[..., None] >> np.array([0, 2, 4, 6], np.uint8)) & 3
            ).reshape(*packed.shape[:-1], -1).astype(np.int32)


@pytest.mark.parametrize("k, lp", [
    pytest.param(15, 28, id="15"), pytest.param(21, 28, id="21"),
    pytest.param(31, 28, id="31"),
    # one and two windows a row, and a stride off 4-byte alignment
    pytest.param(16, 4, id="16-lp4"), pytest.param(31, 8, id="31-lp8"),
    pytest.param(21, 25, id="21-lp25")])
def test_canonical_windows_twin_matches_jax(k, lp):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from hast_tpu.ops import encode as JE

    packed, lengths = packed_batch(k, lp=lp, k=k)
    before = dict(_build.TWIN_CALLS), dict(_build.LAUNCHES)
    keys, valid = E.canonical_windows(torch.from_numpy(packed),
                                      torch.from_numpy(lengths), k)
    # a CPU tensor takes the twin, never the kernel
    assert _build.TWIN_CALLS["canonical_windows_ref"] == \
        before[0].get("canonical_windows_ref", 0) + 1
    assert dict(_build.LAUNCHES) == before[1]

    codes = jnp.asarray(unpack_np(packed))
    hi, lo = JE.canonical_kmers(codes, k)
    want = (np.asarray(hi).astype(np.int64) << 32) | np.asarray(lo)
    want_valid = JE.window_valid(jnp.ones(codes.shape, bool),
                                 jnp.asarray(lengths), k)
    assert keys.dtype == torch.int64 and keys.shape == want.shape
    np.testing.assert_array_equal(keys.numpy(), want)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))


def test_stride_under_k_gives_no_windows():
    packed = torch.zeros((5, 3), dtype=torch.uint8)
    keys, valid = E.canonical_windows(packed, torch.full((5,), 12,
                                                         dtype=torch.int32),
                                      15)
    assert tuple(keys.shape) == (5, 0) and tuple(valid.shape) == (5, 0)


def test_wrapper_rejects_other_devices_and_bad_input():
    packed = torch.zeros((2, 8), dtype=torch.uint8, device="meta")
    lengths = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        E.canonical_windows(packed, lengths, 21)
    with pytest.raises(ValueError, match="k must be"):
        E.canonical_windows(torch.zeros((2, 8), dtype=torch.uint8),
                            torch.zeros((2,), dtype=torch.int32), 32)
    with pytest.raises(ValueError, match="lengths"):
        E.canonical_windows(torch.zeros((2, 8), dtype=torch.uint8),
                            torch.zeros((2,), dtype=torch.int64), 21)


@pytest.mark.parametrize("name", ["hap0.mer", "edge.hap1.mer", "k15.hap0.mer",
                                  "k31.hap1.mer"])
def test_load_mer_file_matches_jax(name):
    pytest.importorskip("jax")
    from hast_tpu.ops import encode as JE

    got = E.load_mer_file(str(GOLD / name))
    want = JE.load_mer_file(str(GOLD / name))
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_load_mer_file_tail_with_a_newline(tmp_path):
    """A file whose length is k (mod k + 1) and whose last k bytes hold a
    newline (short lines at the end) is malformed: the loader says so
    instead of encoding those k bytes as a k-mer.  A well-formed last
    line without its newline still loads."""
    k = 21
    lines = (GOLD / "hap0.mer").read_bytes().split(b"\n")[:3]
    good = b"\n".join(lines)                          # no final newline
    bad = b"\n".join(lines[:2]) + b"\n" + b"ACGTACGTAC\nACGTACGTAC"
    assert len(bad) % (k + 1) == k and b"\n" in bad[-k:]
    (tmp_path / "good.mer").write_bytes(good)
    (tmp_path / "bad.mer").write_bytes(bad)
    hi, lo, got_k = E.load_mer_file(str(tmp_path / "good.mer"))
    want = E.canonical_kmers_np(E.encode_np(np.frombuffer(
        b"".join(lines), np.uint8).reshape(3, k)), k)
    assert got_k == k
    np.testing.assert_array_equal(hi, want[0][:, 0])
    np.testing.assert_array_equal(lo, want[1][:, 0])
    with pytest.raises(ValueError, match="line 3 has 10 bytes"):
        E.load_mer_file(str(tmp_path / "bad.mer"))


def test_host_codec_matches_jax():
    pytest.importorskip("jax")
    from hast_tpu.ops import encode as JE

    rng = np.random.default_rng(3)
    ascii_ = np.frombuffer(b"ACGTNacgtYR", np.uint8)[
        rng.integers(0, 11, (16, 128))]
    np.testing.assert_array_equal(E.pack_codes_np(ascii_),
                                  JE.pack_codes_np(ascii_))
    codes = E.encode_np(ascii_)
    np.testing.assert_array_equal(codes, JE.encode_np(ascii_))
    for k in (1, 15, 31):
        got, want = E.canonical_kmers_np(codes, k), \
            JE.canonical_kmers_np(codes, k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        hi, lo = got[0][0, :5], got[1][0, :5]
        words = (hi.astype(np.uint64) << np.uint64(32)) | lo
        for h, l, row in zip(hi, lo, E.words_to_bytes(words, k)):
            assert E.kmer_to_str(h, l, k) == JE.kmer_to_str(h, l, k) \
                == row.tobytes().decode()


def edge_batch(k: int, lp: int, n: int):
    """synthetic.window_edge_reads (lengths 0, k - 1, k, the stride, an N
    at a window's first and last base) packed at lp bytes a row."""
    from hast_tpu_torch.utils import synthetic as S
    seqs, lengths = S.window_edge_reads(k + lp, k, lp, n=n)
    return E.pack_codes_np(seqs), lengths


@pytest.mark.cuda
@pytest.mark.parametrize("k, lp", [
    pytest.param(k, None, id=str(k)) for k in (15, 17, 21, 31)] + [
    # window_edge_reads at the edge strides, 203 reads: tiles that begin
    # and end inside a read, the last one partial
    pytest.param(k, lp, id=f"{k}-lp{lp}") for k in (15, 17, 21, 31)
    for lp in (25, 26, 28, 30, 520)] + [
    # one window a row on 8,193 reads (the last tile one window, an odd
    # count), two a row (the last tile two windows)
    pytest.param(16, 4, id="16-nwin1"), pytest.param(31, 8, id="31-nwin2"),
    pytest.param(15, 4, id="15-nwin2")])
def test_canonical_windows_kernel_matches_twin(card, k, lp):
    if lp is None:
        packed, lengths = packed_batch(100 + k, n=4096, k=k)
    else:
        packed, lengths = edge_batch(k, lp, 8193 if 4 * lp - k < 2 else 203)
    p = torch.from_numpy(packed).to(card)
    n = torch.from_numpy(lengths).to(card)
    launches = _build.LAUNCHES["canonical_windows"]
    keys, valid = E.canonical_windows(p, n, k)
    assert _build.LAUNCHES["canonical_windows"] == launches + 1
    rkeys, rvalid = E.canonical_windows_ref(p, n, k)
    assert torch.equal(keys, rkeys) and torch.equal(valid, rvalid)
