"""Base codec and canonical k-mer windows (port of hast_tpu/ops/encode.py).

Host side: numpy copies of the JAX package's codec (``encode_np``,
``canonical_kmers_np``, ``load_mer_file``, ``kmer_to_str``,
``pack_codes_np``); they live in a module that imports jax there, so the
port carries its own.

Device side: K1 :func:`canonical_windows` (``csrc/count.cu``, an instance
of K4's tile kernel that keeps every key) turns 2-bit packed reads into
canonical keys and a validity mask.  A key is the
canonical k-mer as one int64 word, ``(hi << 32) | lo`` of the JAX
package's uint32 pair; k <= 31 keeps it below 2^62, so signed order is
the reference's (hi, lo) order.  :func:`canonical_windows_ref` is the
plain PyTorch twin; it carries words in int64 because torch on the CPU
has no uint32 shifts or compares.
"""

from __future__ import annotations

import numpy as np
import torch

from hast_tpu_torch.ops import _build

MAX_K = 31
_BASE = "ACTG"


# ---------------------------------------------------------------------------
# host-side numpy codec
# ---------------------------------------------------------------------------


def encode_np(seq_bytes: np.ndarray) -> np.ndarray:
    """ASCII -> 2-bit codes, A=0 C=1 T=2 G=3, (c >> 1) & 3 on any byte."""
    return (seq_bytes.astype(np.int32) >> 1) & 3


def canonical_kmers_np(codes: np.ndarray, k: int):
    """(..., L) 2-bit codes -> canonical (hi, lo) uint32, (..., L-k+1)."""
    L = codes.shape[-1]
    P = L - k + 1
    c32 = codes.astype(np.uint32)
    shp = codes.shape[:-1] + (P,)
    fwd_hi = np.zeros(shp, np.uint32)
    fwd_lo = np.zeros(shp, np.uint32)
    rc_hi = np.zeros(shp, np.uint32)
    rc_lo = np.zeros(shp, np.uint32)
    for j in range(k):
        c = c32[..., j:j + P]
        pos = 2 * (k - 1 - j)
        if pos >= 32:
            fwd_hi |= c << np.uint32(pos - 32)
        else:
            fwd_lo |= c << np.uint32(pos)
        cc = c ^ np.uint32(2)
        pos = 2 * j
        if pos >= 32:
            rc_hi |= cc << np.uint32(pos - 32)
        else:
            rc_lo |= cc << np.uint32(pos)
    is_fwd = (fwd_hi < rc_hi) | ((fwd_hi == rc_hi) & (fwd_lo < rc_lo))
    return np.where(is_fwd, fwd_hi, rc_hi), np.where(is_fwd, fwd_lo, rc_lo)


def kmer_to_str(hi: int, lo: int, k: int) -> str:
    """canonical (hi, lo) -> ACTG string (Kmer::ToBaseStr)."""
    word = (int(hi) << 32) | int(lo)
    return "".join(_BASE[(word >> (2 * (k - 1 - i))) & 3] for i in range(k))


def words_to_bytes(words: np.ndarray, k: int) -> np.ndarray:
    """(n,) canonical int words -> (n, k) ACTG uint8 rows."""
    shifts = np.arange(2 * (k - 1), -1, -2, dtype=np.uint64)
    codes = (words.astype(np.uint64)[:, None] >> shifts) & np.uint64(3)
    return np.frombuffer(_BASE.encode(), np.uint8)[codes.astype(np.intp)]


def load_mer_file(path: str, k_expect: int | None = None):
    """One-kmer-per-line marker text -> canonical (hi, lo, k).

    k is the length of the first line (classify.cpp:35-37); every line
    is canonicalized.  Well-formed files (k+1 bytes a line) reshape with
    no per-line Python.
    """
    with open(path, "rb") as f:
        data = f.read()
    if not data:
        raise ValueError(f"empty marker file: {path}")
    k = data.index(b"\n") if b"\n" in data else len(data)
    if k_expect is not None and k != k_expect:
        raise ValueError(f"{path}: k={k}, expected {k_expect}")
    flat = np.frombuffer(data, np.uint8)
    n_full = len(data) // (k + 1)
    tail = flat[n_full * (k + 1):]   # a last line without its \n, or none
    if n_full and tail.size in (0, k) and not (tail == ord("\n")).any():
        arr2 = flat[:n_full * (k + 1)].reshape(n_full, k + 1)
        if (arr2[:, k] == ord("\n")).all():
            rows = [arr2[:, :k]]
            if tail.size == k:
                rows.append(tail[None, :])
            return _canonical_rows_chunked(rows, k) + (k,)
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    for i, line in enumerate(lines):
        if len(line) != k:
            raise ValueError(f"{path}: line {i + 1} has {len(line)} bytes, "
                             f"expected k={k}")
    arr = np.frombuffer(b"".join(lines), np.uint8).reshape(len(lines), k)
    hi, lo = canonical_kmers_np(encode_np(arr), k)
    return hi[:, 0], lo[:, 0], k


def _canonical_rows_chunked(rows, k, chunk: int = 1 << 24):
    his, los = [], []
    for arr in rows:
        for s in range(0, arr.shape[0], chunk):
            h, l = canonical_kmers_np(encode_np(arr[s:s + chunk]), k)
            his.append(h[:, 0])
            los.append(l[:, 0])
    if len(his) == 1:
        return his[0], los[0]
    return np.concatenate(his), np.concatenate(los)


def pack_codes_np(seqs_u8: np.ndarray) -> np.ndarray:
    """(..., L) ASCII -> (..., L/4) 2-bit packed uint8 (L a multiple of 4)."""
    codes = (seqs_u8 >> 1) & np.uint8(3)
    return (codes[..., 0::4] | (codes[..., 1::4] << np.uint8(2))
            | (codes[..., 2::4] << np.uint8(4))
            | (codes[..., 3::4] << np.uint8(6)))


# ---------------------------------------------------------------------------
# K1: canonical windows of packed reads
# ---------------------------------------------------------------------------


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")


def unpack_ref(packed: torch.Tensor) -> torch.Tensor:
    """(N, Lp) uint8 -> (N, 4*Lp) int64 codes, base i at bits 2*(i & 3)."""
    p = packed.to(torch.int64)
    shifts = torch.arange(0, 8, 2, device=p.device)
    return ((p[..., None] >> shifts) & 3).reshape(*p.shape[:-1], -1)


def canonical_windows_ref(packed: torch.Tensor, lengths: torch.Tensor,
                          k: int):
    """Plain PyTorch twin of :func:`canonical_windows`."""
    _build.TWIN_CALLS["canonical_windows_ref"] += 1
    return code_windows_ref(unpack_ref(packed), lengths, k)


def code_windows_ref(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Canonical int64 keys (N, L-k+1) of (N, L) 2-bit codes, and the
    windows that lie inside their read (p + k <= length); (N, 0) when
    L < k."""
    _check_k(k)
    n_win = max(codes.shape[-1] - k + 1, 0)
    fwd = torch.zeros((codes.shape[0], n_win), dtype=torch.int64,
                      device=codes.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        c = codes[:, j:j + n_win]
        fwd |= c << (2 * (k - 1 - j))
        rc |= (c ^ 2) << (2 * j)
    starts = torch.arange(n_win, device=codes.device)
    valid = starts[None, :] + k <= lengths.to(torch.int64)[:, None]
    return torch.minimum(fwd, rc), valid


def check_packed(packed: torch.Tensor, lengths: torch.Tensor) -> None:
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"packed must be (N, Lp) uint8, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    if lengths.dtype != torch.int32 or lengths.shape != packed.shape[:1]:
        raise ValueError(f"lengths must be ({packed.shape[0]},) int32, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")


def canonical_windows(packed: torch.Tensor, lengths: torch.Tensor, k: int):
    """Canonical keys and window validity of packed reads (K1).

    packed: (N, Lp) uint8, 4 bases a byte; lengths: (N,) int32.
    Returns keys (N, 4*Lp-k+1) int64 and valid (same shape) bool, where
    valid means the window lies inside the read (every base of a packed
    read is good).  A stride under k bases gives (N, 0).  CPU tensors
    take the twin; CUDA tensors launch the kernel.
    """
    _check_k(k)
    check_packed(packed, lengths)
    if packed.device.type == "cpu":
        return canonical_windows_ref(packed, lengths, k)
    _build.require_cuda("canonical_windows", packed, lengths)
    n, lp = packed.shape
    n_win = max(4 * lp - k + 1, 0)
    keys = torch.empty((n, n_win), dtype=torch.int64, device=packed.device)
    valid = torch.empty((n, n_win), dtype=torch.bool, device=packed.device)
    if keys.numel() == 0:
        return keys, valid
    _build.launch("canonical_windows", packed.device, packed.data_ptr(),
                  lengths.data_ptr(), n, lp, k, keys.data_ptr(),
                  valid.data_ptr())
    return keys, valid
