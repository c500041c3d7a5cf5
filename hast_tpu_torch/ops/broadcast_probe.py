"""Broadcast-join probe of a small table (port of
docs/experimental/probe_pallas.py).

K16 :func:`broadcast_probe` (``csrc/broadcast.cu``) gives each query the
largest payload of the table slots holding its key, by comparing every
query with every slot: the small-panel alternative to K2's two-bucket
gather probe (adaptor sets, targeted marker panels), as the JAX package
has it.  Nothing in either package's pipeline calls it.

Words are int32 tensors holding uint32 bits, as the port's tables are
(:mod:`hast_tpu_torch.ops.hashtable`).  :func:`broadcast_probe_ref` is
the plain PyTorch twin: it carries the words in int64, masked, pads the
table with ``EMPTY`` to a multiple of ``chunk`` as the JAX function does,
and walks the padded table and the queries in blocks so that no compare
holds more than 2^21 (query, slot) pairs.
"""

from __future__ import annotations

import torch

from hast_tpu_torch.ops import _build
from hast_tpu_torch.ops import hashtable as H

_M32 = 0xFFFFFFFF
_HI_MASK = int(H.HI_MASK)
_EMPTY = int(H.EMPTY)
_BLOCK_PAIRS = 1 << 21      # (query, slot) pairs a twin compare holds


def table_key_arrays(table: H.KmerTable) -> tuple[torch.Tensor, torch.Tensor]:
    """A full-format table's slots as flat (hi, lo) int32 arrays, payload
    bits kept in hi and empty slots left EMPTY.  Quot slots hold no raw
    key, so a quot table is refused."""
    if table.fmt != "full":
        raise ValueError(f"broadcast join needs full-format slots, got a "
                         f"{table.fmt} table")
    return (table.data[:, 0::2].reshape(-1).contiguous(),
            table.data[:, 1::2].reshape(-1).contiguous())


def _check(table_hi, table_lo, q_hi, q_lo, chunk: int) -> None:
    for name, t in (("table_hi", table_hi), ("table_lo", table_lo),
                    ("q_hi", q_hi), ("q_lo", q_lo)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor of uint32 "
                             f"bits, got {tuple(t.shape)} {t.dtype}")
    if table_hi.shape != table_lo.shape or q_hi.shape != q_lo.shape:
        raise ValueError(f"hi/lo lengths differ: table {table_hi.numel()}/"
                         f"{table_lo.numel()}, queries {q_hi.numel()}/"
                         f"{q_lo.numel()}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")


def broadcast_probe_ref(table_hi: torch.Tensor, table_lo: torch.Tensor,
                        q_hi: torch.Tensor, q_lo: torch.Tensor,
                        chunk: int = 2048) -> torch.Tensor:
    """Plain PyTorch twin of :func:`broadcast_probe`."""
    _check(table_hi, table_lo, q_hi, q_lo, chunk)
    _build.TWIN_CALLS["broadcast_probe_ref"] += 1
    pad = (-table_hi.numel()) % chunk
    thi = torch.cat([table_hi.to(torch.int64) & _M32,
                     table_hi.new_full((pad,), _EMPTY, dtype=torch.int64)])
    tlo = torch.cat([table_lo.to(torch.int64) & _M32,
                     table_lo.new_full((pad,), _EMPTY, dtype=torch.int64)])
    qh = q_hi.to(torch.int64) & _M32
    ql = q_lo.to(torch.int64) & _M32
    out = torch.zeros(qh.shape, dtype=torch.int64, device=qh.device)
    qb = max(1, _BLOCK_PAIRS // chunk)
    for s in range(0, thi.numel(), chunk):
        key_hi = thi[s:s + chunk] & _HI_MASK
        key_lo = tlo[s:s + chunk]
        pay = (thi[s:s + chunk] >> 30) & 3
        for i in range(0, qh.numel(), qb):
            hit = (key_hi[None, :] == qh[i:i + qb, None]) \
                & (key_lo[None, :] == ql[i:i + qb, None])
            found = torch.where(hit, pay[None, :], 0).amax(dim=1)
            out[i:i + qb] = torch.maximum(out[i:i + qb], found)
    return out.to(torch.int32)


def broadcast_probe(table_hi: torch.Tensor, table_lo: torch.Tensor,
                    q_hi: torch.Tensor, q_lo: torch.Tensor,
                    chunk: int = 2048) -> torch.Tensor:
    """Payload (0..3) of each query (q_hi, q_lo), int32 (Q,) (K16).

    The largest ``table_hi >> 30`` over the slots whose key bits
    (``table_hi & 0x3FFFFFFF``, ``table_lo``) equal the query, 0 where
    none does.  ``chunk`` is the JAX kernel's table block: the table is
    taken as padded with EMPTY slots to a multiple of it, so the query
    (0x3FFFFFFF, 0xFFFFFFFF) gets 3 whenever the length is not one.  CPU
    tensors take the twin; CUDA tensors launch the kernel.
    """
    _check(table_hi, table_lo, q_hi, q_lo, chunk)
    tensors = (table_hi, table_lo, q_hi, q_lo)
    if all(t.device.type == "cpu" for t in tensors):
        return broadcast_probe_ref(table_hi, table_lo, q_hi, q_lo, chunk)
    _build.require_cuda("broadcast_probe", *tensors)
    out = torch.empty(q_hi.shape, dtype=torch.int32, device=q_hi.device)
    if out.numel() == 0:
        return out
    n = table_hi.numel()
    _build.launch("broadcast_probe", q_hi.device, table_hi.data_ptr(),
                  table_lo.data_ptr(), n, q_hi.data_ptr(), q_lo.data_ptr(),
                  q_hi.numel(), int(n % chunk != 0), out.data_ptr())
    return out
