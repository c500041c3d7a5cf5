"""Two-choice k-mer membership table (port of hast_tpu/ops/hashtable.py).

The table layout is the JAX package's, unchanged: (n_buckets, 4) uint32
rows of 16 bytes, either four 4-byte "quot" slots (quotient | which << 29
| payload << 30) or two 8-byte "full" slots (hi | payload << 30, lo).
The host build is the same code path (``libhastio``'s
``sort_dedup_or`` / ``build_quot`` / ``place2`` through the port's own
binding ``hast_tpu_torch.io.native``, numpy placement when the library
is absent), so both packages build identical tables and share the
``.probetable.npz`` snapshot.

The port keeps the table as a contiguous int32 tensor holding the uint32
bits (torch has no uint32 arithmetic on the CPU).  K2 :func:`probe`
(``csrc/probe.cu``) looks canonical int64 keys up on the card;
:func:`probe_ref` is its plain PyTorch twin, which carries every word in
int64 and masks with ``& 0xFFFFFFFF`` after each multiply (the low 32
bits survive the int64 wrap).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hast_tpu_torch.io import native as N
from hast_tpu_torch.ops import _build
from hast_tpu_torch.utils import profiling as P

BUCKET = 2                       # slots per bucket, "full" format
QUOT_BUCKET = 4                  # slots per bucket, "quot" format
PAYLOAD_SHIFT = np.uint32(30)
HI_MASK = np.uint32((1 << 30) - 1)
EMPTY = np.uint32(0xFFFFFFFF)
_WHICH_SHIFT = np.uint32(29)
_QMASK = np.uint32((1 << 29) - 1)

_M1 = np.uint32(0x85EBCA6B)
_M2 = np.uint32(0xC2B2AE35)
_GOLD = np.uint32(0x9E3779B9)
_GOLD2 = np.uint32(0xC2B2AE3D)
_FC = (np.uint32(0x9E3779B9), np.uint32(0x85EBCA6B),
       np.uint32(0xC2B2AE35), np.uint32(0x27D4EB2F))
_FORMATS = {"quot": 0, "full": 1}     # csrc/probe.cuh TableFormat


@dataclasses.dataclass
class KmerTable:
    """A built table: its rows as an int32 tensor plus static metadata."""

    data: torch.Tensor        # (n_buckets, 4) int32 holding uint32 bits
    n_buckets: int            # power of two
    max_probe: int            # hash choices of the full format (== 2)
    k: int
    n_keys: int               # distinct canonical keys stored
    set_sizes: tuple[int, ...] = ()  # per-haplotype set size (getHap)
    fmt: str = "full"         # "full" (8 B slots) | "quot" (4 B slots)

    @property
    def bbits(self) -> int:
        return self.n_buckets.bit_length() - 1

    def data_np(self) -> np.ndarray:
        """The rows as uint32 numpy, sharing memory with a CPU tensor."""
        return self.data.cpu().numpy().view(np.uint32)

    def to(self, device) -> "KmerTable":
        """The table on device: span ``table.upload``; counter
        ``table.upload_bytes`` grows by the bytes copied (none when the
        rows are there already)."""
        with P.span("table.upload"):
            data = self.data.to(device)
        if data is not self.data:
            P.count("table.upload_bytes", data.nbytes)
        return dataclasses.replace(self, data=data)


def from_reference(data, n_buckets: int, max_probe: int, k: int,
                   n_keys: int, set_sizes=(), fmt: str = "full",
                   device="cuda") -> KmerTable:
    """The port's table from the JAX package's ``KmerTable`` fields."""
    rows = np.ascontiguousarray(np.asarray(data, np.uint32))
    if rows.shape != (n_buckets, 4):
        raise ValueError(f"table rows {rows.shape} != ({n_buckets}, 4)")
    return KmerTable(data=torch.from_numpy(rows.view(np.int32)).to(device),
                     n_buckets=int(n_buckets), max_probe=int(max_probe),
                     k=int(k), n_keys=int(n_keys),
                     set_sizes=tuple(int(x) for x in set_sizes), fmt=fmt)


# ---------------------------------------------------------------------------
# host hashes (numpy uint32, as hast_tpu/ops/hashtable.py computes them)
# ---------------------------------------------------------------------------


def _mix(h):
    """murmur3 fmix32 over uint32 arrays."""
    h = h ^ (h >> np.uint32(16))
    h = (h * _M1).astype(np.uint32)
    h = h ^ (h >> np.uint32(13))
    h = (h * _M2).astype(np.uint32)
    return h ^ (h >> np.uint32(16))


def kmer_hash(hi, lo):
    hi = np.asarray(hi, np.uint32)
    lo = np.asarray(lo, np.uint32)
    return _mix((lo + (hi * _GOLD).astype(np.uint32)).astype(np.uint32))


def kmer_hash2(hi, lo):
    hi = np.asarray(hi, np.uint32)
    lo = np.asarray(lo, np.uint32)
    h = ((lo ^ _GOLD2) + (hi * _M2).astype(np.uint32)).astype(np.uint32)
    return _mix(h ^ np.uint32(0x5BD1E995))


def _hash_round(rnd: int, hi, lo):
    return kmer_hash(hi, lo) if rnd == 0 else kmer_hash2(hi, lo)


def _feistel_halves(hi, lo, k: int):
    """4-round Feistel permutation of the 2k-bit key -> (A, B) halves."""
    kmask = np.uint32((1 << k) - 1)
    hi = np.asarray(hi, np.uint32)
    lo = np.asarray(lo, np.uint32)
    A = ((hi << np.uint32(32 - k)) | (lo >> np.uint32(k))) & kmask
    B = lo & kmask
    for i, c in enumerate(_FC):
        if i % 2 == 0:
            A = A ^ (_mix((B * _M1).astype(np.uint32) + c) & kmask)
        else:
            B = B ^ (_mix((A * _M1).astype(np.uint32) + c) & kmask)
    return A, B


def _quot_bucket_q(hi, lo, k: int, bbits: int):
    """(b1, q): b1 = low bbits of the permuted key, q = the other bits."""
    A, B = _feistel_halves(hi, lo, k)
    if bbits <= k:
        b1 = B & np.uint32((1 << bbits) - 1)
        q = A if bbits == k else \
            (B >> np.uint32(bbits)) | (A << np.uint32(k - bbits))
    else:
        b1 = (B | (A << np.uint32(k))) & np.uint32((1 << bbits) - 1) \
            if bbits < 32 else (B | (A << np.uint32(k)))
        q = A >> np.uint32(bbits - k)
    return b1, q


def _quot_alt(b1, q, bbits: int):
    """Alternate bucket b1 ^ (fmix32(q * GOLD) | 1), masked to bbits."""
    g = (_mix((q * _GOLD).astype(np.uint32)) | np.uint32(1)) \
        & np.uint32((1 << bbits) - 1)
    return b1 ^ g


# ---------------------------------------------------------------------------
# host build (2-choice placement on precomputed (b1, b2) arrays)
# ---------------------------------------------------------------------------


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _assign(b1, b2, n_buckets: int, bucket: int):
    """Native greedy + cuckoo placement when libhastio is present, else the
    numpy rounds; (row, slot) or None when the table must double."""
    res = N.place2(np.asarray(b1, np.uint32), np.asarray(b2, np.uint32),
                   n_buckets, bucket, seed=n_buckets)
    if res == "failed":
        return None
    if res is not None:
        return res
    return _assign_2choice(b1, b2, n_buckets, bucket)


def _assign_2choice(b1, b2, n_buckets: int, bucket: int):
    """Round 0 fills home buckets, round 1 the alternates; stragglers take
    a seeded cuckoo random walk.  (row, slot) int64 or None."""
    n = b1.size
    row = np.full(n, -1, np.int64)
    slot = np.full(n, -1, np.int64)
    occ = np.full((n_buckets, bucket), -1, np.int64)
    occupancy = np.zeros(n_buckets, np.int64)
    pending = np.arange(n)
    for b_all in (b1, b2):
        if not pending.size:
            break
        bb = np.asarray(b_all[pending], np.int64)
        order = np.argsort(bb, kind="stable")
        pend_s, b_s = pending[order], bb[order]
        first = np.empty(b_s.size, bool)
        first[0] = True
        first[1:] = b_s[1:] != b_s[:-1]
        grp_start = np.maximum.accumulate(
            np.where(first, np.arange(b_s.size), 0))
        rank = np.arange(b_s.size) - grp_start
        free = bucket - occupancy[b_s]
        place = rank < free
        tslot = occupancy[b_s] + rank
        keys = pend_s[place]
        row[keys] = b_s[place]
        slot[keys] = tslot[place]
        occ[b_s[place], tslot[place]] = keys
        np.add.at(occupancy, b_s[place], 1)
        pending = pend_s[~place]
    if pending.size and not _walk_2choice(b1, b2, row, slot, occ,
                                          bucket, pending, n_buckets):
        return None
    return row, slot


def _walk_2choice(b1, b2, row, slot, occ, bucket: int, pending,
                  seed: int, max_rounds: int = 4096) -> bool:
    rng = np.random.default_rng(seed)
    cur = pending.copy()
    tgt = np.asarray(b2[cur], np.int64)
    for _ in range(max_rounds):
        if cur.size == 0:
            return True
        order = np.argsort(tgt, kind="stable")
        t_s = tgt[order]
        first = np.ones(t_s.size, bool)
        first[1:] = t_s[1:] != t_s[:-1]
        actors = order[first]
        ab = tgt[actors]
        free = occ[ab] < 0
        has_free = free.any(axis=1)
        sl = np.where(has_free, np.argmax(free, axis=1),
                      rng.integers(0, bucket, actors.size))
        victims = occ[ab, sl].copy()
        keys = cur[actors]
        occ[ab, sl] = keys
        row[keys] = ab
        slot[keys] = sl
        kicked = victims[~has_free]
        k_b1 = np.asarray(b1[kicked], np.int64)
        k_tgt = np.where(k_b1 == row[kicked],
                         np.asarray(b2[kicked], np.int64), k_b1)
        row[kicked] = -1
        slot[kicked] = -1
        keep = np.ones(cur.size, bool)
        keep[actors] = False
        s_cur = cur[keep]
        s_tgt = np.where(tgt[keep] == np.asarray(b1[s_cur], np.int64),
                         np.asarray(b2[s_cur], np.int64),
                         np.asarray(b1[s_cur], np.int64))
        cur = np.concatenate([s_cur, kicked])
        tgt = np.concatenate([s_tgt, k_tgt])
    return False


def _dedup_or(hi, lo, payload):
    """Sort keys, merge duplicates by OR-ing their payloads."""
    hi, lo, payload = hi.copy(), lo.copy(), payload.copy()
    m = N.sort_dedup_or(hi, lo, payload)
    if m is not None:
        return hi[:m], lo[:m], payload[:m]
    order = np.lexsort((lo, hi))
    hi, lo, payload = hi[order], lo[order], payload[order]
    new = np.empty(hi.size, bool)
    new[0] = True
    new[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    pay = np.bitwise_or.reduceat(payload, np.flatnonzero(new))
    return hi[new], lo[new], pay


def table_shape(n: int, k: int, load: float = 0.35,
                fmt: str = "auto") -> tuple[str, int]:
    """(format, n_buckets) that :func:`build_table` starts from for n
    distinct keys: fmt "auto" takes "quot" whenever the quotient fits a
    slot (2k - log2(n_buckets) <= 29), else "full".  Placement doubles
    n_buckets while it fails, and "quot" while its quotient is too wide."""
    def buckets(per: int) -> int:
        return _next_pow2(max(1, int(np.ceil(n / (per * load)))))
    if fmt == "auto":
        fmt = "quot" if 2 * k - buckets(QUOT_BUCKET).bit_length() + 1 <= 29 \
            else "full"
    return fmt, buckets(QUOT_BUCKET if fmt == "quot" else BUCKET)


def build_table(hi, lo, payload, k: int, load: float = 0.35,
                set_sizes: tuple[int, ...] = (),
                fmt: str = "auto") -> KmerTable:
    """Build the table on the host from canonical (hi, lo) uint32 keys and
    payloads; ``KmerTable.to`` moves it to the card.

    Duplicate keys OR their payloads (a marker of both haplotypes gets 3);
    fmt and the size are :func:`table_shape`'s.  Span ``table.build``
    around the call, its children ``table.dedup`` (the sort and merge)
    and ``table.place``; counters ``table.keys`` (distinct keys stored)
    and ``table.rows`` (n_buckets) grow by the table's.
    """
    with P.span("table.build"):
        hi = np.ascontiguousarray(hi, np.uint32)
        lo = np.ascontiguousarray(lo, np.uint32)
        payload = np.ascontiguousarray(payload, np.uint32)
        if hi.size:
            with P.span("table.dedup"):
                hi, lo, payload = _dedup_or(hi, lo, payload)
        with P.span("table.place"):
            table = _place(hi, lo, payload, k, load, set_sizes, fmt)
    P.count("table.keys", table.n_keys)
    P.count("table.rows", table.n_buckets)
    return table


def _place(hi, lo, payload, k: int, load: float, set_sizes,
           fmt: str) -> KmerTable:
    """The table of distinct sorted keys: 2-choice placement, doubling
    the buckets until every key is placed."""
    n = hi.size
    fmt, n_buckets = table_shape(n, k, load, fmt)
    if fmt == "quot":
        while True:
            bbits = n_buckets.bit_length() - 1
            if 2 * k - bbits > 29:
                n_buckets *= 2
                continue
            data = N.build_quot(np.ascontiguousarray(hi),
                                np.ascontiguousarray(lo),
                                np.ascontiguousarray(payload),
                                k, bbits, seed=n_buckets)
            if data is None:
                b1, q = _quot_bucket_q(hi, lo, k, bbits)
                b2 = _quot_alt(b1, q, bbits)
                asg = _assign(b1, b2, n_buckets, QUOT_BUCKET)
                if asg is None:
                    n_buckets *= 2
                    continue
                row, slot = asg
                data = np.zeros((n_buckets, QUOT_BUCKET), np.uint32)
                which = (row != np.asarray(b1, np.int64)).astype(np.uint32)
                data[row, slot] = (q & _QMASK) | (which << _WHICH_SHIFT) \
                    | (payload << PAYLOAD_SHIFT)
            elif isinstance(data, str):   # "failed": placement full
                n_buckets *= 2
                continue
            return from_reference(data, n_buckets, 2, k, n, set_sizes,
                                  "quot", device="cpu")

    hi_packed = hi | (payload << PAYLOAD_SHIFT)
    while True:
        mask = np.uint32(n_buckets - 1)
        asg = _assign(kmer_hash(hi, lo) & mask, kmer_hash2(hi, lo) & mask,
                      n_buckets, BUCKET)
        if asg is not None:
            break
        n_buckets *= 2
    row, slot = asg
    data = np.full((n_buckets, 2 * BUCKET), EMPTY, np.uint32)
    data[row, 2 * slot] = hi_packed
    data[row, 2 * slot + 1] = lo
    return from_reference(data, n_buckets, 2, k, n, set_sizes, "full",
                          device="cpu")


def probe_np(table: KmerTable, q_hi, q_lo) -> np.ndarray:
    """Host numpy lookup of (hi, lo) pairs (tests and small inputs)."""
    data = table.data_np()
    q_hi = np.asarray(q_hi, np.uint32).reshape(-1)
    q_lo = np.asarray(q_lo, np.uint32).reshape(-1)
    res = np.zeros(q_hi.shape, np.uint32)
    if table.fmt == "quot":
        b1, q = _quot_bucket_q(q_hi, q_lo, table.k, table.bbits)
        b2 = _quot_alt(b1, q, table.bbits)
        for rnd, b in enumerate((b1, b2)):
            rows = data[b.astype(np.int64)]
            hit = ((rows & _QMASK) == q[:, None]) \
                & (((rows >> _WHICH_SHIFT) & 1) == rnd)
            res |= np.max(np.where(hit, rows >> PAYLOAD_SHIFT, 0),
                          axis=1).astype(np.uint32)
        return res.astype(np.int32)
    mask = np.uint32(table.n_buckets - 1)
    for rnd in range(table.max_probe):
        rows = data[(_hash_round(rnd, q_hi, q_lo) & mask).astype(np.int64)]
        slot_hi, slot_lo = rows[:, 0::2], rows[:, 1::2]
        hit = ((slot_hi & HI_MASK) == q_hi[:, None]) \
            & (slot_lo == q_lo[:, None])
        res |= np.max(np.where(hit, slot_hi >> PAYLOAD_SHIFT, 0),
                      axis=1).astype(np.uint32)
    return res.astype(np.int32)


def remove_keys(table: KmerTable, hi, lo, payload_mask: int
                ) -> list[tuple[int, int, int]]:
    """Clear payload bits of the given keys in place (InitAdaptor parity).

    The set sizes shrink with every cleared bit.  Returns
    [(hi, lo, cleared_bits)] for the erase log.  Adaptor-scale only: it
    walks keys in Python.  The table must be on the CPU (erase before
    moving it to the card).
    """
    if table.data.device.type != "cpu":
        raise ValueError("remove_keys edits the host table; call it before "
                         "KmerTable.to(device)")
    data = table.data.numpy().view(np.uint32)   # shares the tensor's memory
    hi = np.asarray(hi, np.uint32).reshape(-1)
    lo = np.asarray(lo, np.uint32).reshape(-1)
    cleared = []
    sizes = list(table.set_sizes)
    seen = set()

    def clear(b: int, s: int, key) -> None:
        w = int(data[b, s])
        pay = w >> int(PAYLOAD_SHIFT)
        bits = pay & payload_mask
        if not bits:
            return
        data[b, s] = np.uint32((w & 0x3FFFFFFF)
                               | ((pay & ~payload_mask) << int(PAYLOAD_SHIFT)))
        cleared.append((key[0], key[1], bits))
        for hap in range(len(sizes)):
            if bits & (1 << hap):
                sizes[hap] -= 1

    if table.fmt == "quot":
        b1a, qa = _quot_bucket_q(hi, lo, table.k, table.bbits)
        b2a = _quot_alt(b1a, qa, table.bbits)
    mask = np.uint32(table.n_buckets - 1)
    for i in range(hi.size):
        key = (int(hi[i]), int(lo[i]))
        if key in seen:
            continue
        seen.add(key)
        if table.fmt == "quot":
            for rnd, b in enumerate((int(b1a[i]), int(b2a[i]))):
                for s in range(QUOT_BUCKET):
                    w = int(data[b, s])
                    if (w & int(_QMASK)) == int(qa[i]) and \
                            ((w >> int(_WHICH_SHIFT)) & 1) == rnd:
                        clear(b, s, key)
            continue
        for rnd in range(table.max_probe):
            b = int(_hash_round(rnd, hi[i:i + 1], lo[i:i + 1])[0] & mask)
            for s in range(BUCKET):
                if (int(data[b, 2 * s]) & int(HI_MASK)) == key[0] and \
                        int(data[b, 2 * s + 1]) == key[1]:
                    clear(b, 2 * s, key)
    table.set_sizes = tuple(sizes)
    return cleared


# ---------------------------------------------------------------------------
# K2: probe of canonical int64 keys
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mix_t(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * int(_M1)) & _M32
    h = h ^ (h >> 13)
    h = (h * int(_M2)) & _M32
    return h ^ (h >> 16)


def _kmer_hash_t(rnd: int, hi: torch.Tensor, lo: torch.Tensor):
    if rnd == 0:
        return _mix_t((lo + hi * int(_GOLD)) & _M32)
    h = ((lo ^ int(_GOLD2)) + hi * int(_M2)) & _M32
    return _mix_t(h ^ 0x5BD1E995)


def _quot_bucket_q_t(hi: torch.Tensor, lo: torch.Tensor, k: int, bbits: int):
    kmask = (1 << k) - 1
    A = ((hi << (32 - k)) | (lo >> k)) & kmask
    B = lo & kmask
    for i, c in enumerate(_FC):
        if i % 2 == 0:
            A = A ^ (_mix_t((B * int(_M1) + int(c)) & _M32) & kmask)
        else:
            B = B ^ (_mix_t((A * int(_M1) + int(c)) & _M32) & kmask)
    bmask = (1 << bbits) - 1
    if bbits <= k:
        b1 = B & bmask
        q = A if bbits == k else ((B >> bbits) | (A << (k - bbits))) & _M32
    else:
        b1 = (B | ((A << k) & _M32)) & bmask
        q = A >> (bbits - k)
    return b1, q


def _rows_t(table: KmerTable, b: torch.Tensor, row_lo: int):
    """The rows of buckets b (int64 words) and whether table.data, rows
    [row_lo, row_lo + len) of the table, holds them."""
    n_rows = table.data.shape[0]
    local = b - row_lo
    owned = (local >= 0) & (local < n_rows)
    rows = table.data[local.clamp(0, n_rows - 1)].to(torch.int64) & _M32
    return rows, owned[:, None]


def probe_ref(table: KmerTable, keys: torch.Tensor,
              row_lo: int = 0) -> torch.Tensor:
    """Plain PyTorch twin of :func:`probe`.  table.data may be the slice
    of rows [row_lo, row_lo + len) that one tp shard holds: a bucket
    outside it adds nothing (hast_tpu/parallel/mesh.py `_probe_local`)."""
    _build.TWIN_CALLS["probe_ref"] += 1
    flat = keys.reshape(-1).to(torch.int64)
    hi, lo = flat >> 32, flat & _M32
    res = torch.zeros_like(flat)
    if table.fmt == "quot":
        b1, q = _quot_bucket_q_t(hi, lo, table.k, table.bbits)
        g = (_mix_t((q * int(_GOLD)) & _M32) | 1) & (table.n_buckets - 1)
        for rnd, b in enumerate((b1, b1 ^ g)):
            rows, owned = _rows_t(table, b, row_lo)
            hit = ((rows & int(_QMASK)) == q[:, None]) \
                & (((rows >> 29) & 1) == rnd) & owned
            res |= torch.where(hit, rows >> 30, 0).amax(dim=1)
    else:
        for rnd in range(table.max_probe):
            rows, owned = _rows_t(table, _kmer_hash_t(rnd, hi, lo)
                                  & (table.n_buckets - 1), row_lo)
            s_hi, s_lo = rows[:, 0::2], rows[:, 1::2]
            hit = ((s_hi & int(HI_MASK)) == hi[:, None]) \
                & (s_lo == lo[:, None]) & owned
            res |= torch.where(hit, s_hi >> 30, 0).amax(dim=1)
    return res.to(torch.int32).reshape(keys.shape)


def check_table(table: KmerTable, row_lo: int | None = None) -> None:
    """table.data must be the whole (n_buckets, 4) int32 table, or, when
    row_lo is given, a slice of it: rows [row_lo, row_lo + len)."""
    d = table.data
    rows = d.shape[0] if d.dim() == 2 else -1
    whole = row_lo is None and rows == table.n_buckets
    part = row_lo is not None and 0 <= row_lo and 0 < rows \
        and row_lo + rows <= table.n_buckets
    if d.dtype != torch.int32 or d.dim() != 2 or d.shape[1] != 4 or not (
            whole or part):
        raise ValueError(f"table data must be ({table.n_buckets}, 4) int32 "
                         f"or rows of it from row_lo={row_lo}, got "
                         f"{tuple(d.shape)} {d.dtype}")
    if table.fmt not in _FORMATS or not 0 <= table.bbits < 32:
        raise ValueError(f"unsupported table: fmt={table.fmt} "
                         f"n_buckets={table.n_buckets}")


def kernel_table_args(table: KmerTable) -> tuple:
    """The (table, n_buckets, bbits, fmt, k, max_probe) C arguments."""
    return (table.data.data_ptr(), table.n_buckets, table.bbits,
            _FORMATS[table.fmt], table.k, table.max_probe)


def probe(table: KmerTable, keys: torch.Tensor) -> torch.Tensor:
    """Payload (0..3) of each canonical int64 key, int32, keys' shape (K2).

    Bit 0 = in the hap0 set, bit 1 = in the hap1 set.  CPU tensors take
    the twin; CUDA tensors launch the kernel.
    """
    check_table(table)
    if keys.dtype != torch.int64:
        raise ValueError(f"keys must be int64, got {keys.dtype}")
    if keys.device.type == "cpu" and table.data.device.type == "cpu":
        return probe_ref(table, keys)
    _build.require_cuda("probe", table.data, keys)
    out = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    if out.numel() == 0:
        return out
    _build.launch("probe", keys.device, *kernel_table_args(table),
                  keys.data_ptr(), keys.numel(), out.data_ptr())
    return out
