"""Device meshes for the classify and counting paths (port of
hast_tpu/parallel/mesh.py).

The JAX mesh is single-controller: one process addresses a dp×tp grid of
devices, read batches split over dp and the marker table hash-sharded
over tp.  The port keeps that shape.  A :class:`Mesh` is a dp×tp grid of
torch devices in which a device may repeat: ``devices=["cuda:0"] * 4``
runs every shard's kernels and every collective's data movement on one
card, and ``devices=["cpu"] * 8`` runs the plain twins, as the JAX tests
run on 8 fake CPU devices.  Collectives are explicit: :func:`psum` copies
the shards' tensors to one device and sums them there, and the
all_to_all of :func:`sharded_count_chunk` copies row d of every shard's
buffer to shard d.

Per shard, on a card, the work is kernels:

  K13 vote_reads    pipeline/classify.py  votes, the shard's buckets only
  K15 tally_votes   pipeline/classify.py  votes into the barcode tally
  K14 route_kmers   here (csrc/route.cu)  k-mers into their owners' slots
  K5, K6, K12       DeviceCounter          the per-shard sort and fold
  K7, K8            DeviceCountTable       histogram, total, marker algebra

Over tp the port sums each shard's *votes* where JAX sums payloads
(mesh.py:139, :185).  A key sits in one slot of the table, so at most one
tp shard hits any window, for both slot formats, and the two sums agree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hast_tpu_torch.ops import _build
from hast_tpu_torch.ops import encode as E
from hast_tpu_torch.ops import hashtable as H
from hast_tpu_torch.ops import kmer_count as KC
from hast_tpu_torch.pipeline import classify as C


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A dp×tp grid of torch devices; devices[i][j] is shard (i, j)."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def dp(self) -> int:
        return len(self.devices)

    @property
    def tp(self) -> int:
        return len(self.devices[0])


def visible_devices() -> list[torch.device]:
    """The CUDA devices torch sees, cuda:0 ... cuda:n-1."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, tp: int = 1,
              devices=None) -> Mesh:
    """The first n_devices of devices (default: the visible cards) as a
    (n_devices // tp, tp) grid.  A list may name a device more than once."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else visible_devices())]
    n = n_devices or len(devices)
    if n % tp:
        raise ValueError(f"{n} devices do not split into tp = {tp}")
    if n > len(devices):
        raise ValueError(f"a mesh of {n} devices needs more than the "
                         f"{len(devices)} given: {[str(d) for d in devices]}")
    grid = [tuple(devices[i * tp:(i + 1) * tp]) for i in range(n // tp)]
    return Mesh(tuple(grid))


def choose_tp(table_bytes: int, n_devices: int,
              hbm_budget_bytes: int | None = None) -> int:
    """The smallest power-of-two tp whose table shard fits the budget
    (default 4 GiB, the JAX package's), at most n_devices: replicating
    the table is fastest, sharding it saves device memory."""
    if hbm_budget_bytes is None:
        hbm_budget_bytes = 4 << 30
    tp = 1
    while tp < n_devices and table_bytes // tp > hbm_budget_bytes:
        tp *= 2
    return tp


def shard_table(mesh: Mesh, table: H.KmerTable) -> list[list[torch.Tensor]]:
    """The table's rows split evenly over tp: shards[i][j] holds rows
    [j * R, (j + 1) * R), R = n_buckets / tp, on device (i, j).  Rows are
    hash-ordered, so a row split is a hash split.  A device that holds
    the same slice for several dp rows keeps one copy."""
    if table.n_buckets % mesh.tp:
        raise ValueError(f"{table.n_buckets} table rows do not split over "
                         f"tp = {mesh.tp}")
    rows = table.n_buckets // mesh.tp
    placed: dict = {}
    shards = []
    for row in mesh.devices:
        out = []
        for j, dev in enumerate(row):
            key = (str(dev), j)
            if key not in placed:
                placed[key] = table.data[j * rows:(j + 1) * rows].to(
                    dev).contiguous()
            out.append(placed[key])
        shards.append(out)
    return shards


def psum(parts: list[torch.Tensor], device) -> torch.Tensor:
    """The sum of tensors held on several devices, on device."""
    total = parts[0].to(device, copy=True)
    for p in parts[1:]:
        total += p.to(device)
    return total


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def _votes_over_tp(mesh: Mesh, tables, i: int, reads: torch.Tensor,
                   lengths: torch.Tensor, packed: bool, k: int,
                   max_probe: int, n_buckets: int, fmt: str) -> torch.Tensor:
    """K13 on dp row i's reads at each of its tp shards, summed on device
    (i, 0).  Packed votes are uint16 bits in int16 and sum as uint16."""
    parts = []
    for j, dev in enumerate(mesh.devices[i]):
        data = tables[i][j]
        table = H.KmerTable(data, n_buckets, max_probe, k, 0, (), fmt)
        parts.append(C.vote_reads(table, reads.to(dev), lengths.to(dev),
                                  packed, row_lo=j * data.shape[0]))
    if len(parts) == 1:
        return parts[0]
    if not packed:
        return psum(parts, mesh.devices[i][0])
    wide = [p.to(torch.int32) & 0xFFFF for p in parts]
    return C._int16_bits(psum(wide, mesh.devices[i][0]) & 0xFFFF)


def sharded_vote_step(mesh: Mesh, tables, packed, lengths, k: int,
                      max_probe: int, n_buckets: int,
                      fmt: str = "full") -> torch.Tensor:
    """Per-read votes on a dp×tp mesh: (S, B, L/4) packed reads and
    (S, B) lengths (tensors or numpy) -> (S, B, 2) int16 holding the
    uint16 votes, on device (0, 0).  Reads split over dp on dim 1, the
    table (:func:`shard_table`) over tp; K13 per shard, a sum over tp."""
    packed, lengths = _as_tensor(packed), _as_tensor(lengths)
    s, b, lp = packed.shape
    if b % mesh.dp:
        raise ValueError(f"{b} reads a batch do not split over dp = "
                         f"{mesh.dp}")
    w = b // mesh.dp
    out = []
    for i in range(mesh.dp):
        rows = packed[:, i * w:(i + 1) * w].reshape(s * w, lp).contiguous()
        lens = lengths[:, i * w:(i + 1) * w].reshape(s * w).contiguous()
        votes = _votes_over_tp(mesh, tables, i, rows, lens, True, k,
                               max_probe, n_buckets, fmt)
        out.append(votes.reshape(s, w, 2).to(mesh.devices[0][0]))
    return torch.cat(out, dim=1)


def sharded_classify_step(mesh: Mesh, tables, seqs_u8, lengths, barcode_ids,
                          has_n, k: int, max_probe: int, n_buckets: int,
                          num_barcodes: int,
                          fmt: str = "full") -> torch.Tensor:
    """One whole step on a dp×tp mesh: ASCII reads (B, L), lengths, barcode
    ids and N flags (B,) split over dp -> the (num_barcodes, 3) int32
    tally (hap0 votes, hap1 votes, unknown) on device (0, 0).  Per dp row:
    K13 at each tp shard, a sum over tp, K15 into its device's tally (one
    zeroed tally a distinct device, which every dp row there adds into:
    int32 sums are exact in any order); then a sum over the devices."""
    seqs_u8, lengths = _as_tensor(seqs_u8), _as_tensor(lengths)
    barcode_ids, has_n = _as_tensor(barcode_ids), _as_tensor(has_n)
    b = seqs_u8.shape[0]
    if b % mesh.dp:
        raise ValueError(f"{b} reads do not split over dp = {mesh.dp}")
    w = b // mesh.dp
    tallies: dict = {}
    for i in range(mesh.dp):
        part = slice(i * w, (i + 1) * w)
        votes = _votes_over_tp(mesh, tables, i, seqs_u8[part].contiguous(),
                               lengths[part].contiguous(), False, k,
                               max_probe, n_buckets, fmt)
        dev = mesh.devices[i][0]
        if dev not in tallies:
            tallies[dev] = torch.zeros((num_barcodes, 3), dtype=torch.int32,
                                       device=dev)
        C.tally_votes(votes, has_n[part].contiguous().to(dev),
                      barcode_ids[part].contiguous().to(dev), num_barcodes,
                      out=tallies[dev])
    return psum(list(tallies.values()), mesh.devices[0][0])


# ---------------------------------------------------------------------------
# stage 00: hash-range-sharded count tables
# ---------------------------------------------------------------------------
#
# As in the JAX package, stage 00 shards its count tables over dp by HASH
# RANGE: every shard holds the same hash range of both parents, so the
# marker algebra runs per shard with no communication, and only the
# histograms and totals are summed (on the host, in int64: the count-1
# bin of a human parent can pass 2^31 across shards).


def route_kmers_ref(seqs: torch.Tensor, lengths: torch.Tensor, k: int,
                    dp: int, cap: int):
    """Plain PyTorch twin of :func:`route_kmers`.  Its rows hold their keys
    in ascending order, as JAX's (dest, hi, lo) sort leaves them, and a
    row past its cap keeps its smallest keys."""
    _build.TWIN_CALLS["route_kmers_ref"] += 1
    dev = seqs.device
    keys, valid = E.code_windows_ref((seqs.to(torch.int64) >> 1) & 3,
                                        lengths, k)
    n_win = keys.shape[1]
    if n_win:
        good = torch.from_numpy(KC._ACGT).to(dev)[seqs.to(torch.int64)]
        for j in range(k):
            valid &= good[:, j:j + n_win]
    keys = keys[valid]
    if dp == 1:
        dest = torch.zeros_like(keys)
    else:
        h = H._kmer_hash_t(0, keys >> 32, keys & 0xFFFFFFFF)
        dest = (h // ((1 << 32) // dp)).clamp(max=dp - 1)
    keys, order = torch.sort(keys, stable=True)
    dest, order = torch.sort(dest[order], stable=True)
    keys = keys[order]
    start = torch.searchsorted(dest, torch.arange(dp, device=dev))
    offset = torch.arange(keys.numel(), device=dev) - start[dest]
    keep = offset < cap
    buf = torch.full((dp * cap,), KC.SENT, dtype=torch.int64, device=dev)
    buf[(dest * cap + offset)[keep]] = keys[keep]
    return buf.reshape(dp, cap), (~keep).sum()


def route_batch_ref(seqs: torch.Tensor, lengths: torch.Tensor, k: int,
                    dp: int, cap: int, n_src: int):
    """Plain PyTorch twin of :func:`route_batch`: :func:`route_kmers_ref`
    for each source shard, then the receivers' concatenation."""
    _build.TWIN_CALLS["route_batch_ref"] += 1
    w = seqs.shape[0] // n_src
    parts = [route_kmers_ref(seqs[s * w:(s + 1) * w],
                             lengths[s * w:(s + 1) * w], k, dp, cap)
             for s in range(n_src)]
    return (torch.cat([buf for buf, _ in parts], dim=1),
            torch.stack([d for _, d in parts]))


def route_batch(seqs: torch.Tensor, lengths: torch.Tensor, k: int, dp: int,
                cap: int, n_src: int):
    """The canonical k-mers of n_src source shards routed to their owners
    and laid out as the receivers hold them (K14, one launch).

    seqs: (n_src * w, L) uint8 ASCII reads, rows [s * w, (s + 1) * w) of
    source shard s; lengths: (n_src * w,) int32.  A window is a key iff
    it lies inside its read and its k bytes are A, C, G or T in either
    case.  A key goes to shard min(kmer_hash(hi, lo) // (2^32 // dp),
    dp - 1) (0 when dp = 1).  Returns (recv, dropped): recv (dp, n_src *
    cap) int64, whose segment recv[d, s * cap:(s + 1) * cap] holds, in no
    fixed order, the keys of source s bound for shard d and then
    INT64_MAX, so that recv[d] is all that shard d receives; dropped
    (n_src,) int64 counts each source's keys that found their segment
    full, sum over d of max(0, keys_sd - cap).  CPU tensors take the
    twin; CUDA tensors launch the kernel.
    """
    E._check_k(k)
    if seqs.dtype != torch.uint8 or seqs.dim() != 2:
        raise ValueError(f"seqs must be (n, L) uint8, got "
                         f"{tuple(seqs.shape)} {seqs.dtype}")
    if lengths.dtype != torch.int32 or lengths.shape != seqs.shape[:1]:
        raise ValueError(f"lengths must be ({seqs.shape[0]},) int32")
    if not 1 <= dp <= 2048 or cap < 0:
        raise ValueError(f"route_kmers: dp {dp} outside [1, 2048] or cap "
                         f"{cap} < 0")
    if n_src < 1 or seqs.shape[0] % n_src:
        raise ValueError(f"route_kmers: {seqs.shape[0]} reads do not split "
                         f"into {n_src} source shards")
    if seqs.device.type == "cpu":
        return route_batch_ref(seqs, lengths, k, dp, cap, n_src)
    _build.require_cuda("route_kmers", seqs, lengths)
    dev = seqs.device
    n, stride = seqs.shape
    recv = torch.empty((dp, n_src * cap), dtype=torch.int64, device=dev)
    counts = torch.empty(n_src * (dp + 1), dtype=torch.int64, device=dev)
    _build.launch("route_kmers", dev, seqs.data_ptr(), lengths.data_ptr(),
                  n // n_src, n_src, stride, k, dp, cap, recv.data_ptr(),
                  counts.data_ptr())
    return recv, counts[n_src * dp:]


def route_kmers(seqs: torch.Tensor, lengths: torch.Tensor, k: int, dp: int,
                cap: int):
    """One dp shard's canonical k-mers routed to their owners' rows: the
    one-source form of :func:`route_batch` (K14).  Returns (buf,
    dropped): buf (dp, cap) int64 whose row d holds, in no fixed order,
    the keys bound for shard d and then INT64_MAX; dropped, a 0-d int64
    tensor, counts the keys that found their row full, sum over d of
    max(0, keys_d - cap).
    """
    buf, dropped = route_batch(seqs, lengths, k, dp, cap, 1)
    return buf, dropped[0]


def _rows_on(t: torch.Tensor, shards: list[int], w: int,
             dev: torch.device) -> torch.Tensor:
    """The rows of the given shards (w a shard) on dev, in one copy: from
    pinned memory without waiting when t is on the host and dev a card."""
    lo, hi = shards[0], shards[-1] + 1
    rows = (t[lo * w:hi * w] if shards == list(range(lo, hi)) else
            torch.cat([t[i * w:(i + 1) * w] for i in shards]))
    if rows.device == dev:
        return rows.contiguous()
    if rows.device.type == "cpu" and dev.type == "cuda":
        return rows.pin_memory().to(dev, non_blocking=True)
    return rows.to(dev).contiguous()


def sharded_count_chunk(mesh: Mesh, seqs_u8, lengths, k: int,
                        slack: int = 2):
    """Distributed k-mer counting step (the JAX `sharded_count_chunk`):
    (B, L) ASCII reads split over dp -> each shard's received keys,
    sorted, and each source shard's drop count.

    Each distinct device of the mesh routes the shards it holds with one
    K14 launch (:func:`route_batch`), cap = n if slack >= dp else min(n,
    n // dp * slack) for a shard's n windows.  When every shard is on one
    device that launch writes each key straight into its receiver's slot
    and receiver d's keys are row d of its buffer; otherwise receiver d
    concatenates row d of every device's buffer (the all_to_all's
    copies).  K5 sorts the dp * cap keys there (INT64_MAX pads last).
    Returns (keys, dropped): keys[d] (dp * cap,) int64 on shard d's
    device, dropped[d] a 0-d int64 tensor on it.  When nothing is
    dropped, keys[d] equals JAX's shard d (its sentinel pair read as
    INT64_MAX).  A drop leaves the result to be thrown away.
    """
    dp = mesh.dp
    seqs_u8, lengths = _as_tensor(seqs_u8), _as_tensor(lengths)
    b, L = seqs_u8.shape
    if b % dp:
        raise ValueError(f"{b} reads do not split over dp = {dp}")
    w = b // dp
    n = w * max(L - k + 1, 0)
    cap = n if slack >= dp else min(n, n // dp * slack)
    groups: dict = {}
    for i, row in enumerate(mesh.devices):
        groups.setdefault(row[0], []).append(i)
    bufs, dropped = [], [None] * dp
    for dev, shards in groups.items():
        buf, lost = route_batch(_rows_on(seqs_u8, shards, w, dev),
                                _rows_on(lengths, shards, w, dev), k, dp,
                                cap, len(shards))
        bufs.append(buf)
        for j, i in enumerate(shards):
            dropped[i] = lost[j]
    keys = []
    for d, row in enumerate(mesh.devices):
        recv = bufs[0][d] if len(bufs) == 1 else torch.cat(
            [buf[d].to(row[0]) for buf in bufs])
        keys.append(KC.sort_pairs(recv, None, k)[0])
    return keys, dropped


class MeshCountTable:
    """A hash-range-sharded count table: one DeviceCountTable a dp shard,
    on that shard's device."""

    def __init__(self, shards: list[KC.DeviceCountTable], k: int):
        self.shards = shards
        self.k = k

    @property
    def n_valid(self) -> np.ndarray:
        """(dp,) distinct keys per shard."""
        return np.asarray([s.n_valid for s in self.shards], np.int64)

    @property
    def n_distinct(self) -> int:
        return int(self.n_valid.sum())

    @property
    def total(self) -> int:
        """The sum of the counts: K7's int64 total per shard, summed."""
        return sum(s.total for s in self.shards)

    def histo(self, low: int = 1, high: int = 10000) -> np.ndarray:
        """The jellyfish-histo bins of the whole table: K7 per shard, the
        int64 bins summed on the host."""
        return np.sum([s.histo(low, high) for s in self.shards], axis=0,
                      dtype=np.int64)

    def fetch(self) -> KC.CountTable:
        """The whole table on the host, in key order (tests)."""
        parts = [s.fetch() for s in self.shards]
        words = np.concatenate([p.words for p in parts])
        counts = np.concatenate([p.counts for p in parts])
        order = np.argsort(words, kind="stable")
        return KC.CountTable(words[order], counts[order], self.k)


class MeshDeviceCounter:
    """Streaming mesh counter: feed :func:`sharded_count_chunk`'s keys, fold
    each shard in its device's memory, finalize to a MeshCountTable.  One
    :class:`DeviceCounter` a shard (K5, K6 and K12 in its folds; a
    chunk's count-1 payload is made in the fold, as JAX's
    `_ones_like_sharded`)."""

    def __init__(self, mesh: Mesh, k: int):
        self.k = k
        self.counters = [KC.DeviceCounter(k, row[0]) for row in mesh.devices]

    def add_chunk(self, keys: list[torch.Tensor]) -> None:
        """keys[d]: shard d's keys, INT64_MAX pads included."""
        for counter, part in zip(self.counters, keys):
            counter.add_sorted_chunk(part)

    def finalize_mesh(self) -> MeshCountTable:
        return MeshCountTable([c.finalize_device() for c in self.counters],
                              self.k)


def mesh_marker_algebra(pat: MeshCountTable, mat: MeshCountTable,
                        p_lower: int, p_upper: int,
                        m_lower: int, m_upper: int):
    """unique ∩ count-range per parent, shard by shard (K8 on each pair of
    shards: they hold the same hash range), and only the kept keys come
    to the host.  K8 takes runs of different lengths, so no shard is
    padded.  Shards are hash ranges, not key ranges: the words get one
    host sort.  Returns (paternal, maternal) ascending uint64."""
    p_parts, m_parts = [], []
    for p, m in zip(pat.shards, mat.shards):
        pw, mw = KC.device_marker_algebra(p, m, p_lower, p_upper, m_lower,
                                          m_upper)
        p_parts.append(pw)
        m_parts.append(mw)
    return np.sort(np.concatenate(p_parts)), np.sort(np.concatenate(m_parts))
