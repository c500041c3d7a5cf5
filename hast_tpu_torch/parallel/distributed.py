"""Multi-process bring-up and mesh stage-00 counting (port of
hast_tpu/parallel/distributed.py).

The reference scales out by users running file shards by hand and
reducing them offline (mergeResult.cpp:116-129, meryl's union-sum).  The
JAX package automates that shape, and the port keeps it: each process
classifies or counts its own round-robin share of the input files on its
own devices, and one reduce at the end gives every process the same
global tally or count table; process 0 writes the output.  Where JAX
brings the processes up with ``jax.distributed`` and allgathers host
arrays, the port uses ``torch.distributed`` with the gloo backend,
addressed by ``HAST_COORDINATOR`` (host:port of rank 0),
``HAST_NUM_PROCESSES`` and ``HAST_PROCESS_ID``; the reduce moves host
arrays only, so gloo serves CPUs and cards alike.

Stage 00 on a mesh (:func:`count_files_mesh_device`,
:func:`build_unshared_markers_mesh`) shards the count tables by hash
range over dp (parallel/mesh.py); :func:`count_files_sharded` routes the
same way and reduces the shards on the host.
"""

from __future__ import annotations

import os
import sys
import tempfile
import types
from typing import Sequence

import numpy as np
import torch

from hast_tpu_torch.io import fastq as FQ
from hast_tpu_torch.ops import kmer_count as KC
from hast_tpu_torch.parallel import mesh as PM

# batches between a mesh count's dispatch and the read of its drop counts
CHECK_LAG = 4


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """torch.distributed (gloo) bring-up from the arguments or the HAST_*
    environment; nothing to do for one process or when already up."""
    coordinator_address = coordinator_address or os.environ.get(
        "HAST_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("HAST_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("HAST_PROCESS_ID", "0"))
    if num_processes <= 1 or torch.distributed.is_initialized():
        return
    if not coordinator_address:
        raise ValueError("HAST_NUM_PROCESSES > 1 needs HAST_COORDINATOR "
                         "(host:port of process 0)")
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def process_count() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_initialized() else 0


def shard_paths(paths: Sequence[str]) -> list[str]:
    """This process's input files: every process_count()-th, round-robin."""
    n, i = process_count(), process_index()
    return [p for j, p in enumerate(paths) if j % n == i]


def _dropped(dropped: list[torch.Tensor]) -> int:
    return sum(int(d) for d in dropped)


def count_files_sharded(mesh: PM.Mesh, paths: Sequence[str], k: int,
                        batch_size: int = FQ.DEFAULT_BATCH) -> KC.CountTable:
    """Count k-mers on a mesh into a host table: each batch's reads split
    over dp, route to their hash-range owners and sort there
    (sharded_count_chunk); every shard's keys come to the host and
    union-sum.  A batch whose keys overflow a destination's slots is
    retried in halves; the rows that do not divide over dp count on the
    mesh's first device."""
    counter = KC.Counter(k)
    for path in paths:
        for batch in FQ.sequence_batches(path, k, batch_size):
            _count_batch_sharded(mesh, counter, batch.seqs, batch.lengths,
                                 k)
    return counter.finalize()


def _count_batch_sharded(mesh: PM.Mesh, counter: KC.Counter, seqs, lengths,
                         k: int, depth: int = 0) -> None:
    dp = mesh.dp
    b = seqs.shape[0]
    rows = (b // dp) * dp
    if rows:
        keys, dropped = PM.sharded_count_chunk(mesh, seqs[:rows],
                                               lengths[:rows], k)
        if _dropped(dropped):
            # skewed hash split: halve the batch (doubles slack) and retry
            if depth >= 6 or rows <= dp:
                raise RuntimeError(
                    "k-mers dropped by all_to_all capacity even at a batch "
                    f"of {rows} reads; pathological hash skew")
            half = ((rows // 2) // dp) * dp or dp
            _count_batch_sharded(mesh, counter, seqs[:half], lengths[:half],
                                 k, depth + 1)
            _count_batch_sharded(mesh, counter, seqs[half:rows],
                                 lengths[half:rows], k, depth + 1)
        else:
            for part in keys:
                counter.add_sorted_chunk(part.cpu().numpy())
    if rows < b:
        counter.add_table(KC.count_batches(
            [types.SimpleNamespace(seqs=seqs[rows:], lengths=lengths[rows:])],
            k, device=mesh.devices[0][0]))


def _allgather_u8(arr: np.ndarray) -> list[np.ndarray]:
    """Every process's variable-length uint8 array (gloo all_gather of the
    sizes, then of the arrays padded to the largest)."""
    dist = torch.distributed
    n = dist.get_world_size()
    arr = np.ascontiguousarray(arr, np.uint8)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(sizes, torch.tensor([arr.size], dtype=torch.int64))
    sizes = [int(s) for s in sizes]
    buf = torch.zeros(max(1, max(sizes)), dtype=torch.uint8)
    buf[:arr.size] = torch.from_numpy(arr)
    out = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(out, buf)
    return [o.numpy()[:s] for o, s in zip(out, sizes)]


def allgather_tally(tally) -> None:
    """Fold every process's BarcodeTally into every process's (in place):
    the automated form of mergeResult's offline shard reduce.  Nothing
    to do for one process."""
    if process_count() == 1:
        return
    names, counts = tally.finalize()
    width = names.dtype.itemsize if names.size else 1
    header = np.asarray([names.size, width], np.int64).view(np.uint8)
    payload = np.concatenate([
        header, np.ascontiguousarray(names).view(np.uint8).reshape(-1),
        np.ascontiguousarray(counts, np.int64).view(np.uint8).reshape(-1)])
    me = process_index()
    for i, buf in enumerate(_allgather_u8(payload)):
        if i == me:
            continue
        n, w = (int(x) for x in buf[:16].view(np.int64))
        names_i = buf[16:16 + n * w].copy().view(f"S{w}")
        # copied before the int64 view: the slice may be unaligned
        counts_i = np.frombuffer(buf[16 + n * w:16 + n * w + n * 24]
                                 .tobytes(), np.int64).reshape(n, 3)
        tally.merge_names(names_i, counts_i)


def allgather_count_table(table: KC.CountTable) -> KC.CountTable:
    """Union-sum every process's CountTable (meryl union-sum over the
    processes); the table itself for one process."""
    if process_count() == 1:
        return table
    me = process_index()
    payload = np.concatenate([
        np.asarray([table.words.size], np.int64).view(np.uint8),
        np.ascontiguousarray(table.words, np.uint64).view(np.uint8),
        np.ascontiguousarray(table.counts, np.int64).view(np.uint8)])
    counter = KC.Counter(table.k)
    counter.add_table(table)
    for i, buf in enumerate(_allgather_u8(payload)):
        if i == me:
            continue
        n = int(buf[:8].view(np.int64)[0])
        words = np.frombuffer(buf[8:8 + n * 8].tobytes(), np.uint64)
        counts = np.frombuffer(buf[8 + n * 8:8 + n * 16].tobytes(), np.int64)
        counter.add_table(KC.CountTable(words, counts, table.k))
    return counter.finalize()


def count_files_mesh_device(mesh: PM.Mesh, paths: Sequence[str], k: int,
                            batch_size: int = FQ.DEFAULT_BATCH
                            ) -> PM.MeshCountTable:
    """Count k-mers into a hash-range-sharded table that stays on the
    mesh's devices: only the all_to_all's copies move keys.

    A batch's keys join the counter only once its drop counts, read
    CHECK_LAG batches later (the device has long finished it), are zero.
    A batch that overflowed a destination's slots is dispatched again
    whole with twice the slack, up to dp, where the cap holds every key
    and nothing can drop: halving cannot cure skew, since the cap scales
    with the batch."""
    dp = mesh.dp
    counter = PM.MeshDeviceCounter(mesh, k)
    pending: list = []   # (dropped, seqs, lengths, keys)

    def settle(entry):
        dropped, seqs, lengths, keys = entry
        slack = 2
        while _dropped(dropped):
            if slack >= dp:
                raise AssertionError(
                    "k-mers dropped at full per-destination capacity")
            slack = min(2 * slack, dp)
            print(f"  [mesh count] all_to_all overflow: retrying batch "
                  f"with slack={slack}", file=sys.stderr)
            keys, dropped = PM.sharded_count_chunk(mesh, seqs, lengths, k,
                                                   slack)
        counter.add_chunk(keys)

    for path in paths:
        for batch in FQ.sequence_batches(path, k, batch_size):
            seqs, lengths = batch.seqs, batch.lengths
            if seqs.shape[0] % dp:
                pad = dp - seqs.shape[0] % dp
                seqs = np.concatenate(
                    [seqs, np.zeros((pad, seqs.shape[1]), np.uint8)])
                lengths = np.concatenate([lengths, np.zeros(pad, np.int32)])
            keys, dropped = PM.sharded_count_chunk(mesh, seqs, lengths, k, 2)
            pending.append((dropped, seqs, lengths, keys))
            if len(pending) > CHECK_LAG:
                settle(pending.pop(0))
    for entry in pending:
        settle(entry)
    return counter.finalize_mesh()


def build_unshared_markers_mesh(
        mesh: PM.Mesh, paternal: Sequence[str], maternal: Sequence[str],
        out_dir: str = ".", k: int = 21, auto_bounds: bool = False,
        p_lower: int = 9, p_upper: int = 33,
        m_lower: int = 9, m_upper: int = 33,
        batch_size: int = FQ.DEFAULT_BATCH, log=None) -> dict[str, str]:
    """Stage 00 on a mesh: both parents' count tables hash-range-sharded
    over dp (:func:`count_files_mesh_device`), histograms summed over the
    shards, the marker algebra shard by shard, and only the markers come
    to the host.  The same histo, bounds and .mer files as the
    single-device engines, byte for byte.  Single-process meshes only;
    across processes, shard the files (:func:`count_files_multihost`)."""
    from hast_tpu_torch.pipeline import markers as M
    log = log or sys.stderr
    j = lambda name: os.path.join(out_dir, name)  # noqa: E731
    print("extract unique mers (mesh-sharded device count tables) ...",
          file=log)
    mat = count_files_mesh_device(mesh, maternal, k, batch_size)
    pat = count_files_mesh_device(mesh, paternal, k, batch_size)
    for name, t in (("maternal", mat), ("paternal", pat)):
        print(f"  {name}: {t.n_distinct} distinct / {t.total} total "
              f"{k}-mers", file=log)
    m_rows = M._rows_from_hist(mat.histo())
    p_rows = M._rows_from_hist(pat.histo())
    M._write_histos(m_rows, p_rows, auto_bounds, j)
    m_lower, m_upper, p_lower, p_upper = M._bounds_in_use(
        m_rows, p_rows, auto_bounds, (m_lower, m_upper, p_lower, p_upper),
        log)
    p_words, m_words = PM.mesh_marker_algebra(pat, mat, p_lower, p_upper,
                                              m_lower, m_upper)
    paths = {"paternal": j("paternal.unique.filter.mer"),
             "maternal": j("maternal.unique.filter.mer")}
    n_p = KC.dump_words(p_words, k, paths["paternal"])
    n_m = KC.dump_words(m_words, k, paths["maternal"])
    print(f"final paternal unique kmer is : {n_p}", file=log)
    print(f"final maternal unique kmer is : {n_m}", file=log)
    return paths


def local_mesh(tp: int = 1, devices=None) -> PM.Mesh:
    """A dp×tp mesh over this process's devices (default: its cards)."""
    return PM.make_mesh(tp=tp, devices=devices)


def classify_fastqs_multihost(table, paths: Sequence[str],
                              batch_size: int = FQ.DEFAULT_BATCH,
                              tp: int = 1, device="cuda", devices=None):
    """Multi-process stage-01 classify: each process classifies its share
    of the files, with the table on device (tp = 1) or tp-sharded over
    its devices, and one reduce at the end gives every process the same
    global tally; process 0 is the one to write it.  With one process
    this is classify_fastqs and a reduce that does nothing."""
    from hast_tpu_torch.pipeline import classify as C
    local = shard_paths(list(paths))
    if not local:
        tally = C.BarcodeTally()
    elif tp > 1:
        tally = C.classify_fastqs_mesh(local_mesh(tp, devices), table, local,
                                       batch_size=batch_size)
    else:
        tally = C.classify_fastqs(table.to(device), local,
                                  batch_size=batch_size)
    allgather_tally(tally)
    return tally


def count_files_multihost(paths: Sequence[str], k: int,
                          batch_size: int = FQ.DEFAULT_BATCH,
                          use_mesh: bool = False, device="cuda",
                          devices=None) -> KC.CountTable:
    """Multi-process stage-00 counting: each process counts its share of
    the files (hash-range-sharded over its devices with use_mesh and more
    than one of them), then the union-sum over the processes.  Every
    process gets the same table."""
    from hast_tpu_torch.pipeline import markers as M
    local = shard_paths(list(paths))
    devices = devices if devices is not None else PM.visible_devices()
    if not local:
        table = KC.CountTable(np.zeros(0, np.uint64), np.zeros(0, np.int64),
                              k)
    elif use_mesh and len(devices) > 1:
        table = count_files_sharded(local_mesh(devices=devices), local, k,
                                    batch_size)
    else:
        with tempfile.TemporaryDirectory() as spill_dir:
            table = M.count_files(local, k, batch_size, device=device,
                                  spill_dir=spill_dir)
    return allgather_count_table(table)
