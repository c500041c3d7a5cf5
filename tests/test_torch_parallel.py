"""hast_tpu_torch.parallel against hast_tpu.parallel on the same inputs.

The JAX mesh runs on the 8 fake CPU devices of tests/conftest.py; the
port's mesh is ``make_mesh(devices=["cpu"] * n)``, where every shard runs
the kernels' plain twins.  Inputs are made from seeds with numpy and
handed to both; reads mix A, C, G, T with a, c, g, t, N, R and U, the
bytes that tell the three ASCII rules apart (K13 takes any byte, K14
ACGT in either case, K9 uppercase ACGT).  Everything is integers, so
the tolerance is exact equality; the JAX comparisons skip where JAX has
fewer devices than the grid (a run without tests/conftest.py).

Covered: K13's twin (vote_reads: vote_kernel, vote_kernel_multi,
vote_kernel_packed, owned bucket ranges; on planted reads and on
utils/synthetic.py read_tile_edge_batches), K15's (tally_votes, against
segment_sum's drop of out-of-range ids), K14's (route_kmers, through
sharded_count_chunk and its drop counts); sharded_classify_step and
sharded_vote_step at (dp, tp) in {(8, 1), (4, 2), (2, 4)} and both slot
formats; MeshCountTable, the overflow retry, count_files_sharded and
build_unshared_markers_mesh against the stage-00 goldens;
classify_fastqs_mesh and merge_phased_files against the stage-01
golden.  The `cuda` tests hold K13-K15 against their twins on the card.
"""

import io
import pathlib
import shutil

import numpy as np
import pytest
import torch

from hast_tpu_torch.ops import _build
from hast_tpu_torch.ops import encode as E
from hast_tpu_torch.ops import hashtable as H
from hast_tpu_torch.ops import kmer_count as KC
from hast_tpu_torch.parallel import distributed as D
from hast_tpu_torch.parallel import mesh as PM
from hast_tpu_torch.parallel import merge as PMerge
from hast_tpu_torch.pipeline import classify as C
from hast_tpu_torch.pipeline import markers as M
from hast_tpu_torch.utils import synthetic as S

ROOT = pathlib.Path(__file__).parent
GOLD = ROOT / "golden" / "stage01"
GOLD00 = ROOT / "golden" / "stage00"
E2E = ROOT / "golden" / "e2e"
ALPHABET = np.frombuffer(b"ACGTACGTACGTACGTacgtNRU", np.uint8)
GRIDS = [(8, 1), (4, 2), (2, 4)]
# a read whose windows all share one key: every key of a batch of them
# routes to one shard
SKEW = b"A" * 128


@pytest.fixture(autouse=True)
def one_thread():
    """The twins run many small torch ops a shard; beside other test
    workers, torch's intra-op threads only contend, so one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def jax_mesh(n: int, tp: int = 1):
    """hast_tpu's mesh of n devices, or a skip when JAX has fewer."""
    pytest.importorskip("jax")
    import jax
    from hast_tpu.parallel import mesh as JPM
    if len(jax.devices()) < n:
        pytest.skip(f"JAX sees {len(jax.devices())} devices, the grid needs "
                    f"{n}")
    return JPM.make_mesh(n, tp=tp)


def cpu_mesh(n: int, tp: int = 1) -> PM.Mesh:
    return PM.make_mesh(n, tp=tp, devices=["cpu"] * n)


def marker_words(seed: int, n: int, k: int) -> np.ndarray:
    hi, lo = E.canonical_kmers_np(
        np.random.default_rng(seed).integers(0, 4, (n, k), np.int32), k)
    return (hi[:, 0].astype(np.int64) << 32) | lo[:, 0]


def tables(seed: int, k: int, fmt: str = "auto", n: int = 4000):
    """(hast_tpu KmerTable, the port's copy on the CPU) of n random keys."""
    from hast_tpu.ops import hashtable as JH
    words = marker_words(seed, n, k)
    pay = np.random.default_rng(seed + 1).integers(1, 4, n).astype(np.uint32)
    ref = JH.build_table((words >> 32).astype(np.uint32),
                         (words & 0xFFFFFFFF).astype(np.uint32), pay, k,
                         set_sizes=(n, n), fmt=fmt)
    return ref, H.from_reference(ref.data, ref.n_buckets, ref.max_probe, k,
                                 ref.n_keys, ref.set_sizes, ref.fmt,
                                 device="cpu")


def port_table(seed: int, k: int, fmt: str, n: int = 4000) -> H.KmerTable:
    """The table of tables() built by the port alone (no jax needed)."""
    words = marker_words(seed, n, k)
    pay = np.random.default_rng(seed + 1).integers(1, 4, n).astype(np.uint32)
    return H.build_table((words >> 32).astype(np.uint32),
                         (words & 0xFFFFFFFF).astype(np.uint32), pay, k,
                         set_sizes=(n, n), fmt=fmt)


def planted_reads(seed: int, words: np.ndarray, k: int, b: int = 64,
                  L: int = 128):
    """(b, L) ASCII reads over ALPHABET with table keys planted, some in
    lowercase, lengths L or shorter (down to 0)."""
    rng = np.random.default_rng(seed)
    seqs = ALPHABET[rng.integers(0, ALPHABET.size, (b, L))]
    kmers = E.words_to_bytes(words[rng.integers(0, words.size, 2 * b)], k)
    for i, s in enumerate(kmers):
        p = rng.integers(0, L - k)
        seqs[i % b, p:p + k] = s | (0x20 if i % 5 == 0 else 0)
    lengths = np.full(b, L, np.int32)
    lengths[::5] = 70
    lengths[1:4] = (0, k - 1, k)
    return seqs, lengths


# ---------------------------------------------------------------------------
# K13: vote_reads and the vote_kernel* counterparts
# ---------------------------------------------------------------------------


def edge_reads(k: int, lp: int, words: np.ndarray):
    """The reads of read_tile_edge_batches: (ASCII seqs, packed, lengths)."""
    _, seqs, lengths, _, _ = S.read_tile_edge_batches(k + lp, k, lp,
                                                      words)[0]
    return seqs, E.pack_codes_np(seqs), lengths


def formats(k: int) -> tuple:
    return ("quot", "full") if k < 31 else ("full",)


def jax_votes(fn: str, ref, seqs, packed, lengths, k: int) -> np.ndarray:
    """(n, 2) votes of hast_tpu's vote_kernel, vote_kernel_multi (one
    slice) or vote_kernel_packed (one slice, uint16)."""
    import jax.numpy as jnp
    from hast_tpu.pipeline import classify as JC
    args = (k, ref.max_probe, ref.fmt)
    if fn == "vote_kernel":
        return np.stack([np.asarray(v) for v in JC.vote_kernel(
            jnp.asarray(ref.data), jnp.asarray(seqs), jnp.asarray(lengths),
            *args)], axis=-1)
    if fn == "vote_kernel_multi":
        return np.asarray(JC.vote_kernel_multi(
            jnp.asarray(ref.data), jnp.asarray(seqs[None]),
            jnp.asarray(lengths[None]), *args))[0]
    return np.asarray(JC.vote_kernel_packed(
        jnp.asarray(ref.data), jnp.asarray(packed[None]),
        jnp.asarray(lengths[None]), *args))[0]


def _vote_edges_vs_jax(fn: str, k: int):
    """fn's port on read_tile_edge_batches' reads at every stride of
    READ_EDGE_STRIDES_CPU, both table formats, against JAX's (a stride under k
    bases, which JAX refuses, votes nothing)."""
    pytest.importorskip("jax")
    votes = 0
    words = marker_words(k, 600, k)
    for fmt in formats(k):
        ref, table = tables(k, k, fmt, n=600)
        data = torch.from_numpy(np.asarray(ref.data).view(np.int32))
        args = (k, ref.max_probe, ref.fmt)
        for lp in S.READ_EDGE_STRIDES_CPU:
            seqs, packed, lengths = edge_reads(k, lp, words)
            lens = torch.from_numpy(lengths)
            if fn == "vote_kernel":
                got = torch.stack(C.vote_kernel(
                    data, torch.from_numpy(seqs), lens, *args), dim=-1)
            elif fn == "vote_kernel_multi":
                got = C.vote_kernel_multi(data, torch.from_numpy(seqs[None]),
                                          lens[None], *args)[0]
            else:
                got = C.vote_kernel_packed(
                    data, torch.from_numpy(packed[None]), lens[None],
                    *args)[0].view(torch.uint16)
            got = got.numpy()
            if 4 * lp < k:
                want = np.zeros_like(got)
            else:
                want = jax_votes(fn, ref, seqs, packed, lengths, k)
            np.testing.assert_array_equal(got, want, err_msg=f"{fmt} {lp}")
            votes += int(want.astype(np.int64).sum())
    assert votes > 0


@pytest.mark.parametrize("k,edges", [
    *(pytest.param(k, False, id=str(k)) for k in (15, 21, 31)),
    *(pytest.param(k, True, id=f"{k}-edges") for k in (15, 21, 31))])
@pytest.mark.parametrize("fn", ["vote_kernel", "vote_kernel_multi",
                                "vote_kernel_packed"])
def test_vote_kernels_match_jax(fn, k, edges):
    """Planted reads over ALPHABET; with edges, read_tile_edge_batches'
    reads at every stride in both table formats."""
    if edges:
        _vote_edges_vs_jax(fn, k)
        return
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from hast_tpu.pipeline import classify as JC
    ref, table = tables(k, k, n=600)
    seqs, lengths = planted_reads(k, marker_words(k, 600, k), k, b=96)
    data = torch.from_numpy(np.asarray(ref.data).view(np.int32))
    args = (k, ref.max_probe, ref.fmt)
    twin_calls = _build.TWIN_CALLS["vote_reads_ref"]
    if fn == "vote_kernel":
        want = np.stack([np.asarray(v) for v in JC.vote_kernel(
            jnp.asarray(ref.data), jnp.asarray(seqs), jnp.asarray(lengths),
            *args)], axis=-1)
        got = torch.stack(C.vote_kernel(data, torch.from_numpy(seqs),
                                        torch.from_numpy(lengths), *args),
                          dim=-1).numpy()
    elif fn == "vote_kernel_multi":
        s3, l3 = seqs.reshape(3, 32, -1), lengths.reshape(3, 32)
        want = np.asarray(JC.vote_kernel_multi(
            jnp.asarray(ref.data), jnp.asarray(s3), jnp.asarray(l3), *args))
        got = C.vote_kernel_multi(data, torch.from_numpy(s3),
                                  torch.from_numpy(l3), *args).numpy()
    else:
        p3 = E.pack_codes_np(seqs).reshape(3, 32, -1)
        l3 = lengths.reshape(3, 32)
        want = np.asarray(JC.vote_kernel_packed(
            jnp.asarray(ref.data), jnp.asarray(p3), jnp.asarray(l3), *args))
        got = C.vote_kernel_packed(data, torch.from_numpy(p3),
                                   torch.from_numpy(l3), *args).numpy()
        assert got.dtype == np.int16 and want.dtype == np.uint16
        got = got.view(np.uint16)
    assert _build.TWIN_CALLS["vote_reads_ref"] == twin_calls + 1
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


@pytest.mark.parametrize("fmt,edges", [
    pytest.param("full", False, id="full"),
    pytest.param("quot", False, id="quot"),
    pytest.param("full", True, id="full-edges"),
    pytest.param("quot", True, id="quot-edges")])
@pytest.mark.parametrize("tp", [2, 4])
def test_owned_ranges_sum_to_the_whole_table(tp, fmt, edges):
    """Each shard's votes over its own rows, summed over tp, are the whole
    table's votes, in both read forms; with edges, on
    read_tile_edge_batches' reads at every stride, and the whole table's
    votes are JAX's vote_kernel's (ASCII) and vote_kernel_packed's."""
    pytest.importorskip("jax")
    ref, table = tables(5, 21, fmt)
    words = marker_words(5, 4000, 21)
    rows = table.n_buckets // tp
    inputs = [planted_reads(6, words, 21)] if not edges else [
        edge_reads(21, lp, words)[::2] for lp in S.READ_EDGE_STRIDES_CPU]
    for seqs, lengths in inputs:
        for packed, reads in ((False, seqs), (True, E.pack_codes_np(seqs))):
            reads, lens = torch.from_numpy(reads), torch.from_numpy(lengths)
            whole = C.vote_reads(table, reads, lens, packed).to(torch.int64)
            parts = [C.vote_reads(
                H.KmerTable(table.data[j * rows:(j + 1) * rows],
                            table.n_buckets, table.max_probe, 21, 0, (),
                            table.fmt),
                reads, lens, packed, row_lo=j * rows).to(torch.int64)
                for j in range(tp)]
            assert torch.equal(sum(parts), whole)
            if not edges:
                assert int(whole.sum()) > 0 and all(int(p.sum())
                                                    for p in parts)
            elif seqs.shape[1] >= 21:
                want = jax_votes("vote_kernel_packed" if packed
                                 else "vote_kernel", ref, seqs,
                                 reads.numpy(), lengths, 21)
                np.testing.assert_array_equal(
                    whole.numpy(), want.astype(np.int64))
    if edges:
        assert int(whole.sum()) > 0


def test_vote_reads_checks_its_table_slice():
    table = port_table(5, 21, "full", n=200)
    reads = torch.zeros((2, 8), dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int32)
    half = H.KmerTable(table.data[:table.n_buckets // 2], table.n_buckets,
                       2, 21, 0, (), "full")
    with pytest.raises(ValueError):
        C.vote_reads(half, reads, lens, True)            # no row_lo
    with pytest.raises(ValueError):
        C.vote_reads(half, reads, lens, True, row_lo=table.n_buckets)


# ---------------------------------------------------------------------------
# K15: tally_votes
# ---------------------------------------------------------------------------


def test_tally_votes_matches_segment_sum():
    """ids -7, -1, num_barcodes and beyond are dropped, as segment_sum
    drops them."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    n, nb = 3000, 50
    votes = rng.integers(0, 6, (n, 2)).astype(np.int32)
    votes[rng.random(n) < 0.3] = 0
    has_n = rng.random(n) < 0.1
    ids = rng.integers(-8, nb + 8, n).astype(np.int32)
    v0 = np.where(has_n, 0, votes[:, 0])
    v1 = np.where(has_n, 0, votes[:, 1])
    unk = (has_n | ((v0 == 0) & (v1 == 0))).astype(np.int32)
    want = np.asarray(jax.ops.segment_sum(
        jnp.asarray(np.stack([v0, v1, unk], -1)), jnp.asarray(ids),
        num_segments=nb))
    got = C.tally_votes(torch.from_numpy(votes), torch.from_numpy(has_n),
                        torch.from_numpy(ids), nb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert ((ids < 0) | (ids >= nb)).any() and want.sum() > 0


def tally_inputs(seed: int, n: int, nb: int, sorted_ids: bool):
    """K15's inputs as tensors: votes, N flags and barcode ids, random or
    in stLFR's barcode runs (utils/synthetic.py barcode_sorted_ids)."""
    rng = np.random.default_rng(seed)
    votes = rng.integers(0, 9, (n, 2)).astype(np.int32)
    votes[rng.random(n) < 0.3] = 0
    has_n = rng.random(n) < 0.05
    ids = (S.barcode_sorted_ids(seed, n, nb) if sorted_ids
           else rng.integers(-3, nb + 3, n).astype(np.int32))
    return (torch.from_numpy(votes), torch.from_numpy(has_n),
            torch.from_numpy(ids))


@pytest.mark.parametrize("sorted_ids", [False, True])
def test_tally_votes_out_adds_into_a_given_tally(sorted_ids):
    """With out=, the twin adds into the given tally: two halves tallied
    into one tally equal the two separate tallies summed; a tally of the
    wrong shape, type or device is refused."""
    n, nb = 5000, 300
    votes, has_n, ids = tally_inputs(13, n, nb, sorted_ids)
    h = n // 2
    parts = [C.tally_votes(votes[s], has_n[s], ids[s], nb)
             for s in (slice(0, h), slice(h, n))]
    out = torch.zeros((nb, 3), dtype=torch.int32)
    for s in (slice(0, h), slice(h, n)):
        assert C.tally_votes(votes[s], has_n[s], ids[s], nb, out=out) is out
    assert torch.equal(out, parts[0] + parts[1])
    assert torch.equal(out, C.tally_votes(votes, has_n, ids, nb))
    assert int(out.sum()) > 0
    for bad in (torch.zeros((nb + 1, 3), dtype=torch.int32),
                torch.zeros((nb, 3), dtype=torch.int64),
                torch.zeros((nb, 3), dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError, match="out must be"):
            C.tally_votes(votes, has_n, ids, nb, out=bad)


# ---------------------------------------------------------------------------
# the mesh's classify steps
# ---------------------------------------------------------------------------


def _classify_inputs(k: int = 21):
    seqs, lengths = planted_reads(2, marker_words(1, 4000, k), k)
    rng = np.random.default_rng(3)
    has_n = np.zeros(seqs.shape[0], bool)
    has_n[[3, 17]] = True
    bids = rng.integers(0, 10, seqs.shape[0]).astype(np.int32)
    bids[[5, 9, 40]] = (-1, 10, 13)     # dropped by segment_sum
    return seqs, lengths, bids, has_n


@pytest.mark.parametrize("fmt", ["full", "quot"])
@pytest.mark.parametrize("dp,tp", GRIDS)
def test_sharded_classify_step_matches_jax(dp, tp, fmt):
    import jax.numpy as jnp
    jmesh = jax_mesh(dp * tp, tp)
    from hast_tpu.parallel import mesh as JPM
    ref, table = tables(1, 21, fmt)
    assert ref.fmt == fmt
    seqs, lengths, bids, has_n = _classify_inputs()
    want = np.asarray(JPM.sharded_classify_step(
        jmesh, JPM.shard_table(jmesh, ref), jnp.asarray(seqs),
        jnp.asarray(lengths), jnp.asarray(bids), jnp.asarray(has_n), 21,
        ref.max_probe, ref.n_buckets, 10, fmt=fmt))
    mesh = cpu_mesh(dp * tp, tp)
    got = PM.sharded_classify_step(
        mesh, PM.shard_table(mesh, table), seqs, lengths, bids, has_n, 21,
        table.max_probe, table.n_buckets, 10, fmt=fmt)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:, :2].sum() > 0


@pytest.mark.parametrize("fmt", ["full", "quot"])
@pytest.mark.parametrize("dp,tp", GRIDS)
def test_sharded_vote_step_matches_jax(dp, tp, fmt):
    import jax.numpy as jnp
    jmesh = jax_mesh(dp * tp, tp)
    from hast_tpu.parallel import mesh as JPM
    ref, table = tables(1, 21, fmt)
    seqs, lengths = planted_reads(4, marker_words(1, 4000, 21), 21, b=64)
    packed = E.pack_codes_np(seqs).reshape(2, 32, -1)
    lengths = lengths.reshape(2, 32)
    want = np.asarray(JPM.sharded_vote_step(
        jmesh, JPM.shard_table(jmesh, ref), jnp.asarray(packed),
        jnp.asarray(lengths), 21, ref.max_probe, ref.n_buckets, fmt=fmt))
    mesh = cpu_mesh(dp * tp, tp)
    got = PM.sharded_vote_step(mesh, PM.shard_table(mesh, table), packed,
                               lengths, 21, table.max_probe, table.n_buckets,
                               fmt=fmt)
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)
    assert want.sum() > 0


def test_make_mesh_and_shards():
    mesh = cpu_mesh(8, tp=2)
    assert (mesh.dp, mesh.tp) == (4, 2)
    assert mesh.devices[3][1] == torch.device("cpu")
    with pytest.raises(ValueError):
        PM.make_mesh(4, tp=2, devices=["cpu"] * 3)     # more than given
    with pytest.raises(ValueError):
        PM.make_mesh(6, tp=4, devices=["cpu"] * 8)     # 6 % 4
    table = port_table(2, 21, "quot", n=300)
    shards = PM.shard_table(mesh, table)
    rows = table.n_buckets // 2
    assert shards[0][1] is shards[3][1]                # one copy a device
    assert torch.equal(torch.cat(shards[2]), table.data)
    assert shards[0][0].shape == (rows, 4)
    assert PM.choose_tp(16 << 30, 8) == 4
    assert PM.choose_tp(16 << 30, 2) == 2
    assert PM.choose_tp(1 << 20, 8) == 1


# ---------------------------------------------------------------------------
# K14 and the stage-00 mesh
# ---------------------------------------------------------------------------


def _port_keys(rhi, rlo) -> np.ndarray:
    """JAX's (hi, lo) uint32 rows as the port's int64 keys, the sentinel
    pair as INT64_MAX."""
    hi = np.asarray(rhi).astype(np.int64)
    lo = np.asarray(rlo).astype(np.int64)
    sent = (hi == 0xFFFFFFFF) & (lo == 0xFFFFFFFF)
    return np.where(sent, KC.SENT, (hi << 32) | lo)


@pytest.mark.parametrize("dp", [1, 2, 8])
def test_sharded_count_chunk_matches_jax_per_shard(dp):
    """Ragged lengths, N, R, U and soft-masked bytes: each shard's keys
    (the batch twin, route_batch_ref, on the CPU) equal JAX's shard."""
    import jax.numpy as jnp
    jmesh = jax_mesh(dp)
    from hast_tpu.parallel import mesh as JPM
    rng = np.random.default_rng(3)
    B, L = 128, 128
    seqs = ALPHABET[rng.integers(0, ALPHABET.size, (B, L))]
    seqs[64:] = seqs[:64]              # counts above 1
    lengths = np.full(B, L, np.int32)
    lengths[::7] = rng.integers(0, L, lengths[::7].size)
    rhi, rlo, dropped = JPM.sharded_count_chunk(
        jmesh, jnp.asarray(seqs), jnp.asarray(lengths), 21)
    assert int(np.asarray(dropped).sum()) == 0
    twin_calls = _build.TWIN_CALLS["route_batch_ref"]
    keys, port_dropped = PM.sharded_count_chunk(cpu_mesh(dp), seqs, lengths,
                                                21)
    assert _build.TWIN_CALLS["route_batch_ref"] == twin_calls + 1
    assert [int(d) for d in port_dropped] == [0] * dp
    for d in range(dp):
        np.testing.assert_array_equal(keys[d].numpy(),
                                      _port_keys(rhi[d], rlo[d]))
    assert all((k != KC.SENT).sum() for k in keys)


def batch_reads(seed: int, b: int, L: int = 128):
    """(b, L) ASCII reads, half their bytes soft-masked and 1 % N, R or
    U, ragged lengths down to 0, as tensors."""
    rng = np.random.default_rng(seed)
    seqs = np.frombuffer(b"ACGTacgt", np.uint8)[rng.integers(0, 8, (b, L))]
    odd = rng.random((b, L)) < 0.01
    seqs[odd] = ALPHABET[rng.integers(20, 23, int(odd.sum()))]
    lengths = rng.integers(0, L + 1, b).astype(np.int32)
    lengths[::3] = L
    return torch.from_numpy(seqs), torch.from_numpy(lengths)


@pytest.mark.parametrize("dp,cap", [(2, 400), (4, 40), (8, 0)])
def test_route_batch_lays_out_the_one_shard_rows(dp, cap):
    """Segment (d, s) of the receive buffer is row d of source s's
    one-shard buffer, drops included (cap 40 and 0 overflow)."""
    seqs, lengths = batch_reads(dp, 8 * dp)
    recv, dropped = PM.route_batch(seqs, lengths, 21, dp, cap, dp)
    assert tuple(recv.shape) == (dp, dp * cap)
    w = 8
    for s in range(dp):
        buf, lost = PM.route_kmers(seqs[s * w:(s + 1) * w],
                                   lengths[s * w:(s + 1) * w], 21, dp, cap)
        assert torch.equal(recv[:, s * cap:(s + 1) * cap], buf)
        assert int(dropped[s]) == int(lost)
    assert (int(dropped.sum()) > 0) == (cap < 100)


def test_sharded_count_chunk_over_several_devices():
    """Shards on two devices (cpu and cpu:0, interleaved): one route per
    device, the receivers concatenate; keys and drops equal those of the
    mesh on one device."""
    seqs, lengths = batch_reads(5, 64)
    want, want_lost = PM.sharded_count_chunk(cpu_mesh(4), seqs, lengths, 21)
    mesh = PM.make_mesh(4, devices=["cpu", "cpu:0"] * 2)
    twin_calls = _build.TWIN_CALLS["route_batch_ref"]
    got, lost = PM.sharded_count_chunk(mesh, seqs, lengths, 21)
    assert _build.TWIN_CALLS["route_batch_ref"] == twin_calls + 2
    for d in range(4):
        assert torch.equal(got[d], want[d])
        assert int(lost[d]) == int(want_lost[d]) == 0


@pytest.mark.parametrize("slack", [2, 4, 8])
def test_skewed_batch_drop_counts_match_jax(slack):
    """64 identical reads of one key: every key routes to one shard."""
    import jax.numpy as jnp
    jmesh = jax_mesh(8)
    from hast_tpu.parallel import mesh as JPM
    seqs = np.tile(np.frombuffer(SKEW, np.uint8), (64, 1))
    lengths = np.full(64, len(SKEW), np.int32)
    _, _, want = JPM.sharded_count_chunk(
        jmesh, jnp.asarray(seqs), jnp.asarray(lengths), 21, slack)
    _, got = PM.sharded_count_chunk(cpu_mesh(8), seqs, lengths, 21, slack)
    np.testing.assert_array_equal([int(d) for d in got], np.asarray(want))
    assert (np.asarray(want).sum() > 0) == (slack < 8)


def test_route_kmers_byte_rule():
    """A window is a key iff its bytes are ACGT in either case: a and t
    count, N, R and U do not."""
    seq = np.frombuffer(b"ACGTACGTACGTACGTACGTA" b"acgtacgtacgtacgtacgta"
                        b"ACGTACGTNCGTACGTACGTA" b"ACGTRCGTACGTACGTACGUA",
                        np.uint8).reshape(4, 21)
    buf, dropped = PM.route_kmers(torch.from_numpy(seq.copy()),
                                  torch.full((4,), 21, dtype=torch.int32),
                                  21, 1, 4)
    keys = buf.numpy()[0]
    assert int(dropped) == 0
    assert (keys != KC.SENT).sum() == 2 and keys[0] == keys[1]


def test_mesh_count_table_matches_jax():
    """Per-shard distinct counts and keys (the same routing), totals and
    histograms of count_files_mesh_device."""
    jmesh = jax_mesh(8)
    from hast_tpu.parallel import distributed as JD
    paths = [str(GOLD00 / "maternal.reads.fa.gz")]
    want = JD.count_files_mesh_device(jmesh, paths, 21, batch_size=4096)
    # a larger batch than JAX's: the shards' tables do not depend on it
    got = D.count_files_mesh_device(cpu_mesh(8), paths, 21,
                                    batch_size=16384)
    np.testing.assert_array_equal(got.n_valid, np.asarray(want.n_valid))
    assert got.n_distinct == want.n_distinct
    assert got.total == want.total
    np.testing.assert_array_equal(got.histo(), want.histo())
    for d, shard in enumerate(got.shards):
        n = shard.n_valid
        np.testing.assert_array_equal(
            shard.keys[:n].numpy(),
            _port_keys(want.hi[d, :n], want.lo[d, :n]))


def test_mesh_count_overflow_recovery(tmp_path, capfd):
    """The skewed batch overflows the 2x slack; the batch is retried with
    more and the table equals the single-device count's."""
    fa = tmp_path / "skew.fa"
    fa.write_bytes(b"".join(b">r%d\n%s\n" % (i, SKEW) for i in range(64)))
    t = D.count_files_mesh_device(cpu_mesh(8), [str(fa)], 21,
                                  batch_size=64)
    want = M.count_files([str(fa)], 21, batch_size=4096, device="cpu")
    err = capfd.readouterr().err
    assert "retrying batch with slack=4" in err
    assert "retrying batch with slack=8" in err
    host = t.fetch()
    np.testing.assert_array_equal(host.words, want.words)
    np.testing.assert_array_equal(host.counts, want.counts)
    assert t.total == want.total and t.n_distinct == want.n_distinct


def test_count_files_sharded_matches_host():
    paths = [str(E2E / "paternal.fa.gz")]
    ours = D.count_files_sharded(cpu_mesh(8), paths, 21, batch_size=16384)
    want = M.count_files(paths, 21, batch_size=4096, device="cpu")
    np.testing.assert_array_equal(ours.words, want.words)
    np.testing.assert_array_equal(ours.counts, want.counts)


def test_counter_add_sorted_chunk_matches_jax():
    pytest.importorskip("jax")
    from hast_tpu.ops import kmer_count as JKC
    rng = np.random.default_rng(8)
    ours, theirs = KC.Counter(21, compact_above=300), JKC.Counter(21)
    for _ in range(4):
        words = np.sort(np.repeat(rng.integers(0, 1 << 42, 200),
                                  rng.integers(1, 4, 200)))
        pads = np.full(50, KC.SENT)
        ours.add_sorted_chunk(np.concatenate([words, pads]))
        theirs.add_sorted_chunk(
            np.concatenate([(words >> 32), np.full(50, 0xFFFFFFFF)]),
            np.concatenate([words & 0xFFFFFFFF, np.full(50, 0xFFFFFFFF)]))
    a, b = ours.finalize(), theirs.finalize()
    np.testing.assert_array_equal(a.words, b.words)
    np.testing.assert_array_equal(a.counts, b.counts)


def test_build_unshared_markers_mesh_matches_goldens(tmp_path):
    pat = [str(GOLD00 / "paternal.reads.fa.gz")]
    mat = [str(GOLD00 / "maternal.reads.fa.gz")]
    mesh_dir, dev_dir = tmp_path / "mesh", tmp_path / "device"
    mesh_dir.mkdir()
    dev_dir.mkdir()
    D.build_unshared_markers_mesh(cpu_mesh(8), pat, mat,
                                  out_dir=str(mesh_dir), auto_bounds=True,
                                  batch_size=16384, log=io.StringIO())
    M.build_unshared_markers(pat, mat, str(dev_dir), auto_bounds=True,
                             device="cpu", log=io.StringIO())
    for parent in ("maternal", "paternal"):
        assert (mesh_dir / f"{parent}.kmercount.histo").read_bytes() == \
            (GOLD00 / f"{parent}.histo").read_bytes()
        assert (mesh_dir / f"{parent}.bounds.txt").read_bytes() == \
            (GOLD00 / f"{parent}.bounds.txt").read_bytes()
        ours = (mesh_dir / f"{parent}.unique.filter.mer").read_bytes()
        assert ours == (dev_dir / f"{parent}.unique.filter.mer").read_bytes()
        assert sorted(ours.split()) == sorted(
            (GOLD00 / f"{parent}.unique.filter.mer").read_bytes().split())


# ---------------------------------------------------------------------------
# mesh classify and the merge of shard outputs
# ---------------------------------------------------------------------------


def _golden_inputs(dst: pathlib.Path):
    for f in ("hap0.mer", "hap1.mer", "reads1.fq.gz", "reads2.fq"):
        shutil.copy(GOLD / f, dst / f)
    return str(dst / "hap0.mer"), str(dst / "hap1.mer"), [
        str(dst / "reads1.fq.gz"), str(dst / "reads2.fq")]


@pytest.mark.parametrize("fmt", ["full", "quot"])
def test_classify_fastqs_mesh_matches_golden(fmt, tmp_path):
    """The table forced to each slot format (by the JAX package's loader),
    classified on an 8x2 mesh."""
    pytest.importorskip("jax")
    from hast_tpu.pipeline import classify as JC
    hap0, hap1, reads = _golden_inputs(tmp_path)
    ref = JC.load_marker_table(hap0, hap1, snapshot=False, fmt=fmt)
    JC.erase_adaptors(ref)
    table = H.from_reference(ref.data, ref.n_buckets, ref.max_probe, ref.k,
                             ref.n_keys, ref.set_sizes, ref.fmt, device="cpu")
    assert table.fmt == fmt
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tally = C.classify_fastqs_mesh(cpu_mesh(16, tp=2), table, reads,
                                       batch_size=4096)
    out = io.BytesIO()
    C.write_phased_barcodes(tally, table, out, w0=1.04)
    assert out.getvalue() == (GOLD / "phased.barcodes.golden").read_bytes()
    # each file's fold of the host tally is a span
    folds = [e for e in prof.events() if e.name == "classify.host_fold"]
    assert len(folds) >= len(reads)
    assert all(e.time_range.elapsed_us() > 0 for e in folds)


def test_host_tally_path_matches_golden(tmp_path):
    """_classify_fastqs_native with its default vote_fn: K13's packed form
    on the table's device, the tally on the host."""
    hap0, hap1, reads = _golden_inputs(tmp_path)
    table = C.load_marker_table(hap0, hap1)
    C.erase_adaptors(table)
    tally = C._classify_fastqs_native(table, reads, 4096, None, 2)
    out = io.BytesIO()
    C.write_phased_barcodes(tally, table, out, w0=1.04)
    assert out.getvalue() == (GOLD / "phased.barcodes.golden").read_bytes()


def test_run_classify_on_a_mesh_rejects_an_uneven_batch(tmp_path):
    hap0, hap1, reads = _golden_inputs(tmp_path)
    with pytest.raises(ValueError):
        C.run_classify(hap0, hap1, reads, io.BytesIO(), batch_size=4095,
                       mesh=cpu_mesh(2))


def test_merge_phased_files_matches_golden(tmp_path):
    hap0, hap1, reads = _golden_inputs(tmp_path)
    table = C.load_marker_table(hap0, hap1)
    C.erase_adaptors(table)
    shards = []
    for i, path in enumerate(reads):
        out = io.BytesIO()
        C.write_phased_barcodes(C.classify_fastqs(table, [path], 4096),
                                table, out, w0=1.04)
        shards.append(tmp_path / f"s{i}.txt")
        shards[-1].write_bytes(out.getvalue())
    merged = io.BytesIO()
    PMerge.merge_phased_files([str(s) for s in shards], merged,
                              *table.set_sizes, w0=1.04)
    assert merged.getvalue() == (GOLD / "phased.barcodes.golden").read_bytes()
    assert merged.getvalue() != b"".join(s.read_bytes() for s in shards)


def test_get_hap_matches_decide_haps_and_jax():
    pytest.importorskip("jax")
    from hast_tpu.pipeline import classify as JC
    rng = np.random.default_rng(4)
    bcs = np.array([b"0", b"0_0", b"0_0_0", b"12_3_4"] * 50)
    c0 = rng.integers(0, 4, bcs.size)
    c1 = rng.integers(0, 4, bcs.size)
    want = C.decide_haps(bcs, c0, c1, 1000, 1040, 1.04, 1.0)
    for i, bc in enumerate(bcs.tolist()):
        args = (bc, int(c0[i]), int(c1[i]), 1000, 1040, 1.04, 1.0)
        assert C.get_hap(*args) == want[i] == JC.get_hap(*args)


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,edges", [
    pytest.param("full", False, id="full"),
    pytest.param("quot", False, id="quot"),
    pytest.param("full", True, id="full-edges"),
    pytest.param("quot", True, id="quot-edges")])
def test_vote_reads_kernel_matches_twin(card, fmt, edges):
    """With edges: read_tile_edge_batches' reads at every stride (the
    long-row form at 2,048 and 16,384 packed bytes), k = 15, 17, 21 and,
    in the full format, 31; packed and ASCII; the whole table and its 2-
    and 4-way shards, one C call each."""
    if edges:
        for k in (15, 17, 21, 31) if fmt == "full" else (15, 17, 21):
            _vote_edges_on_card(card, fmt, k)
        return
    table = port_table(9, 21, fmt)
    seqs, lengths = planted_reads(9, marker_words(9, 4000, 21), 21, b=512)
    tp, rows = 4, table.n_buckets // 4
    for packed, reads in ((False, seqs), (True, E.pack_codes_np(seqs))):
        reads, lens = torch.from_numpy(reads), torch.from_numpy(lengths)
        for row_lo in (None, *range(0, table.n_buckets, rows)):
            sl = table if row_lo is None else H.KmerTable(
                table.data[row_lo:row_lo + rows], table.n_buckets,
                table.max_probe, 21, 0, (), fmt)
            want = C.vote_reads(sl, reads, lens, packed, row_lo or 0)
            launches = _build.LAUNCHES["vote_reads"]
            got = C.vote_reads(sl.to(card), reads.to(card), lens.to(card),
                               packed, row_lo or 0)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["vote_reads"] == launches + 1
            assert torch.equal(got.cpu(), want), (packed, row_lo, tp)


def _vote_edges_on_card(card, fmt: str, k: int):
    table = port_table(k, k, fmt)
    words = marker_words(k, 4000, k)
    assert _build.read_tile_geometry() == S.READ_TILE_GEOMETRY
    for lp in S.READ_EDGE_STRIDES:
        seqs, packed_np, lengths = edge_reads(k, lp, words)
        lens = torch.from_numpy(lengths)
        for packed, reads in ((False, torch.from_numpy(seqs)),
                              (True, torch.from_numpy(packed_np))):
            for tp in (1, 2, 4):
                rows = table.n_buckets // tp
                for j in range(tp):
                    sl = table if tp == 1 else H.KmerTable(
                        table.data[j * rows:(j + 1) * rows], table.n_buckets,
                        table.max_probe, k, 0, (), fmt)
                    want = C.vote_reads(sl, reads, lens, packed, j * rows)
                    launches = _build.LAUNCHES["vote_reads"]
                    got = C.vote_reads(sl.to(card), reads.to(card),
                                       lens.to(card), packed, j * rows)
                    assert _build.LAUNCHES["vote_reads"] == launches + 1
                    assert torch.equal(got.cpu(), want), (k, lp, packed, tp,
                                                          j)


@pytest.mark.cuda
def test_tally_votes_kernel_matches_twin(card):
    rng = np.random.default_rng(12)
    votes = torch.from_numpy(rng.integers(0, 9, (20000, 2)).astype(np.int32))
    has_n = torch.from_numpy(rng.random(20000) < 0.05)
    ids = torch.from_numpy(rng.integers(-3, 1003, 20000).astype(np.int32))
    want = C.tally_votes(votes, has_n, ids, 1000)
    got = C.tally_votes(votes.to(card), has_n.to(card), ids.to(card), 1000)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [31, 20000])
def test_tally_votes_kernel_on_barcode_runs(card, n):
    """Barcode-sorted ids whose runs cross warp boundaries (ids -1 and
    past the tally inside runs) and random ids, bit-exact against the
    twin; out= adds two calls into one tally."""
    for sorted_ids in (True, False):
        votes, has_n, ids = tally_inputs(n, n, 500, sorted_ids)
        want = C.tally_votes(votes, has_n, ids, 500)
        dev = [x.to(card) for x in (votes, has_n, ids)]
        launches = _build.LAUNCHES["tally_votes"]
        got = C.tally_votes(*dev, 500)
        assert _build.LAUNCHES["tally_votes"] == launches + 1
        assert torch.equal(got.cpu(), want), sorted_ids
        out = torch.zeros((500, 3), dtype=torch.int32, device=card)
        h = n // 2
        for s in (slice(0, h), slice(h, n)):
            C.tally_votes(*(x[s] for x in dev), 500, out=out)
        assert torch.equal(out.cpu(), want), sorted_ids


@pytest.mark.cuda
@pytest.mark.parametrize("dp,cap", [(4, None), (8, None), (8, 40)])
def test_route_kmers_kernel_matches_twin(card, dp, cap):
    """Rows equal once sorted (the kernel's order inside a row is free);
    drop counts equal, also when a row overflows."""
    rng = np.random.default_rng(dp)
    seqs = torch.from_numpy(ALPHABET[rng.integers(0, ALPHABET.size,
                                                  (256, 112))])
    lens = torch.from_numpy(rng.integers(0, 113, 256).astype(np.int32))
    cap = cap or 256 * 92 // dp * 2
    want, want_drop = PM.route_kmers(seqs, lens, 21, dp, cap)
    got, got_drop = PM.route_kmers(seqs.to(card), lens.to(card), 21, dp, cap)
    assert int(got_drop) == int(want_drop)
    if not int(want_drop):
        assert torch.equal(got.sort(dim=1).values.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dp,L,top", [
    pytest.param(4, 128, 128, id="4"), pytest.param(8, 128, 128, id="8"),
    pytest.param(4, 256, 250, id="4-long-reads"),
    pytest.param(8, 100, 100, id="8-unaligned-rows"),
    pytest.param(40, 128, 128, id="40-shared-atomics")])
def test_route_batch_kernel_matches_twin(card, dp, L, top):
    """The batch form in one launch against route_batch_ref: segments
    equal once sorted, drop counts equal; also the skewed batch of
    identical reads, whose drops fall as the cap grows.  Rows of 256
    bytes hold reads of up to 250 (past one warp segment of 128
    windows), rows of 100 bytes take the byte loads (not 16-byte ones),
    and dp 40 takes shared atomics instead of ballots."""
    seqs, lengths = batch_reads(dp, 64 * dp, L)
    lengths.clamp_(max=top)
    per = max(64 // dp, 1)                   # skewed reads a source shard
    skew = torch.full((per * dp, L), ord("A"), dtype=torch.uint8)
    skew_lens = torch.full((per * dp,), top, dtype=torch.int32)
    n_win = top - 21 + 1
    for reads, lens, cap in ((seqs, lengths, 64 * n_win // dp * 2),
                             (skew, skew_lens, per * n_win // dp * 2),
                             (skew, skew_lens, per * n_win)):
        want, want_lost = PM.route_batch(reads, lens, 21, dp, cap, dp)
        launches = _build.LAUNCHES["route_kmers"]
        got, lost = PM.route_batch(reads.to(card), lens.to(card), 21, dp,
                                   cap, dp)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["route_kmers"] == launches + 1
        assert lost.tolist() == want_lost.tolist()
        if not int(want_lost.sum()):
            got = got.reshape(dp, dp, cap).sort(dim=2).values
            assert torch.equal(got.reshape(dp, -1).cpu(), want)


@pytest.mark.cuda
def test_sharded_count_chunk_on_one_card(card):
    """Four shards of one card: one K14 launch, keys and drops equal to
    the CPU mesh's."""
    seqs, lengths = batch_reads(6, 256)
    want, want_lost = PM.sharded_count_chunk(cpu_mesh(4), seqs.numpy(),
                                             lengths.numpy(), 21)
    launches = _build.LAUNCHES["route_kmers"]
    got, lost = PM.sharded_count_chunk(PM.make_mesh(4, devices=[card] * 4),
                                       seqs.numpy(), lengths.numpy(), 21)
    assert _build.LAUNCHES["route_kmers"] == launches + 1
    for d in range(4):
        assert torch.equal(got[d].cpu(), want[d])
        assert int(lost[d]) == int(want_lost[d]) == 0


@pytest.mark.cuda
def test_classify_on_named_cards(card, tmp_path):
    """--device cuda:0 and, with two or more cards, the last one: the
    launch goes to the tensors' own card (ops/_build.py launch)."""
    from hast_tpu_torch.cli import main
    hap0, hap1, reads = _golden_inputs(tmp_path)
    names = ["cuda:0"]
    if torch.cuda.device_count() >= 2:
        names.append(f"cuda:{torch.cuda.device_count() - 1}")
    for name in names:
        out = tmp_path / f"phased.{name}"
        main(["classify", "--hap0", hap0, "--hap1", hap1, "--read",
              reads[0], "--read", reads[1], "--weight0", "1.04", "--output",
              str(out), "--device", name])
        assert out.read_bytes() == \
            (GOLD / "phased.barcodes.golden").read_bytes(), name
