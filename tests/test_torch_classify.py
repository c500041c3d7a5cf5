"""hast_tpu_torch.pipeline against hast_tpu.pipeline and the stage-01 goldens.

K3's twin (tally_step_ref, what the wrapper runs on CPU tensors) against
the JAX tally_step on one packed super-batch and on the read tiles' edge
batches (utils/synthetic.py read_tile_edge_batches), and the twins of K10 and
K11 (the tally's growth and its narrow fetch) against _grow_acc,
_pack_acc and _fetch_acc; the whole slice on the CPU
against every golden of tests/test_stage01_parity.py, byte for byte, with
both read engines; the snapshot shared by both packages; the slice on
seeded synthetic inputs against hast_tpu's run_classify.  Integers only,
so the tolerance is exact equality.  Inputs are copied to tmp_path
first: a marker load writes its .probetable.npz beside hap0.
"""

import gzip
import io
import os
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

from hast_tpu_torch.io import native as N
from hast_tpu_torch.ops import _build
from hast_tpu_torch.ops import encode as E
from hast_tpu_torch.ops import hashtable as H
from hast_tpu_torch.pipeline import classify as C
from hast_tpu_torch.pipeline import partition as P
from hast_tpu_torch.utils.profiling import COUNTERS

GOLD = pathlib.Path(__file__).parent / "golden" / "stage01"
CASES = {
    "main": ("hap0.mer", "hap1.mer", ["reads1.fq.gz", "reads2.fq"],
             "phased.barcodes.golden", 4096),
    "edge": ("edge.hap0.mer", "edge.hap1.mer", ["edge.fq"],
             "edge.phased.golden", 4096),
    "k15": ("k15.hap0.mer", "k15.hap1.mer", ["k15.fq"], "k15.phased.golden",
            2048),
    "k31": ("k31.hap0.mer", "k31.hap1.mer", ["k31.fq"], "k31.phased.golden",
            2048),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def copy_case(name: str, dst: pathlib.Path):
    h0, h1, reads, golden, batch = CASES[name]
    for f in (h0, h1, *reads):
        shutil.copy(GOLD / f, dst / f)
    return (str(dst / h0), str(dst / h1), [str(dst / r) for r in reads],
            (GOLD / golden).read_bytes(), batch)


def super_batch(seed: int, key_words: np.ndarray, k: int, s: int = 2,
                b: int = 48, lp: int = 28, cap: int = 32):
    """(S, B, Lp) packed reads with planted keys, N reads, short reads,
    id -1 rows and repeated ids, plus a non-zero starting tally."""
    rng = np.random.default_rng(seed)
    n = s * b
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, 4 * lp))]
    kmers = E.words_to_bytes(key_words[rng.integers(0, key_words.size, n)], k)
    pos = rng.integers(0, 4 * lp - k - 8, n)
    seqs[np.arange(n)[:, None], pos[:, None] + np.arange(k)] = kmers
    lengths = rng.integers(pos + k, 4 * lp + 1).astype(np.int32)
    lengths[:6] = (0, 1, k - 1, k, 4 * lp, 4 * lp)
    ids = rng.integers(0, cap - 1, n).astype(np.int32)  # never cap-1
    ids[rng.random(n) < 0.15] = -1
    ids[:3] = 5                                          # a repeated id
    has_n = (rng.random(n) < 0.1).astype(np.uint8)
    acc = rng.integers(0, 50, (cap, 3)).astype(np.int32)
    return (E.pack_codes_np(seqs).reshape(s, b, lp), lengths.reshape(s, b),
            ids.reshape(s, b), has_n.reshape(s, b), acc)


TALLY_CASES = [("quot", 15), ("quot", 21), ("full", 21), ("full", 31)]
EDGE_CAP = 512


@pytest.mark.parametrize("fmt,k,edges", [
    *(pytest.param(f, k, False, id=f"{f}-{k}") for f, k in TALLY_CASES),
    *(pytest.param(f, k, True, id=f"{f}-{k}-edges") for f, k in TALLY_CASES)])
def test_tally_step_twin_matches_jax(fmt, k, edges):
    """The id -1 rows are reads that hit markers; with edges, the reads of
    read_tile_edge_batches at every stride of READ_EDGE_STRIDES_CPU."""
    if edges:
        _tally_edges_vs_jax(fmt, k)
    else:
        _tally_vs_jax(fmt, k, empty_pads=False)


@pytest.mark.parametrize("fmt,k", TALLY_CASES)
def test_tally_step_empty_pads_match_jax(fmt, k):
    """The id -1 rows are empty, as the pipeline's pad rows are."""
    _tally_vs_jax(fmt, k, empty_pads=True)


def jax_and_port_tables(fmt: str, k: int):
    """(hast_tpu table, the port's copy on the CPU, its keys as int64
    words) of 500 random k-mers."""
    from hast_tpu.ops import hashtable as JH
    rng = np.random.default_rng(k)
    hi, lo = E.canonical_kmers_np(rng.integers(0, 4, (500, k), np.int32), k)
    hi, lo = hi[:, 0], lo[:, 0]
    ref = JH.build_table(hi, lo, rng.integers(1, 4, 500).astype(np.uint32),
                         k, load=0.7, fmt=fmt)
    table = H.from_reference(ref.data, ref.n_buckets, ref.max_probe, k,
                             ref.n_keys, ref.set_sizes, ref.fmt,
                             device="cpu")
    return ref, table, (hi.astype(np.int64) << 32) | lo


def edge_tally_inputs(lp: int, seqs, lengths, ids, has_n):
    """(packed, lengths, ids, has_n) of an edge batch, and a tally that
    already holds counts."""
    acc = np.random.default_rng(lp).integers(
        0, 50, (EDGE_CAP, 3)).astype(np.int32)
    return (E.pack_codes_np(seqs), lengths, ids, has_n), acc


def _tally_edges_vs_jax(fmt: str, k: int):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from hast_tpu.pipeline import classify as JC
    from hast_tpu_torch.utils import synthetic as S

    ref, table, words = jax_and_port_tables(fmt, k)
    hits = 0
    for lp in S.READ_EDGE_STRIDES_CPU:
        for name, *batch in S.read_tile_edge_batches(k + lp, k, lp, words,
                                                     EDGE_CAP):
            args, acc = edge_tally_inputs(lp, *batch)
            ids = args[2]
            got = C.tally_step(table, torch.from_numpy(acc.copy()),
                               *map(torch.from_numpy, args)).numpy()
            if 4 * lp < k:
                # JAX refuses a stride under k bases; each kept read votes
                # (0, 0, 1)
                want = acc.copy()
                keep = (ids >= 0) & (ids < EDGE_CAP)
                np.add.at(want[:, 2], ids[keep], 1)
            else:
                # JAX's id -1 rows land in row cap - 1 (see _tally_vs_jax);
                # as id cap they are dropped, as the port drops them
                jids = np.where(ids < 0, EDGE_CAP, ids).astype(np.int32)
                want = np.asarray(JC.tally_step(
                    jnp.asarray(ref.data), jnp.asarray(acc),
                    *(jnp.asarray(x[None]) for x in (args[0], args[1], jids,
                                                     args[3])),
                    k, ref.max_probe, fmt))
            np.testing.assert_array_equal(got, want, err_msg=f"{lp} {name}")
            hits += int((want[:, :2] - acc[:, :2]).sum())
    assert hits > 0


def _tally_vs_jax(fmt: str, k: int, empty_pads: bool):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from hast_tpu.pipeline import classify as JC

    ref, table, words = jax_and_port_tables(fmt, k)
    packed, lengths, ids, has_n, acc = super_batch(k, words, k)
    if empty_pads:
        lengths[ids == -1] = 0
    lp = packed.shape[-1]
    cap = acc.shape[0]

    def jax_tally(ids):
        return np.asarray(JC.tally_step(
            jnp.asarray(ref.data), jnp.asarray(acc), jnp.asarray(packed),
            jnp.asarray(lengths), jnp.asarray(ids), jnp.asarray(has_n), k,
            ref.max_probe, fmt))

    twin_calls = _build.TWIN_CALLS["tally_step_ref"]
    got = C.tally_step(table, torch.from_numpy(acc.copy()),
                       torch.from_numpy(packed.reshape(-1, lp)),
                       torch.from_numpy(lengths.reshape(-1)),
                       torch.from_numpy(ids.reshape(-1)),
                       torch.from_numpy(has_n.reshape(-1))).numpy()
    assert _build.TWIN_CALLS["tally_step_ref"] == twin_calls + 1
    want = jax_tally(ids)
    assert (got[:, :2] > acc[:, :2]).any()       # markers were hit
    # The contract drops id -1 rows, and the port does.  JAX normalises
    # id -1 to the last row before mode="drop", so the id -1 rows land in
    # want[-1] as if their id were cap-1; no other read carries cap-1.
    n_pads = int((ids == -1).sum())
    assert n_pads > 0
    np.testing.assert_array_equal(got[:-1], want[:-1])
    np.testing.assert_array_equal(got[-1], acc[-1])
    # JAX over the id -1 rows alone, moved to cap-1 (the others to cap,
    # out of range, dropped)
    alone = jax_tally(np.where(ids == -1, cap - 1, cap).astype(np.int32))
    np.testing.assert_array_equal(alone[:-1], acc[:-1])
    np.testing.assert_array_equal(want[-1], alone[-1])
    if empty_pads:
        # an empty row votes for nothing: only the unknown column grows
        np.testing.assert_array_equal(want[-1] - acc[-1], [0, 0, n_pads])
    else:
        assert (want[-1, :2] > acc[-1, :2]).any()   # the pads hit markers


def test_tally_step_rejects_bad_input():
    table = H.build_table(np.zeros(1, np.uint32), np.ones(1, np.uint32),
                          np.ones(1, np.uint32), 21)
    acc = torch.zeros((4, 3), dtype=torch.int32)
    packed = torch.zeros((2, 8), dtype=torch.uint8)
    lengths = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="acc"):
        C.tally_step(table, acc.to(torch.int64), packed, lengths, lengths,
                     lengths.to(torch.uint8))
    with pytest.raises(ValueError, match="ids"):
        C.tally_step(table, acc, packed, lengths, lengths[:1],
                     lengths.to(torch.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        C.tally_step(table.to("meta"), acc.to("meta"), packed.to("meta"),
                     lengths.to("meta"), lengths.to("meta"),
                     lengths.to(torch.uint8).to("meta"))


def test_tally_grows_by_doubling():
    acc = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    twin_calls = _build.TWIN_CALLS["grow_tally_ref"]
    grown = C.grow_tally(acc, 9)
    assert _build.TWIN_CALLS["grow_tally_ref"] == twin_calls + 1
    assert tuple(grown.shape) == (16, 3)
    assert torch.equal(grown[:4], acc) and int(grown[4:].abs().sum()) == 0
    assert C.grow_tally(acc, 3) is acc
    with pytest.raises(ValueError, match="tally"):
        C.grow_tally(acc.to(torch.int64), 9)
    with pytest.raises(ValueError, match="CUDA"):
        C.grow_tally(acc.to("meta"), 9)


@pytest.mark.parametrize("max_id", [100, 4095, 4096, 70_000])
def test_grow_tally_twin_matches_jax(max_id):
    """K10's twin against the JAX driver's doubling loop of _grow_acc."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from hast_tpu.pipeline import classify as JC
    acc = np.random.default_rng(max_id).integers(
        0, 300, (4096, 3)).astype(np.int32)
    want, cap = jnp.asarray(acc), acc.shape[0]
    while max_id >= cap:
        want = JC._grow_acc(want, jnp.zeros((cap, 3), jnp.int32))
        cap *= 2
    got = C.grow_tally(torch.from_numpy(acc), max_id)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows", [1, 2, 4, 1 << 10])
def test_grow_tally_from_small_tallies(rows):
    """From 1, 2 and 2^a rows: the closed-form row count equals the
    doubling loop, and the twin's tally JAX's _grow_acc loop."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from hast_tpu.pipeline import classify as JC
    for max_id in (0, rows - 1, rows, 2 * rows + 1, 5 * rows, 3 * rows + 7):
        want_rows = rows
        while max_id >= want_rows:
            want_rows *= 2
        assert C._grown_rows(rows, max_id) == want_rows
        acc = np.random.default_rng(rows + max_id).integers(
            0, 300, (rows, 3)).astype(np.int32)
        want, cap = jnp.asarray(acc), rows
        while max_id >= cap:
            want = JC._grow_acc(want, jnp.zeros((cap, 3), jnp.int32))
            cap *= 2
        got = C.grow_tally(torch.from_numpy(acc), max_id)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def tally_values(regime: str) -> np.ndarray:
    """A (5000, 3) int32 tally whose largest entry fits 8 bits, 16 bits
    or neither; "negative" also holds entries below 0."""
    rng = np.random.default_rng(len(regime))
    top = {"8bit": 256, "16bit": 1 << 16, "32bit": 1 << 31,
           "negative": 1 << 20}[regime]
    acc = rng.integers(0, 256, (5000, 3))
    acc[rng.random((5000, 3)) < 0.01] = top - 1
    if regime == "negative":
        acc[rng.random((5000, 3)) < 0.01] = -7
    return acc.astype(np.int32)


@pytest.mark.parametrize("regime", ["8bit", "16bit", "32bit", "negative"])
def test_pack_tally_twin_matches_jax(regime):
    """K11's twin against _pack_acc, and the fetch it serves against
    _fetch_acc: the same images and counts, the same int64 tally."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from hast_tpu.pipeline import classify as JC
    acc = tally_values(regime)
    lo8, n8, lo16, n16 = (np.asarray(x) for x in JC._pack_acc(
        jnp.asarray(acc)))
    twin_calls = _build.TWIN_CALLS["pack_tally_ref"]
    got8, got16, over = C.pack_tally(torch.from_numpy(acc))
    assert _build.TWIN_CALLS["pack_tally_ref"] == twin_calls + 1
    np.testing.assert_array_equal(got8.numpy(), lo8)
    np.testing.assert_array_equal(got16.numpy().view(np.uint16), lo16)
    assert over.tolist() == [int(n8), int(n16)]
    assert (int(n8) == 0) == (regime == "8bit")
    fetched = C.fetch_tally(torch.from_numpy(acc))
    assert fetched.dtype == np.int64
    np.testing.assert_array_equal(fetched,
                                  JC._fetch_acc(jnp.asarray(acc)))
    np.testing.assert_array_equal(fetched, acc)


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("case", list(CASES))
def test_goldens_bit_identical_on_cpu(tmp_path, case, engine):
    if engine == "native" and N.get_lib() is None:
        pytest.skip("libhastio.so unavailable")
    hap0, hap1, reads, golden, batch = copy_case(case, tmp_path)
    out = io.BytesIO()
    C.run_classify(hap0, hap1, reads, out, w0=1.04, batch_size=batch,
                   device="cpu", engine=engine)
    assert out.getvalue() == golden


def test_barcode_splits_match_goldens(tmp_path):
    P.split_barcodes(str(GOLD / "phased.barcodes.golden"),
                     out_prefix=str(tmp_path) + "/")
    for name in ("paternal", "maternal", "homozygous"):
        assert (tmp_path / f"{name}.unique.barcodes").read_bytes() == \
            (GOLD / f"{name}.unique.barcodes.golden").read_bytes(), name


@pytest.mark.parametrize("engine", ["native", "python"])
def test_quartering_matches_goldens(tmp_path, monkeypatch, engine):
    if engine == "native" and N.get_lib() is None:
        pytest.skip("libhastio.so unavailable")
    monkeypatch.chdir(tmp_path)
    err = sys.stderr if engine == "native" else io.StringIO()
    P.quarter_fastq(str(GOLD / "reads2.fq"),
                    str(GOLD / "paternal.unique.barcodes.golden"),
                    str(GOLD / "maternal.unique.barcodes.golden"),
                    str(GOLD / "homozygous.unique.barcodes.golden"), err=err)
    for name in ("paternal", "maternal", "homozygous", "nobarcode"):
        ours = tmp_path / f"reads2.fq.{name}.fastq"
        golden = GOLD / "quarter" / f"reads2.fq.{name}.fastq"
        if golden.exists():
            assert ours.read_bytes() == golden.read_bytes(), name
        else:
            assert not ours.exists(), name
    # the stats block (the golden's first line holds an absolute path)
    assert (tmp_path / "filter_reads.log").read_bytes().split(b"\n")[1:] == \
        (GOLD / "quarter" / "filter_reads.log").read_bytes().split(b"\n")[1:]
    if engine == "python":
        assert err.getvalue() == (GOLD / "quarter" / "quarter.stderr"
                                  ).read_text()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_shared_between_packages(tmp_path, monkeypatch, writer):
    """A .probetable.npz written by the port loads in the JAX package
    without reparsing the marker text.  One written by the JAX package
    lacks the port's st_mtime_ns field: the port parses the text again,
    rewrites the snapshot, and the JAX package then loads the port's."""
    pytest.importorskip("jax")
    from hast_tpu.ops import encode as JE
    from hast_tpu.pipeline import classify as JC

    hap0, hap1, _, _, _ = copy_case("main", tmp_path)
    if writer == "port":
        first = C.load_marker_table(hap0, hap1)
        monkeypatch.setattr(JE, "load_mer_file", _no_parse)
        second = JC.load_marker_table(hap0, hap1)
        port, ref = first, second
    else:
        first = JC.load_marker_table(hap0, hap1)
        with np.load(hap0 + ".probetable.npz") as z:
            assert "mtime_ns" not in z
        second = C.load_marker_table(hap0, hap1)
        with np.load(hap0 + ".probetable.npz") as z:
            assert "mtime_ns" in z
        monkeypatch.setattr(JE, "load_mer_file", _no_parse)
        np.testing.assert_array_equal(
            np.asarray(JC.load_marker_table(hap0, hap1).data),
            np.asarray(first.data))
        port, ref = second, first
    assert pathlib.Path(hap0 + ".probetable.npz").exists()
    assert (port.fmt, port.n_buckets, port.max_probe, port.k, port.n_keys,
            port.set_sizes) == (ref.fmt, ref.n_buckets, ref.max_probe, ref.k,
                                ref.n_keys, ref.set_sizes)
    np.testing.assert_array_equal(port.data_np(), np.asarray(ref.data))


def _no_parse(*a, **kw):
    raise AssertionError("marker text parsed although a snapshot exists")


def test_snapshot_sees_a_rewrite_within_one_second(tmp_path):
    """A marker file rewritten inside the same second at the same size
    (fixed-width lines make equal sizes likely) is parsed again: the
    snapshot keeps both files' st_mtime_ns beside the JAX package's
    whole-second key."""
    hap0, hap1, _, _, _ = copy_case("main", tmp_path)
    second = 1_700_000_000 * 10**9
    os.utime(hap0, ns=(second + 100, second + 100))
    first = C.load_marker_table(hap0, hap1)
    lines = pathlib.Path(hap0).read_bytes().split(b"\n")
    lines[0] = lines[0][::-1]          # another k-mer, the same size
    pathlib.Path(hap0).write_bytes(b"\n".join(lines))
    os.utime(hap0, ns=(second + 900_000_000, second + 900_000_000))
    again = C.load_marker_table(hap0, hap1)
    assert not np.array_equal(again.data_np(), first.data_np())
    os.remove(hap0 + ".probetable.npz")
    np.testing.assert_array_equal(again.data_np(),
                                  C.load_marker_table(hap0, hap1).data_np())


def _sorted_tally(tally):
    names, counts = tally.finalize()
    order = np.argsort(names)
    return names[order], counts[order]


@pytest.mark.parametrize("width,third", [(1, False), (2, False), (2, True)])
def test_interleaved_native_classify(tmp_path, monkeypatch, width, third):
    """Native classify with up to width files' readers open at once, a
    batch from each in turn: the stage-01 goldens' bytes, and, with a
    third file (every other record of reads1, last first) that opens in
    the place of the shortest file and ends before the first, the python
    engine's tally on the same list."""
    if N.get_lib() is None:
        pytest.skip("libhastio.so unavailable")
    hap0, hap1, reads, golden, batch = copy_case("main", tmp_path)
    if third:
        lines = gzip.decompress(pathlib.Path(reads[0]).read_bytes()).split(
            b"\n")
        records = [lines[i:i + 4] for i in range(0, len(lines) - 3, 8)]
        path = tmp_path / "reads3.fq"
        path.write_bytes(b"".join(b"\n".join(r) + b"\n"
                                  for r in records[::-1]))
        reads.append(str(path))
    monkeypatch.setattr(C, "_reader_width", lambda n: min(n, width))
    table = C.load_marker_table(hap0, hap1)
    C.erase_adaptors(table)
    overlapped = COUNTERS["classify.overlapped_batches"]
    got = C.classify_fastqs(table, reads, 512, engine="native")
    overlapped = COUNTERS["classify.overlapped_batches"] - overlapped
    assert (overlapped > 0) == (width > 1)
    want = C.classify_fastqs(table, reads, 512, engine="python")
    out = io.BytesIO()
    C.write_phased_barcodes(got, table, out, w0=1.04)
    if not third:
        assert out.getvalue() == golden
    for g, w in zip(_sorted_tally(got), _sorted_tally(want)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("engine", ["native", "mesh", "native-interleaved"])
def test_native_paths_take_reads_past_1024_bases(tmp_path, engine, capsys):
    """A read of 1,500 bases in a file: both native classify paths redo
    the file with a larger len_cap and give the python reader's tally.
    With a file of short reads beside it and both readers open at once,
    only the long file is redone."""
    from hast_tpu_torch.parallel import mesh as PM
    hap0, hap1, reads, _, batch = copy_case("main", tmp_path)
    lines = pathlib.Path(reads[1]).read_bytes().split(b"\n")
    lines[1] = (lines[1] * 16)[:1500]    # the planted markers repeat
    lines[3] = b"I" * 1500
    long_fq = tmp_path / "long.fq"
    long_fq.write_bytes(b"\n".join(lines))
    paths = [str(long_fq)]
    if engine == "native-interleaved":
        paths = [reads[1], str(long_fq)]
    table = C.load_marker_table(hap0, hap1)
    want = C.classify_fastqs(table, paths, batch,
                             engine="python").finalize()
    opens = COUNTERS["io.reader_opens"]
    capsys.readouterr()
    if engine == "mesh":
        got = C.classify_fastqs_mesh(PM.make_mesh(2, devices=["cpu"] * 2),
                                     table, paths, batch).finalize()
    else:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(C, "_reader_width", lambda n: n)
            got = C.classify_fastqs(table, paths, batch,
                                    engine="native").finalize()
        assert COUNTERS["io.reader_opens"] - opens == len(paths) + 1
        notes = [ln for ln in capsys.readouterr().err.splitlines()
                 if "NOTE" in ln]
        assert len(notes) == 1 and str(long_fq) in notes[0]
    w, g = np.argsort(want[0]), np.argsort(got[0])
    np.testing.assert_array_equal(got[0][g], want[0][w])
    np.testing.assert_array_equal(got[1][g], want[1][w])
    first = lines[0].split(b"#")[1].split(b"/")[0]
    assert want[1][want[0] == first].sum() > 0


def test_slice_matches_jax_on_synthetic_inputs(tmp_path):
    """The seeded generator's markers and reads (N reads, null barcodes,
    adaptor k-mers) through both packages' run_classify."""
    pytest.importorskip("jax")
    from hast_tpu.pipeline import classify as JC
    from hast_tpu_torch.utils import synthetic as S

    hap0, hap1 = str(tmp_path / "h0.mer"), str(tmp_path / "h1.mer")
    m0, m1 = S.make_marker_files(11, 3000, 21, hap0, hap1)
    assert m0.shape == (3000, 21) and m1.shape == (3000, 21)
    reads = str(tmp_path / "r.fq")
    S.make_stlfr_fastq(12, reads, m0, m1, 5000, chunk=1500)
    with open(reads, "rb") as f:
        head = f.read(4096)
    assert head.startswith(b"@V00000000#") and b"\n+\n" in head
    got = io.BytesIO()
    C.run_classify(hap0, hap1, [reads], got, w0=1.04, device="cpu")
    want = io.BytesIO()
    JC.run_classify(hap0, hap1, [reads], want, w0=1.04)
    rows = got.getvalue().splitlines()
    assert got.getvalue() == want.getvalue()
    assert {r.split(b"\t")[1] for r in rows} == {b"0", b"1", b"-1"}
    assert any(r.startswith(b"0_0_0\t") for r in rows)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,k,edges", [
    pytest.param("quot", 21, False, id="quot-21"),
    pytest.param("full", 31, False, id="full-31"),
    *(pytest.param(f, k, True, id=f"{f}-{k}-edges") for f, k in (
        ("quot", 15), ("quot", 17), ("quot", 21), ("full", 21),
        ("full", 31)))])
def test_tally_kernel_matches_twin(card, fmt, k, edges):
    """With edges: read_tile_edge_batches at every stride of
    READ_EDGE_STRIDES (the long-row form from 520 bytes), into a tally
    that holds counts, after checking that the library's tiles are the
    ones the batches were made for."""
    if edges:
        _tally_edges_on_card(card, fmt, k)
        return
    rng = np.random.default_rng(k)
    hi, lo = E.canonical_kmers_np(rng.integers(0, 4, (5000, k), np.int32), k)
    hi, lo = hi[:, 0], lo[:, 0]
    table = H.build_table(hi, lo, rng.integers(1, 4, 5000).astype(np.uint32),
                          k, load=0.7, fmt=fmt).to(card)
    packed, lengths, ids, has_n, acc = super_batch(
        k, (hi.astype(np.int64) << 32) | lo, k, s=4, b=1024)
    lp = packed.shape[-1]
    args = [torch.from_numpy(x.reshape(-1, lp) if x is packed
                             else x.reshape(-1)).to(card)
            for x in (packed, lengths, ids, has_n)]
    got = torch.from_numpy(acc).to(card)
    want = got.clone()
    launches = _build.LAUNCHES["classify_tally"]
    C.tally_step(table, got, *args)
    assert _build.LAUNCHES["classify_tally"] == launches + 1
    C.tally_step_ref(table, want, *args)
    assert torch.equal(got, want)


def _tally_edges_on_card(card, fmt: str, k: int):
    from hast_tpu_torch.utils import synthetic as S
    rng = np.random.default_rng(k)
    hi, lo = E.canonical_kmers_np(rng.integers(0, 4, (5000, k), np.int32), k)
    hi, lo = hi[:, 0], lo[:, 0]
    table = H.build_table(hi, lo, rng.integers(1, 4, 5000).astype(np.uint32),
                          k, load=0.7, fmt=fmt).to(card)
    words = (hi.astype(np.int64) << 32) | lo
    assert _build.read_tile_geometry() == S.READ_TILE_GEOMETRY
    for lp in S.READ_EDGE_STRIDES:
        for name, *batch in S.read_tile_edge_batches(k + lp, k, lp, words,
                                                     EDGE_CAP):
            args, acc = edge_tally_inputs(lp, *batch)
            args = [torch.from_numpy(x).to(card) for x in args]
            got = torch.from_numpy(acc).to(card)
            want = C.tally_step_ref(table, got.clone(), *args)
            launches = _build.LAUNCHES["classify_tally"]
            C.tally_step(table, got, *args)
            assert _build.LAUNCHES["classify_tally"] == launches + 1
            assert torch.equal(got, want), (lp, name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_goldens_bit_identical_on_card(card, tmp_path, case):
    hap0, hap1, reads, golden, batch = copy_case(case, tmp_path)
    out = io.BytesIO()
    C.run_classify(hap0, hap1, reads, out, w0=1.04, batch_size=batch,
                   device=card)
    assert out.getvalue() == golden


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["8bit", "16bit", "32bit", "negative"])
def test_tally_growth_and_pack_kernels_match_twins(card, regime):
    acc = torch.from_numpy(tally_values(regime)).to(card)
    launches = dict(_build.LAUNCHES)
    grown = C.grow_tally(acc, 3 * acc.shape[0])
    assert torch.equal(grown, C.grow_tally_ref(acc, 3 * acc.shape[0]))
    for g, w in zip(C.pack_tally(grown), C.pack_tally_ref(grown)):
        assert torch.equal(g, w)
    np.testing.assert_array_equal(C.fetch_tally(acc),
                                  acc.cpu().numpy().astype(np.int64))
    assert _build.LAUNCHES["grow_tally"] == launches.get("grow_tally", 0) + 1
    assert _build.LAUNCHES["pack_tally"] == launches.get("pack_tally", 0) + 2


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 2, 4, 1 << 12])
def test_grow_tally_kernel_paths(card, rows):
    """K10's int4 path (4 rows and more, aligned) and its int32 loop (1 or
    2 rows, or a tally that starts 12 bytes into its storage) against the
    twin, one launch each."""
    acc = torch.from_numpy(np.random.default_rng(rows).integers(
        -5, 300, (rows + 1, 3)).astype(np.int32)).to(card)
    for tally in (acc[:rows], acc[1:]):
        for max_id in (rows, 7 * rows + 3):
            launches = _build.LAUNCHES["grow_tally"]
            got = C.grow_tally(tally, max_id)
            assert _build.LAUNCHES["grow_tally"] == launches + 1
            assert torch.equal(got, C.grow_tally_ref(tally, max_id))
