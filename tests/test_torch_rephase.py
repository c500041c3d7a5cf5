"""hast_tpu_torch.pipeline.rephase against hast_tpu.pipeline.rephase and
the stage-03 goldens.

K9's twin (segment_votes_ref, what the wrapper runs on CPU tensors) is
held against the JAX `_strict_vote` on one padded batch and against the
JAX `_segment_hits_batch` (pieces of 4096 bytes, votes summed per record)
on the same numpy-seeded records: soft-masked bases, N, IUPAC codes and
lengths 0, k - 1, k, 4096 + k - 1 and 9,000, at k = 15, 21 and 31, on
quot and full tables.  The segment table is held against the JAX build
(line-count set sizes, a mer file with duplicate lines), and the whole
stage on the CPU against every golden of tests/test_stage03_parity.py.
Integers and bytes only, so the tolerance is exact equality.  The kernel
and the goldens on the card are marked cuda.
"""

import io
import os
import pathlib

import numpy as np
import pytest
import torch

from hast_tpu_torch.ops import _build
from hast_tpu_torch.ops import encode as E
from hast_tpu_torch.ops import hashtable as H
from hast_tpu_torch.pipeline import rephase as R

GOLD = pathlib.Path(__file__).parent / "golden" / "stage03"
MERS = [str(GOLD / "paternal.mer"), str(GOLD / "maternal.mer")]
FILES = [
    "output.phb.1.fa", "output.phb.2.fa", "output.homo.fa",
    "phasing.out",
    "output.phb.12.father.idx", "output.phb.12.mother.idx",
    "output.phb.12.ambiguous.idx",
    "output.merge.father.ids", "output.merge.mother.ids",
    "output.merge.homo.ids",
    "output.father.fa", "output.father.idx", "output.supplement.fa",
]
TABLES = [(15, "quot"), (15, "full"), (21, "quot"), (21, "full"),
          (31, "full")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_records(seed: int, k: int, n_random: int = 24) -> list[bytes]:
    """Records of ACGT with 2 % soft-masked, 1 % N and 0.5 % IUPAC bytes;
    the first lengths are 0, k - 1, k, 4096 + k - 1 and 9,000."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", np.uint8)
    iupac = np.frombuffer(b"RYKMSWBDHV", np.uint8)
    lengths = [0, k - 1, k, 4096 + k - 1, 9000] + \
        rng.integers(0, 3000, n_random).tolist()
    out = []
    for n in lengths:
        s = letters[rng.integers(0, 4, n)]
        u = rng.random(n)
        s = np.where(u < 0.02, s | 0x20, s)
        s = np.where((u >= 0.02) & (u < 0.03), ord("N"), s)
        s = np.where((u >= 0.03) & (u < 0.035),
                     iupac[rng.integers(0, iupac.size, n)], s)
        out.append(s.astype(np.uint8).tobytes())
    return out


def edge_records(seed: int, k: int) -> list[bytes]:
    """The records a rolled window or a tile walk gets wrong: bad bytes
    (lowercase, N, IUPAC) on the first and last byte of K9's tiles and of
    1,024-window tiles, records of exactly k - 1 + 1,024 and k - 1 +
    SEGMENT_TILE bytes (one tile to the byte) and one byte more, one all
    lowercase, one with a single good window, and a record shorter than
    k between long ones."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", np.uint8)
    acgt = lambda n: letters[rng.integers(0, 4, n)].copy()  # noqa: E731
    out = []
    for tile in (1024, R.SEGMENT_TILE):
        s = acgt(2 * tile + k - 1 + 300)
        for i, t in enumerate(range(0, s.size, tile)):
            # a tile's first byte, and the last byte of its last window
            for pos in (t, t + tile + k - 2):
                if pos < s.size:
                    s[pos] = b"aNRy"[(i + pos) % 4]
        out.append(s.tobytes())
        out.append(acgt(k - 2).tobytes())
        for extra in (0, 1):
            out.append(acgt(k - 1 + tile + extra).tobytes())
    out.append(bytes(acgt(3000) | 0x20))
    one = np.full(2 * k + 11, ord("N"), np.uint8)
    one[k:2 * k] = acgt(k)
    out.append(one.tobytes())
    return out


def marker_keys(seed: int, k: int, seqs: list[bytes]):
    """1,500 windows drawn from the records (soft-masked and N ones too)
    plus 1,500 random keys, with payloads 1, 2 and 3; 100 keys appear
    twice (a mer file's duplicate lines), so their payloads are ORed."""
    rng = np.random.default_rng(seed)
    long = [np.frombuffer(s, np.uint8) for s in seqs if len(s) >= k]
    rows = []
    for _ in range(1500):
        s = long[int(rng.integers(0, len(long)))]
        p = int(rng.integers(0, s.size - k + 1))
        rows.append(s[p:p + k])
    rows = np.concatenate([np.stack(rows),
                           np.frombuffer(b"ACGT", np.uint8)[
                               rng.integers(0, 4, (1500, k))]])
    rows = np.concatenate([rows, rows[:100]])
    hi, lo = E.canonical_kmers_np(E.encode_np(rows), k)
    return hi[:, 0], lo[:, 0], rng.integers(1, 4, rows.shape[0]).astype(
        np.uint32)


def table_of(keys, k: int, fmt: str) -> H.KmerTable:
    table = H.build_table(*keys, k, fmt=fmt, set_sizes=(1500, 1500))
    assert table.fmt == fmt
    return table


def records_of(kind: str, k: int) -> list[bytes]:
    return make_records(k, k) if kind == "random" else edge_records(k, k)


# the random records keep their ids ("21-quot"); the edge records add
# cases of the same tests ("21-quot-edges")
RECORD_CASES = [pytest.param(k, fmt, kind, id=f"{k}-{fmt}{suffix}")
                for kind, suffix in (("random", ""), ("edges", "-edges"))
                for k, fmt in TABLES]


@pytest.mark.parametrize("k,fmt,kind", RECORD_CASES)
def test_segment_votes_twin_matches_jax(k, fmt, kind):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from hast_tpu.ops import hashtable as JH
    from hast_tpu.pipeline import rephase as JR

    seqs = records_of(kind, k)
    keys = marker_keys(k + 1, k, seqs)
    table = table_of(keys, k, fmt)
    jt = JH.build_table(*keys, k, fmt=fmt, set_sizes=(1500, 1500))
    before = dict(_build.TWIN_CALLS), dict(_build.LAUNCHES)
    got = R._segment_hits_batch(table, seqs)
    assert _build.TWIN_CALLS["segment_votes_ref"] == \
        before[0].get("segment_votes_ref", 0) + 1
    assert dict(_build.LAUNCHES) == before[1]

    # against the JAX pieces-and-sum path
    want = JR._segment_hits_batch(jt, seqs)
    np.testing.assert_array_equal(got, want)
    tiny = [i for i, s in enumerate(seqs) if len(s) < k]
    assert tiny and got[tiny].sum() == 0        # shorter than k: nothing
    assert got[:, 0].sum() > 0 and got[:, 1].sum() > 0
    if kind == "edges":
        # the all-lowercase record has no window, the last one at most one
        assert got[-2].sum() == 0 and got[-1].sum() <= 2

    # against one _strict_vote call on the records that fit a piece
    short = [s for s in seqs if len(s) <= 4096]
    buf = np.zeros((len(short), 4096), np.uint8)
    for i, s in enumerate(short):
        buf[i, :len(s)] = np.frombuffer(s, np.uint8)
    lengths = np.array([len(s) for s in short], np.int32)
    v0, v1 = JR._strict_vote(jnp.asarray(jt.data), jnp.asarray(buf),
                             jnp.asarray(lengths),
                             jnp.asarray(JR._UPPER_ACGT[buf]), k,
                             jt.max_probe, jt.fmt)
    np.testing.assert_array_equal(
        R._segment_hits_batch(table, short),
        np.stack([np.asarray(v0), np.asarray(v1)], axis=1))


def test_segment_votes_shapes_are_checked():
    seqs = make_records(3, 21, n_random=2)
    table = table_of(marker_keys(4, 21, seqs), 21, "full")
    data = torch.zeros(10, dtype=torch.uint8)
    starts = torch.tensor([0, 10])
    with pytest.raises(ValueError):
        R.segment_votes(table, data, starts.to(torch.int32),
                        torch.zeros((1, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        R.segment_votes(table, data, starts,
                        torch.zeros((2, 2), dtype=torch.int64))


def write_mer(path: pathlib.Path, words: np.ndarray, k: int) -> None:
    rows = E.words_to_bytes(words, k)
    path.write_bytes(b"\n".join(r.tobytes() for r in rows) + b"\n")


@pytest.mark.parametrize("case", ["golden", "quot-with-duplicates"])
def test_segment_table_matches_jax(tmp_path, case):
    """data, fmt and set_sizes of the JAX _build_segment_table: sizes are
    marker LINE counts, so a duplicated line counts twice."""
    pytest.importorskip("jax")
    from hast_tpu.pipeline import rephase as JR
    if case == "golden":
        files = MERS
    else:
        rng = np.random.default_rng(7)
        words = np.unique(rng.integers(0, 1 << 42, 45000, dtype=np.int64))
        rng.shuffle(words)
        files = [str(tmp_path / "hap0.mer"), str(tmp_path / "hap1.mer")]
        write_mer(pathlib.Path(files[0]),
                  np.concatenate([words[:20000], words[:500]]), 21)
        write_mer(pathlib.Path(files[1]), words[20000:40000], 21)
    got = R._build_segment_table(files, device="cpu")
    want = JR._build_segment_table(files)
    assert (got.fmt, got.set_sizes, got.n_buckets, got.n_keys) == \
        (want.fmt, want.set_sizes, want.n_buckets, want.n_keys)
    np.testing.assert_array_equal(got.data_np(), want.data)
    if case != "golden":
        assert got.fmt == "quot" and got.set_sizes == (20500, 20000)


def test_quot_table_segments_hit(tmp_path):
    """A marker set big enough for the quot format classifies (the JAX
    package's regression: a full-format probe of quot data hits nothing)."""
    rng = np.random.default_rng(7)
    words = np.unique(rng.integers(0, 1 << 42, 45000, dtype=np.int64))
    rng.shuffle(words)
    p0, p1 = tmp_path / "hap0.mer", tmp_path / "hap1.mer"
    write_mer(p0, words[:20000], 21)
    write_mer(p1, words[20000:40000], 21)
    fa = tmp_path / "seg.fa"
    fa.write_bytes(b">1_1_1\n" + b"".join(
        r.tobytes() for r in E.words_to_bytes(words[:50], 21)) + b"\n")
    out = io.StringIO()
    R.classify_segments([str(p0), str(p1)], [str(fa)], out, device="cpu")
    name, verdict, weight = out.getvalue().strip().split("\t")
    assert verdict == "haplotype0" and float(weight) >= 50 / 20000


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("stage03_torch")
    R.mkoutput(assembly_path=str(GOLD / "assembly"), prefix="output",
               paternal_mer=MERS[0], maternal_mer=MERS[1],
               prefer="paternal", workdir=str(out), device="cpu")
    return out


@pytest.mark.parametrize("name", FILES)
def test_mkoutput_file_bit_identical(run_dir, name):
    assert (run_dir / name).read_bytes() == (GOLD / name).read_bytes(), name


def test_mkoutput_symlinks(run_dir):
    primary = run_dir / "output.primary.fa"
    assert primary.is_symlink()
    assert os.readlink(primary) == "output.father.fa"
    assert not (run_dir / "output.secondary.fa").exists()


def test_mkoutput_secondary_symlink(tmp_path):
    """A second run with the opposite prefer in the same directory adds
    the secondary link and keeps the first run's primary."""
    args = dict(assembly_path=str(GOLD / "assembly"), prefix="output",
                paternal_mer=MERS[0], maternal_mer=MERS[1],
                workdir=str(tmp_path), device="cpu")
    R.mkoutput(prefer="maternal", **args)
    assert not (tmp_path / "output.secondary.fa").exists()
    res = R.mkoutput(prefer="paternal", **args)
    secondary = tmp_path / "output.secondary.fa"
    assert os.readlink(secondary) == "output.mother.fa"
    assert res["secondary"].endswith("output.secondary.fa")
    assert os.readlink(tmp_path / "output.primary.fa") == "output.mother.fa"


def test_mkoutput_prefix_in_a_directory(tmp_path):
    """Symlink targets are basenames: with prefix 'sub/output' the links
    resolve inside sub/, not at sub/sub/."""
    (tmp_path / "sub").mkdir()
    asm = tmp_path / "asm"
    (asm / "sub").mkdir(parents=True)
    for f in ("output.1.fasta", "output.2.fasta", "output.1.idx",
              "output.2.idx"):
        (asm / "sub" / f).write_bytes((GOLD / "assembly" / f).read_bytes())
    timings = {}
    R.mkoutput(str(asm), "sub/output", MERS[0], MERS[1], "paternal",
               str(tmp_path), device="cpu", timings=timings)
    primary = tmp_path / "sub" / "output.primary.fa"
    assert primary.read_bytes() == (GOLD / "output.father.fa").read_bytes()
    assert set(timings) == {"split", "table", "classify", "merge", "gensq"}


def test_classify_segments_fastq_mode():
    out = io.StringIO()
    R.classify_segments(MERS, [str(GOLD / "fastq_mode.fq")], out, fmt="fastq",
                        device="cpu")
    assert out.getvalue() == (GOLD / "fastq_mode.out").read_text()


@pytest.mark.parametrize("target_bytes", [1, 20_000, 10**9])
def test_segment_stream_incremental_and_equal(target_bytes):
    """The stream keeps input order, yields before the input is used up
    (bounded memory) and gives the same votes whatever the chunk size."""
    table = R._build_segment_table(MERS, device="cpu")
    rng = np.random.default_rng(3)
    B = np.frombuffer(b"ACGT", np.uint8)
    seqs = [B[rng.integers(0, 4, 9000)].tobytes() for _ in range(12)]
    consumed = []

    def gen():
        for i, s in enumerate(seqs):
            consumed.append(i)
            yield (b"%d_1_1" % i, s)

    stream = R._segment_hits_stream(table, gen(), target_bytes=target_bytes)
    names, hits = next(stream)
    if target_bytes < 10**9:
        assert len(consumed) < len(seqs), "stream held the whole input"
    for n, h in stream:
        names += n
        hits = np.concatenate([hits, h])
    assert names == [b"%d_1_1" % i for i in range(12)]
    np.testing.assert_array_equal(hits, R._segment_hits_batch(table, seqs))


def test_mkoutput_matches_jax_on_synthetic_assembly(tmp_path):
    """A seeded pseudohap2 assembly (the chip run's scale input, cut to
    400 kb) through both packages: every file equal, and each case of
    MergePhaseResult taken."""
    pytest.importorskip("jax")
    from hast_tpu.pipeline import rephase as JR
    from hast_tpu_torch.utils import synthetic as S
    mers = [str(tmp_path / "pat.mer"), str(tmp_path / "mat.mer")]
    made = S.make_pseudohap2_assembly(5, str(tmp_path), *mers,
                                      n_scaffolds=40, phased_bases=200_000,
                                      n_markers=5000, span=(200, 5000))
    assert made["phased_bases"][0] == 200_000 and all(made["cases"].values())
    for name in ("pat.mer", "mat.mer"):
        assert (tmp_path / name).read_bytes().count(b"\n") == 5000
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    R.mkoutput(str(tmp_path), "output", *mers, "paternal", str(ours),
               device="cpu")
    JR.mkoutput(str(tmp_path), "output", *mers, "paternal", str(theirs))
    names = sorted(p.name for p in theirs.iterdir() if not p.is_symlink())
    assert names == sorted(p.name for p in ours.iterdir()
                           if not p.is_symlink())
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), \
            name
    verdicts = {line.split("\t")[1] for line in
                (ours / "phasing.out").read_text().splitlines()}
    assert verdicts == {"haplotype0", "haplotype1", "ambiguous"}
    assert (ours / "output.merge.homo.ids").read_bytes()


@pytest.mark.cuda
@pytest.mark.parametrize("k,fmt,kind", RECORD_CASES)
def test_segment_votes_kernel_matches_twin(card, k, fmt, kind):
    seqs = records_of(kind, k)
    table = table_of(marker_keys(k + 1, k, seqs), k, fmt)
    starts = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=starts[1:])
    data = torch.frombuffer(bytearray(b"".join(seqs)), dtype=torch.uint8)
    args = (table.to(card), data.to(card), torch.from_numpy(starts).to(card))
    got = torch.zeros((len(seqs), 2), dtype=torch.int64, device=card) + 5
    want = got.clone()
    launches = _build.LAUNCHES["segment_votes"]
    R.segment_votes(*args, got)
    assert _build.LAUNCHES["segment_votes"] == launches + 1
    R.segment_votes_ref(*args, want)
    assert torch.equal(got, want)
    assert int(got.sum()) > 10 * len(seqs)


@pytest.mark.cuda
def test_mkoutput_goldens_on_card(card, tmp_path):
    launches = _build.LAUNCHES["segment_votes"]
    R.mkoutput(str(GOLD / "assembly"), "output", MERS[0], MERS[1],
               "paternal", str(tmp_path), device=card)
    assert _build.LAUNCHES["segment_votes"] > launches
    for name in FILES:
        assert (tmp_path / name).read_bytes() == (GOLD / name).read_bytes()
