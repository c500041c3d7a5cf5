"""Stage 03, "fabulous 2.0" re-phasing of Supernova pseudohap2 output
(port of hast_tpu/pipeline/rephase.py).

Replaces the four reference binaries (03.mkoutput_by_fabulous2.0
Split, classify, MergePhaseResult, GenSq) plus the shell script's grep/awk
routing (mkoutput_by_fabulous2.0.sh:119-126).  The segment classifier is
one kernel, K9 :func:`segment_votes` (``csrc/segment.cu``), over the
combined marker table; everything else is small-data host code, copied
from the JAX package.

Parity notes (the JAX package's, which its goldens pin):
  * Split: per scaffold the pseudohap2 .idx line "scaffid c0 c1 c2 ..."
    holds an even-length coordinate list; even-index pairs are
    homozygous spans, odd-index pairs are phased (bubble) spans
    (appcommon/Idx.h:21-36).  phb segments use odd seq_index 1,3,..,
    homo segments even 0,2,..; homo comes from the .1 fasta only; 60-col
    wrap (Split.cpp:82-119,146-162).
  * classify(fasta): the reference stores each marker string AND its
    reverse complement and probes raw substrings
    (03/src_main/classify.cpp:51-70,203-218), which equals canonical
    probing with windows restricted to uppercase ACGT.  hapCounts are
    normalized by the marker file LINE counts (not set sizes), and the
    verdict/print logic is PrintOutput (classify.cpp:104-135), including
    the literal "0.0" for all-zero sequences.
  * MergePhaseResult: pairing, the supernova-majority prior, and the
    float32 weight comparisons follow MergePhaseResult.cpp:57-156.
  * GenSq: alternating homo/phased block chain, 80-col output, block
    boundary idx, and the supplement map keyed by (scaff_id, phase_id)
    ONLY: the reference's Scaff_Seg_Head::operator< ignores seq_index
    (appcommon/SegmentFa.h:12-16), so later supplement segments of a
    scaffold overwrite the seq but keep the first segment's name; that
    observable behavior is reproduced (GenSq.cpp:237-271).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from hast_tpu_torch.io import fastq as FQ
from hast_tpu_torch.ops import _build
from hast_tpu_torch.ops import encode as E
from hast_tpu_torch.ops import hashtable as H

SEGMENT_TILE = 4096        # windows a K9 tile (csrc/segment.cu kTile)
SEGMENT_CHUNK = 1 << 24    # record bytes resident on the device at a time
_TWIN_CHUNK = 1 << 20      # window starts per step of the plain twin
_UPPER_ACGT = torch.zeros(256, dtype=torch.bool)
_UPPER_ACGT[list(b"ACGT")] = True

# ---------------------------------------------------------------------------
# shared small pieces
# ---------------------------------------------------------------------------


def wrap_seq(seq: bytes, n: int) -> bytes:
    """BGIQD::SEQ::seq::Seq(n): wrap at n cols, trailing newline, empty->''."""
    if not seq:
        return b""
    return b"\n".join(seq[i:i + n] for i in range(0, len(seq), n)) + b"\n"


def parse_seg_head(name: bytes | str) -> tuple[int, int, int]:
    """'12_3_1' (or '>12_3_1') -> (scaff_id, seq_index, phase_id)."""
    if isinstance(name, bytes):
        name = name.decode()
    name = name.lstrip(">")
    a, b, c = name.split("_")
    return int(a), int(b), int(c)


@dataclasses.dataclass
class Idx:
    scaffold_id: int
    indexs: list[int]

    @classmethod
    def from_line(cls, line: str) -> "Idx":
        parts = line.split()
        return cls(int(parts[0]), [int(x) for x in parts[1:]])

    def is_valid(self) -> bool:
        return len(self.indexs) > 1 and len(self.indexs) % 2 == 0

    def is_multi(self) -> bool:
        return len(self.indexs) > 2

    def phase_parts(self) -> list[tuple[int, int]]:
        if not self.is_valid() or not self.is_multi():
            return []
        return [(self.indexs[i], self.indexs[i + 1])
                for i in range(1, len(self.indexs) - 2, 2)]

    def homo_parts(self) -> list[tuple[int, int]]:
        if not self.is_valid():
            return []
        return [(self.indexs[i], self.indexs[i + 1])
                for i in range(0, len(self.indexs) - 1, 2)]


def _load_idx(path: str) -> dict[int, Idx]:
    cache: dict[int, Idx] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            idx = Idx.from_line(line)
            if not idx.is_valid():
                raise ValueError(f"{path}: odd or short coordinate list: "
                                 f"{line}")
            cache[idx.scaffold_id] = idx
    return cache


def _scaff_id_of(head: bytes) -> int:
    """std::stoul of the first header token (Id_Desc_Head.Id)."""
    tok = head.split()[0] if head.split() else b""
    digits = b""
    for ch in tok:
        if chr(ch).isdigit():
            digits += bytes([ch])
        else:
            break
    if not digits:
        raise ValueError(f"non-numeric scaffold id in header: {head!r}")
    return int(digits)


# ---------------------------------------------------------------------------
# Split (Split.cpp)
# ---------------------------------------------------------------------------

def split_pseudohap(fa_1: str, fa_2: str, idx_1: str, idx_2: str,
                    prefix: str) -> dict[str, str]:
    """pseudohap2 fastas + idx -> phb.1.fa / phb.2.fa / homo.fa."""
    names = {
        "phb1": prefix + ".phb.1.fa",
        "phb2": prefix + ".phb.2.fa",
        "homo": prefix + ".homo.fa",
    }
    idx1 = _load_idx(idx_1)
    fas1 = list(FQ.fasta_records(fa_1))

    with open(names["phb1"], "wb") as out:
        for head, seq in fas1:
            sid = _scaff_id_of(head)
            idx = idx1[sid]
            if not idx.is_multi():
                continue
            i = 1
            for start, end in idx.phase_parts():
                out.write(b">%d_%d_1\n" % (sid, i))
                out.write(wrap_seq(seq[start:end], 60))
                i += 2

    with open(names["homo"], "wb") as out:
        for head, seq in fas1:
            sid = _scaff_id_of(head)
            idx = idx1[sid]
            i = 0
            for start, end in idx.homo_parts():
                out.write(b">%d_%d_0\n" % (sid, i))
                out.write(wrap_seq(seq[start:end], 60))
                i += 2

    del fas1
    idx2 = _load_idx(idx_2)
    with open(names["phb2"], "wb") as out:
        for head, seq in FQ.fasta_records(fa_2):
            sid = _scaff_id_of(head)
            idx = idx2[sid]
            if not idx.is_multi():
                continue
            i = 1
            for start, end in idx.phase_parts():
                out.write(b">%d_%d_2\n" % (sid, i))
                out.write(wrap_seq(seq[start:end], 60))
                i += 2
    return names


# ---------------------------------------------------------------------------
# classify (fasta segments): 03/src_main/classify.cpp
# ---------------------------------------------------------------------------


def _check_segment_args(data: torch.Tensor, starts: torch.Tensor,
                        out: torch.Tensor) -> None:
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError(f"data must be (n,) uint8, got {tuple(data.shape)} "
                         f"{data.dtype}")
    if starts.dtype != torch.int64 or starts.dim() != 1 or \
            starts.numel() < 1:
        raise ValueError("starts must be (n_records + 1,) int64")
    n_rec = starts.numel() - 1
    if out.dtype != torch.int64 or tuple(out.shape) != (n_rec, 2):
        raise ValueError(f"out must be ({n_rec}, 2) int64, got "
                         f"{tuple(out.shape)} {out.dtype}")


def segment_votes_ref(table: H.KmerTable, data: torch.Tensor,
                      starts: torch.Tensor, out: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch twin of :func:`segment_votes` (adds into out).

    Walks the window starts of the whole byte buffer _TWIN_CHUNK at a
    time, so records of megabases take bounded memory: int64 codes,
    forward and reverse-complement words, an uppercase-ACGT test by a
    prefix sum of bad bytes, the window's record by a search of starts,
    then :func:`hashtable.probe_ref` of the valid windows and an
    ``index_add_`` of their payload bits into out.
    """
    _build.TWIN_CALLS["segment_votes_ref"] += 1
    k = table.k
    n = data.numel()
    starts = starts.to(torch.int64)
    upper = _UPPER_ACGT.to(data.device)
    for g0 in range(0, max(0, n - k + 1), _TWIN_CHUNK):
        nw = min(_TWIN_CHUNK, n - k + 1 - g0)
        seg = data[g0:g0 + nw + k - 1].to(torch.int64)
        codes = (seg >> 1) & 3
        fwd = torch.zeros(nw, dtype=torch.int64, device=data.device)
        rc = torch.zeros_like(fwd)
        for j in range(k):
            c = codes[j:j + nw]
            fwd |= c << (2 * (k - 1 - j))
            rc |= (c ^ 2) << (2 * j)
        bad = torch.zeros(nw + k, dtype=torch.int64, device=data.device)
        bad[1:] = torch.cumsum((~upper[seg]).to(torch.int64), 0)
        g = torch.arange(g0, g0 + nw, device=data.device)
        rec = torch.searchsorted(starts, g, right=True) - 1
        ok = ((bad[k:] - bad[:nw]) == 0) & (g + k <= starts[rec + 1])
        pay = H.probe_ref(table, torch.minimum(fwd, rc)[ok]).to(torch.int64)
        out.index_add_(0, rec[ok], torch.stack([pay & 1, (pay >> 1) & 1],
                                               dim=1))
    return out


def segment_votes(table: H.KmerTable, data: torch.Tensor,
                  starts: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Add each record's marker votes (v0, v1) into out (K9).

    data: (n,) uint8, the records' ASCII bytes back to back; starts:
    (R + 1,) int64, ascending from 0 to n (record r is
    data[starts[r]:starts[r + 1]]); out: (R, 2) int64, updated in place
    and returned.  v0 counts the record's windows of k uppercase A/C/G/T
    bytes whose payload has bit 0, v1 those with bit 1; records shorter
    than k add nothing.  CPU tensors take the twin; CUDA tensors launch
    the kernel.
    """
    H.check_table(table)
    _check_segment_args(data, starts, out)
    if data.device.type == "cpu":
        return segment_votes_ref(table, data, starts, out)
    _build.require_cuda("segment_votes", table.data, data, starts, out)
    n_rec = starts.numel() - 1
    if n_rec == 0 or data.numel() < table.k:
        return out
    n_win = (starts[1:] - starts[:-1] - (table.k - 1)).clamp_(min=0)
    tile_start = torch.zeros(n_rec + 1, dtype=torch.int64, device=data.device)
    torch.cumsum((n_win + SEGMENT_TILE - 1) // SEGMENT_TILE, 0,
                 out=tile_start[1:])
    _build.launch("segment_votes", out.device, *H.kernel_table_args(table),
                  data.data_ptr(), starts.data_ptr(), tile_start.data_ptr(),
                  n_rec, data.numel() // SEGMENT_TILE + n_rec, out.data_ptr())
    return out


def _build_segment_table(hap_files: list[str], device="cuda") -> H.KmerTable:
    """Combined canonical table; normalization uses marker LINE counts
    (03/src_main/classify.cpp:51-70 total_kmers), the load is
    build_table's default and no snapshot is cached (stage 01's
    load_marker_table differs in all three)."""
    his, los, pays, totals = [], [], [], []
    k = None
    for h, path in enumerate(hap_files):
        hi, lo, kk = E.load_mer_file(path, k_expect=k)
        k = kk
        his.append(hi)
        los.append(lo)
        pays.append(np.full(hi.size, 1 << h, np.uint32))
        totals.append(hi.size)
        print(f"Recorded {hi.size} haplotype {h} specific {k}-mers",
              file=sys.stderr)
    table = H.build_table(np.concatenate(his), np.concatenate(los),
                          np.concatenate(pays), k,
                          set_sizes=tuple(totals))
    return table.to(device)


def _segment_hits_stream(table: H.KmerTable, records,
                         target_bytes: int = SEGMENT_CHUNK):
    """Stream (names, hits) over record chunks of bounded device memory.

    The reference classifier streams segments through a job pool with
    10000/3000 watermarks (03/src_main/classify.cpp:180-230) so memory
    stays constant in the input size; the same contract holds here: only
    one chunk of records (about target_bytes, plus the largest single
    record) is resident at a time, and verdicts emit in input order,
    chunk by chunk.
    """
    names: list[bytes] = []
    seqs: list[bytes] = []
    n_bytes = 0
    for head, seq in records:
        names.append(head)
        seqs.append(seq)
        n_bytes += len(seq)
        if n_bytes >= target_bytes:
            yield names, _segment_hits_batch(table, seqs)
            names, seqs, n_bytes = [], [], 0
    if names:
        yield names, _segment_hits_batch(table, seqs)


def _segment_hits_batch(table: H.KmerTable, seqs: list[bytes]) -> np.ndarray:
    """(len(seqs), 2) int64 votes of one chunk: one K9 call on the
    table's device over the chunk's bytes."""
    starts = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=starts[1:])
    if starts[-1] < table.k:
        return np.zeros((len(seqs), 2), np.int64)
    dev = table.data.device
    data = torch.frombuffer(bytearray(b"".join(seqs)), dtype=torch.uint8)
    out = torch.zeros((len(seqs), 2), dtype=torch.int64, device=dev)
    segment_votes(table, data.to(dev), torch.from_numpy(starts).to(dev), out)
    return out.cpu().numpy()


def write_verdicts(table: H.KmerTable, path: str, out,
                   fmt: str = "fasta") -> None:
    """Verdict lines of one fasta (or fastq) file's records against a
    built segment table, in input order (see :func:`classify_segments`)."""
    if fmt == "fasta":
        records = FQ.fasta_records(path)
    else:
        records = ((rec[0][1:], rec[1]) for rec in FQ.fastq_records(path))
    totals = table.set_sizes
    for names, hits in _segment_hits_stream(table, records):
        for i, head in enumerate(names):
            counts = [hits[i, 0] / totals[0], hits[i, 1] / totals[1]]
            out.write(_verdict_line(head.decode(), counts))


def classify_segments(hap_files: list[str], read_files: list[str], out,
                      fmt: str = "fasta", device="cuda",
                      timings: dict | None = None) -> None:
    """Stage-03 classify main(): per-sequence verdict lines on ``out``.

    Output (03/src_main/classify.cpp:104-135): "name\\tverdict\\tweight"
    where verdict is haplotype0/haplotype1/ambiguous; weight is the
    normalized top count at %0.6f, or the literal 0.0 for all-zero.
    timings, when given, receives the wall seconds of the table parse
    and build ("table") and of the classification ("classify").
    """
    timings = {} if timings is None else timings
    t0 = time.perf_counter()
    table = _build_segment_table(hap_files, device)
    t1 = time.perf_counter()
    for path in read_files:
        write_verdicts(table, path, out, fmt)
    timings.update(table=t1 - t0, classify=time.perf_counter() - t1)


def _verdict_line(name: str, counts: list[float]) -> str:
    best = 0.0
    second = 0.0
    hap = ""
    for i, c in enumerate(counts):
        if c > 0 and c < best and c > second:
            second = c
        if c > 0 and c > best:
            hap = f"haplotype{i}"
            second = best
            best = c
    if second == 0 and best != 0:
        return f"{name}\t{hap}\t{best:0.6f}\n"
    if best == 0 and second == 0:
        return f"{name}\tambiguous\t0.0\n"
    if best / second > 1:
        return f"{name}\t{hap}\t{best:0.6f}\n"
    return f"{name}\tambiguous\t{best:0.6f}\n"


def route_phasing(phasing_out: str, prefix: str) -> dict[str, str]:
    """phasing.out -> father/mother/ambiguous idx (the script's grep/awk,
    mkoutput_by_fabulous2.0.sh:124-126): '$1\\t$3' per matching line."""
    names = {
        "father": prefix + ".phb.12.father.idx",
        "mother": prefix + ".phb.12.mother.idx",
        "ambiguous": prefix + ".phb.12.ambiguous.idx",
    }
    outs = {key: open(p, "w") for key, p in names.items()}
    try:
        with open(phasing_out) as f:
            for line in f:
                cols = line.split()
                if len(cols) < 3:
                    continue
                # grep semantics: substring match anywhere in the line
                for key, pat in (("father", "haplotype0"),
                                 ("mother", "haplotype1"),
                                 ("ambiguous", "ambiguous")):
                    if pat in line:
                        outs[key].write(f"{cols[0]}\t{cols[2]}\n")
    finally:
        for o in outs.values():
            o.close()
    return names


# ---------------------------------------------------------------------------
# MergePhaseResult (MergePhaseResult.cpp)
# ---------------------------------------------------------------------------

FATHER, MOTHER, HOMO = 1, 2, 3


def _oppo(t: int) -> int:
    if t == HOMO:
        raise ValueError("a homozygous verdict has no opposite")
    return MOTHER if t == FATHER else FATHER


@dataclasses.dataclass
class _Elem:
    trio: int = 0
    paired: int = 0
    super_type: int = 0   # 1 or 2
    line: str = ""
    weight: np.float32 = np.float32(0)


def merge_phase_result(prefix: str, father_ids: str, mother_ids: str,
                       homo_ids: str) -> dict[str, str]:
    data: dict[int, dict[int, dict[int, _Elem]]] = {}

    def load(path: str, trio: int):
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                name = parts[0]
                weight = np.float32(parts[1]) if len(parts) > 1 \
                    else np.float32(0)
                sid, seg, phase = parse_seg_head(name)
                elem = _Elem(trio=trio, line=name, weight=weight,
                             super_type=phase)
                if phase not in (1, 2):
                    raise ValueError(f"bad phase id in {name}")
                data.setdefault(sid, {}).setdefault(seg, {})[phase] = elem

    load(father_ids, FATHER)
    load(mother_ids, MOTHER)
    load(homo_ids, HOMO)

    pairs = []
    for sid in sorted(data):
        for seg in sorted(data[sid]):
            pair = data[sid][seg]
            if 1 not in pair or 2 not in pair:
                raise ValueError(
                    f"unpaired phase block scaff={sid} seg={seg}")
            pairs.append((pair[1], pair[2]))

    # GenTrioBinPairedResult
    for e1, e2 in pairs:
        if e1.trio != e2.trio and e1.trio != HOMO and e2.trio != HOMO:
            e1.paired, e2.paired = e1.trio, e2.trio
        elif e1.trio == e2.trio:
            e1.paired = e2.paired = HOMO
        elif e1.trio == HOMO:
            e2.paired = e2.trio
            e1.paired = _oppo(e2.trio)
        else:
            e1.paired = e1.trio
            e2.paired = _oppo(e1.trio)

    # CountSupernovaType1: majority vote over type-1 paired results
    counts = {FATHER: 0, MOTHER: 0, HOMO: 0}
    for e1, e2 in pairs:
        vote = e1.paired if e1.super_type == 1 else e2.paired
        counts[vote] += 1
    total = counts[FATHER] + counts[MOTHER] + counts[HOMO]
    father_fac = np.float32(counts[FATHER]) / np.float32(total)
    mother_fac = np.float32(counts[MOTHER]) / np.float32(total)
    homo_fac = np.float32(counts[HOMO]) / np.float32(total)
    print(f" father_fac {father_fac:g}", file=sys.stderr)
    print(f" mother_fac {mother_fac:g}", file=sys.stderr)
    print(f" homo_fac {homo_fac:g}", file=sys.stderr)
    type_1_eq = FATHER if father_fac >= mother_fac else MOTHER

    # SetAllHomo: resolve residual both-homo pairs
    final_homo: set[str] = set()
    for e1, e2 in pairs:
        if e1.paired == e2.paired:
            if e1.paired != HOMO:
                raise ValueError(f"pair {e1.line} resolved to one side")
            if e1.weight > e2.weight:
                e1.paired = e1.trio
                e2.paired = _oppo(e1.trio)
            elif e1.weight < e2.weight:
                e2.paired = e2.trio
                e1.paired = _oppo(e2.trio)
            else:
                e1.paired = type_1_eq if e1.super_type == 1 \
                    else _oppo(type_1_eq)
                e2.paired = type_1_eq if e2.super_type == 1 \
                    else _oppo(type_1_eq)
                final_homo.add(e1.line)

    names = {
        "father": prefix + ".merge.father.ids",
        "mother": prefix + ".merge.mother.ids",
        "homo": prefix + ".merge.homo.ids",
    }
    with open(names["father"], "w") as f:
        for e1, e2 in pairs:
            f.write((e1.line if e1.paired == FATHER else e2.line) + "\n")
    with open(names["mother"], "w") as f:
        for e1, e2 in pairs:
            f.write((e2.line if e1.paired == FATHER else e1.line) + "\n")
    with open(names["homo"], "w") as f:
        for line in sorted(final_homo):
            f.write(line + "\n")
    return names


# ---------------------------------------------------------------------------
# GenSq (GenSq.cpp)
# ---------------------------------------------------------------------------

def gen_sq(prefix: str, prefer: str) -> dict[str, str]:
    if prefer not in ("pat", "mat"):
        raise ValueError(f"prefer must be pat or mat, got {prefer!r}")
    # load segment fastas: cache[scaff][seq_index][phase] = seq
    cache: dict[int, dict[int, dict[int, bytes]]] = {}
    for suffix in (".phb.1.fa", ".phb.2.fa", ".homo.fa"):
        for head, seq in FQ.fasta_records(prefix + suffix):
            sid, seg, phase = parse_seg_head(head)
            cache.setdefault(sid, {}).setdefault(seg, {})[phase] = seq

    # phased block -> (father_seq_key, mother_seq_key)
    phased: dict[int, dict[int, dict[str, tuple[int, int, int]]]] = {}
    for which, path in (("father", prefix + ".merge.father.ids"),
                        ("mother", prefix + ".merge.mother.ids")):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                sid, seg, phase = parse_seg_head(line)
                phased.setdefault(sid, {}).setdefault(seg, {})[which] = (
                    sid, seg, phase)

    out_key = "father" if prefer == "pat" else "mother"
    fa_path = f"{prefix}.{out_key}.fa"
    idx_path = f"{prefix}.{out_key}.idx"
    idx_cache: dict[int, list[int]] = {}
    with open(fa_path, "wb") as out:
        for sid in sorted(cache):
            blocks = {}
            for seg, phases in cache[sid].items():
                if 0 in phases:
                    blocks[seg] = phases[0]
            for seg, sides in phased.get(sid, {}).items():
                key = sides.get(out_key)
                if key is None:
                    raise ValueError(
                        f"missing {out_key} block scaff={sid} seg={seg}")
                blocks[seg] = cache[key[0]][key[1]][key[2]]
            n = len(blocks)
            if n % 2 != 1:
                raise ValueError(f"scaffold {sid}: {n} blocks, not odd")
            idx = [0]
            parts = []
            for i in range(n):
                if i not in blocks:
                    raise ValueError(f"missing block {sid}/{i}")
                parts.append(blocks[i])
                idx.append(idx[-1] + len(blocks[i]))
            seq = b"".join(parts)
            out.write(b">%d\n" % sid)
            out.write(wrap_seq(seq, 80))
            idx_cache[sid] = idx
    with open(idx_path, "w") as out:
        for sid in sorted(idx_cache):
            out.write(str(sid) + "".join(f" {i}" for i in idx_cache[sid])
                      + "\n")

    # supplement: non-preferred branch of globally-voted homo pairs,
    # keyed by (scaff_id, phase_id) only (the reference operator< quirk)
    supp_key_order: list[tuple[int, int]] = []
    supp_name: dict[tuple[int, int], tuple[int, int]] = {}
    supp_seq: dict[tuple[int, int], bytes] = {}
    other = "mother" if prefer == "pat" else "father"
    with open(prefix + ".merge.homo.ids") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            sid, seg, phase = parse_seg_head(line)
            sides = phased[sid][seg]
            key = sides[other]
            mapkey = (sid, phase)
            if mapkey not in supp_name:
                supp_name[mapkey] = (sid, seg)
                supp_key_order.append(mapkey)
            supp_seq[mapkey] = cache[key[0]][key[1]][key[2]]
    supp_path = prefix + ".supplement.fa"
    with open(supp_path, "wb") as out:
        for mapkey in sorted(supp_name):
            sid, seg = supp_name[mapkey]
            out.write(b">scaff_%d_segment_%d\n" % (sid, seg))
            out.write(wrap_seq(supp_seq[mapkey], 80))
    return {out_key: fa_path, "idx": idx_path, "supplement": supp_path}


# ---------------------------------------------------------------------------
# the whole stage (mkoutput_by_fabulous2.0.sh)
# ---------------------------------------------------------------------------

def mkoutput(assembly_path: str, prefix: str, paternal_mer: str,
             maternal_mer: str, prefer: str = "paternal",
             workdir: str = ".", device="cuda",
             timings: dict | None = None) -> dict[str, str]:
    """Full stage 03: Split -> classify -> route -> merge -> GenSq.

    Runs in ``workdir`` (the process changes into it and back).  timings,
    when given, receives each step's wall seconds: split, table (marker
    parse and table build), classify, merge (routing and
    MergePhaseResult) and gensq.
    """
    timings = {} if timings is None else timings
    assembly_path, paternal_mer, maternal_mer = (
        os.path.abspath(p) for p in (assembly_path, paternal_mer,
                                     maternal_mer))
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        p = prefix
        t0 = time.perf_counter()
        split_pseudohap(
            os.path.join(assembly_path, p + ".1.fasta"),
            os.path.join(assembly_path, p + ".2.fasta"),
            os.path.join(assembly_path, p + ".1.idx"),
            os.path.join(assembly_path, p + ".2.idx"), p)
        with open(p + ".phb.12.fa", "wb") as out:
            for name in (p + ".phb.1.fa", p + ".phb.2.fa"):
                with open(name, "rb") as f:
                    out.write(f.read())
        timings["split"] = time.perf_counter() - t0
        with open("phasing.out", "w") as out:
            classify_segments([paternal_mer, maternal_mer],
                              [p + ".phb.12.fa"], out, device=device,
                              timings=timings)
        t0 = time.perf_counter()
        routed = route_phasing("phasing.out", p)
        merge_phase_result(p, routed["father"], routed["mother"],
                           routed["ambiguous"])
        t1 = time.perf_counter()
        result = gen_sq(p, "pat" if prefer == "paternal" else "mat")
        timings.update(merge=t1 - t0, gensq=time.perf_counter() - t1)
        # final symlinks (mkoutput_by_fabulous2.0.sh:142-152): primary ->
        # the preferred hap's fa; secondary -> the other hap's fa IF that
        # file exists (GenSq only writes the preferred side, so secondary
        # appears only when an earlier opposite-prefer run left its fa).
        out_key = "father" if prefer == "paternal" else "mother"
        other_key = "mother" if prefer == "paternal" else "father"
        # symlink targets must be basenamed: a relative target resolves
        # from the LINK's directory, so with a prefix like "out/hap" a
        # target "out/hap.father.fa" would dangle at "out/out/..."
        primary = p + ".primary.fa"
        if not os.path.exists(primary):
            os.symlink(os.path.basename(f"{p}.{out_key}.fa"), primary)
        secondary = p + ".secondary.fa"
        other_fa = f"{p}.{other_key}.fa"
        if os.path.exists(other_fa) and not os.path.exists(secondary):
            os.symlink(os.path.basename(other_fa), secondary)
            result["secondary"] = secondary
        result["primary"] = primary
        return result
    finally:
        os.chdir(cwd)
