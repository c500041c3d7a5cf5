"""tools/self_vcftools equivalents (a copy of hast_tpu/tools/vcfqc.py).

Reimplements all ten reference programs
(HAST's tools/self_vcftools/*.cpp) with their observable
behavior, including quirks:

  * the shared split() drops empty fields mid-string
    (PhasedSNP.cpp:47-65) — "a\\t\\tb" parses as 3 columns a,b? no: 2.
  * V_in_Parent scores matches by the 1-based index of the matching
    allele in the *sorted* allele set, so "alt1"/"alt2" for 1_2
    genotypes follow sorted order, not GT order
    (InheritSolidSNP.cpp:191-227).
  * isChr1_22 accepts chr + 1-2 leading-digit names only
    (MergeHapSNP.cpp:113-122).
  * PhaseInheritSolidSNP computes inherit types but its print call is
    dead code — it emits only stderr stats (PhaseInheritSolidSNP.cpp
    main loop); reproduced as-is.
  * CalcHD uses not_match (unswitchable mismatches) + switch_error
    over each true phase block, minimum over both phase pairings
    (CalcHD.cpp:76-106,182-196).

Three VCF parse variants exist in the reference and are kept apart:
full (FILTER + FORMAT-indexed GT/PS + '.'->'0': PhasedSNP), format
(FORMAT-indexed GT/PS: GetSNPInfo, GetHapSNP_fromDipcall), simple
(column 10 field 0 = GT, field 1 = PS: the rest).
"""

from __future__ import annotations

import dataclasses
import sys

SNP, INDEL, SV = "SNP", "InDel", "SV"
T01, T11, T12 = "0_1", "1_1", "1_2"

# A_in_B_Type codes
A_NOT_IN_B, A_IN_B_REF, A_IN_B_ALT1, A_IN_B_ALT2, A_IN_B_ALL, A_DIFF_B = \
    range(6)


def split(s: str, sep: str) -> list[str]:
    """The reference's split: empty mid-fields dropped (:47-65)."""
    ret = []
    pos1 = 0
    pos2 = s.find(sep)
    while pos2 != -1:
        item = s[pos1:pos2]
        if item:
            ret.append(item)
        pos1 = pos2 + 1
        pos2 = s.find(sep, pos1)
    if pos1 != len(s):
        ret.append(s[pos1:])
    return ret


@dataclasses.dataclass
class VI:
    ref_name: str = ""
    pos: int = 0
    filter: str = "."
    ref: str = ""
    alt: str = ""
    seqs: set = dataclasses.field(default_factory=set)
    gt_str: str = ""
    phased_id: str = ""
    alt1: str = ""
    alt2: str = ""
    htype: str = T12
    vtype: str = SNP

    def valid(self) -> bool:
        return self.filter in ("PASS", ".")

    def is_chr1_22(self) -> bool:
        n = self.ref_name
        return (len(n) > 3 and n[:3] == "chr" and len(n) <= 5
                and n[3].isdigit())


def parse_vi(line: str, mode: str = "simple") -> VI:
    """mode: 'full' (filter+format+dot0), 'format', 'simple'."""
    items = split(line, "\t")
    vi = VI()
    vi.ref_name = items[0]
    vi.pos = int(items[1])
    vi.ref = items[3]
    vi.alt = items[4]
    v_alts = split(items[4], ",")
    vi.seqs = set(v_alts)
    if mode == "full":
        vi.filter = items[6]
        if not vi.valid():
            return vi
    if mode in ("full", "format", "format0"):
        describe = split(items[8], ":")
        gt_i = ps_i = -1
        for i, d in enumerate(describe):
            if d == "GT":
                gt_i = i
            if d == "PS":
                ps_i = i
        datas = split(items[9], ":")
        gt = datas[gt_i] if gt_i >= 0 else ""
        if mode in ("full", "format0"):
            gt = gt.replace(".", "0")
        vi.gt_str = gt
        if ps_i >= 0 and ps_i < len(datas):
            vi.phased_id = datas[ps_i]
        has_gt = gt_i >= 0
    else:
        datas = split(items[9], ":")
        vi.gt_str = datas[0]
        if len(datas) > 1:
            vi.phased_id = datas[1]
        has_gt = True
    if has_gt:
        gt = vi.gt_str
        if gt in ("0|1", "0/1", "1|0", "1/0"):
            vi.htype = T01
        elif gt in ("1|1", "1/1"):
            vi.htype = T11
        else:
            vi.htype = T12
        if vi.htype == T11:
            vi.alt1 = vi.alt2 = v_alts[0]
        elif vi.htype == T01:
            if gt in ("0/1", "0|1"):
                vi.alt1, vi.alt2 = vi.ref, v_alts[0]
            else:
                vi.alt1, vi.alt2 = v_alts[0], vi.ref
        else:
            # reference quirk: the 2|1/2/1 branch assigns the same
            # mapping as 1|2 (PhasedSNP.cpp:161-167 writes alt2 then
            # alt1 but from the same sources) — alts order always wins
            vi.alt1, vi.alt2 = v_alts[0], v_alts[1]
        if vi.htype == T01:
            vi.seqs.add(vi.ref)
    vi.vtype = SNP
    if len(vi.ref) == 1:
        if any(len(x) > 1 for x in vi.seqs):
            vi.vtype = INDEL
    else:
        vi.vtype = INDEL
    if vi.vtype == INDEL:
        if len(vi.ref) > 50 or any(len(x) > 50 for x in vi.seqs):
            vi.vtype = SV
    return vi


def _vcf_lines(path: str):
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line and line[0] != "#":
                yield line


def _load_vcf(path: str, err, mode: str = "simple", chr1_22: bool = False,
              snp_only: bool = False) -> dict[str, dict[int, VI]]:
    amap: dict[str, dict[int, VI]] = {}
    counts = {SNP: 0, INDEL: 0, SV: 0}
    total = 0
    for line in _vcf_lines(path):
        vi = parse_vi(line, mode)
        total += 1
        counts[vi.vtype] += 1
        if chr1_22 and not (vi.is_chr1_22() and vi.vtype == SNP):
            continue
        if snp_only and vi.vtype != SNP:
            continue
        amap.setdefault(vi.ref_name, {})[vi.pos] = vi
    print(f"Loaded total\t{total} variants from{path}", file=err)
    print(f"       SNPs\t{counts[SNP]}", file=err)
    print(f"       InDels\t{counts[INDEL]}", file=err)
    print(f"       SVs\t{counts[SV]}", file=err)
    if not chr1_22:
        print("", file=err)
    return amap


# ---------------------------------------------------------------------------
# simple extractors
# ---------------------------------------------------------------------------

def get_snp_only(vcf: str, out, err=sys.stderr) -> None:
    """GetSNPOnly: echo SNP lines verbatim."""
    total = counts = None
    n = {SNP: 0, INDEL: 0, SV: 0}
    total = 0
    for line in _vcf_lines(vcf):
        vi = parse_vi(line, "simple")
        total += 1
        n[vi.vtype] += 1
        if vi.vtype == SNP:
            out.write(line + "\n")
    print(f"Loaded total\t{total} variants from{vcf}", file=err)
    print(f"       SNPs\t{n[SNP]}", file=err)
    print(f"       InDels\t{n[INDEL]}", file=err)
    print(f"       SVs\t{n[SV]}", file=err)
    print("All done", file=err)


def get_snp_info(vcf: str, out, err=sys.stderr) -> None:
    """GetSNPInfo: CHROM POS ALT1 ALT2 for SNPs."""
    n = {SNP: 0, INDEL: 0, SV: 0}
    total = 0
    for line in _vcf_lines(vcf):
        vi = parse_vi(line, "format")
        total += 1
        n[vi.vtype] += 1
        if vi.vtype == SNP:
            out.write(f"{vi.ref_name}\t{vi.pos}\t{vi.alt1}\t{vi.alt2}\n")
    print(f"Loaded total\t{total} variants from{vcf}", file=err)
    print(f"       SNPs\t{n[SNP]}", file=err)
    print(f"       InDels\t{n[INDEL]}", file=err)
    print(f"       SVs\t{n[SV]}", file=err)
    print("All done", file=err)


def phased_snp(vcf: str, out, err=sys.stderr) -> None:
    """PhasedSNP: phased het SNPs as CHROM POS N1 N2 PS."""
    c = dict(variant=0, snp=0, indel=0, sv=0, phased=0, unphased=0,
             homo=0, invalid=0)
    for line in _vcf_lines(vcf):
        vi = parse_vi(line, "full")
        c["variant"] += 1
        if not vi.valid():
            c["invalid"] += 1
            continue
        if vi.vtype == INDEL:
            c["indel"] += 1
        if vi.vtype == SV:
            c["sv"] += 1
        if vi.vtype != SNP:
            continue
        c["snp"] += 1
        if vi.htype == T11:
            c["homo"] += 1
        elif vi.gt_str in ("0/1", "1/0", "2/1", "1/2"):
            c["unphased"] += 1
        else:
            c["phased"] += 1
            out.write(f"{vi.ref_name}\t{vi.pos}\t{vi.alt1}\t{vi.alt2}\t"
                      f"{vi.phased_id}\n")
    print(f"Loaded   total\t{c['variant']} variants from{vcf}", file=err)
    print(f"         SNPs\t{c['snp']}", file=err)
    print(f"   homo     SNPs\t{c['homo']}", file=err)
    print(f"   unphased SNPs\t{c['unphased']}", file=err)
    print(f"   phased   SNPs\t{c['phased']}", file=err)
    print(f"         InDels\t{c['indel']}", file=err)
    print(f"         SVs\t{c['sv']}\n", file=err)
    print(f"         Filter\t{c['invalid']}\n", file=err)
    print("All done", file=err)


def get_hapsnp_from_dipcall(vcf: str, out, err=sys.stderr) -> None:
    """GetHapSNP_fromDipcall: het SNPs; slashed GTs get random_$id PS."""
    rand_id = 0
    n = {SNP: 0, INDEL: 0, SV: 0}
    total = 0
    for line in _vcf_lines(vcf):
        # the shipped source is truncated mid-statement and unbuildable
        # (GetHapSNP_fromDipcall.cpp:134); we implement the evident
        # intent: FORMAT-indexed GT/PS plus PhasedSNP's '.'->'0' loop
        vi = parse_vi(line, "format0")
        total += 1
        n[vi.vtype] += 1
        if vi.vtype != SNP or vi.htype == T11:
            continue
        if vi.gt_str in ("0/1", "1/0", "2/1", "1/2"):
            out.write(f"{vi.ref_name}\t{vi.pos}\t{vi.alt1}\t{vi.alt2}\t"
                      f"random_{rand_id}\n")
            rand_id += 1
        else:
            out.write(f"{vi.ref_name}\t{vi.pos}\t{vi.alt1}\t{vi.alt2}\t"
                      f"{vi.phased_id}\n")
    print(f"Loaded total\t{total} variants from{vcf}", file=err)
    print("All done", file=err)


# ---------------------------------------------------------------------------
# trio inheritance typing
# ---------------------------------------------------------------------------

def v_in_parent(item: VI, parent: dict[str, dict[int, VI]]):
    """(A_in_B_Type, inherit_str) — InheritSolidSNP.cpp:191-227."""
    chrs = parent.get(item.ref_name)
    if chrs is None:
        return A_NOT_IN_B, ""
    vi = chrs.get(item.pos)
    if vi is None:
        return A_NOT_IN_B, ""
    match_num = 0
    match_str = ""
    for i, seq in enumerate(sorted(item.seqs), start=1):
        if seq in vi.seqs:
            match_num += i
            match_str = seq
    if match_num == 0:
        return A_DIFF_B, ""
    if match_num >= 3:
        return A_IN_B_ALL, ""
    if item.htype == T01:
        if match_str == item.ref:
            return A_IN_B_REF, match_str
        return A_IN_B_ALT1, match_str
    if item.htype == T11:
        return A_IN_B_ALT1, match_str
    return (A_IN_B_ALT1 if match_num == 1 else A_IN_B_ALT2), match_str


def is_snp_solid(vi: VI, p1: int, p2: int) -> bool:
    """InheritSolidSNP.cpp:260-321."""
    if vi.vtype != SNP:
        return False
    if vi.htype == T11:
        return p1 == A_IN_B_ALT1 and p2 == A_IN_B_ALT1
    if vi.htype == T01:
        if p1 in (A_NOT_IN_B, A_IN_B_REF):
            return p2 in (A_IN_B_ALT1, A_IN_B_ALL)
        if p1 == A_IN_B_ALT1:
            return p2 in (A_IN_B_ALL, A_NOT_IN_B, A_IN_B_REF)
        if p1 == A_IN_B_ALL:
            return p2 in (A_IN_B_ALL, A_NOT_IN_B, A_IN_B_ALT1, A_IN_B_REF)
        return False
    if vi.htype == T12:
        if p1 == A_IN_B_ALL:
            return p2 in (A_IN_B_ALL, A_IN_B_ALT1, A_IN_B_ALT2)
        if p1 == A_IN_B_ALT1:
            return p2 in (A_IN_B_ALL, A_IN_B_ALT2)
        if p1 == A_IN_B_ALT2:
            return p2 in (A_IN_B_ALL, A_IN_B_ALT1)
        return False
    return False


def is_snp_3aa(vi: VI, p1: int, p2: int) -> bool:
    """Inherit3Aa.cpp: 0_1 SNPs where both parents carry both alleles."""
    if vi.vtype != SNP:
        return False
    if vi.htype == T01:
        return p1 == A_IN_B_ALL and p2 == A_IN_B_ALL
    return False


def _print_inherit(out, vi: VI, t: int, inherit: str) -> None:
    out.write(f"{vi.ref_name}\t{vi.pos}\t{vi.ref}\t{vi.alt}\t{vi.gt_str}\t"
              f"{vi.htype}\t{vi.vtype}\t{t}\t")
    if t in (A_IN_B_REF, A_IN_B_ALT1, A_IN_B_ALT2):
        out.write(inherit + "\n")
    elif t == A_IN_B_ALL:
        out.write("*\n")
    else:
        out.write(".\n")


def hap_inherit(parent_vcf: str, child_vcf: str, out,
                err=sys.stderr) -> None:
    """HapInherit: type every child variant against one parent."""
    a_map = _load_vcf(parent_vcf, err, "simple")
    b_map = _load_vcf(child_vcf, err, "simple")
    for name in sorted(b_map):           # std::map iteration order
        chrom = b_map[name]
        for pos in sorted(chrom):
            vi = chrom[pos]
            t, inherit = v_in_parent(vi, a_map)
            _print_inherit(out, vi, t, inherit)
    print("All done", file=err)


def _inherit_filter(p1_vcf: str, p2_vcf: str, f1_vcf: str, out, err,
                    decide) -> None:
    p1_map = _load_vcf(p1_vcf, err, "simple")
    p2_map = _load_vcf(p2_vcf, err, "simple")
    n = {SNP: 0, INDEL: 0, SV: 0}
    total = solid = 0
    for line in _vcf_lines(f1_vcf):
        vi = parse_vi(line, "simple")
        total += 1
        n[vi.vtype] += 1
        if vi.vtype != SNP:
            continue
        t1, _ = v_in_parent(vi, p1_map)
        t2, _ = v_in_parent(vi, p2_map)
        if decide(vi, t1, t2):
            out.write(line + "\n")
            solid += 1
    print(f"Loaded total\t{total} variants from{f1_vcf}", file=err)
    print(f"       SNPs\t{n[SNP]}", file=err)
    print(f" solid SNPs\t{solid}", file=err)
    print(f"       InDels\t{n[INDEL]}", file=err)
    print(f"       SVs\t{n[SV]}\n", file=err)
    print("All done", file=err)


def inherit_solid_snp(p1: str, p2: str, f1: str, out, err=sys.stderr):
    _inherit_filter(p1, p2, f1, out, err, is_snp_solid)


def inherit_3aa(p1: str, p2: str, f1: str, out, err=sys.stderr):
    _inherit_filter(p1, p2, f1, out, err, is_snp_3aa)


def phase_inherit_solid_snp(p1: str, p2: str, f1: str, out,
                            err=sys.stderr) -> None:
    """PhaseInheritSolidSNP: computes inherit types per F1 SNP but the
    reference's print call is dead code — only stats are emitted."""
    p1_map = _load_vcf(p1, err, "simple")
    p2_map = _load_vcf(p2, err, "simple")
    f1_map = _load_vcf(f1, err, "simple")
    for chrom in f1_map.values():
        for vi in chrom.values():
            if vi.vtype != SNP:
                continue
            v_in_parent(vi, p1_map)
            v_in_parent(vi, p2_map)
    print("All done", file=err)


# ---------------------------------------------------------------------------
# pairing + Hamming error rate
# ---------------------------------------------------------------------------

def merge_hap_snp(h1_vcf: str, h2_vcf: str, out, err=sys.stderr) -> None:
    """MergeHapSNP: pair 1/1 SNPs of two hap assemblies (chr1-22)."""
    h1 = _load_vcf(h1_vcf, err, "simple", chr1_22=True)
    h2 = _load_vcf(h2_vcf, err, "simple", chr1_22=True)
    merged: dict[str, dict[int, tuple[str, str]]] = {}

    def update(src, other, is_h1):
        for chrom in src.values():
            for vi in chrom.values():
                dst = merged.setdefault(vi.ref_name, {})
                if vi.pos in dst:
                    continue
                ovi = other.get(vi.ref_name, {}).get(vi.pos)
                n2 = ovi.alt1 if ovi is not None else vi.ref
                dst[vi.pos] = (vi.alt1, n2) if is_h1 else (n2, vi.alt1)

    update(h1, h2, True)
    update(h2, h1, False)
    for ref_name in sorted(merged):
        for pos in sorted(merged[ref_name]):
            a1, a2 = merged[ref_name][pos]
            out.write(f"{ref_name}\t{pos}\t{a1}\t{a2}\n")


def calc_hd(standard_path: str, target_path: str,
            err=sys.stderr) -> dict[str, float]:
    """CalcHD: Hamming (unswitchable-mismatch) + switch error rates."""
    true_blocks: dict[str, dict[str, dict[int, tuple[str, str]]]] = {}
    n = 0
    with open(standard_path) as f:
        for line in f:
            # istringstream >> semantics: missing trailing fields stay
            # default ('' / 0); every line counts (CalcHD.cpp:156-161)
            parts = line.split()
            n += 1
            ref = parts[0] if len(parts) > 0 else ""
            pos = int(parts[1]) if len(parts) > 1 else 0
            a1 = parts[2] if len(parts) > 2 else ""
            a2 = parts[3] if len(parts) > 3 else ""
            ps = parts[4] if len(parts) > 4 else ""
            true_blocks.setdefault(ref, {}).setdefault(ps, {})[pos] = \
                (a1, a2)
    print(f"load {n} from {standard_path}", file=err)
    cand: dict[str, dict[int, tuple[str, str]]] = {}
    n = 0
    with open(target_path) as f:
        for line in f:
            parts = line.split()
            n += 1
            ref = parts[0] if len(parts) > 0 else ""
            pos = int(parts[1]) if len(parts) > 1 else 0
            a1 = parts[2] if len(parts) > 2 else ""
            a2 = parts[3] if len(parts) > 3 else ""
            cand.setdefault(ref, {})[pos] = (a1, a2)
    print(f"load {n} from {target_path}", file=err)
    print(f"load {n} in hap snp mode {target_path}", file=err)

    total_hit = total_wrong = total_pair = total_wrong_pair = 0
    for ref_name, blocks in true_blocks.items():
        chrom = cand.get(ref_name, {})
        for block in blocks.values():
            expect, real = [], []
            for pos in sorted(block):
                r = chrom.get(pos)
                if r is None:
                    continue
                expect.append(block[pos])
                real.append(r)
            # not_match
            w = sum(1 for e, r in zip(expect, real)
                    if not (e == r or (e[0] == r[1] and e[1] == r[0])))
            total_hit += len(expect)
            total_wrong += w
            # switch_error
            prev_s = -1
            for e, r in zip(expect, real):
                if e == r:
                    cur = 1
                elif e[0] == r[1] and e[1] == r[0]:
                    cur = 0
                else:
                    continue
                if prev_s == -1:
                    prev_s = cur
                if prev_s != cur:
                    total_wrong_pair += 1
                prev_s = cur
                total_pair += 1
    import numpy as np

    def _score(w, t):
        # x86 float 0/0 prints as "-nan" via ostream; match it
        if t == 0:
            return "-nan"
        return f"{np.float32(w) / np.float32(t):g}"

    print(f" total hit snps {total_hit} with wrong hit {total_wrong} "
          f"score={_score(total_wrong, total_hit)}", file=err)
    print(f" total hit snps pair {total_pair} with wrong pair "
          f"{total_wrong_pair} score={_score(total_wrong_pair, total_pair)}",
          file=err)
    return {"hamming_wrong": total_wrong, "hamming_total": total_hit,
            "switch_wrong": total_wrong_pair, "switch_total": total_pair}
