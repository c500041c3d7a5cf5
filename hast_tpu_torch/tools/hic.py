"""tools/classify_hic_reads.sh equivalent (a copy of hast_tpu/tools/hic.py).

From two name-ordered SAM alignments (child Hi-C reads vs paternal and
maternal assemblies), score each read and route names into
paternal/maternal/homo lists (HAST's tools/classify_hic_reads.sh).

Faithful quirks preserved:
  * the "NM" value is taken from SAM column 12 only (cut -f 1,2,6,12);
    lines whose 12th column is not an NM tag score 0 (:29).
  * per-alignment identity uses cigar M/I/D runs: idy =
    1-(NM-g+o)/(m+o) with m=sum(M), g=sum(I,D), o=#(I,D) runs (:29).
  * only alignments with 0 < flag < 256 contribute; flag 0 (primary,
    forward strand) is excluded, exactly like the awk (:54).
  * the LAST read's score group is never flushed (the awk has no END
    block) — reproduced (:54).
  * score = 3*log10(idy) + log10(total_match_len), summed (:54).
"""

from __future__ import annotations

import math
import os
import re

_M_RE = re.compile(r"(\d+)M")
_ID_RE = re.compile(r"(\d+)[ID]")
_NM_RE = re.compile(r"NM:i:(\d+)")


def get_infos(sam_path: str):
    """Yield (name, flag, idy, exact_match_len, total_match_len)."""
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            cols = line.rstrip("\n").split("\t")
            name = cols[0] if cols else ""
            kept = "\t".join(
                cols[i] for i in (0, 1, 5, 11) if i < len(cols))
            m_nm = _NM_RE.search(kept)
            if m_nm:
                n = int(m_nm.group(1))
                m = sum(int(x) for x in _M_RE.findall(kept))
                g = sum(int(x) for x in _ID_RE.findall(kept))
                o = len(_ID_RE.findall(kept))
                denom = m + o
                idy = 1 - (n - g + o) / denom if denom else 0.0
                yield (name, int(cols[1]), idy, denom - (n - g + o), denom)
            else:
                yield (name, 0, 0.0, 0, 0)


def get_scores(infos):
    """Per-read summed score over primary alignments (awk parity,
    including the dropped final group)."""
    name, score = "", 0.0
    for rec_name, flag, idy, _exact, total in infos:
        if rec_name != name and name != "":
            yield name, score
            score = 0.0
        name = rec_name
        if 0 < flag < 256:
            li = math.log10(idy) if idy > 0 else float("-inf")
            lt = math.log10(total) if total > 0 else float("-inf")
            score += 3 * li + lt
    # NOTE: reference awk never flushes the last group; neither do we.


def classify_hic_reads(pat_sam: str, mat_sam: str,
                       out_dir: str = ".") -> dict[str, int]:
    """Full tool: infos -> scores -> outer join -> routed name lists."""
    s1 = dict(get_scores(get_infos(pat_sam)))
    s2 = dict(get_scores(get_infos(mat_sam)))
    counts = {"paternal": 0, "maternal": 0, "homo": 0}
    outs = {k: open(os.path.join(out_dir, f"{k}.reads"), "w")
            for k in counts}
    names = list(s1) + [n for n in s2 if n not in s1]
    for name in names:
        a = s1.get(name, 0.0)
        b = s2.get(name, 0.0)
        if a > b:
            key = "paternal"
        elif b > a:
            key = "maternal"
        else:
            key = "homo"
        outs[key].write(name + "\n")
        counts[key] += 1
    for o in outs.values():
        o.close()
    return counts
