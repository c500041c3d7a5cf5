"""tools/draw_heatalign equivalents (a copy of hast_tpu/tools/heatalign.py).

Reimplements the reference SVG generators
(tools/draw_heatalign/{KIR,MHC}.cpp of HAST — identical except
for scale constants), the N-run reporter (getN.cpp), and the gene
coverage checker (CheckGenes.cpp).  CheckN.cpp in the reference is an
empty stub (parses args, returns 1) and is intentionally not
reproduced beyond :func:`check_n_stub`.

The SVG output reproduces the reference's element stream (header,
border, heat bar, per-pair ref line / query line / heat polygons,
scale, gene track) with the same geometry formulas; float-to-int
coordinate handling follows the C++ (int truncation where the
reference uses int variables, raw floats in the polygon path).
"""

from __future__ import annotations

import dataclasses
import sys

HEATCOLORS = [
    "rgba(253,254,191,0.90)", "rgba(249,226,123,0.90)",
    "rgba(252,191,84, 0.90)", "rgba(246,159,95, 0.90)",
    "rgba(231,133,117,0.90)", "rgba(207,115,136,0.90)",
    "rgba(180,103,149,0.90)", "rgba(151,93 ,154,0.90)",
    "rgba(122,83 ,149,0.90)", "rgba(92, 85 ,117,0.90)",
    "rgba(77, 77 ,79 ,0.90)",
]

PRESETS = {
    # scale_len, scale_step, scale_label_step, label_suffix, ref_name,
    # scale_line_x2
    "KIR": (1_100_000, 50_000, 100_000, "00Kb", "GRCH38 KIR", 900),
    "MHC": (5_000_000, 200_000, 1_000_000, " Mb", "GRCH38 MHC", 870),
}

MIN_IDY = 0.89


@dataclasses.dataclass
class AlignBlock:
    ref_name: str = ""
    ref_start: int = 0
    ref_end: int = 0
    query_name: str = ""
    query_start: int = 0
    query_end: int = 0
    idy: float = 0.0
    orient: bool = True
    is_n: bool = False

    @classmethod
    def from_line(cls, line: str, err=sys.stderr) -> "AlignBlock":
        b = cls()
        det = line.count("\t")
        if det < 6:
            print("align info is invalid:", file=err)
            print(line, file=err)
            print("please use \\t to seperate columns!!!", file=err)
            print("exit ...", file=err)
        parts = line.split()
        b.ref_name = parts[0]
        b.ref_start = int(parts[1])
        b.ref_end = int(parts[2])
        b.query_name = parts[3]
        b.query_start = int(parts[4])
        b.query_end = int(parts[5])
        if det == 6:
            b.idy = float(parts[6])
            b.orient = b.query_start < b.query_end
        else:
            o = parts[6]
            b.idy = float(parts[7])
            if o == "+":
                b.orient = True
            elif o == "-":
                b.orient = False
                if b.query_start < b.query_end:
                    b.query_start, b.query_end = b.query_end, b.query_start
            elif o in ("N", "n"):
                b.is_n = True
            else:
                raise ValueError(f"bad orient {o!r}")
        return b

    def maped_len(self) -> int:
        return 0 if self.is_n else self.ref_end - self.ref_start + 1


@dataclasses.dataclass
class QuerySeq:
    seq_name: str = ""
    query_shift: int = 0
    query_pos_min: int = -1
    query_pos_max: int = -1
    ref_pos_min: int = -1
    ref_pos_max: int = -1
    orient: bool = True
    valid_n_zone: bool = False
    blocks: list = dataclasses.field(default_factory=list)

    def is_n_seq(self) -> bool:
        return len(self.blocks) == 1 and self.blocks[0].is_n

    def seq_len(self) -> int:
        if not self.is_n_seq():
            return self.query_pos_max - self.query_pos_min + 1
        if self.ref_pos_max >= self.query_shift + 1000:
            return self.ref_pos_max - self.query_shift + 1
        return 1000

    def line_start(self) -> int:
        return self.query_shift

    def line_end(self) -> int:
        return self.query_shift + self.seq_len()

    def pos_in_line(self, pos: int) -> float:
        if self.orient:
            return pos - self.query_pos_min + self.query_shift
        return self.query_shift + self.query_pos_max - pos

    def set_shift(self, prev_line_end: int) -> None:
        for b in self.blocks:
            for v in (b.query_start, b.query_end):
                if self.query_pos_min == -1 or self.query_pos_min > v:
                    self.query_pos_min = v
                if self.query_pos_max == -1 or self.query_pos_max < v:
                    self.query_pos_max = v
            for v in (b.ref_start, b.ref_end):
                if self.ref_pos_min == -1 or self.ref_pos_min > v:
                    self.ref_pos_min = v
                if self.ref_pos_max == -1 or self.ref_pos_max < v:
                    self.ref_pos_max = v
        if not self.is_n_seq():
            self.query_shift = self.ref_pos_min \
                if prev_line_end < self.ref_pos_min else prev_line_end
        else:
            self.query_shift = prev_line_end

    def detect_orient(self) -> None:
        t = sum(b.maped_len() for b in self.blocks if b.orient)
        f = sum(b.maped_len() for b in self.blocks if not b.orient)
        self.orient = t > f


class Query:
    def __init__(self, name: str, align_index: int):
        self.query_name = name
        self.align_index = align_index
        self.seqs: list[QuerySeq] = []

    def _flush_last(self):
        if len(self.seqs) == 1:
            self.seqs[0].set_shift(0)
        elif len(self.seqs) > 1:
            self.seqs[-1].set_shift(self.seqs[-2].line_end())

    def load(self, filename: str, err=sys.stderr) -> None:
        print(f"loading data from {filename}", file=err)
        low_idy = 0
        curr = ""
        with open(filename) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                b = AlignBlock.from_line(line, err)
                if b.idy < MIN_IDY or \
                        abs(b.ref_end) - abs(b.ref_start) < 2000:
                    low_idy += 1
                    continue
                if curr == "" or curr != b.query_name or b.is_n:
                    curr = b.query_name
                    self._flush_last()
                    self.seqs.append(QuerySeq(seq_name=curr))
                    if b.is_n:
                        curr = ""
                self.seqs[-1].blocks.append(b)
        self._flush_last()
        for s in self.seqs:
            s.detect_orient()
        self._reset_n()
        print(f"filter {low_idy} low idy maps by min_idy={MIN_IDY:g}",
              file=err)
        print(f"loading data end with {len(self.seqs)} query sequence(s).",
              file=err)

    def _reset_n(self):
        for i, seq in enumerate(self.seqs):
            if not seq.is_n_seq():
                continue
            assert 0 < i < len(self.seqs) - 1
            prev, nxt = self.seqs[i - 1], self.seqs[i + 1]
            if prev.seq_name != nxt.seq_name:
                seq.valid_n_zone = False
                continue
            seq.valid_n_zone = True
            seq.query_shift = prev.line_end()
            seq.ref_pos_max = nxt.query_shift
            if seq.ref_pos_max < seq.query_shift + 1000:
                seq.ref_pos_max = seq.query_shift + 1000


class SvgWriter:
    """Geometry formulas mirror SVG_Align (KIR.cpp:70-278)."""

    def __init__(self, out, preset: str, align_num: int, ref_len: int):
        (self.scale_len, self.scale_step, self.scale_label_step,
         self.label_suffix, self.ref_name, self.scale_x2) = PRESETS[preset]
        self.preset = preset
        self.out = out
        self.align_num = align_num
        self.graph_width = 1200
        self.graph_height = ((align_num - 1) // 2 + 1) * 120 + 100
        self.ref_len = ref_len
        self.scale = 800.0 / ref_len

    def x_pos(self, pos) -> float:
        return 50 + pos * self.scale

    def y_in_ref(self, i) -> float:
        return ((i - 1) // 2 + 1) * 120

    def y_in_ref_rect(self, i) -> float:
        return self.y_in_ref(i) - 2 if i % 2 == 1 else self.y_in_ref(i) + 2

    def y_in_query_rect(self, i) -> float:
        return self.y_in_ref(i) - 45 if i % 2 == 1 else self.y_in_ref(i) + 45

    def y_in_query(self, i) -> float:
        return self.y_in_ref(i) - 47 if i % 2 == 1 else self.y_in_ref(i) + 47

    def header(self):
        self.out.write(
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>\n'
            '<!DOCTYPE svg PUBLIC "-//W3C//DTD SVG 1.0//EN" '
            '"http://www.w3.org/TR/2001/REC-SVG-20010904/DTD/svg10.dtd">\n'
            f'<svg height="{self.graph_height}" width="{self.graph_width}" '
            'xmlns="http://www.w3.org/2000/svg" '
            'xmlns:svg="http://www.w3.org/2000/svg" '
            'xmlns:xlink="http://www.w3.org/1999/xlink">\n')

    def footer(self):
        self.out.write("</svg>\n")

    def border(self):
        self.out.write(
            f'<rect width="{self.graph_width}" '
            f'height="{self.graph_height}" '
            'style="fill:rgb(255,255,255);stroke-width:1;'
            'stroke:rgb(0,0,0)"/>\n')

    def heat_bar(self):
        for i in range(11):
            x = 100 + i * 15
            c = HEATCOLORS[i]
            self.out.write(
                f'<rect width="15" height="15" x="{x}" y="15" '
                f'style="fill:{c};stroke:{c};stroke-width:1;" />\n')
        self.out.write('<text font-family="Arial" font-size="0.7em" '
                       'x="100" y="45">0%</text>\n')
        self.out.write('<text font-family="Arial" font-size="0.7em" '
                       'x="250" y="45">10%</text>\n')
        self.out.write('<text font-family="Arial" font-size="0.7em" '
                       'x="275" y="25">Est.difference</text>\n')

    def ref_line(self, i):
        y = int(self.y_in_ref(i))
        self.out.write(
            '<line fill="rgb(112,173,71)" stroke="rgb(112,173,71)" '
            f'stroke-width="3" x1="50" x2="850" y1="{y}" y2="{y}" />\n')

    def query_color(self, i) -> str:
        return "rgb(237,125,49)" if i % 2 == 1 else "rgb(91,155,213)"

    def query_line(self, start, end, i):
        x1, x2 = int(self.x_pos(start)), int(self.x_pos(end))
        y = int(self.y_in_query(i))
        c = self.query_color(i)
        self.out.write(
            f'<line fill="{c}" stroke="{c}" stroke-width="3" '
            f'x1="{x1}" x2="{x2}" y1="{y}" y2="{y}" />\n')

    def query_n_line(self, start, end, i):
        x1, x2 = int(self.x_pos(start)), int(self.x_pos(end))
        y = int(self.y_in_query(i))
        c = self.query_color(i)
        for dy in (1, -1):
            self.out.write(
                f'<line fill="none" stroke="{c}" stroke-width="1" '
                f'x1="{x1}" x2="{x2}" y1="{y + dy}" y2="{y + dy}" />\n')

    def heat_color(self, idy: float) -> str:
        if idy == 1:
            return HEATCOLORS[0]
        if idy < 0.89:
            # KIR.cpp:254-256: the <0.89 assignment is overwritten by
            # the else branch unless idy == 1 — reproduce the formula
            return HEATCOLORS[99 - int(idy * 100)] \
                if 99 - int(idy * 100) < 11 else HEATCOLORS[10]
        return HEATCOLORS[99 - int(idy * 100)]

    def map_rect(self, rstart, rend, qstart, qend, i, idy):
        xr1, xr2 = self.x_pos(rstart), self.x_pos(rend)
        xq1, xq2 = self.x_pos(qstart), self.x_pos(qend)
        yr, yq = self.y_in_ref_rect(i), self.y_in_query_rect(i)
        c = self.heat_color(idy)
        self.out.write(
            f'<polygon points="{_f(xr1)},{_f(yr)} {_f(xr2)},{_f(yr)} '
            f'{_f(xq2)},{_f(yq)} {_f(xq1)},{_f(yq)}" '
            f'style="fill:{c};stroke:{c};stroke-width:1;" />\n')

    def point_in_ref(self, pos, i):
        x, y = int(self.x_pos(pos)), int(self.y_in_ref(i))
        self.out.write(f'<circle cx="{x}" cy="{y}" r="1" stroke="black" '
                       'stroke-width="1" fill="black" />\n')

    def ref_name_text(self, i):
        y = int(self.y_in_ref(i) - 6)
        self.out.write(f'<text font-family="Arial" font-size="0.7em" '
                       f'x="70" y="{y}">{self.ref_name}</text>\n')

    def query_name_text(self, name, i):
        y = int(self.y_in_query(i))
        y = y + 15 if i % 2 == 1 else y - 6
        self.out.write(f'<text font-family="Arial" font-size="0.7em" '
                       f'x="70" y="{y}">{name}</text>\n')

    def scale_track(self):
        y = int(self.y_in_ref(self.align_num) + 60)
        self.out.write(
            '<line fill="black" stroke="black" stroke-width="1" '
            f'x1="30" x2="{self.scale_x2}" y1="{y}" y2="{y}" />\n')
        for pos in range(0, self.scale_len + 1, self.scale_step):
            x = int(self.x_pos(pos))
            y1 = y + 5 if pos % self.scale_label_step == 0 else y + 3
            self.out.write(
                '<line fill="black" stroke="black" stroke-width="1" '
                f'x1="{x}" x2="{x}" y1="{y}" y2="{y1}" />\n')
            if pos % self.scale_label_step == 0:
                xx = pos // self.scale_label_step
                if self.preset == "KIR":
                    label = f"{xx} " if xx == 0 else f"{xx}{self.label_suffix} "
                else:
                    label = f"{xx}{self.label_suffix} "
                self.out.write(
                    f'<text font-family="Arial" font-size="0.7em" '
                    f'x="{x - 10}" y="{y + 15}">{label}</text>\n')

    def gene_track(self, genes: dict[int, str]):
        y = int(self.y_in_ref(self.align_num))
        for index, pos in enumerate(sorted(genes), start=1):
            name = genes[pos]
            x = int(self.x_pos(pos))
            if len(name) < 3:
                y1 = y + 13 if index % 2 == 1 else y - 5
                self.out.write(
                    f'<text font-family="Arial" font-size="0.5em" '
                    f'x="{x}" y="{y1}" fill="black" >{name}</text>\n')
            else:
                if index % 2 == 1:
                    y1 = y + 8
                    rot = f'rotate(60,{x},{y1})'
                else:
                    y1 = y - 5
                    rot = f'rotate(-60,{x},{y1})'
                self.out.write(
                    f'<text font-family="Arial" font-size="0.5em" '
                    f'x="{x}" y="{y1}" fill="black" '
                    f'transform="{rot}">{name}</text>\n')


def _f(x: float) -> str:
    """ostream float formatting: %g with 6 significant digits."""
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return f"{x:g}"


def draw_heatalign(ref_len: int, align_files: list[str], out,
                   gene_file: str | None = None, preset: str = "KIR",
                   err=sys.stderr) -> None:
    """The KIR/MHC main(): align files -> SVG on `out`."""
    queries = []
    for i, path in enumerate(align_files, start=1):
        # reference keeps the full path minus ".align.txt" (KIR.cpp:62-68)
        name = path[:-10] if path.endswith(".align.txt") else path
        q = Query(name, i)
        q.load(path, err)
        queries.append(q)
    genes: dict[int, str] = {}
    if gene_file:
        with open(gene_file) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    genes[int(parts[0])] = parts[1]
        print(f"load {len(genes)} genes from {gene_file}", file=err)

    svg = SvgWriter(out, preset, len(queries), ref_len)
    svg.header()
    svg.border()
    svg.heat_bar()
    for q in queries:
        if q.align_index % 2 == 1:
            svg.ref_line(q.align_index)
            if gene_file:
                for pos in sorted(genes):
                    svg.point_in_ref(pos, q.align_index)
        for seq in q.seqs:
            if not seq.is_n_seq():
                svg.query_line(seq.line_start(), seq.line_end(),
                               q.align_index)
            elif seq.seq_len() > 0 and seq.valid_n_zone:
                svg.query_n_line(seq.line_start(), seq.line_end(),
                                 q.align_index)
        for seq in q.seqs:
            if seq.is_n_seq():
                continue
            for b in seq.blocks:
                svg.map_rect(b.ref_start, b.ref_end,
                             seq.pos_in_line(b.query_start),
                             seq.pos_in_line(b.query_end),
                             q.align_index, b.idy)
        if q.align_index % 2 == 1:
            svg.ref_name_text(q.align_index)
        svg.query_name_text(q.query_name, q.align_index)
    svg.scale_track()
    if gene_file:
        svg.gene_track(genes)
    svg.footer()


def get_n(fasta_lines, out) -> None:
    """getN.cpp: report 1-based [start, end] runs of N/n per sequence."""

    def flush(name, seq):
        if not name or not seq:
            return
        prev = -1
        cur = -1
        for i, c in enumerate(seq):
            if c in "Nn":
                cur = i
                if prev == -1:
                    prev = i
            else:
                if prev != -1 and cur != -1:
                    out.write(f"{name}\t{prev + 1}\t{cur + 1}\n")
                    prev = cur = -1
        # NOTE: reference never flushes a trailing N-run at sequence
        # end inside printNZone's loop... it does: loop ends without
        # final flush — an N-run touching the end of the sequence is
        # dropped (getN.cpp:10-24).  Reproduced.

    name, seq = "", []
    for line in fasta_lines:
        line = line.rstrip("\n")
        if not line:
            continue
        if line.startswith(">"):
            flush(name, "".join(seq))
            toks = line[1:].split()
            name = toks[0] if toks else ""
            seq = []
        else:
            seq.append(line)
    flush(name, "".join(seq))


def check_genes(align_txt: str, gene_txt: str, out) -> None:
    """CheckGenes.cpp: per-gene covered fraction by alignment blocks."""
    genes = []
    with open(gene_txt) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split()
            genes.append((int(parts[0]), int(parts[1]), parts[2], line))
    blocks = []
    with open(align_txt) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            b = AlignBlock.from_line(line)
            blocks.append(b)
    import numpy as np
    seen = set()
    for start, end, name, line in genes:
        if name in seen:
            continue
        seen.add(name)
        total = end - start + 1
        cov = 0
        for b in blocks:
            if b.ref_start > end or b.ref_end < start:
                continue
            s = max(b.ref_start, start)
            e = min(b.ref_end, end)
            cov += e - s + 1
        frac = np.float32(cov) / np.float32(total)
        out.write(f"{line}\t{frac:g}\n")


def check_n_stub() -> int:
    """CheckN.cpp is an unfinished stub in the reference: it parses
    its two arguments and returns 1 without doing anything."""
    return 1
