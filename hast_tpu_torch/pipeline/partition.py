"""Barcode splits, fastq quartering (port of hast_tpu/pipeline/partition.py).

Host-only code, copied: the port imports nothing of ``hast_tpu``.
``split_barcodes`` mirrors
classify_stlfr_reads.sh:156-165; ``quarter_fastq`` mirrors
quartering_fastq.awk, routing whole records by the second field of the
head line under ``-F '#|/'`` (the reference's own asymmetry with the
classifier's last-#/last-/ barcode parse), through the native quartering
pass when libhastio is present; ``filter_fastq_by_barcodes`` mirrors
filter_fq_by_barcodes.awk.
"""

from __future__ import annotations

import os
import re
import sys

from hast_tpu_torch.io import fastq as FQ
from hast_tpu_torch.io import native as N

_SPLIT = re.compile(rb"[#/]")


def split_barcodes(phased_path: str, out_prefix: str = "") -> dict[str, str]:
    """phased.barcodes -> {paternal,maternal,homozygous}.unique.barcodes."""
    outs = {
        "0": open(out_prefix + "paternal.unique.barcodes", "wb"),
        "1": open(out_prefix + "maternal.unique.barcodes", "wb"),
        "-1": open(out_prefix + "homozygous.unique.barcodes", "wb"),
    }
    try:
        with open(phased_path, "rb") as f:
            for line in f:
                cols = line.split(b"\t")
                if len(cols) < 2:
                    continue
                o = outs.get(cols[1].decode())
                if o is not None:
                    o.write(cols[0] + b"\n")
    finally:
        for o in outs.values():
            o.close()
    return {k: o.name for k, o in outs.items()}


def _load_set(path: str) -> set[bytes]:
    with open(path, "rb") as f:
        return {line.rstrip(b"\r\n") for line in f if line.strip()}


def quarter_fastq(fastq_path: str, paternal_barcodes: str,
                  maternal_barcodes: str, homozygous_barcodes: str,
                  prefix: str | None = None,
                  log_path: str = "filter_reads.log",
                  err=sys.stderr) -> dict[str, int]:
    """Route one fastq into 4 bins by barcode class (awk parity).

    prefix defaults to basename(fastq_path) without a trailing ".gz".
    The native pass writes its unknown-barcode messages to the process's
    stderr, so it is taken only when err is sys.stderr.
    """
    if prefix is None:
        prefix = os.path.basename(fastq_path)
        if prefix.endswith(".gz"):
            prefix = prefix[:-3]
    if err is sys.stderr:
        stats = N.native_quarter(fastq_path, prefix, paternal_barcodes,
                                 maternal_barcodes, homozygous_barcodes,
                                 log_path)
        if stats is not None:
            return stats
    pat = _load_set(paternal_barcodes)
    mat = _load_set(maternal_barcodes)
    homo = _load_set(homozygous_barcodes)
    names = {0: prefix + ".nobarcode.fastq", 1: prefix + ".paternal.fastq",
             2: prefix + ".maternal.fastq", 3: prefix + ".homozygous.fastq"}
    outs: dict[int, object] = {}
    stats = dict(total=0, no_reads=0, pa_reads=0, ma_reads=0, ho_reads=0,
                 un_reads=0)
    # awk sees FILENAME="-" when fed from `gzip -dc |`
    logged_name = "-" if fastq_path.endswith(".gz") else fastq_path
    try:
        with open(log_path, "ab") as log:
            log.write(logged_name.encode() + b"\n")
            for rec in FQ.fastq_records(fastq_path):
                fields = _SPLIT.split(rec[0])
                stats["total"] += 1
                if len(fields) > 1 and fields[1] != b"0_0_0":
                    bc = fields[1]
                    if bc in pat:
                        stats["pa_reads"] += 1
                        rt = 1
                    elif bc in mat:
                        stats["ma_reads"] += 1
                        rt = 2
                    elif bc in homo:
                        stats["ho_reads"] += 1
                        rt = 3
                    else:
                        print(f"ERROR : unclassify barcode : {bc.decode()}",
                              file=err)
                        stats["un_reads"] += 1
                        continue
                else:
                    stats["no_reads"] += 1
                    rt = 0
                o = outs.get(rt)
                if o is None:
                    o = outs[rt] = open(names[rt], "wb")
                o.write(b"\n".join(rec) + b"\n")
            log.write(b"#Total reads                : %d \n" % stats["total"])
            log.write(b"#Reads without barcode      : %d \n"
                      % stats["no_reads"])
            log.write(b"#Paternal reads             : %d \n"
                      % stats["pa_reads"])
            log.write(b"#Maternal reads             : %d \n"
                      % stats["ma_reads"])
            log.write(b"#Homozygous reads           : %d \n"
                      % stats["ho_reads"])
    finally:
        for o in outs.values():
            o.close()
    return stats


def filter_fastq_by_barcodes(fastq_path: str, barcode_list: str, out,
                             log_path: str = "filter_reads.log") -> int:
    """Keep records whose $2 barcode is listed (filter_fq_by_barcodes.awk).

    Awk quirks preserved: a header WITHOUT a barcode field falls into
    the non-header branch and is printed iff the previous record was
    kept (the `c` flag, filter_fq_by_barcodes.awk:18-22); `total`
    counts only barcode-bearing headers; "use N from M" stats append to
    filter_reads.log (:25-26).
    """
    keep = _load_set(barcode_list)
    used = total = 0
    c = 0
    lineno = 0
    with FQ.open_text(fastq_path) as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            lineno += 1
            fields = _SPLIT.split(line)
            if lineno % 4 == 1 and len(fields) > 1:
                total += 1
                if fields[1] in keep:
                    out.write(line + b"\n")
                    used += 1
                    c = 1
                else:
                    c = 0
            elif c == 1:
                out.write(line + b"\n")
    with open(log_path, "ab") as log:
        log.write(b"use %d from %d\n" % (used, total))
    return used
