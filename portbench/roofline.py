"""The yardstick of the kernels' roofline shares: peaks and work counts.

A frozen copy of what ``chip_smoke.py`` states (its ``HBM_BYTES_PER_S``,
``INT_OPS_PER_S``, ``bound()`` and the per-kernel operation counts), so
that a later change to the program cannot move the bound it is held to.

A kernel's bound is the least time the card could take for its work: the
larger of the bytes it must move (each input read once, each output
written once; a probing kernel adds the two 16-byte table rows a probed
window touches) over the HBM rate, and the int32 operations the work
needs over the int32 rate.  Its roofline share is that bound over the
kernel's measured device time.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s
HBM_BYTES_PER_S = 3.35e12
# int32 rate, derived from the boost clock and not a data-sheet figure:
# 132 SMs x 64 INT32 lanes x 1.98 GHz (Hopper white paper)
INT_OPS_PER_S = 132 * 64 * 1.98e9

# int32 operations the work needs, counted from the kernels' arithmetic
# with 64-bit words as two 32-bit halves, where the data allow the least:
# a window rolled one base a step (code 2, forward word 4, reverse
# complement 5, 64-bit min 4, run of good bases 3)
WINDOW_OPS = 18
# one two-bucket probe: quot = Feistel split 5 + 4 rounds of 11 + bucket
# and quotient 4 + alternate bucket 12 + 8 slot tests of 8 + the maxima 7;
# full = two hashes of 9 and 11, masks 2, 4 slot tests of 6, maxima 4
PROBE_OPS = {"quot": 136, "full": 50}
VOTE_OPS = 4          # payload bits into the two vote sums
READ_OPS = 10         # K3 per read: id and N tests, unknown flag, 3 adds
SORT_PASS_OPS = 8     # K5 per key and pass: digit, count, rank, place
SORT_DIGIT_BITS = 8   # K5's widest digit: ceil((2k + 1) / 8) passes


def bound_ms(n_bytes: float, n_ops: float) -> float:
    """The least milliseconds for n_bytes of traffic and n_ops int32
    operations: the larger of the two times."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT_OPS_PER_S) * 1e3


def k3_bound_ms(n_reads: int, packed_bytes: int, tally_rows: int,
                probed: int, fmt: str = "quot") -> float:
    """K3 ``classify_tally`` over n_reads reads: the packed reads, their
    lengths, ids and N flags (9 bytes a read) and the (rows, 3) int32
    tally read and written once, two 16-byte rows a probed window; a
    window, a probe and a vote's operations a probed window and
    READ_OPS a read."""
    n_bytes = packed_bytes + 9 * n_reads + 2 * 12 * tally_rows + 32 * probed
    n_ops = ((WINDOW_OPS + PROBE_OPS[fmt] + VOTE_OPS) * probed
             + READ_OPS * n_reads)
    return bound_ms(n_bytes, n_ops)


def sort_passes(k: int) -> int:
    """K5's radix passes at k: the low 2k + 1 bits, SORT_DIGIT_BITS a
    pass at most."""
    return math.ceil((2 * k + 1) / SORT_DIGIT_BITS)


def k5_bound_ms(n: int, k: int, payload: bool = True) -> float:
    """K5 ``sort_pairs`` of n int64 keys, with int32 payloads or none:
    each key and payload read once and written once (24 bytes a pair, 16
    a bare key), SORT_PASS_OPS a key a pass."""
    n_bytes = (24 if payload else 16) * n
    return bound_ms(n_bytes, SORT_PASS_OPS * n * sort_passes(k))
