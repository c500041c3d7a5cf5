"""The frozen roofline counts give PERF.md section 6's bounds."""

from portbench import roofline as RL


def test_k3_bound_of_a_32768_read_batch():
    # chip_smoke.py's K3 batch: 32,768 reads of 100 bp in 112-base packed
    # rows (28 bytes), 256 reads shorter than k, 256 ids of -1, 2 % with
    # an N, a 4,096-row tally
    b = 32768
    probed = (b - 256 - 256 - round(0.02 * b)) * 80
    ms = RL.k3_bound_ms(b, 28 * b, 4096, probed)
    assert round(ms, 4) == 0.0245


def test_k5_bound_of_2_26_pairs_at_k21():
    assert RL.sort_passes(21) == 6
    assert round(RL.k5_bound_ms(1 << 26, 21), 4) == 0.4808
    # bytes bound it: 24 bytes a pair over 3.35 TB/s
    assert RL.k5_bound_ms(1 << 26, 21) == 24 * (1 << 26) / 3.35e12 * 1e3


def test_int32_rate_is_derived_from_the_boost_clock():
    assert RL.INT_OPS_PER_S == 132 * 64 * 1.98e9
