"""The comparison that decides `correct` fails the control and each
fault the cells can have."""

import numpy as np
import pytest
import torch

from portbench import control
from portbench.tests import tiny


def test_classify_control_fails_at_a_size_where_float32_loses_a_unit():
    """Sets of 2^24 and 2^24 + 1 markers: float32 cannot tell the sizes
    apart (the cell's 5e7 and 5e7 + 1 alike), and the near-tie barcodes
    decide otherwise."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        c = tiny.cell(tmp, "classify-hbm-gz",
                      config={"markers_per_haplotype": 1 << 24,
                              "read_pairs": 3000},
                      traffic={"near_tie_barcodes": 20})
        r = control.readings(c, 7, "cpu", tmp)
    assert r["phased_rows_wrong"][0] > 0


def test_markers_control_fails_where_counts_pass_2_21(tmp_path):
    """A segment that is mostly satellite: its five k-mers count past
    2^21, and the 21-bit counts of the control miss the total."""
    c = tiny.cell(tmp_path, "markers-parts4",
                  config={"genome_length": 500000,
                          "satellite_length": 470000})
    r = control.readings(c, 11, "cpu", str(tmp_path))
    assert r["total_gap"][0] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["classify-hbm-gz", "markers-parts4"])
@pytest.mark.parametrize("seed", [3100000001, 3100000002, 3100000003])
def test_control_fails_on_the_card_at_the_cells_size(workload, seed,
                                                      tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench import harness
    c = harness.resolve(harness.load_spec(), workload)
    r = control.readings(c, seed, "cuda", str(tmp_path))
    print(workload, seed, r)
    assert any(v > lim for v, lim in r.values())


# faults planted in the program under a run's timed path


def _faulty_tally_step(mode):
    from hast_tpu_torch.pipeline import classify as C
    real = C.tally_step

    def step(table, acc, packed, lengths, ids, has_n):
        if mode == "unchanged":
            return acc
        half = packed.shape[0] // 2
        return real(table, acc, packed[:half], lengths[:half], ids[:half],
                    has_n[:half])
    return step


@pytest.mark.parametrize("mode", ["unchanged", "half"])
def test_classify_fault_in_the_tally_is_not_correct(tmp_path, monkeypatch,
                                                     mode):
    from hast_tpu_torch.pipeline import classify as C
    monkeypatch.setattr(C, "tally_step", _faulty_tally_step(mode))
    r = tiny.run(tiny.cell(tmp_path, "classify-hbm-gz"), str(tmp_path))
    assert not r["correct"] and r["failed"] == r["attempted"]


def test_classify_fault_in_an_answer_is_not_correct(tmp_path, monkeypatch):
    from hast_tpu_torch.io import native as N
    real = N.decide_format_phased

    def altered(bcs, order, c0, c1, *a):
        c0 = c0.copy()
        c0[order[len(order) // 2]] += 1
        return real(bcs, order, c0, c1, *a)

    monkeypatch.setattr(N, "decide_format_phased", altered)
    r = tiny.run(tiny.cell(tmp_path, "classify-hbm-gz"), str(tmp_path))
    assert not r["correct"]
    assert r["checks"]["phased_rows_wrong"]["value"] == 1


def test_markers_fault_state_unchanged_is_not_correct(tmp_path, monkeypatch):
    from hast_tpu_torch.ops import kmer_count as KC
    monkeypatch.setattr(KC.DeviceCounter, "merge_device",
                        lambda self, other: None)
    r = tiny.run(tiny.cell(tmp_path, "markers-parts4"), str(tmp_path))
    assert not r["correct"]


def test_markers_fault_half_the_batch_is_not_correct(tmp_path, monkeypatch):
    from hast_tpu_torch.ops import kmer_count as KC
    real = KC.count_windows

    def half(packed, lengths, k, *a, **kw):
        keys = real(packed, lengths, k, *a, **kw)
        keys = keys.reshape(packed.shape[0], -1).clone()
        keys[packed.shape[0] // 2:] = KC.SENT
        return keys.reshape(-1)
    monkeypatch.setattr(KC, "count_windows", half)
    r = tiny.run(tiny.cell(tmp_path, "markers-parts4"), str(tmp_path))
    assert not r["correct"]
    assert r["checks"]["total_gap"]["value"] > 0


def test_markers_fault_in_an_answer_is_not_correct(tmp_path, monkeypatch):
    from hast_tpu_torch.ops import kmer_count as KC
    real = KC.dump_words

    def altered(words, k, path):
        return real(np.asarray(words)[1:], k, path)
    monkeypatch.setattr(KC, "dump_words", altered)
    r = tiny.run(tiny.cell(tmp_path, "markers-parts4"), str(tmp_path))
    assert not r["correct"]
    assert r["checks"]["mer_lines_wrong"]["value"] > 0
