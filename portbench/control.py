"""The control of a cell's comparison: the plain reference put in the
program's place, computed one step below the precision the configuration
states, must come out not correct.

* classify: getHap's one floating step in float32 instead of float64;
* markers: every count held in the 21 bits that ride above a 43-bit key
  in one 64-bit word at k = 21, instead of exactly.

``tests/test_portbench_control.py`` runs it: on the CPU at a small
size, and on the card (``-m cuda``) at each cell's size on three seeds,
printing the readings.  The cell's own runs never run it.
"""

from __future__ import annotations


def readings(cell, seed: int, device: str, workdir: str) -> dict:
    """{number: (value, limit)} of the control against the reference, at
    the cell's sizes (the inputs of a run of that seed)."""
    from portbench import harness
    run = harness.Run(cell, seed, 0.0, device, workdir)
    run.inputs = cell.job.make_inputs(run)
    expected = cell.job.reference(run, run.inputs)
    checks, _ = cell.job.compare(run, expected, [cell.job.control(
        run, run.inputs)])
    return {name: (value, limit) for name, value, limit in checks}
