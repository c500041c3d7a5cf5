"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

(or ``python3 -m portbench.run ...``) from the root of a checkout on a
machine with an NVIDIA GPU.  The last line of standard output is the
result, a JSON object; the numbers compared with the reference, each
beside its limit, are the last lines of standard error.  Without a CUDA
device, with fewer than the cell needs, or with JAX or the JAX package
loaded once the window has closed, it exits non-zero and prints no
result.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402

# the port runs without JAX: neither it nor the JAX package may load
BLOCKED = ("jax", "jaxlib", "flax", "hast_tpu")
for _name in BLOCKED:
    sys.modules[_name] = None

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
# run as a script, this folder heads sys.path: the checkout's root takes
# its place, so that its modules import as portbench.*
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
sys.path.insert(0, _ROOT)


def loaded_blocked() -> list:
    """Modules of the blocked packages that are loaded, by whole
    top-level name."""
    return sorted(m for m, v in sys.modules.items()
                  if v is not None and m.split(".")[0] in BLOCKED)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch
    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.resolve(harness.load_spec(_ROOT), a.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {a.workload} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} seen", file=sys.stderr)
        return 2
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        result = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace),
                                  "cuda", workdir, T_START)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    found = loaded_blocked()
    if found:
        print(f"portbench: loaded, and must not be: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
