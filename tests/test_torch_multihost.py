"""The port's multi-process paths: two OS processes joined by
torch.distributed (gloo) on the CPU, with jax and hast_tpu blocked.

As tests/test_multihost.py holds the JAX package: each process
classifies (or counts) its round-robin share of the input files, one
reduce gives every process the global tally (or count table), and
process 0 writes.  The merged result must equal the single-process
golden byte for byte (classify) or a single count_files (counting).
Each subprocess has its own 120 s timeout.
"""

import os
import pathlib
import shutil
import socket
import subprocess
import sys

import numpy as np

from hast_tpu_torch.pipeline import markers as M

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLD = ROOT / "tests" / "golden" / "stage01"
E2E = ROOT / "tests" / "golden" / "e2e"
BLOCK = ("import sys\nsys.modules['jax'] = None\n"
         "sys.modules['hast_tpu'] = None\n")
CLI = BLOCK + "from hast_tpu_torch.cli import main\nmain(sys.argv[1:])\n"
COUNT = BLOCK + """
import numpy as np
from hast_tpu_torch.parallel import distributed as D
D.initialize()
assert D.process_count() == 2
table = D.count_files_multihost(sys.argv[2:], 21, batch_size=4096,
                                device="cpu")
if D.process_index() == 0:
    np.savez(sys.argv[1], words=table.words, counts=table.counts)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_two(code: str, args: list[str], cwd: pathlib.Path) -> None:
    """code as two processes of one torch.distributed job."""
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT), HAST_NUM_PROCESSES="2",
                   HAST_PROCESS_ID=str(rank), HAST_COORDINATOR=coordinator)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, *args], cwd=cwd, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"process failed:\n{out[-3000:]}"


def test_two_process_classify_matches_golden(tmp_path):
    for f in ("hap0.mer", "hap1.mer", "reads1.fq.gz", "reads2.fq"):
        shutil.copy(GOLD / f, tmp_path / f)
    out = tmp_path / "phased.merged"
    run_two(CLI, ["classify", "--hap0", str(tmp_path / "hap0.mer"),
                  "--hap1", str(tmp_path / "hap1.mer"),
                  "--read", str(tmp_path / "reads1.fq.gz"),
                  "--read", str(tmp_path / "reads2.fq"), "--weight0", "1.04",
                  "--batch-size", "4096", "--output", str(out),
                  "--device", "cpu"], tmp_path)
    assert out.read_bytes() == (GOLD / "phased.barcodes.golden").read_bytes()


def test_two_process_count_matches_single(tmp_path):
    paths = [str(E2E / "paternal.fa.gz"), str(E2E / "maternal.fa.gz")]
    run_two(COUNT, [str(tmp_path / "count.npz"), *paths], tmp_path)
    z = np.load(tmp_path / "count.npz")
    want = M.count_files(paths, 21, batch_size=4096, device="cpu")
    np.testing.assert_array_equal(z["words"], want.words)
    np.testing.assert_array_equal(z["counts"], want.counts)
