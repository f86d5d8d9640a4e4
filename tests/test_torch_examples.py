"""The serving example twin (kill, revive, rescale and a checkpoint round
trip on ``cuda_bf``, asserting its answers and epoch stamps itself) runs
to its end on the CPU.  A file of its own: it is the longest example."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_serve_ksp_cluster_twin():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_serve_ksp_cluster.py"),
         "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"), cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].endswith("serving driver OK")
