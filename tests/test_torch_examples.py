"""The example twins that take longest run to their end on the CPU: the
serving twin (kill, revive, rescale and a checkpoint round trip on
``cuda_bf``, asserting its answers and epoch stamps itself) and the
fault-tolerant training twin (a 12-step LM run checkpointed at steps 5
and 10, "crashed" at 10 and resumed, equal to the uninterrupted run
within rtol 1e-5, the loss falling)."""

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


def test_train_lm_resume_twin():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_train_lm_resume.py"),
         "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"), cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert "resumed trajectory == uninterrupted trajectory ✓" in lines
    assert lines[-1] == "fault-tolerant training example on cpu OK"
