"""``python -m repro_torch.launch.serve`` on the CPU (``--device cpu``):
every engine with and without ``--mesh``, kill and revive, each query
variant and both update modes end in "serving run complete" with no
EMPTY results; ``--mesh`` on the meshless ``pyen`` exits with the
reference's error text; without ``--device cpu`` and with no card the
driver fails instead of falling back.  Then the example twins, each run
as a script on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--device", "cpu", "--rows", "8", "--cols", "8", "--workers", "3",
         "--queries", "4", "--z", "16", "--xi", "4"]


def run_driver(capsys, *extra):
    serve.main(SMALL + list(extra))
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert lines[-1].startswith("serving run complete"), out
    assert "EMPTY results" not in out and "WARNING" not in out, out
    return out


@pytest.mark.parametrize("engine,mesh", [
    ("pyen", False), ("dense_bf", False), ("dense_bf", True),
    ("cuda_bf", False), ("cuda_bf", True)])
def test_engines(capsys, engine, mesh):
    out = run_driver(capsys, "--engine", engine, "--epochs", "2",
                     *(["--mesh"] if mesh else []))
    assert ("mesh refine over a 1x1 device mesh" in out) == mesh
    assert "applied 1 update batch → epoch 2" in out


@pytest.mark.parametrize("engine", ["cuda_bf", "dense_bf"])
def test_kill_revive_under_mesh(capsys, engine):
    out = run_driver(capsys, "--engine", engine, "--mesh", "--epochs", "3",
                     "--kill", "1", "--revive")
    assert "-- killed worker 1" in out and "-- revived worker 1" in out
    assert "stale-replica re-syncs" in out


@pytest.mark.parametrize("variant", ["ksp", "diverse", "bounded",
                                     "one_to_many"])
def test_variants(capsys, variant):
    run_driver(capsys, "--engine", "cuda_bf", "--mesh", "--epochs", "1",
               "--variant", variant)


def test_streaming_and_trace(capsys, tmp_path):
    trace = tmp_path / "trace.json"
    out = run_driver(capsys, "--engine", "cuda_bf", "--mesh", "--epochs", "2",
                     "--update-mode", "streaming", "--trace", str(trace))
    assert "(streaming + index maintenance" in out and trace.exists()


def test_mesh_on_a_meshless_engine_is_refused(capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(SMALL + ["--engine", "pyen", "--mesh"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--mesh: engine 'pyen' has no device-mesh path; mesh-capable " \
           "engines: cuda_bf, dense_bf" in err


def test_no_card_no_fallback():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: nothing to refuse")
    for extra in ([], ["--mesh"]):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            serve.main(["--engine", "cuda_bf", "--rows", "8", "--cols", "8"]
                       + extra)


@pytest.mark.parametrize("script", ["torch_quickstart.py",
                                    "torch_engine_dataplane.py"])
def test_example_twins(script):
    """Each example twin runs to its end on the CPU."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"), cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].endswith("OK")
