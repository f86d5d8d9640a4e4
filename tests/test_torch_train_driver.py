"""``python -m repro_torch.launch.train --device cpu`` for one arch of
each family (an LM smoke config, gin-tu, bst): the reference's output
lines, periodic checkpoints, and a resume that picks up the latest step;
a run that crashes after a checkpoint and resumes from it gives the
uninterrupted run's losses; without ``--device cpu`` and with no card
the driver fails instead of falling back."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import train as T
from tests._torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["starcoder2-3b", "gin-tu", "bst"]


class Crash(Exception):
    """The simulated failure of a training process."""


def driver(*args):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         *args],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"), cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


@pytest.mark.parametrize("arch", ARCHS)
def test_driver_checkpoints_and_resumes(arch, tmp_path):
    ck = ["--arch", arch, "--ckpt-every", "5", "--ckpt-dir", str(tmp_path)]
    first = driver(*ck, "--steps", "10")
    assert [ln.split()[1] for ln in first if ln.startswith("step")] == [
        "0", "5", "9"]
    assert all(" loss " in ln and " gnorm " in ln and " lr " in ln
               for ln in first if ln.startswith("step"))
    assert first[-1].startswith("done: 10 steps, checkpoints in ")
    assert sorted(os.listdir(tmp_path / arch)) == [
        "step-0000000005", "step-0000000010"]
    second = driver(*ck, "--steps", "15", "--resume")
    assert second[0] == "resumed from step 10"
    assert [ln.split()[1] for ln in second if ln.startswith("step")] == [
        "10", "14"]
    assert second[-1].startswith("done: 15 steps")
    assert np.isfinite([float(ln.split()[3]) for ln in first + second
                        if ln.startswith("step")]).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_crash_and_resume_give_the_uninterrupted_losses(arch, tmp_path,
                                                        monkeypatch):
    """A run that dies at step 12 (after its step-10 checkpoint) and is
    resumed from that checkpoint continues the uninterrupted trajectory:
    the same batches (a pure function of the step) and the restored
    parameters and optimizer state."""
    args = ["--device", "cpu", "--arch", arch, "--steps", "15",
            "--ckpt-every", "5"]
    whole = T.train(T.parse_args(args + ["--ckpt-dir",
                                         str(tmp_path / "a")]))
    assert len(whole) == 15

    setup = T._smoke_setup

    def crashing(name, device):
        init_fn, loss_fn, batch_at = setup(name, device)

        def batch_or_crash(step):
            if step == 12:
                raise Crash(f"{name} crashed at step 12")
            return batch_at(step)

        return init_fn, loss_fn, batch_or_crash

    crashed = T.parse_args(args + ["--ckpt-dir", str(tmp_path / "b")])
    monkeypatch.setattr(T, "_smoke_setup", crashing)
    with pytest.raises(Crash):
        T.train(crashed)
    monkeypatch.setattr(T, "_smoke_setup", setup)
    assert sorted(os.listdir(tmp_path / "b" / arch)) == [
        "step-0000000005", "step-0000000010"]
    crashed.resume = True
    tail = T.train(crashed)
    np.testing.assert_allclose(tail, whole[10:], rtol=1e-5)


def test_no_card_no_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: nothing to refuse")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        T.main(["--arch", "gin-tu", "--steps", "1",
                "--ckpt-dir", str(tmp_path)])
