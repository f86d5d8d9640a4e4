"""repro_torch stands alone: it imports neither ``jax`` nor anything of
the reference package ``repro``, runs on the card unless asked for the
CPU, and never falls back from one to the other.  ``chip_smoke.py``, the
port's on-card check, follows the same import rule and refuses to run
without a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.service import KSPService, ServiceConfig

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
_FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in _FORBIDDEN)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_and_reference_unloaded():
    code = (
        "import sys\n"
        "import repro_torch.service, repro_torch.convert, "
        "repro_torch.kernels.ops\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
        "m.startswith(('jax.', 'repro.')))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_device_defaults_to_the_card():
    assert ServiceConfig().device == "cuda"
    assert ServiceConfig(engine="cuda_bf", device="cpu").device == "cpu"
    with pytest.raises(RuntimeError):
        ServiceConfig(device="not-a-device")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: nothing to refuse")
    from repro_torch.data.roadnet import grid_road_network

    g = grid_road_network(5, 5, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        KSPService.build(g, ServiceConfig(engine="cuda_bf", z=12, xi=4))


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a card — and alone, away from the repository — the smoke
    script exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    env = dict(os.environ, PYTHONPATH="")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)], env=env,
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
