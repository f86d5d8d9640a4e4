"""Nothing of the benchmark imports JAX or the JAX package ``repro``; the
reference and the generators import nothing of the program either.
Module names are compared by their top-level name, as a whole word: the
program's name, ``repro_torch``, begins with the JAX package's."""

import ast

import pytest

from kspbench import cell

FILES = sorted(cell.ROOT.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: the yardstick's own modules: they take nothing from the program
INDEPENDENT = {"reference.py", "roadgen.py", "roofline.py", "record.py"}


def _top_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_files_found():
    names = {p.name for p in FILES}
    assert INDEPENDENT <= names and "run.py" in names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(cell.ROOT)))
def test_no_jax_nor_jax_package(path):
    assert not set(_top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("name", sorted(INDEPENDENT))
def test_yardstick_imports_nothing_of_the_program(name):
    names = set(_top_names(cell.ROOT / name))
    assert "repro_torch" not in names and not names & FORBIDDEN


def test_whole_word_comparison(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.kernels\nfrom repro.core import x\n")
    assert list(_top_names(probe)) == ["repro_torch", "repro"]
