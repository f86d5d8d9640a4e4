"""Arch/shape registry interface.

Every architecture exposes a list of *cells*; a cell is one (arch × shape)
combination with everything a run at that shape needs:

    step_fn      — the function to run (serve_step / refresh / ...)
    arg_specs    — tuple of :class:`TensorSpec` (shape and dtype only, no
                   allocation)
    arg_axes     — matching tuples of logical-axis names
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one argument of a cell's ``step_fn``."""

    shape: tuple
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n * torch.empty((), dtype=self.dtype).element_size()


def spec_tree(tree):
    """The :class:`TensorSpec` of every tensor of a tree (a meta init's,
    say): the tree's structure with specs for leaves."""
    from repro_torch.models.common import tree_map

    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), tree)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str  # 'train' | 'prefill' | 'decode' | 'serve' | 'retrieval'
    step_fn: Callable
    arg_specs: tuple
    arg_axes: tuple
    note: str = ""
    skip: str | None = None  # reason if this cell is skipped (documented)

    @property
    def name(self) -> str:
        return f"{self.arch}×{self.shape}"


@dataclasses.dataclass
class Arch:
    name: str
    family: str  # 'lm' | 'gnn' | 'recsys' | 'ksp'
    cells_fn: Callable[[], list[Cell]]
    smoke_fn: Callable[..., dict]  # tiny real run; returns metrics
    describe: str = ""

    def cells(self) -> list[Cell]:
        return self.cells_fn()


_REGISTRY: dict[str, Arch] = {}


def register(arch: Arch):
    _REGISTRY[arch.name] = arch
    return arch


def get_arch(name: str) -> Arch:
    import repro_torch.configs.registry  # noqa: F401  (populates)

    return _REGISTRY[name]


def all_archs() -> dict[str, Arch]:
    import repro_torch.configs.registry  # noqa: F401

    return dict(_REGISTRY)
