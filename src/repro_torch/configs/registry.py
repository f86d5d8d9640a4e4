"""Importing this module populates the arch registry (see base.py).

Only the paper's own architecture (the KSP data plane) is ported so far;
the reference's LM, GNN and BST families follow with their models."""

from . import kspdg_arch  # noqa: F401
