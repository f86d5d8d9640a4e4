"""Importing this module populates the arch registry (see base.py)."""

from . import bst_arch  # noqa: F401
from . import deepseek_coder_33b  # noqa: F401
from . import deepseek_v3_671b  # noqa: F401
from . import gemma3_27b  # noqa: F401
from . import gnn_archs  # noqa: F401
from . import moonshot_v1_16b_a3b  # noqa: F401
from . import starcoder2_3b  # noqa: F401

# the paper's own architecture (KSP refine data plane) registers here too
from . import kspdg_arch  # noqa: F401
