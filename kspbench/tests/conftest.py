"""The benchmark's own tests: ``python -m pytest kspbench/tests`` from the
repository root.  They run on the CPU; none needs the card."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)
