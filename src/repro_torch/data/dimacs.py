"""DIMACS challenge-9 road-network loader (.gr format).

The paper's datasets (NY/COL/FLA/CUSA travel times, [31]) are not in
the repository; when the files ARE present, this loader feeds them into
the same Graph substrate the synthetic generators use.

Format:  c comment / p sp <n> <m> / a <u> <v> <w>  (1-indexed arcs).
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from repro_torch.core.graph import Graph


def load_gr(path: str, undirected: bool = True, max_edges: int | None = None):
    """Parse a .gr or .gr.gz into a Graph.

    DIMACS files list both arc directions for roads; with
    `undirected=True` duplicate (u,v)/(v,u) arcs collapse into one
    logical edge (keeping the smaller travel time), matching the paper's
    undirected experiments.  `undirected=False` keeps arcs as-is."""
    opener = gzip.open if path.endswith(".gz") else open
    n = None
    us, vs, ws = [], [], []
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith("p"):
                parts = line.split()
                n = int(parts[2])
            elif line.startswith("a"):
                _, u, v, w = line.split()
                us.append(int(u) - 1)
                vs.append(int(v) - 1)
                ws.append(float(w))
                if max_edges and len(us) >= max_edges:
                    break
    if n is None:
        raise ValueError(f"{path}: no problem line")
    u = np.asarray(us, dtype=np.int64)
    v = np.asarray(vs, dtype=np.int64)
    w = np.maximum(np.asarray(ws, dtype=np.float64), 1e-3)
    if undirected:
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        key = lo * (n + 1) + hi
        order = np.argsort(key, kind="stable")
        key, lo, hi, w = key[order], lo[order], hi[order], w[order]
        first = np.ones(key.shape[0], dtype=bool)
        first[1:] = key[1:] != key[:-1]
        # min weight among duplicates
        w_min = np.minimum.reduceat(w, np.nonzero(first)[0])
        u, v, w = lo[first], hi[first], w_min
        keep = u != v
        u, v, w = u[keep], v[keep], w[keep]
        return Graph(n, u, v, w, directed=False)
    keep = u != v
    return Graph(n, u[keep], v[keep], w[keep], directed=True)


def find_dimacs(name: str, search=("data",)):
    """Locate USA-road-t.<NAME>.gr[.gz] if present; else None."""
    for root in search:
        for ext in (".gr", ".gr.gz"):
            p = os.path.join(root, f"USA-road-t.{name}{ext}")
            if os.path.exists(p):
                return p
    return None
