"""MinHash + banded LSH partitioning of EBP-II columns (Section 4.2.1).

PE-Matrix: rows = bounding paths, columns = edges; entry 1 iff the path
contains the edge.  The Sig-Matrix is the column-wise MinHash signature
under h hash functions h_i(r) = (a_i · r + 1) mod c with a_i the first h
primes and c the smallest prime ≥ #rows (the paper uses h = 20, b = 2
bands).  Columns identical in at least one band are grouped together
(union-find over band buckets).
"""

from __future__ import annotations

import numpy as np

_PRIMES = [
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
    73, 79, 83, 89, 97, 101, 103, 107, 109, 113,
]


def _next_prime(n: int) -> int:
    def is_prime(x):
        if x < 2:
            return False
        i = 2
        while i * i <= x:
            if x % i == 0:
                return False
            i += 1
        return True

    x = max(n, 2)
    while not is_prime(x):
        x += 1
    return x


def minhash_signatures(ebp, n_paths: int, h: int = 20) -> np.ndarray:
    """Sig-Matrix [h, n_cols] for the EBP-II columns (edges)."""
    c = _next_prime(max(n_paths, 5))
    a = np.array(_PRIMES[:h], dtype=np.int64)[:, None]  # [h,1]
    n_cols = ebp.keys.shape[0]
    sig = np.full((h, n_cols), np.iinfo(np.int64).max, dtype=np.int64)
    # hash every row id once
    row_ids = np.arange(n_paths, dtype=np.int64)[None, :]
    hashed = (a * row_ids + 1) % c  # [h, n_paths]
    for col in range(n_cols):
        pids = ebp.pids[ebp.indptr[col] : ebp.indptr[col + 1]]
        if pids.shape[0]:
            sig[:, col] = hashed[:, pids].min(axis=1)
    return sig


def lsh_groups(sig: np.ndarray, b: int = 2) -> list[np.ndarray]:
    """Group column indices; same bucket in ≥1 band ⇒ same group."""
    h, n_cols = sig.shape
    if n_cols == 0:
        return []
    rows_per_band = max(h // b, 1)
    parent = np.arange(n_cols)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(x, y):
        rx, ry = find(x), find(y)
        if rx != ry:
            parent[rx] = ry

    for band in range(b):
        lo = band * rows_per_band
        hi = h if band == b - 1 else lo + rows_per_band
        buckets: dict = {}
        for col in range(n_cols):
            key = sig[lo:hi, col].tobytes()
            if key in buckets:
                union(col, buckets[key])
            else:
                buckets[key] = col
    roots: dict = {}
    for col in range(n_cols):
        roots.setdefault(find(col), []).append(col)
    return [np.array(v, dtype=np.int64) for v in roots.values()]
