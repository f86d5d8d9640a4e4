"""EBP-II: Edges-and-Bounding-Paths inverted index (Section 4.1).

Key = edge id, value = ids of bounding paths containing that edge.
Stored as CSR for compactness and O(1) lookup; ``slots()`` reports a
storage-cost model (8-byte slots) used by the EBP-II vs MPTree memory
comparison benchmark (paper Fig. 15e).
"""

from __future__ import annotations

import numpy as np


class EBPII:
    def __init__(self, path_edges: list[np.ndarray]):
        """path_edges[p] = global edge ids of bounding path p."""
        pairs = []  # (eid, pid)
        for pid, eids in enumerate(path_edges):
            if eids is None:
                continue
            for e in eids:
                pairs.append((int(e), pid))
        if pairs:
            arr = np.array(pairs, dtype=np.int64)
            order = np.lexsort((arr[:, 1], arr[:, 0]))
            arr = arr[order]
            self.keys, starts = np.unique(arr[:, 0], return_index=True)
            self.indptr = np.append(starts, arr.shape[0]).astype(np.int64)
            self.pids = arr[:, 1].copy()
        else:
            self.keys = np.empty(0, dtype=np.int64)
            self.indptr = np.zeros(1, dtype=np.int64)
            self.pids = np.empty(0, dtype=np.int64)
        self._key_pos = {int(k): i for i, k in enumerate(self.keys)}

    def paths_containing(self, eid: int) -> np.ndarray:
        i = self._key_pos.get(int(eid))
        if i is None:
            return np.empty(0, dtype=np.int64)
        return self.pids[self.indptr[i] : self.indptr[i + 1]]

    def slots(self, path_len: np.ndarray | None = None) -> int:
        """Storage cost in 8-byte slots.

        The paper's EBP-II (Fig. 8) stores, under every edge key, the set of
        bounding paths *themselves* — "there could be many duplicate bounding
        paths associated with different keys" (Section 4.2).  With
        ``path_len[p]`` = number of vertices of path p, the cost is therefore
        one slot per key plus the full length of every duplicated path.
        Without ``path_len`` we fall back to id postings (a flattering,
        already-compacted model).
        """
        if path_len is None:
            return int(self.keys.shape[0] + self.pids.shape[0])
        return int(self.keys.shape[0] + path_len[self.pids].sum())
