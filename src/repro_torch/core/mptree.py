"""MPTree / G-MPTree: compacted bounding-path storage (Section 4.2.2).

For each LSH group, bounding-path ids are sorted by descending frequency
(number of edges whose posting list contains the path) so shared
prefixes align, then for each edge e the sequence
L = ⟨p_0, …, p_l, e⟩ is inserted into a modified prefix tree:

* the longest matching prefix L̃ may start at ANY node (not only the
  root) — the remainder of L is appended below the deepest match;
* the final element is a *tail node* holding |P_e|, and the tree root
  records e → tail so ``paths_containing(e)`` walks |P_e| steps up from
  the tail, recovering exactly p_l … p_0 regardless of what hangs above
  the match start.

All group trees are merged under a common super-root (G-MPTree).
"""

from __future__ import annotations

import numpy as np


class _Node:
    __slots__ = ("label", "parent", "children")

    def __init__(self, label, parent):
        self.label = label
        self.parent = parent
        self.children: dict = {}


class MPTree:
    def __init__(self):
        self.root = _Node(None, None)
        self.tails: dict = {}  # eid → (tail node, count)
        self._by_label: dict = {}  # label → [nodes]
        self.n_nodes = 0

    def _new_node(self, label, parent) -> _Node:
        node = _Node(label, parent)
        parent.children[label] = node
        self._by_label.setdefault(label, []).append(node)
        self.n_nodes += 1
        return node

    def insert(self, eid: int, path_ids: list[int]) -> None:
        """Insert L = path_ids + [tail(eid)]."""
        seq = list(path_ids)
        # longest matching prefix starting from any node
        best_node, best_len = None, 0
        for start in self._by_label.get(seq[0], []) if seq else []:
            node, length = start, 1
            while length < len(seq):
                nxt = node.children.get(seq[length])
                if nxt is None:
                    break
                node, length = nxt, length + 1
            if length > best_len:
                best_node, best_len = node, length
        if best_node is None:
            node = self.root
            matched = 0
        else:
            node = best_node
            matched = best_len
        for label in seq[matched:]:
            node = self._new_node(label, node)
        tail = self._new_node(("e", int(eid)), node)
        self.tails[int(eid)] = (tail, len(seq))

    def paths_containing(self, eid: int) -> np.ndarray:
        hit = self.tails.get(int(eid))
        if hit is None:
            return np.empty(0, dtype=np.int64)
        tail, count = hit
        out = []
        node = tail.parent
        for _ in range(count):
            out.append(node.label)
            node = node.parent
        return np.array(out[::-1], dtype=np.int64)

    def slots(self) -> int:
        """Storage model: 3 slots per node (label, parent, child link)."""
        return 3 * self.n_nodes


class GMPTree:
    """Global MPTree over all LSH groups of one subgraph (Section 4.2.2)."""

    def __init__(self, ebp, groups: list[np.ndarray]):
        self.trees: list[MPTree] = []
        self.edge_to_tree: dict = {}
        for group in groups:
            # frequency of each path within the group
            freq: dict = {}
            for col in group:
                for pid in ebp.pids[ebp.indptr[col] : ebp.indptr[col + 1]]:
                    freq[int(pid)] = freq.get(int(pid), 0) + 1
            tree = MPTree()
            for col in group:
                eid = int(ebp.keys[col])
                pids = [int(p) for p in ebp.pids[ebp.indptr[col] : ebp.indptr[col + 1]]]
                pids.sort(key=lambda p: (-freq[p], p))
                tree.insert(eid, pids)
                self.edge_to_tree[eid] = tree
            self.trees.append(tree)

    def paths_containing(self, eid: int) -> np.ndarray:
        tree = self.edge_to_tree.get(int(eid))
        if tree is None:
            return np.empty(0, dtype=np.int64)
        return tree.paths_containing(eid)

    def slots(self, path_len: np.ndarray | None = None) -> int:
        """Storage cost in 8-byte slots.

        Tree nodes hold path *ids* (3 slots: label, parent, child link);
        the path objects themselves live once in a shared path table of
        Σ len(p) slots over the distinct paths referenced — the dedup that
        Section 4.2 compacts EBP-II with.
        """
        base = len(self.edge_to_tree) * 2 + sum(t.slots() for t in self.trees)
        if path_len is None:
            return base
        distinct = set()
        for t in self.trees:
            for label in t._by_label:
                if not isinstance(label, tuple):  # tail labels are ("e", eid)
                    distinct.add(int(label))
        table = int(sum(int(path_len[p]) for p in distinct))
        return base + table
