"""Union-find for single-linkage preclustering.

Replaces the reference's `disjoint::DisjointSetVec` (src/clusterer.rs:9,
452-487). `sets()` returns groups ordered by first-seen element index,
matching the traversal order the reference relies on for deterministic
precluster ids.

The port's own copy of galah_tpu/cluster/union_find.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

from typing import List

import numpy as np


class DisjointSet:
    def __init__(self, n: int) -> None:
        self.parent = np.arange(n, dtype=np.int64)
        self.rank = np.zeros(n, dtype=np.int8)

    def find(self, x: int) -> int:
        root = x
        p = self.parent
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return int(root)

    def join(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1

    def sets(self) -> List[List[int]]:
        """Groups of element indices, each sorted ascending, ordered by
        smallest member."""
        groups = {}
        for i in range(len(self.parent)):
            groups.setdefault(self.find(i), []).append(i)
        return [sorted(v) for _, v in sorted(groups.items(), key=lambda kv: min(kv[1]))]
