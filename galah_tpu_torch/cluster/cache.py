"""Sparse symmetric pair-distance cache.

Parity with the reference's SortedPairGenomeDistanceCache
(src/sorted_pair_genome_distance_cache.rs:5-58): keys are (min, max)
index pairs; *presence* of a key means the pair passed the precluster
threshold, while the stored value may be None ("computed, but below the
cluster threshold").

The port's own copy of galah_tpu/cluster/cache.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple


class SortedPairDistanceCache:
    __slots__ = ("_d",)

    def __init__(self) -> None:
        self._d: Dict[Tuple[int, int], Optional[float]] = {}

    @staticmethod
    def _key(i: int, j: int) -> Tuple[int, int]:
        return (i, j) if i < j else (j, i)

    def insert(self, pair: Tuple[int, int], distance: Optional[float]) -> None:
        self._d[self._key(*pair)] = distance

    def get(self, pair: Tuple[int, int]):
        """Returns None if absent, else a 1-tuple holding the stored
        Optional[float] — mirroring the reference's Option<&Option<f32>>
        so 'absent' and 'present-but-None' stay distinguishable."""
        k = self._key(*pair)
        if k in self._d:
            return (self._d[k],)
        return None

    def contains_key(self, pair: Tuple[int, int]) -> bool:
        return self._key(*pair) in self._d

    def transform_ids(self, input_ids: Iterable[int]) -> "SortedPairDistanceCache":
        """Re-index a subset into a precluster-local cache
        (src/sorted_pair_genome_distance_cache.rs:47-58)."""
        ids = list(input_ids)
        out = SortedPairDistanceCache()
        for a, gid1 in enumerate(ids):
            for b in range(a + 1, len(ids)):
                got = self.get((gid1, ids[b]))
                if got is not None:
                    out.insert((a, b), got[0])
        return out

    def items(self):
        return self._d.items()

    def __len__(self) -> int:
        return len(self._d)

    def __eq__(self, other) -> bool:
        return isinstance(other, SortedPairDistanceCache) and self._d == other._d

    def __repr__(self) -> str:
        inner = ", ".join(f"({i}, {j}): {v}" for (i, j), v in sorted(self._d.items()))
        return f"SortedPairDistanceCache {{{inner}}}"
