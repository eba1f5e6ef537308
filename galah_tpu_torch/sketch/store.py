"""Persistable sketch store.

The reference's only between-phase artifacts are skani's on-disk sketch
DB in low-memory mode (src/skani.rs:265-290) and the precomputed-input
bypasses (SURVEY §5). Here sketches and sparse distance caches are
first-class persistable artifacts: natural checkpoints between the
sketch -> screen -> verify -> cluster phases, and the backing for
low-memory runs (sketches spill to disk, an LRU keeps the working set
in RAM).

The port's own copy of galah_tpu/sketch/store.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

import json
import logging
import os
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from galah_tpu_torch.cluster.cache import SortedPairDistanceCache
from galah_tpu_torch.sketch.fracminhash import NativeSketch, NativeSketchParams

logger = logging.getLogger(__name__)

_PARAM_FIELDS = (
    "k",
    "genome_scale",
    "fragment_scale",
    "fragment_length",
    "prefilter_bits",
    "member_bits",
    "min_fragment_hashes",
    "min_fragment_length",
)


def dump_sketch(sketch: NativeSketch, fh, compress: bool = True) -> None:
    """Serialize a sketch to an open binary file handle (or BytesIO).
    compress=False skips the deflate pass — right for in-memory
    transport (multi-process sketch exchange) where CPU beats bytes."""
    meta = {f: getattr(sketch.params, f) for f in _PARAM_FIELDS}
    savez = _savez if compress else np.savez
    savez(fh,
          name=np.array(sketch.name),
          total_len=np.int64(sketch.total_len),
          prefilter_buckets=sketch.prefilter_buckets,
          frag_buckets=sketch.frag_buckets,
          frag_offsets=sketch.frag_offsets,
          member_buckets=sketch.member_buckets,
          params_json=np.array(json.dumps(meta)),
          )


def save_sketch(sketch: NativeSketch, path: str) -> None:
    # np.savez appends ".npz" to bare paths; write through a file handle
    # so the file lands exactly where the caller asked. Write-temp +
    # atomic rename: several processes may write the same stable path
    # in a shared --sketch-directory (the MP sketch exchange), and a
    # reader must never see a half-written file.
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        dump_sketch(sketch, fh)
    os.replace(tmp, path)


def load_sketch(path) -> NativeSketch:
    """Load a sketch from a path or an open binary file handle."""
    with np.load(path, allow_pickle=False) as z:
        params = NativeSketchParams(**json.loads(str(z["params_json"])))
        return NativeSketch(
            name=str(z["name"]),
            total_len=int(z["total_len"]),
            prefilter_buckets=z["prefilter_buckets"],
            frag_buckets=z["frag_buckets"],
            frag_offsets=z["frag_offsets"],
            member_buckets=z["member_buckets"],
            params=params,
        )


class DiskSketchStore:
    """Disk-backed sketch store with an LRU in-memory working set —
    the low-memory analog of skani's sketch-then-search database
    (src/skani.rs:229-377)."""

    def __init__(self, directory: str, params: NativeSketchParams,
                 max_resident: int = 256) -> None:
        self.directory = directory
        self.params = params
        self.max_resident = max_resident
        os.makedirs(directory, exist_ok=True)
        self._resident: "OrderedDict[str, NativeSketch]" = OrderedDict()
        self._on_disk: Dict[str, str] = {}
        self._counter = 0

    def set_params(self, params: NativeSketchParams) -> None:
        """Adopt late parameter changes (bitmap widening happens at
        preclusterer construction, after the store exists)."""
        self.params = params

    def _disk_path(self, key: str) -> str:
        p = self._on_disk.get(key)
        if p is None:
            p = os.path.join(self.directory, f"sketch_{self._counter}.npz")
            self._counter += 1
            self._on_disk[key] = p
        return p

    def put(self, key: str, sketch: NativeSketch) -> None:
        save_sketch(sketch, self._disk_path(key))
        self._resident[key] = sketch
        self._resident.move_to_end(key)
        self._evict()

    def get(self, key: str) -> Optional[NativeSketch]:
        sk = self._resident.get(key)
        if sk is not None:
            self._resident.move_to_end(key)
            return sk
        p = self._on_disk.get(key)
        if p is None:
            return None
        sk = load_sketch(p)
        self._resident[key] = sk
        self._evict()
        return sk

    def __contains__(self, key: str) -> bool:
        return key in self._on_disk

    def _evict(self) -> None:
        while len(self._resident) > self.max_resident:
            self._resident.popitem(last=False)


def _stable_sketch_name(key: str, params: NativeSketchParams,
                        stat_sig: str = "") -> str:
    """Content-stable filename for a persistent sketch: unit key +
    parameter fingerprint + source-file signature. A changed input
    file (different size/mtime) or different sketch params hashes to
    a different name, so stale sketches are never reused (orphans are
    left behind; the directory is a cache, not a database)."""
    import hashlib

    meta = json.dumps(
        {f: getattr(params, f) for f in _PARAM_FIELDS}, sort_keys=True
    )
    h = hashlib.sha256()
    h.update(key.encode())
    h.update(b"\0")
    h.update(meta.encode())
    h.update(b"\0")
    h.update(stat_sig.encode())
    return f"sketch_{h.hexdigest()[:40]}.npz"


def _file_sig(key: str) -> str:
    """Size+mtime signature when the key is an existing file path
    (genome mode); empty otherwise."""
    try:
        st = os.stat(key)
        return f"{st.st_size}:{st.st_mtime_ns}"
    except OSError:
        return ""


class PersistentSketchStore(DiskSketchStore):
    """Cross-RUN sketch store (`--sketch-directory`): sketches land at
    content-stable paths, so a re-run — including one resuming a crash
    via --sweep-checkpoint / --input-distance-cache — reuses every
    sketch from disk instead of re-sketching the corpus (SURVEY §5:
    sketches as first-class persistable artifacts; the reference's
    analog is skani's on-disk sketch DB, src/skani.rs:265-290, which
    is likewise reusable across invocations)."""

    def set_params(self, params: NativeSketchParams) -> None:
        # Stable paths derive from params: drop cached paths so
        # post-widening lookups hash the NEW width (sketches saved at
        # the old width become unreachable orphans, never reused).
        self.params = params
        self._on_disk.clear()
        self._resident.clear()

    def _disk_path(self, key: str) -> str:
        p = self._on_disk.get(key)
        if p is None:
            p = os.path.join(
                self.directory,
                _stable_sketch_name(key, self.params, _file_sig(key)),
            )
            self._on_disk[key] = p
        return p

    def __contains__(self, key: str) -> bool:
        return (
            key in self._resident
            or os.path.exists(self._disk_path(key))
        )

    def get(self, key: str) -> Optional[NativeSketch]:
        sk = self._resident.get(key)
        if sk is not None:
            self._resident.move_to_end(key)
            return sk
        p = self._disk_path(key)
        if not os.path.exists(p):
            return None
        sk = load_sketch(p)
        self._resident[key] = sk
        self._evict()
        return sk


def save_contig_sketches(path: str, sketches) -> None:
    """One bundle file per input FASTA for contig mode (per-contig
    files would mean 100k+ tiny npz files): concatenated arrays with
    offsets, loadable in one read."""
    names = [s.name for s in sketches]
    arrays: dict = {"names": np.array(names)}
    arrays["total_lens"] = np.array(
        [s.total_len for s in sketches], np.int64
    )
    for field in ("prefilter_buckets", "frag_buckets", "member_buckets"):
        parts = [np.asarray(getattr(s, field)) for s in sketches]
        arrays[field] = (
            np.concatenate(parts) if parts else np.empty(0, np.int32)
        )
        arrays[field + "_off"] = np.cumsum(
            [0] + [len(p) for p in parts]
        ).astype(np.int64)
    fo_parts = [np.asarray(s.frag_offsets) for s in sketches]
    arrays["frag_offsets"] = (
        np.concatenate(fo_parts) if fo_parts else np.empty(0, np.int64)
    )
    arrays["frag_offsets_off"] = np.cumsum(
        [0] + [len(p) for p in fo_parts]
    ).astype(np.int64)
    if sketches:
        meta = {
            f: getattr(sketches[0].params, f) for f in _PARAM_FIELDS
        }
    else:
        meta = {}
    arrays["params_json"] = np.array(json.dumps(meta))
    # pid-suffixed tmp + atomic rename: concurrent writers of the same
    # bundle in a shared --sketch-directory must not interleave.
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        _savez(fh, **arrays)
    os.replace(tmp, path)


def load_contig_sketches(path: str):
    """Inverse of save_contig_sketches; returns List[NativeSketch]."""
    out = []
    with np.load(path, allow_pickle=False) as z:
        params = (
            NativeSketchParams(**json.loads(str(z["params_json"])))
            if str(z["params_json"]) != "{}" else None
        )
        names = z["names"]
        total_lens = z["total_lens"]
        cols = {
            f: (z[f], z[f + "_off"])
            for f in ("prefilter_buckets", "frag_buckets",
                      "member_buckets", "frag_offsets")
        }
        for i in range(len(names)):
            fields = {}
            for f, (arr, off) in cols.items():
                fields[f] = arr[off[i] : off[i + 1]].copy()
            out.append(NativeSketch(
                name=str(names[i]),
                total_len=int(total_lens[i]),
                params=params,
                **fields,
            ))
    return out


def save_distance_cache(
    cache: SortedPairDistanceCache, path: str, names=None,
    threshold: Optional[float] = None,
    min_af: Optional[float] = None,
    method: Optional[str] = None,
    mode: Optional[str] = None,
) -> None:
    """Persist the sparse above-threshold pair list (the phase-2
    artifact; pairs whose value is None are kept distinct). The
    metadata records the flags the pairs were filtered under —
    `threshold` (ANI pct), `min_af` (fraction), `method` (preclusterer)
    and `mode` ('triangle'/'contigs'/'references') — so resume can
    refuse a run whose flags would silently change which pairs exist."""
    items = list(cache.items())
    ii = np.array([k[0] for k, _ in items], dtype=np.int64)
    jj = np.array([k[1] for k, _ in items], dtype=np.int64)
    vals = np.array(
        [v if v is not None else np.nan for _, v in items], dtype=np.float64
    )
    has_val = np.array([v is not None for _, v in items], dtype=bool)
    kwargs = dict(i=ii, j=jj, values=vals, has_value=has_val)
    if names is not None:
        kwargs["names"] = np.array(list(names))
    if threshold is not None:
        kwargs["threshold"] = np.float64(threshold)
    if min_af is not None:
        kwargs["min_af"] = np.float64(min_af)
    if method is not None:
        kwargs["method"] = np.array(method)
    if mode is not None:
        kwargs["mode"] = np.array(mode)
    with open(path, "wb") as fh:
        _savez(fh, **kwargs)


def load_distance_cache(path: str):
    """Returns (cache, names, meta) where meta holds 'threshold',
    'min_af', 'method' and 'mode' (each None when the cache predates
    that field)."""
    cache = SortedPairDistanceCache()
    with np.load(path, allow_pickle=False) as z:
        for i, j, v, hv in zip(z["i"], z["j"], z["values"], z["has_value"]):
            cache.insert((int(i), int(j)), float(v) if hv else None)
        names = [str(n) for n in z["names"]] if "names" in z else None
        meta = {
            "threshold": float(z["threshold"]) if "threshold" in z else None,
            "min_af": float(z["min_af"]) if "min_af" in z else None,
            "method": str(z["method"]) if "method" in z else None,
            "mode": str(z["mode"]) if "mode" in z else None,
        }
    return cache, names, meta


def _savez(fh, **kwargs) -> None:
    np.savez_compressed(fh, **kwargs)
