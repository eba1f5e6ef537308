"""The native engine on torch: preclusterer + clusterer
(counterpart of galah_tpu/engines/native.py).

One NativeContext owns the sketch parameters, the sketch store and the
device-side fragment-ANI engine; the preclusterer and clusterer share it
so every unit is sketched once per run. `distances()`:

1. sketch every genome: on a CUDA device by device sketching
   (ops/device_sketch.py, K5), on the CPU by the host sketcher (the C++
   one when it loads, threaded); GALAH_TPU_DEVICE_SKETCH=1/0 forces
   either. Device-born bitmaps are adopted into the verify bitmap pool
   and, for the resident packed screen, into its matrix, and their
   fragment streams into the verify stream arena (GALAH_TPU_RESIDENT=0
   turns adoption off);
2. screen all pairs at a conservative containment cutoff: the packed
   triangle screen (ops/prefilter.py), resident or streaming, the
   popcount screen (ops/popcount_screen.py) under
   GALAH_TPU_SCREEN=popcount, or the u8 indicator screen
   (ops/prefilter.py::screen_triangle) under GALAH_TPU_SCREEN=indicator;
3. verify the surviving pairs (ops/fragment_ani.py);
4. return the pairs whose verified ANI and AF pass, as a sparse cache.

With device sketching and the resident packed screen (every default
run on a card), the three phases overlap instead (_run_pipelined): each
sketch batch's device-born prefilter rows go straight into an
IncrementalPackedScreen, which issues every tile whose row blocks are
complete while later batches are read and sketched, and the drained
tiles' pairs are verified in chunks as they come (_VerifyFeeder).
GALAH_TPU_PIPELINE=0 runs the phases one after another; the results are
the same.

`distances_contigs()` does the same with one unit per contig (contig
mode), and `distances_with_references()` screens the (query, reference)
rectangle instead (reference-genome mode). In low-memory mode sketches
live in a disk store with a 64-sketch working set, the screens stream
their blocks from the host, and verify runs in chunks of 64 genomes.

The resume artifacts are the JAX package's, in its file formats:
- a persistent sketch directory (NativeContext(sketch_directory=),
  --sketch-directory): genome sketches in a PersistentSketchStore (its
  working set 64 sketches under --low-memory, else unbounded), contig
  sketches as one bundle per input FASTA. Sketches read from it are not
  device-born: their screen rows and verify streams are uploaded from
  the host;
- the mid-sweep checkpoint (NativePreclusterer(sweep_checkpoint=),
  --sweep-checkpoint) of the resident packed triangle sweep, sequential
  or pipelined (ops/sweep_checkpoint.py). The popcount and indicator
  screens, the streaming (low-memory) sweep and the reference rectangle
  warn that they do not checkpoint.

Over several shards (NativeContext given several devices) or several
processes (parallel/mesh.py) the screens are the sharded sweeps of
parallel/distance.py, under the JAX package's conditions: the
replicated triangle (with the sweep checkpoint), the row-sharded
triangle under --low-memory, the replicated rectangle in
reference-genome mode; an explicit GALAH_TPU_SCREEN keeps the
single-device screens. The phases do not overlap there. With several
processes the genomes are sketched round robin across them and the
sketches exchanged (GALAH_TPU_MP_SKETCH=0 on process 0 sketches every
genome in every process), and verify partitions its pairs
(ops/fragment_ani.py). Every process returns the same cache.
"""

from __future__ import annotations

import logging
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from galah_tpu_torch import defaults
from galah_tpu_torch.cluster.cache import SortedPairDistanceCache
from galah_tpu_torch.engines.base import (
    ClusterDistanceFinder,
    PreclusterDistanceFinder,
)
from galah_tpu_torch.ops.fragment_ani import FragmentAniConfig, FragmentAniEngine
from galah_tpu_torch.ops.popcount_screen import screen_triangle_popcount
from galah_tpu_torch.ops.prefilter import (
    IncrementalPackedScreen,
    ScreenResult,
    _device_resident_budget,
    screen_rectangle,
    screen_rectangle_packed,
    screen_triangle,
    screen_triangle_packed,
)
from galah_tpu_torch.parallel import distance
from galah_tpu_torch.parallel.mesh import process_count, process_index
from galah_tpu_torch.sketch.fracminhash import (
    NativeSketch,
    NativeSketchParams,
    sketch_contigs_native,
    sketch_file_native,
    small_genome_params,
)
from galah_tpu_torch.sketch.store import (
    DiskSketchStore,
    PersistentSketchStore,
    _file_sig,
    _stable_sketch_name,
    load_contig_sketches,
    save_contig_sketches,
)
from galah_tpu_torch.utils import metrics
from galah_tpu_torch.utils.convert import pack_indicator, words_to_torch

logger = logging.getLogger(__name__)

# Distinct genomes per verify batch in low-memory mode: about the disk
# sketch store's working set (max_resident=64), as in the reference.
LOW_MEMORY_VERIFY_KEYS = 64
# Bytes of device-born packed prefilter rows kept for the resident
# screen, unless GALAH_TPU_PREF_CACHE_BYTES says otherwise (the
# reference's default and variable); evicted rows come from the host
# sketches.
PREF_CACHE_BYTES = 512 << 20


class _DictStore:
    """In-memory sketch store (default mode)."""

    def __init__(self) -> None:
        self._d: Dict[str, NativeSketch] = {}

    def put(self, key: str, sketch: NativeSketch) -> None:
        self._d[key] = sketch

    def get(self, key: str) -> Optional[NativeSketch]:
        return self._d.get(key)

    def __contains__(self, key: str) -> bool:
        return key in self._d


class _LazySketchList:
    """List-like view over a sketch store: items load on access, so the
    screen and verify never hold every sketch in RAM at once."""

    def __init__(self, store, keys: List[str]) -> None:
        self._store = store
        self._keys = keys

    def __len__(self) -> int:
        return len(self._keys)

    def __getitem__(self, i: int) -> NativeSketch:
        return self._store.get(self._keys[i])

    def __iter__(self):
        for k in self._keys:
            yield self._store.get(k)


class _LazyIndicatorRows:
    """uint8 0/1 prefilter indicator rows, made on access (each is 8x
    the packed row, so they are never all held)."""

    def __init__(self, sketches) -> None:
        self._sketches = sketches

    def __len__(self) -> int:
        return len(self._sketches)

    def __getitem__(self, i: int) -> np.ndarray:
        return self._sketches[i].prefilter_indicator()


class _LazyPackedRows:
    """Packed uint32 prefilter rows, packed on access."""

    def __init__(self, sketches, bits: int) -> None:
        self._sketches = sketches
        self._bits = bits
        # Lets the screens size their buffers without loading row 0.
        self.row_width = bits // 32

    def __len__(self) -> int:
        return len(self._sketches)

    def __getitem__(self, i: int) -> np.ndarray:
        return pack_indicator(self._sketches[i].prefilter_buckets, self._bits)


def _use_device_sketch(device: torch.device) -> bool:
    """Whether sketching runs on the device: GALAH_TPU_DEVICE_SKETCH=1/0
    forces it; otherwise on for a CUDA device, off on the CPU (the
    reference's rule and variable)."""
    env = os.environ.get("GALAH_TPU_DEVICE_SKETCH")
    if env is not None:
        return env == "1"
    return device.type == "cuda"


def _resident() -> bool:
    """Whether device-born sketch rows are adopted (GALAH_TPU_RESIDENT=0
    turns adoption off)."""
    return os.environ.get("GALAH_TPU_RESIDENT", "1") != "0"


class _PrefRowCache:
    """Device-born packed prefilter rows, kept for the resident screen
    matrix: references to device-sketch batches' (G, W) prefilter words,
    keyed by unit name, FIFO-bounded by bytes. An evicted name is no
    longer served; its row then comes from the host sketch."""

    def __init__(self, budget_bytes: int) -> None:
        from collections import deque

        self._budget = budget_bytes
        self._map: Dict[str, Tuple[torch.Tensor, int]] = {}
        self._batches: "deque" = deque()
        self._bytes = 0

    def adopt(self, names: Sequence[str], pref_words: torch.Tensor) -> None:
        nb = pref_words.numel() * 4
        if nb > self._budget:
            return
        while self._bytes + nb > self._budget and self._batches:
            old_names, old_arr, old_nb = self._batches.popleft()
            for i, nm in enumerate(old_names):
                hit = self._map.get(nm)
                if hit is not None and hit[0] is old_arr and hit[1] == i:
                    del self._map[nm]
            self._bytes -= old_nb
        self._batches.append((list(names), pref_words, nb))
        self._bytes += nb
        for i, nm in enumerate(names):
            self._map[nm] = (pref_words, i)

    def get(self, name: str) -> Optional[Tuple[torch.Tensor, int]]:
        return self._map.get(name)

    def __len__(self) -> int:
        return len(self._map)


def _screen_backend() -> str:
    """The screen GALAH_TPU_SCREEN selects: "popcount" the popcount
    screen, "indicator" the u8 indicator screen; unset or any other
    value the packed screen, as in the reference's fall-through. The
    reference's CPU default is the indicator screen, a choice of speed
    on its CPU backend: the port keeps the packed screen on every
    device, with the same results."""
    env = os.environ.get("GALAH_TPU_SCREEN")
    return env if env in ("popcount", "indicator") else "packed"


def _shrink_bits(
    params: NativeSketchParams, max_genome_length: int
) -> NativeSketchParams:
    """Shrink bitmap widths when the dataset's genomes are small, never
    growing past the defaults: the prefilter bitmap targets ~6% load
    (x16), the member bitmap ~0.4% (x256). Same rule as the reference,
    so both packages sketch at the same widths."""
    import dataclasses

    def pick(
        target_hashes: int, default_bits: int, floor_bits: int, mult: int
    ) -> int:
        bits = 1 << max(int(target_hashes * mult - 1).bit_length(), floor_bits)
        return min(bits, default_bits)

    member = pick(
        max_genome_length // params.fragment_scale + 1,
        params.member_bits, 17, 256,
    )
    pref = pick(
        max_genome_length // params.genome_scale + 1,
        params.prefilter_bits, 13, 16,
    )
    return dataclasses.replace(params, member_bits=member, prefilter_bits=pref)


def calibrated_ani_threshold(
    threshold_pct: float, semantics: str, k: int
) -> float:
    """Map a user-facing ANI threshold to the native estimator's scale:
    "window" is the identity; "skani-calibrated" shifts the threshold
    down by the documented typical indel bias."""
    if semantics == "window":
        return threshold_pct
    if semantics != "skani-calibrated":
        raise ValueError(f"unknown --ani-semantics {semantics!r}")
    c = (
        defaults.CALIBRATION_INDEL_EVENTS_PER_SUB
        * (k + defaults.CALIBRATION_MEAN_INDEL_LEN - 1.0)
        / k
    )
    return threshold_pct - c * (100.0 - threshold_pct)


def _screen_min_containment(
    ani_threshold_pct: float, min_af: float, k: int
) -> float:
    """Exact screen cutoff from the requested AF; min_af <= 0 disables
    screen pruning (every pair is verified)."""
    if min_af <= 0:
        return 0.0
    return defaults.NATIVE_SCREEN_MARGIN * min_af * (ani_threshold_pct / 100.0) ** k


def _emit_verified(res, idx_by_key_pair, threshold_pct, min_af, cache):
    """Insert bidirectional verify results into the sparse cache: the AF
    and ANI filter, every index pair per key pair (the duplicate-path
    rule: an input given twice is emitted in every cluster it belongs
    to), float32 rounding. The one implementation, shared by the batch
    and the overlapped verify."""
    for kp, (ani, af_f, af_r) in res.items():
        for i, j in idx_by_key_pair[kp]:
            if max(af_f, af_r) >= min_af and ani >= threshold_pct:
                cache.insert((i, j), float(np.float32(ani)))


def _chain_sinks(base, extra):
    """One per-batch callback from the device-sketch adoption `base`
    and an `extra` one (the pipeline's screen feed), base first, so the
    verify caches hold a batch before any of its screen tiles can
    drain."""
    if extra is None:
        return base

    def chained(names, sketches, dev):
        base(names, sketches, dev)
        extra(names, sketches, dev)

    return chained


class _VerifyFeeder:
    """Verify while the screen runs: drained tiles' pairs are verified
    in chunks of GALAH_TPU_VERIFY_FLUSH pairs (50,000 by default; 0
    verifies everything in finish()). Results are per pair, so the
    chunking changes none of them: the cache equals the one-batch
    _verify_pairs cache. The time spent verifying goes to the "verify"
    phase and to verify_pairs_per_s."""

    def __init__(self, owner: "NativePreclusterer", sketch_for) -> None:
        env = os.environ.get("GALAH_TPU_VERIFY_FLUSH")
        self.chunk_pairs = int(env) if env else 50_000
        self.owner = owner
        self.sketch_for = sketch_for
        self.cache = SortedPairDistanceCache()
        self.total = 0
        self.verify_seconds = 0.0
        self._buf: List[np.ndarray] = []
        self._buffered = 0

    def feed(self, pairs: np.ndarray, anis=None) -> None:
        if len(pairs) == 0:
            return
        self._buf.append(pairs)
        self._buffered += len(pairs)
        if self.chunk_pairs and self._buffered >= self.chunk_pairs:
            self._flush()

    def _flush(self) -> None:
        if not self._buf:
            return
        pairs = np.concatenate(self._buf)
        self._buf, self._buffered = [], 0
        t0 = time.perf_counter()
        owner = self.owner
        owner._verify_into(pairs, self.sketch_for, self.cache)
        self.total += len(pairs)
        self.verify_seconds += time.perf_counter() - t0

    def finish(self) -> SortedPairDistanceCache:
        self._flush()
        m = metrics.current()
        m.phases["verify"] = m.phases.get("verify", 0.0) + self.verify_seconds
        if self.total:
            m.rate("verify_pairs_per_s", self.total, self.verify_seconds)
        logger.info(
            "Verified %d candidate pairs (overlapped); %d passed "
            "ANI>=%.4g with AF>=%.3g", self.total, len(self.cache),
            self.owner.threshold, self.owner.min_aligned_threshold,
        )
        return self.cache


class NativeContext:
    """Shared state: sketch params, the sketch store, and the
    fragment-ANI engine on `device`: one device, or a sequence of them,
    the shards (a device may repeat), whose first is the main device
    where sketching runs. sketch_directory: the persistent cross-run
    sketch cache (--sketch-directory), keyed by unit, parameters and
    source-file signature, so a re-run reuses its sketches instead of
    sketching again."""

    def __init__(
        self,
        device: Union[torch.device, Sequence[torch.device]],
        small_genomes: bool = False,
        fragment_length: Optional[int] = None,
        threads: int = 4,
        low_memory: bool = False,
        params: Optional[NativeSketchParams] = None,
        max_genome_length: Optional[int] = None,
        sketch_directory: Optional[str] = None,
    ) -> None:
        if params is not None:
            self.params = params
        elif small_genomes:
            self.params = small_genome_params(fragment_length=fragment_length)
        else:
            self.params = NativeSketchParams(
                fragment_length=fragment_length
                if fragment_length is not None
                else defaults.DEFAULT_FRAGMENT_LENGTH
            )
            if max_genome_length:
                self.params = _shrink_bits(self.params, max_genome_length)
        self.devices = ([device] if isinstance(device, torch.device)
                        else list(device))
        self.device = self.devices[0]
        self._sketched_any = False
        self.threads = max(1, threads)
        self.low_memory = low_memory
        self.sketch_directory = sketch_directory
        if sketch_directory:
            # Under --low-memory the directory is also the spill target
            # (a bounded working set); otherwise every sketch stays
            # resident and the disk copy is the reusable artifact.
            self._store = PersistentSketchStore(
                sketch_directory, self.params,
                max_resident=(LOW_MEMORY_VERIFY_KEYS if low_memory
                              else 1 << 31),
            )
        elif low_memory:
            # Disk-backed sketch store with a 64-sketch LRU working set,
            # in a temporary directory removed with the context.
            self._spill_dir = tempfile.TemporaryDirectory(
                prefix="galah-tpu-sketches-"
            )
            self._store = DiskSketchStore(
                self._spill_dir.name, self.params,
                max_resident=LOW_MEMORY_VERIFY_KEYS,
            )
        else:
            self._store = _DictStore()
        self._contig_store: Dict[str, List[NativeSketch]] = {}
        self._pref_cache = _PrefRowCache(int(os.environ.get(
            "GALAH_TPU_PREF_CACHE_BYTES", PREF_CACHE_BYTES)))
        self.frag_engine = FragmentAniEngine(
            FragmentAniConfig(
                k=self.params.k,
                member_bits=self.params.member_bits,
                min_fragment_hashes=self.params.min_fragment_hashes,
            ),
            self.devices,
        )

    def _widen_for_low_af(
        self, min_af: float, screen_ani_pct: Optional[float]
    ) -> None:
        """Widen the prefilter bitmap so the screen cutoff stays >= 4
        sigma above collision noise (std ~ 1/sqrt(B)); refuse widths
        over 2^26 bits. Same rule as the reference."""
        import dataclasses
        import math as _math

        if min_af <= 0:
            return
        ani = screen_ani_pct or defaults.MIN_SUPPORTED_PRECLUSTER_ANI
        cutoff = _screen_min_containment(ani, min_af, self.params.k)
        need = (4.0 / cutoff) ** 2
        cap = 1 << 26
        if need > cap:
            raise ValueError(
                f"Error: --min-aligned-fraction {min_af:g} at ANI "
                f"{ani:g}% needs a {need / 8 / 1e6:.0f}MB prefilter "
                "sketch per genome to screen reliably. Raise "
                "--min-aligned-fraction, or lower it to 0 to disable "
                "aligned-fraction screening entirely (every pair is "
                "then verified)."
            )
        bits = 1 << _math.ceil(_math.log2(need))
        if bits > self.params.prefilter_bits:
            if self._sketched_any:
                raise RuntimeError(
                    "internal: prefilter bitmap widening requested after "
                    "sketches were already computed at the old width"
                )
            logger.info(
                "Widening prefilter bitmap to %d bits for "
                "--min-aligned-fraction %.3g", bits, min_af,
            )
            self.params = dataclasses.replace(
                self.params, prefilter_bits=bits
            )
            if hasattr(self._store, "set_params"):
                self._store.set_params(self.params)

    def key_for(self, sketch: NativeSketch) -> str:
        return sketch.name

    def sketch(self, path: str) -> NativeSketch:
        sk = self._store.get(path)
        if sk is None:
            self._sketched_any = True
            sk = sketch_file_native(path, self.params)
            self._store.put(path, sk)
        return sk

    def _adopt(self, names: Sequence[str], sketches: Sequence[NativeSketch],
               dev: Dict[str, torch.Tensor]) -> None:
        """Hand one device-sketch batch's bitmaps to the verify bitmap
        pool and, unless in low-memory mode (whose screen streams from
        the host), to the screen's prefilter row cache."""
        if not _resident():
            return
        self.frag_engine.adopt_batch(names, sketches, dev)
        if not self.low_memory:
            self._pref_cache.adopt(names, dev["pref_words"])

    def pref_matrix_builder(self, sketches: Sequence[NativeSketch]):
        """matrix_builder for the resident packed screen: builds the
        (n, W) matrix on the device from device-born prefilter rows
        (index_copy_ per batch), uploading host-packed rows only for the
        rows the cache lost. None when no row is device-born."""
        if not _resident():
            return None
        keys = [self.key_for(s) for s in sketches]
        if not any(self._pref_cache.get(k) is not None for k in keys):
            return None
        bits = self.params.prefilter_bits
        dev = self.device

        def build(n: int) -> torch.Tensor:
            x = torch.zeros((n, bits // 32), dtype=torch.int32, device=dev)
            by_batch: Dict[int, Tuple[torch.Tensor, List[int], List[int]]] = {}
            missing: List[int] = []
            for i, key in enumerate(keys):
                hit = self._pref_cache.get(key)
                if hit is None:
                    missing.append(i)
                else:
                    arr, row = hit
                    _, dst, src = by_batch.setdefault(id(arr), (arr, [], []))
                    dst.append(i)
                    src.append(row)
            for arr, dst, src in by_batch.values():
                x.index_copy_(
                    0, torch.tensor(dst, device=dev),
                    arr.index_select(0, torch.tensor(src, device=dev)))
            step = max(1, (64 << 20) // (bits // 8))
            for lo in range(0, len(missing), step):
                rows = missing[lo:lo + step]
                block = np.stack([pack_indicator(sketches[i].prefilter_buckets,
                                                 bits) for i in rows])
                x.index_copy_(0, torch.tensor(rows, device=dev),
                              words_to_torch(block).to(dev))
            m = metrics.current()
            m.count("screen_rows_device_born", n - len(missing))
            m.count("screen_rows_host_uploaded", len(missing))
            logger.info("Resident screen matrix: %d device-born rows, %d "
                        "host-uploaded", n - len(missing), len(missing))
            return x

        return build

    def _sketch_on_device(self, missing: Sequence[str], sink) -> int:
        """Device-sketch genome files into the store, batch by batch,
        each batch handed to sink(names, sketches, device products);
        returns the bases sketched."""
        from galah_tpu_torch.ops.device_sketch import iter_device_sketch_files

        bases = 0
        for idx, sketches, dev in iter_device_sketch_files(
                missing, self.params, self.device, threads=self.threads,
                low_memory=self.low_memory):
            names = [missing[i] for i in idx]
            sink(names, sketches, dev)
            for p, sk in zip(names, sketches):
                self._store.put(p, sk)
                bases += sk.total_len
        return bases

    def sketch_many(self, paths: Sequence[str],
                    extra_sink=None) -> Sequence[NativeSketch]:
        """Sketch every path not yet in the store. Returns the sketches
        in `paths` order: a list, or in low-memory mode a lazy view that
        loads them from the store on access. extra_sink(names, sketches,
        device products), when given, sees each device-sketch batch
        after its adoption (the pipeline's screen feed).

        With several processes (and GALAH_TPU_MP_SKETCH not 0 on
        process 0) each process sketches every nproc-th missing genome
        and the sketches are exchanged (parallel/mp.py); the received
        ones are host sketches, uploaded when verify needs them.
        genomes_sketched and sketch_bases count this process's share,
        sketch_exchange_bytes and sketch_exchange_s the exchange."""
        from galah_tpu_torch.parallel.mp import governed_flag

        missing = [p for p in dict.fromkeys(paths) if p not in self._store]
        if missing:
            logger.info("Sketching %d genomes ..", len(missing))
            self._sketched_any = True
            m = metrics.current()
            with m.phase("sketch"):
                nproc = process_count()
                if (nproc > 1 and len(missing) > 1
                        and governed_flag("GALAH_TPU_MP_SKETCH")):
                    from galah_tpu_torch.parallel.mp import exchange_sketches

                    mine = missing[process_index()::nproc]
                    bases = self._sketch_local(mine) if mine else 0
                    logger.info("Sketched %d/%d genomes locally; exchanging "
                                "across %d processes", len(mine),
                                len(missing), nproc)
                    t0 = time.perf_counter()
                    sent, received = exchange_sketches(
                        missing, self._store.get, self._store.put,
                        expect_params=self.params)
                    m.count("sketch_exchange_bytes", sent + received)
                    m.count("sketch_exchange_s", time.perf_counter() - t0)
                    sketched_here = len(mine)
                else:
                    bases = self._sketch_local(missing, extra_sink)
                    sketched_here = len(missing)
            m.count("genomes_sketched", sketched_here)
            m.count("sketch_bases", bases)
            logger.info("Finished sketching genomes")
        if self.low_memory:
            return _LazySketchList(self._store, list(paths))
        return [self._store.get(p) for p in paths]

    def _sketch_local(self, missing: Sequence[str], extra_sink=None) -> int:
        """Sketch `missing` in this process into the store: on the device
        (each batch adopted, then handed to extra_sink) or by the host
        sketcher. Returns the bases sketched."""
        bases = 0
        if _use_device_sketch(self.device):
            bases = self._sketch_on_device(
                missing, _chain_sinks(self._adopt, extra_sink))
        elif self.threads > 1 and len(missing) > 1:
            with ThreadPoolExecutor(max_workers=self.threads) as ex:
                sketches = ex.map(
                    lambda p: sketch_file_native(p, self.params), missing)
                for p, sk in zip(missing, sketches):
                    self._store.put(p, sk)
                    bases += sk.total_len
        else:
            for p in missing:
                sk = sketch_file_native(p, self.params)
                self._store.put(p, sk)
                bases += sk.total_len
        return bases

    def sketch_contigs(self, paths: Sequence[str],
                       extra_sink=None) -> List[NativeSketch]:
        """One sketch per contig, across files, in file order (the unit
        order of the reference's contig mode). Contig sketches stay in
        memory in every mode, as in the reference. With a sketch
        directory each file's sketches are read from its bundle when one
        is there, and bundles are written for the files sketched
        (sketch_bundle_read_s / sketch_bundle_write_s time them).
        extra_sink: as in sketch_many."""
        missing = [p for p in dict.fromkeys(paths)
                   if p not in self._contig_store]
        if missing and self.sketch_directory:
            missing = self._load_contig_bundles(missing)
        if missing:
            self._sketched_any = True
            with metrics.current().phase("sketch"):
                if _use_device_sketch(self.device):
                    self._sketch_contigs_on_device(
                        missing, _chain_sinks(self._adopt, extra_sink))
                else:
                    for path in missing:
                        self._contig_store[path] = sketch_contigs_native(
                            path, self.params, threads=self.threads)
            metrics.current().count(
                "contigs_sketched",
                sum(len(self._contig_store[p]) for p in missing))
            if self.sketch_directory:
                t0 = time.perf_counter()
                for p in missing:
                    save_contig_sketches(self._contig_bundle_path(p),
                                         self._contig_store[p])
                metrics.current().count("sketch_bundle_write_s",
                                        time.perf_counter() - t0)
        return [sk for p in paths for sk in self._contig_store[p]]

    def _load_contig_bundles(self, paths: Sequence[str]) -> List[str]:
        """Read the bundle of each path that has one in the sketch
        directory; the paths still to sketch. An unreadable bundle is
        ignored with a warning."""
        t0 = time.perf_counter()
        still = []
        for p in paths:
            bp = self._contig_bundle_path(p)
            if os.path.exists(bp):
                try:
                    self._contig_store[p] = load_contig_sketches(bp)
                    continue
                except Exception as e:
                    logger.warning("ignoring unreadable contig sketch "
                                   "bundle %s: %r", bp, e)
            still.append(p)
        if len(still) < len(paths):
            metrics.current().count("sketch_bundle_read_s",
                                    time.perf_counter() - t0)
            logger.info("Reused contig sketches for %d/%d files from %s",
                        len(paths) - len(still), len(paths),
                        self.sketch_directory)
        return still

    def _contig_bundle_path(self, path: str) -> str:
        """The content-stable bundle name of one FASTA's contig
        sketches: the JAX package's, so either reads the other's."""
        return os.path.join(self.sketch_directory, _stable_sketch_name(
            "contigs:" + path, self.params, _file_sig(path)))

    def _sketch_contigs_on_device(self, missing: Sequence[str],
                                  sink) -> None:
        from galah_tpu_torch.ops.device_sketch import device_sketch_contig_files

        for path, sketches in zip(missing, device_sketch_contig_files(
                missing, self.params, self.device, threads=self.threads,
                low_memory=self.low_memory, on_batch=sink)):
            self._contig_store[path] = sketches


class NativePreclusterer(PreclusterDistanceFinder):
    supports_contigs = True

    def __init__(
        self,
        threshold: float,
        min_aligned_threshold: float,
        ctx: NativeContext,
        ani_semantics: str = defaults.DEFAULT_ANI_SEMANTICS,
        sweep_checkpoint: Optional[str] = None,
    ) -> None:
        """threshold: percent (e.g. 95.0); min_aligned_threshold:
        fraction (e.g. 0.15). sweep_checkpoint: path of the mid-sweep
        tile log (ops/sweep_checkpoint.py): drained screen tiles are
        logged as they come and a killed sweep resumes from them, with
        byte-identical results."""
        if threshold < defaults.MIN_SUPPORTED_PRECLUSTER_ANI:
            raise ValueError(
                "Error: the native engine produces inaccurate results with ANI "
                f"less than 85%. Provided: {threshold:g}"
            )
        self.threshold = calibrated_ani_threshold(
            threshold, ani_semantics, ctx.params.k
        )
        self.min_aligned_threshold = min_aligned_threshold
        self.ctx = ctx
        self.sweep_checkpoint = sweep_checkpoint
        # Sizes the prefilter bitmap for the requested AF before any
        # sketching (the width shapes the sketches).
        ctx._widen_for_low_af(min_aligned_threshold, threshold)

    def distances(
        self, genome_fasta_paths: Sequence[str]
    ) -> SortedPairDistanceCache:
        if self._pipeline_enabled(len(genome_fasta_paths)):
            return self._distances_pipelined(genome_fasta_paths)
        return self._screen_and_verify(self.ctx.sketch_many(genome_fasta_paths))

    def distances_contigs(
        self, genome_fasta_paths: Sequence[str], contig_names: Sequence[str]
    ) -> SortedPairDistanceCache:
        """Contig mode: one unit per contig, screened and verified as
        genomes are."""
        if self._pipeline_enabled(len(contig_names)):
            return self._distances_contigs_pipelined(genome_fasta_paths,
                                                     contig_names)
        return self._screen_and_verify(
            self._contig_sketches(genome_fasta_paths, contig_names))

    def _contig_sketches(self, paths: Sequence[str],
                         contig_names: Sequence[str], extra_sink=None):
        sketches = self.ctx.sketch_contigs(paths, extra_sink=extra_sink)
        if [s.name for s in sketches] != list(contig_names):
            raise ValueError(
                "Contig names passed to distances_contigs do not match file "
                "contents"
            )
        return sketches

    def _sharded(self) -> bool:
        """Whether the screens are the sharded sweeps: several shards
        or processes and no explicit GALAH_TPU_SCREEN (the JAX package's
        condition, jax.device_count() > 1, counts every process's
        devices)."""
        return (os.environ.get("GALAH_TPU_SCREEN") is None
                and (len(self.ctx.devices) > 1 or process_count() > 1))

    def _pipeline_enabled(self, n_units: int) -> bool:
        """Whether sketch, screen and verify overlap (the reference's
        rule, galah_tpu/engines/native.py::_pipeline_enabled): the
        single-device resident packed screen fed by device sketching, so
        not under low memory, not with GALAH_TPU_RESIDENT=0 or another
        screen, not over several shards or processes, and only for a
        matrix within _device_resident_budget. GALAH_TPU_PIPELINE=0
        turns it off; =1 forces it (on the main device) over several
        shards and on host sketches, whose rows all reach the screen
        after sketching."""
        env = os.environ.get("GALAH_TPU_PIPELINE")
        if env == "0" or n_units < 2:
            return False
        ctx = self.ctx
        if ctx.low_memory or not _resident():
            return False
        if env != "1" and (not _use_device_sketch(ctx.device)
                           or self._sharded()):
            return False
        if _screen_backend() != "packed":
            return False
        w = ctx.params.prefilter_bits // 32
        return n_units * w * 4 <= _device_resident_budget(ctx.device)

    def _distances_pipelined(
        self, paths: Sequence[str]
    ) -> SortedPairDistanceCache:
        """The overlapped phases over whole genomes (units keyed by
        path; a path given twice feeds both of its rows)."""
        idxs_by_key: Dict[str, List[int]] = {}
        for i, p in enumerate(paths):
            idxs_by_key.setdefault(p, []).append(i)
        return self._run_pipelined(
            len(paths), idxs_by_key,
            lambda feed: self.ctx.sketch_many(paths, extra_sink=feed),
            list(paths))

    def _distances_contigs_pipelined(
        self, paths: Sequence[str], contig_names: Sequence[str]
    ) -> SortedPairDistanceCache:
        """The overlapped phases over contigs (units keyed by contig
        name; the CLI refuses duplicate names)."""
        idxs_by_key: Dict[str, List[int]] = {}
        for i, nm in enumerate(contig_names):
            idxs_by_key.setdefault(nm, []).append(i)
        return self._run_pipelined(
            len(contig_names), idxs_by_key,
            lambda feed: self._contig_sketches(paths, contig_names, feed),
            list(contig_names))

    def _run_pipelined(
        self, n: int, idxs_by_key: Dict[str, List[int]], sketch_call,
        unit_names: Sequence[str],
    ) -> SortedPairDistanceCache:
        """Sketch, screen and verify overlapped: the sketch sink adds
        each batch's device-born prefilter rows to an
        IncrementalPackedScreen, whose tiles are issued as their row
        blocks complete and whose drained pairs feed a _VerifyFeeder.
        Rows the sink never saw (units already sketched, host sketches)
        are added from the host after sketching. The "screen" phase
        holds only the screen's time after sketching (the rest runs
        inside the sketch phase), and phases_overlapped = 1 says the
        phases overlap; screen_rows_at_first_dispatch counts the rows
        fed when the first tile was issued. Results equal the
        sequential path's. unit_names key the sweep checkpoint's
        fingerprint. A failure anywhere propagates, after the screen
        released its tiles in flight and its checkpoint."""
        ctx = self.ctx
        k = ctx.params.k
        bits = ctx.params.prefilter_bits
        min_cont = _screen_min_containment(
            self.threshold, self.min_aligned_threshold, k
        )
        logger.info("Sketching, screening and verifying %d units "
                    "(overlapped) ..", n)
        scr = IncrementalPackedScreen(n, k, min_cont, bits, ctx.device,
                                      checkpoint_path=self.sweep_checkpoint,
                                      unit_names=unit_names)
        try:
            # A tile is issued only once its row blocks were fed, and every
            # feed records its sketches first, so a drained pair's sketches
            # are here.
            sk_by_idx: Dict[int, NativeSketch] = {}
            feeder = _VerifyFeeder(self, sk_by_idx.__getitem__)
            scr.on_pairs = feeder.feed

            def screen_feed(names, sketches, dev):
                idxs: List[int] = []
                src_rows: List[int] = []
                sizes: List[float] = []
                for r, (nm, sk) in enumerate(zip(names, sketches)):
                    for i in idxs_by_key.get(nm, ()):
                        idxs.append(i)
                        src_rows.append(r)
                        sizes.append(float(sk.n_prefilter))
                        sk_by_idx[i] = sk
                if idxs:
                    scr.add_device_rows(idxs, dev["pref_words"], src_rows,
                                        sizes)

            t0 = time.perf_counter()
            sketches = sketch_call(screen_feed)
            t_sketched = time.perf_counter()
            for i in range(n):
                if i not in sk_by_idx:
                    sk_by_idx[i] = sketches[i]
            late = scr.missing_rows()
            if late:
                scr.add_host_rows(
                    late,
                    [pack_indicator(sk_by_idx[i].prefilter_buckets, bits)
                     for i in late],
                    [float(sk_by_idx[i].n_prefilter) for i in late],
                )
            res = scr.finish()
            tail = time.perf_counter() - t_sketched
            m = metrics.current()
            m.phases["screen"] = m.phases.get("screen", 0.0) + tail
            m.counters["phases_overlapped"] = 1.0
            m.rate("screen_pairs_per_s", n * (n - 1) // 2,
                   time.perf_counter() - t0)
            m.count("screen_rows_device_born", n - len(late))
            m.count("screen_rows_host_uploaded", len(late))
            # None when every tile was replayed from the sweep checkpoint.
            if scr.rows_at_first_dispatch is not None:
                m.count("screen_rows_at_first_dispatch",
                        scr.rows_at_first_dispatch)
            logger.info(
                "Pipelined screen: first tile issued after %s/%d rows; %d "
                "rows added after sketching; screen tail %.2fs; %d "
                "candidate pairs",
                scr.rows_at_first_dispatch, n, len(late), tail, len(res.pairs))
            cache = feeder.finish()
            self._report_indel_load(cache, sk_by_idx.__getitem__)
            return cache
        finally:
            scr.close()

    def distances_with_references(
        self, genome_fasta_paths: Sequence[str], reference_genomes: Sequence[str]
    ) -> SortedPairDistanceCache:
        """Cross-group comparisons only: each non-reference genome
        against each reference, never within a group. The indicator
        screen takes its rectangle (screen_rectangle), every other
        backend the packed one, as the reference does."""
        ctx = self.ctx
        sketches = ctx.sketch_many(genome_fasta_paths)
        ref_set = set(reference_genomes)
        ref_idx = [i for i, p in enumerate(genome_fasta_paths) if p in ref_set]
        query_idx = [
            i for i, p in enumerate(genome_fasta_paths) if p not in ref_set
        ]
        if not ref_idx or not query_idx:
            return SortedPairDistanceCache()
        self._warn_checkpoint_unsupported("reference-genome rectangle")
        k = ctx.params.k
        bits = ctx.params.prefilter_bits
        min_cont = _screen_min_containment(
            self.threshold, self.min_aligned_threshold, k
        )
        logger.info("Screening %d genomes against %d references ..",
                    len(query_idx), len(ref_idx))
        rows = _LazyPackedRows(sketches, bits)
        args = (k, min_cont, bits)
        if self._sharded() and not ctx.low_memory:
            logger.info("Reference-mode screening on %d shards of %d "
                        "processes (sharded rectangle sweep)",
                        len(ctx.devices), process_count())
            screen, opts = distance.sharded_screen_rectangle_packed, {
                "devices": ctx.devices}
        elif _screen_backend() == "indicator":
            rows = _LazyIndicatorRows(sketches)
            screen, args, opts = screen_rectangle, (k, min_cont), {
                "device": ctx.device}
        else:
            screen, opts = screen_rectangle_packed, {
                "device": ctx.device, "cache_blocks": not ctx.low_memory}
        res = self._timed_screen(
            len(query_idx) * len(ref_idx), screen,
            [rows[i] for i in query_idx],
            np.asarray([sketches[i].n_prefilter for i in query_idx]),
            [rows[i] for i in ref_idx],
            np.asarray([sketches[i].n_prefilter for i in ref_idx]),
            *args, **opts,
        )
        if len(res.pairs) == 0:
            return SortedPairDistanceCache()
        remapped = np.stack([
            np.asarray(query_idx, dtype=np.int64)[res.pairs[:, 0]],
            np.asarray(ref_idx, dtype=np.int64)[res.pairs[:, 1]],
        ], axis=1)
        cache = self._verify_pairs(sketches, remapped)
        self._report_indel_load(cache, lambda i: sketches[i])
        return cache

    def method_name(self) -> str:
        return "native"

    def _warn_checkpoint_unsupported(self, path_name: str) -> None:
        """The JAX package's warning for a screen that does not log to
        the sweep checkpoint."""
        if self.sweep_checkpoint:
            logger.warning(
                "--sweep-checkpoint only applies to the single-device "
                "resident packed screen; the %s path will NOT "
                "checkpoint mid-sweep (the between-phase caches, "
                "--output-distance-cache and the sketch store, still "
                "apply)", path_name,
            )

    def _timed_screen(
        self, n_pairs: int, screen: Callable[..., ScreenResult], *args,
        **kwargs,
    ) -> ScreenResult:
        """screen(*args, **kwargs), its time added to the "screen"
        phase."""
        t0 = time.perf_counter()
        res = screen(*args, **kwargs)
        dt = time.perf_counter() - t0
        m = metrics.current()
        m.phases["screen"] = m.phases.get("screen", 0.0) + dt
        m.rate("screen_pairs_per_s", n_pairs, dt)
        logger.info("Screen produced %d candidate pairs", len(res.pairs))
        return res

    def _screen_and_verify(
        self, sketches: Sequence[NativeSketch]
    ) -> SortedPairDistanceCache:
        ctx = self.ctx
        k = ctx.params.k
        bits = ctx.params.prefilter_bits
        n = len(sketches)
        logger.info("Screening %d sketches all-vs-all ..", n)
        min_cont = _screen_min_containment(
            self.threshold, self.min_aligned_threshold, k
        )
        sizes = np.asarray([s.n_prefilter for s in sketches])
        names = [s.name for s in sketches] if self.sweep_checkpoint else None
        rows, args = _LazyPackedRows(sketches, bits), (k, min_cont, bits)
        if self._sharded() and ctx.low_memory:
            # The row-sharded sweep holds about n / shards rows a shard,
            # fed lazily from the low-memory sketch store.
            self._warn_checkpoint_unsupported("row-sharded low-memory")
            logger.info("Screening on %d shards of %d processes (row-sharded "
                        "sweep fed from the low-memory sketch store)",
                        len(ctx.devices), process_count())
            screen = distance.sharded_screen_triangle_rowsharded
            opts = {"devices": ctx.devices}
        elif self._sharded():
            logger.info("Screening on %d shards of %d processes (sharded "
                        "tile sweep)", len(ctx.devices), process_count())
            screen = distance.sharded_screen_triangle_packed
            opts = {"devices": ctx.devices,
                    "checkpoint_path": self.sweep_checkpoint,
                    "unit_names": names}
        elif _screen_backend() == "popcount":
            self._warn_checkpoint_unsupported("popcount")
            screen, opts = screen_triangle_popcount, {"device": ctx.device}
        elif _screen_backend() == "indicator":
            self._warn_checkpoint_unsupported("indicator")
            screen, rows, args = (screen_triangle, _LazyIndicatorRows(sketches),
                                  (k, min_cont))
            opts = {"device": ctx.device, "cache_blocks": not ctx.low_memory}
        else:
            # The streaming (low-memory) sweep warns that it does not
            # checkpoint.
            screen = screen_triangle_packed
            opts = {
                "device": ctx.device,
                "cache_blocks": not ctx.low_memory,
                "matrix_builder": (None if ctx.low_memory
                                   else ctx.pref_matrix_builder(sketches)),
                "checkpoint_path": self.sweep_checkpoint,
                "unit_names": None if ctx.low_memory else names,
            }
        res = self._timed_screen(n * (n - 1) // 2, screen, rows, sizes,
                                 *args, **opts)
        if len(res.pairs) == 0:
            return SortedPairDistanceCache()
        cache = self._verify_pairs(sketches, res.pairs)
        self._report_indel_load(cache, lambda i: sketches[i])
        return cache

    def _report_indel_load(self, cache, sketch_for) -> None:
        """Advisory: estimate the corpus's apparent indel load from a
        sample of verified pairs (ops/indel_estimate.py, host numpy)
        and report it in the metrics and log, as the reference
        does. GALAH_TPU_INDEL_ESTIMATE=0 disables."""
        if os.environ.get("GALAH_TPU_INDEL_ESTIMATE", "1") == "0":
            return
        if len(cache) == 0:
            return
        try:
            from collections import Counter

            from galah_tpu_torch.ops.indel_estimate import estimate_indel_load

            keys = [p for p, _ in cache.items()]
            span = 128
            blocks = Counter(
                min(i, j) // span
                for i, j in keys
                if max(i, j) - min(i, j) < span
            )
            sample = []
            if blocks:
                best = blocks.most_common(1)[0][0]
                sample = [
                    (i, j) for i, j in keys
                    if min(i, j) // span == best
                    and max(i, j) - min(i, j) < span
                ][:24]
            if len(sample) < 8:
                sample = keys[:24]
            res = estimate_indel_load(
                sample, sketch_for, self.ctx.params, max_pairs=24
            )
        except Exception as e:  # advisory: never fail the run
            logger.debug("indel-load estimate failed: %r", e)
            return
        if res is None:
            return
        m = metrics.current()
        m.count(
            "apparent_indel_events_per_sub",
            res["apparent_indel_events_per_sub"],
        )
        m.count("indel_estimate_pairs_used", res["pairs_used"])
        logger.info(
            "Apparent corpus indel load: %.3f indel events per "
            "substitution (skani-calibrated assumes %.3f; mark ratio "
            "%.1f over %d pair-directions / %d fragments).",
            res["apparent_indel_events_per_sub"], res["calibration_default"],
            res["mark_ratio"], int(res["pairs_used"]),
            int(res["fragments_used"]),
        )

    def _verify_pairs(
        self, sketches: Sequence[NativeSketch], pairs: np.ndarray
    ) -> SortedPairDistanceCache:
        """One bidirectional batch over every candidate pair; in
        low-memory mode a batch per LOW_MEMORY_VERIFY_KEYS distinct
        genomes, so at most about the disk store's working set is held
        at a time. Results are per pair, so the chunking changes none
        of them."""
        cache = SortedPairDistanceCache()
        t0 = time.perf_counter()
        keys = (
            sketches._keys if isinstance(sketches, _LazySketchList) else None
        )
        self._verify_into(pairs, sketches.__getitem__, cache, keys,
                          LOW_MEMORY_VERIFY_KEYS if self.ctx.low_memory
                          else None)
        dt = time.perf_counter() - t0
        m = metrics.current()
        m.phases["verify"] = m.phases.get("verify", 0.0) + dt
        if len(pairs):
            m.rate("verify_pairs_per_s", len(pairs), dt)
        logger.info(
            "Verified %d candidate pairs; %d passed ANI>=%.4g with AF>=%.3g",
            len(pairs), len(cache), self.threshold, self.min_aligned_threshold,
        )
        return cache

    def _verify_into(self, pairs, sketch_for, cache, keys=None,
                     chunk_keys: Optional[int] = None) -> None:
        """Verify index pairs (sketches by sketch_for(i); keys[i] their
        keys when given) and insert those that pass into `cache`, in
        batches of chunk_keys distinct keys when given."""
        ctx = self.ctx

        def flush(key_pairs, sketches_by_key, idx_by_key_pair):
            res = ctx.frag_engine.bidirectional(key_pairs, sketches_by_key)
            _emit_verified(res, idx_by_key_pair, self.threshold,
                           self.min_aligned_threshold, cache)

        sketches_by_key: Dict[str, NativeSketch] = {}
        key_pairs: List[Tuple[str, str]] = []
        idx_by_key_pair: Dict[Tuple[str, str], List[Tuple[int, int]]] = {}
        for i, j in pairs:
            i, j = int(i), int(j)
            if keys:
                ki, kj = keys[i], keys[j]
            else:
                ki, kj = ctx.key_for(sketch_for(i)), ctx.key_for(sketch_for(j))
            if ki not in sketches_by_key:
                sketches_by_key[ki] = sketch_for(i)
            if kj not in sketches_by_key:
                sketches_by_key[kj] = sketch_for(j)
            key_pairs.append((ki, kj))
            idx_by_key_pair.setdefault((ki, kj), []).append((i, j))
            if chunk_keys and len(sketches_by_key) >= chunk_keys:
                flush(key_pairs, sketches_by_key, idx_by_key_pair)
                sketches_by_key, key_pairs, idx_by_key_pair = {}, [], {}
        if key_pairs:
            flush(key_pairs, sketches_by_key, idx_by_key_pair)


class NativeClusterer(ClusterDistanceFinder):
    def __init__(
        self,
        threshold: float,
        min_aligned_threshold: float,
        ctx: NativeContext,
        af_fail_result: Optional[float] = 0.0,
        ani_semantics: str = defaults.DEFAULT_ANI_SEMANTICS,
    ) -> None:
        """af_fail_result: value returned when the AF filter fails (0.0,
        skani-compatible; None, fastANI-compatible)."""
        self.threshold = calibrated_ani_threshold(
            threshold, ani_semantics, ctx.params.k
        )
        self.min_aligned_threshold = min_aligned_threshold
        self.ctx = ctx
        self.af_fail_result = af_fail_result

    def initialise(self) -> None:
        if not self.threshold > 1.0:
            raise ValueError("ANI threshold must be a percentage")

    def method_name(self) -> str:
        return "native"

    def get_ani_threshold(self) -> float:
        return self.threshold

    def calculate_ani(self, fasta1: str, fasta2: str) -> Optional[float]:
        return self.calculate_ani_batch([(fasta1, fasta2)])[0]

    def calculate_ani_batch(
        self, pairs: Sequence[Tuple[str, str]]
    ) -> List[Optional[float]]:
        """Pairs are (ref, query) paths."""
        if not pairs:
            return []
        ctx = self.ctx
        sketches_by_key = {}
        key_pairs = []
        for ref, query in pairs:
            rs, qs = ctx.sketch(ref), ctx.sketch(query)
            kr, kq = ctx.key_for(rs), ctx.key_for(qs)
            sketches_by_key[kr] = rs
            sketches_by_key[kq] = qs
            key_pairs.append((kq, kr))
        res = ctx.frag_engine.bidirectional(key_pairs, sketches_by_key)
        out: List[Optional[float]] = []
        for kp in key_pairs:
            ani, af_f, af_r = res[kp]
            if max(af_f, af_r) >= self.min_aligned_threshold:
                out.append(float(np.float32(ani)))
            else:
                out.append(self.af_fail_result)
        return out
