"""galah_tpu_torch — the PyTorch/CUDA port of galah_tpu.

Runs the JAX package's single-device surface with torch tensors on one
CUDA device, or on the CPU for tests:

- the `cluster` command in genome, reference-genome, low-memory and
  contig modes: sketching on the card -> packed all-vs-all screen ->
  fragment-containment verify -> greedy clustering on the host;
- its resume artifacts, in the JAX package's file formats: the
  persistent sketch directory (--sketch-directory), the mid-sweep
  screen checkpoint (--sweep-checkpoint, ops/sweep_checkpoint.py) and
  the between-phase distance caches (--output-distance-cache,
  --input-distance-cache);
- the other methods: finch (MinHash) preclustering, and skani and
  fastANI as external tools;
- the `process`, `analyse` and `cluster-validate` subcommands, and the
  library API (galah_tpu_torch.api: cluster_genomes, cluster_contigs,
  pairwise_ani, each taking the device to run on).

The device work goes through hand-written CUDA kernels: K5 sketches raw
sequence bytes and deduplicates each fragment's buckets on chip
(csrc/device_sketch.cu), K1 and K2 count the screens' intersections on
the tensor cores (csrc/packed_popcount.cu, csrc/popcount_screen.cu); the
verify programs are plain torch. `python -m
galah_tpu_torch.tools.gather_probe` measures the word-gather rate that
sizes them (K3/K4, csrc/gather_probe.cu), and `python -m
galah_tpu_torch.tools.k5_profile` splits K5's time at the CLI's batch
shapes.

The JAX package `galah_tpu` stays the reference. This package imports
nothing of it: its host layer (sketching, clustering, the sketch store,
the checkpoint log, quality filtering, annotation, the subprocess
backends, CLI helpers) is its own copy of the JAX package's host-only
modules, at the same relative paths.
"""

__version__ = "0.2.2"
