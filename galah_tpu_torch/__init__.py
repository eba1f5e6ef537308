"""galah_tpu_torch — the PyTorch/CUDA port of galah_tpu.

Runs the `cluster` command (genome, reference-genome, low-memory and
contig modes) with torch tensors on one CUDA device, or on the CPU for
tests: sketching on the card -> packed all-vs-all screen ->
fragment-containment verify -> greedy clustering on the host. The
device work goes through hand-written CUDA kernels: K5 sketches raw
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
quality filtering, CLI helpers) is its own copy of the JAX package's
host-only modules, at the same relative paths.
"""

__version__ = "0.2.2"
