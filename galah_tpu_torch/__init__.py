"""galah_tpu_torch — the PyTorch/CUDA port of galah_tpu.

Runs the `cluster` main path (host sketch -> packed all-vs-all screen ->
fragment-containment verify -> greedy clustering) with torch tensors on
one CUDA device, or on the CPU for tests. The screens' intersection
counts go through hand-written CUDA kernels (csrc/packed_popcount.cu,
csrc/popcount_screen.cu); the verify programs are plain torch.
`python -m galah_tpu_torch.tools.gather_probe` measures the word-gather
rate that sizes them (csrc/gather_probe.cu).

The JAX package `galah_tpu` stays the reference. This package imports
nothing of it: its host layer (sketching, clustering, the sketch store,
quality filtering, CLI helpers) is its own copy of the JAX package's
host-only modules, at the same relative paths.
"""

__version__ = "0.2.2"
