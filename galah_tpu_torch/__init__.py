"""galah_tpu_torch — the PyTorch/CUDA port of galah_tpu.

Runs the `cluster` main path (host sketch -> packed all-vs-all screen ->
fragment-containment verify -> greedy clustering) with torch tensors on
one CUDA device, or on the CPU for tests. The screen's intersection
counts go through a hand-written CUDA kernel (csrc/packed_popcount.cu);
the verify programs are plain torch.

The JAX package `galah_tpu` stays the reference: this package imports
its host-only modules (sketching, clustering, quality, CLI helpers) and
never imports JAX or any `galah_tpu` module that does.
"""

__version__ = "0.2.2"
