"""Benchmark of galah_tpu_torch: whole cluster jobs on one card."""
