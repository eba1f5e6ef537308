"""Per-layer metric readers, one module a metric, found by the metric's
name in BENCHMARK.json. Each has ``read(ctx)`` returning the number, or
None where the traced job gave it nothing to read."""
