"""Part of the port's benchmark (see bench_gpu/harness.py)."""
