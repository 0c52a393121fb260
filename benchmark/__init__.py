"""The benchmark of lion_tpu_torch on one NVIDIA H100: `run.py` runs one
cell of BENCHMARK.json; see PERF.md for the cells, metrics and limits."""
