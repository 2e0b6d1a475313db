"""The benchmark of sagan_tpu_torch (see BENCHMARK.json)."""
