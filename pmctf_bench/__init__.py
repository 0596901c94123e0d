"""The benchmark of learned_pmctf_tpu_torch: see README.md and BENCHMARK.json."""
