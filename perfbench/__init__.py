"""The benchmark of ir_sgmcmc_tpu_torch on one H100: see run.py and BENCHMARK.json."""
