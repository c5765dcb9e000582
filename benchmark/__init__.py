"""The benchmark of the PyTorch and CUDA port (`pb_llm_tpu_torch`): cells,
configurations, traffic mixes, metric readers, the plain reference and the
yardstick.  `run.py` runs one cell once; `BENCHMARK.json` at the root of the
repository lists what there is."""
