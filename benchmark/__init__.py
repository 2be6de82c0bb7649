"""The benchmark of mgm_tpu_torch, the PyTorch and CUDA port: run.py
runs one cell once and prints its result line (see BENCHMARK.json and
spec.py for what lives where)."""
