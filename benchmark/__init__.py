"""The benchmark of the PyTorch and CUDA port (nebulae_tpu_torch): one cell
of BENCHMARK.json a run (`python3 benchmark/run.py --workload <name> ...`)."""
