"""The benchmark of the PyTorch/CUDA port ``sddmm_tpu_torch`` on the H100:
``python3 perfbench/run.py --workload <cell> ...`` (see README.md)."""
