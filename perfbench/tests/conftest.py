"""Shared sizes of the benchmark's CPU tests: every cell cut to a size at
which the kernels' plain versions run in seconds on the CPU."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: rehearsal overrides by cell
TINY = {
    "sddmm.powerlaw512k.k128": {"traffic": {
        "pattern": {"args": {"num_nodes": 1024, "avg_degree": 8}},
        "pool": 2, "host_calls": 3, "profile_calls": 3}},
    "longformer.train": {
        "config": {"hidden_size": 128, "num_attention_heads": 2,
                   "num_hidden_layers": 2, "attention_window": [64]},
        "traffic": {"seq_len": 256, "batch": 2, "pool": 6, "host_calls": 2,
                    "profile_calls": 2}},
}


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
