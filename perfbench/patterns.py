"""Sparsity patterns of the benchmark's traffic, made from their own seeds.

Frozen copies of the port's suite generator ``powerlaw_graph`` and of the
attention models' sliding-window mask, so that a change to the program
cannot change what the benchmark asks of it.
Each returns a ``Pattern``: the (m, n) shape, ``row_ptr`` (int64) and
``col_idx`` (int32) in CSR entry order (row, then column).  A CPU test holds
the copies bit-equal to the port's generators as they stand.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Pattern:
    m: int
    n: int
    row_ptr: np.ndarray   # (m + 1,) int64
    col_idx: np.ndarray   # (nnz,) int32

    @property
    def nnz(self) -> int:
        return int(len(self.col_idx))

    def row_idx(self) -> np.ndarray:
        """(nnz,) int64 row of every entry."""
        return np.repeat(np.arange(self.m, dtype=np.int64),
                         np.diff(self.row_ptr))


def _from_sorted_keys(m: int, n: int, rows: np.ndarray,
                      cols: np.ndarray) -> Pattern:
    """Entries already in (row, column) order and unique -> a Pattern."""
    row_ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=m), out=row_ptr[1:])
    return Pattern(m, n, row_ptr, cols.astype(np.int32))


def powerlaw(num_nodes: int, avg_degree: float, seed: int = 0,
             exponent: float = 2.1) -> Pattern:
    """Zipf-weighted degrees, neighbours drawn by the same weights (the
    port's ``generate.powerlaw_graph``)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    weights = ranks ** (-1.0 / (exponent - 1.0))
    weights /= weights.sum()
    degrees = rng.poisson(avg_degree * weights * num_nodes /
                          (avg_degree * weights * num_nodes).mean()
                          * avg_degree)
    degrees = np.clip(degrees, 0, num_nodes - 1)
    rows = np.repeat(np.arange(num_nodes, dtype=np.int64), degrees)
    cols = rng.choice(num_nodes, size=len(rows), p=weights)
    keys = np.unique(rows * num_nodes + cols)
    return _from_sorted_keys(num_nodes, num_nodes, keys // num_nodes,
                             keys % num_nodes)


def attention_window(seq_len: int, window: int, num_global: int) -> Pattern:
    """Longformer's mask: row i sees columns within ``window`` of i and
    the first ``num_global`` columns; the first ``num_global`` rows see
    every column."""
    i = np.arange(seq_len, dtype=np.int64)
    lo = np.maximum(i - window, 0)
    hi = np.minimum(i + window + 1, seq_len)
    counts = hi - lo
    rows = [np.repeat(i, counts)]
    cols = [np.arange(int(counts.sum()), dtype=np.int64)
            - np.repeat(np.cumsum(counts) - counts, counts)
            + np.repeat(lo, counts)]
    g = np.arange(num_global, dtype=np.int64)
    rows += [np.repeat(i, num_global), np.repeat(g, seq_len)]
    cols += [np.tile(g, seq_len), np.tile(i, num_global)]
    keys = np.unique(np.concatenate(rows) * seq_len + np.concatenate(cols))
    return _from_sorted_keys(seq_len, seq_len, keys // seq_len,
                             keys % seq_len)


GENERATORS = {"powerlaw": powerlaw,
              "attention_window": attention_window}


def make(spec: dict) -> Pattern:
    """``{"generator": name, "args": {...}}`` -> the Pattern."""
    return GENERATORS[spec["generator"]](**spec["args"])
