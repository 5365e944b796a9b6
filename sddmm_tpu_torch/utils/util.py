"""Misc utilities (reference include/util.hpp equivalents).

Counterpart of ``sddmm_tpu/utils/util.py``: the CLI's log-file names."""

from __future__ import annotations

from pathlib import Path


def to_trimmed_string(x: float) -> str:
    """Float formatted for log filenames: trailing zeros trimmed
    (reference util::to_trimmed_string, include/util.hpp:136-150):
    0.30 -> '0.3', 1.10 -> '1.1', 0.0 -> '0'."""
    s = f"{x:.6f}".rstrip("0").rstrip(".")
    return s if s else "0"


def file_suffix(path: str) -> str:
    return Path(path).suffix


def file_stem(path: str) -> str:
    return Path(path).stem
