"""Checkpoint and resume of training state.

Counterpart of ``sddmm_tpu/utils/checkpoint.py`` (``Checkpointer``, on
orbax there): the same API over ``torch.save`` files, one per step,
``step_<n>.pt`` in one directory.  Each file is written under a temporary
name and renamed into place, so a reader never sees half a file and a
crash leaves the previous step intact.  The newest ``keep`` steps stay.

    ck = Checkpointer("/path/run1", keep=3)
    ck.save(step, {"params": ..., "opt": optimizer.state_dict()})
    state = ck.restore()            # latest, or None if empty
    state = ck.restore(step=500)    # a given step
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class Checkpointer:
    """State dictionaries of tensors and plain values, saved per step."""

    def __init__(self, directory, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep={keep} must be >= 1")
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{int(step)}.pt"

    def all_steps(self) -> list:
        """The saved steps, ascending."""
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """Persist ``state`` at ``step`` (written, then renamed into
        place); then drop all but the newest ``keep`` steps."""
        path = self._path(step)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        try:
            torch.save(state, tmp)
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)
        for old in self.all_steps()[:-self.keep]:
            self._path(old).unlink(missing_ok=True)

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        """The state saved at ``step`` (default: the latest), its tensors
        on ``map_location``; None if nothing was saved.  Only tensors and
        plain containers are read back (``weights_only``)."""
        s = self.latest_step if step is None else int(step)
        if s is None:
            return None
        path = self._path(s)
        if not path.is_file():
            raise FileNotFoundError(f"no checkpoint of step {s} in "
                                    f"{self.directory}")
        return torch.load(path, map_location=map_location, weights_only=True)
