"""Checkpointing of the whole train state (port of
gbnerf_tpu/train/checkpoint.py, orbax → ``torch.save``).

One file per step, ``<ckpt_dir>/<step>.pt``: the step, both fields' state
dicts and the optimizer's. A save writes a temporary file in the same
directory and renames it over the final name, so a reader never sees half
a checkpoint; the newest ``max_to_keep`` are kept. Restoring loads into the
given state in place (the train step closes over its modules).
"""
from __future__ import annotations

import os
import tempfile
from typing import List, Optional

import torch

from .state import TrainState


class CheckpointManager:
    def __init__(self, ckpt_dir: str, max_to_keep: int = 3):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"{step}.pt")

    def steps(self) -> List[int]:
        return sorted(int(f[:-3]) for f in os.listdir(self.ckpt_dir)
                      if f.endswith(".pt") and f[:-3].isdigit())

    def save(self, step: int, state: TrainState) -> None:
        fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=self.ckpt_dir)
        try:
            with os.fdopen(fd, "wb") as fh:
                torch.save(state.state_dict(), fh)
            os.replace(tmp, self._path(step))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        if self.max_to_keep:
            for old in self.steps()[:-self.max_to_keep]:
                os.unlink(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> TrainState:
        """Load the checkpoint of ``step`` (default: the latest) into
        ``state``; a directory with no checkpoint leaves it as it is."""
        step = self.latest_step() if step is None else step
        if step is None:
            return state
        dev = next(state.coarse.parameters()).device
        sd = torch.load(self._path(step), map_location=dev, weights_only=True)
        state.load_state_dict(sd)
        return state
