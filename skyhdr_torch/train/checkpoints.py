"""Checkpoints of the train states (`skyhdr.train.checkpoints`), in torch's
own format: the card's machine has no Orbax, so a checkpoint of the port
is not one of the JAX package and the two cannot read each other's.

The on-disk scheme is the JAX package's: one directory per saved epoch,
`<workdir>/checkpoints/{SKY,SUN}/<epoch>/`, at most `max_to_keep` kept (the
oldest go), the newest restored on start. A directory holds `state.pt`,
`torch.save` of `engine.state_dict(state)`: the modules' parameters and
BatchNorm buffers, the optimizer moments (and Adam's count), the step and
the epoch. A save writes into a temporary directory and renames it into
place, so a crash mid-save leaves no half-written newest epoch.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import List, Optional

import torch

_FILE = "state.pt"


class CheckpointManager:
    """save(step, state), latest_step(), read_latest(), restore_latest(cfg)."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit()
                      and os.path.isfile(os.path.join(self.directory, name, _FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> None:
        from skyhdr_torch.train.engine import state_dict

        tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self.directory)
        try:
            with open(os.path.join(tmp, _FILE), "wb") as f:
                torch.save(state_dict(state), f)
                f.flush()
                os.fsync(f.fileno())
            final = os.path.join(self.directory, str(step))
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        finally:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def read_latest(self) -> Optional[dict]:
        """The newest checkpoint's `state_dict`, read to the host; None if
        there is none."""
        step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, str(step), _FILE)
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore_latest(self, cfg, device="cuda"):
        """The newest checkpoint's state, rebuilt on `device` without
        drawing seeded weights; None if there is none."""
        from skyhdr_torch.train.engine import load_state

        blob = self.read_latest()
        return None if blob is None else load_state(blob, cfg, device)
