"""Epoch loop (`skyhdr.train.loop`): the reference's run() orchestration
(train.py:444-525, train_sun.py:304-380) — per-epoch metric resets, train
and test passes, TensorBoard scalars, a checkpoint every N epochs, and a
resume from the newest checkpoint.

Randomness: `run(rng_seed=...)` starts from `PRNGKey(rng_seed)`
(`utils.jax_random`) and splits it once a batch, `key, sub = split(key)`,
train batches then test batches, handing `sub` to the step: the keys of
`skyhdr`'s loop, so that the steps draw its degradations.
Steps run one per dispatch: `TrainConfig.steps_per_dispatch` must be 1.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch

from skyhdr_torch.data.pipeline import prefetch_to_device
from skyhdr_torch.train.checkpoints import CheckpointManager
from skyhdr_torch.train.metrics import EventWriter, MeanMetrics
from skyhdr_torch.utils import jax_random
from skyhdr_torch.utils.dirs import create_new_dir, timestamp


class TrainLoop:
    """Drives (train_step, eval_step) over (train_ds, test_ds) for epochs.

    `state` is a zero-argument factory of the state. The newest checkpoint
    under `<workdir>/checkpoints/<name>` is restored without calling it (no
    seeded weights are drawn); the factory runs only on a fresh start, and
    `resumed` says which happened. The epoch counter lives in the state and
    is checkpointed with it, so a resume continues at the next epoch.
    `prefetch` batches are decoded and copied to the device ahead of the
    step that takes them."""

    def __init__(self, cfg, name: str, state, train_step, eval_step,
                 train_ds, test_ds, *, workdir: str = ".",
                 log: Callable = print, prefetch: int = 2,
                 epoch_hook: Optional[Callable] = None, device="cuda"):
        if int(cfg.train.steps_per_dispatch) != 1:
            raise NotImplementedError(
                f"TrainConfig.steps_per_dispatch={cfg.train.steps_per_dispatch}: "
                "the port runs one step per dispatch")
        self.cfg = cfg
        self.name = name
        self.train_step = train_step
        self.eval_step = eval_step
        self.train_ds = train_ds
        self.test_ds = test_ds
        self.log = log
        self.prefetch = prefetch
        self.device = torch.device(device)
        # Called as epoch_hook(epoch, eval_outputs, eval_batch) after each
        # epoch with the LAST eval batch.
        self.epoch_hook = epoch_hook

        ckpt_dir = os.path.join(workdir, cfg.train.checkpoint_dir, name)
        self.ckpt = CheckpointManager(ckpt_dir, cfg.train.ckpt_max_to_keep)
        restored = self.ckpt.restore_latest(cfg, self.device)
        self.resumed = restored is not None
        if self.resumed:
            self.state = restored
            self.log(f"Latest {name} checkpoint restored (epoch {self.state.epoch})")
        else:
            self.state = state()

        tb_root = create_new_dir(
            os.path.join(workdir, cfg.train.tensorboard_dir, name), timestamp()
        )
        self.tb_train = EventWriter(os.path.join(tb_root, "train"))
        self.tb_test = EventWriter(os.path.join(tb_root, "val"))
        self.log(f"tensorboard --logdir={tb_root}")

    def run(self, epochs: Optional[int] = None, rng_seed: int = 0):
        epochs = epochs or self.cfg.train.epochs
        key = jax_random.key(rng_seed)
        train_metrics = MeanMetrics()
        test_metrics = MeanMetrics()

        for epoch in range(self.state.epoch + 1, epochs + 1):
            t0 = time.perf_counter()
            train_metrics.reset()
            test_metrics.reset()

            for batch in prefetch_to_device(iter(self.train_ds), self.device, self.prefetch):
                key, sub = jax_random.split(key)
                self.state, metrics = self.train_step(self.state, batch, sub)
                train_metrics.update(metrics)

            last_eval = None
            for batch in prefetch_to_device(iter(self.test_ds), self.device, self.prefetch):
                key, sub = jax_random.split(key)
                metrics, outputs = self.eval_step(self.state, batch, sub)
                test_metrics.update(metrics)
                last_eval = (outputs, batch)

            self.state.epoch = epoch
            if self.epoch_hook is not None and last_eval is not None:
                self.epoch_hook(epoch, *last_eval)
            tr = train_metrics.result()
            te = test_metrics.result()
            self.tb_train.scalars(tr, epoch)
            self.tb_test.scalars(te, epoch)

            if epoch % self.cfg.train.ckpt_every_epochs == 0:
                t_save = time.perf_counter()
                self.ckpt.save(epoch, self.state)
                self.log(f"Saved {self.name} checkpoint for epoch {epoch} "
                         f"in {time.perf_counter() - t_save:.1f}s")

            self.log(f"Epoch {epoch}: train={_fmt(tr)} test={_fmt(te)} "
                     f"elapsed={time.perf_counter() - t0:.1f}s")
        return self.state


def _fmt(metrics):
    return "{" + ", ".join(f"{k}={v:.4g}" for k, v in sorted(metrics.items())
                           if not k.startswith("_")) + "}"
