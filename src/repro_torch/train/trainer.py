"""The training loop on one device.

``make_train_step`` builds one step:

    batch (global_batch, seq) --split--> n_micro microbatches
      --autograd per microbatch--> f32 gradient accumulation (each layer
        recomputed in the backward pass when ``cfg.remat == "block"``)
      --optimizer.update--> new params / state

The gradients come from ``torch.autograd`` over the model's plain-torch
training forward (``Model.loss``), the counterpart of the reference's
``jax.value_and_grad``; no hand-written kernel runs on this path.

The Trainer drives steps, checkpoints asynchronously every ``ckpt_every``,
detects stragglers, and recovers from (simulated) failures by restoring the
latest committed checkpoint — the restart path is identical to a real
preemption: rebuild state from disk, fast-forward the data pipeline cursor.

Counterpart of the JAX package's ``train/trainer.py``.  One card has no
mesh: ``pick_microbatches`` takes a data-parallel extent of 1, and there
is no ``pod_compress`` option, since the int8 cross-pod merge of
``optim/compress.py`` needs a ``pod`` axis.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from ..ckpt import CheckpointManager, load_checkpoint
from ..models.common import sampled
from ..models.model import Model
from ..optim import OptConfig, Optimizer, tree_leaves, tree_map
from .fault import SimulatedFailure, StragglerWatchdog


@dataclass(frozen=True)
class TrainConfig:
    n_micro: int = 1                 # gradient-accumulation microbatches
    ckpt_every: int = 50
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    straggler_factor: float = 3.0


def pick_microbatches(model: Model, global_batch: int, seq_len: int,
                      budget_bytes: float = 4e9) -> int:
    """Choose n_micro so the stored layer inputs (per-layer remat) fit the
    budget; the data-parallel extent is 1 on one card."""
    cfg = model.cfg
    dp = 1
    per_layer = seq_len * cfg.d_model * 2  # bf16 layer input per sample
    stored = cfg.n_layers * per_layer * (global_batch / dp)
    n_micro = 1
    while stored / n_micro > budget_bytes and n_micro < global_batch:
        n_micro *= 2
    n_micro = min(n_micro, max(global_batch // dp, 1))
    while global_batch % n_micro:
        n_micro //= 2
    return max(1, n_micro)


def _value_and_grad(model: Model, params, batch):
    """(loss, f32 gradients in ``params``' structure) by autograd."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        live = {id(t): t.detach().requires_grad_(True) for t in leaves}
        p = tree_map(lambda t: live[id(t)], params)
        loss = model.loss(p, batch)
        grads = torch.autograd.grad(loss, [live[id(t)] for t in leaves])
    by_id = {id(t): g.float() for t, g in zip(leaves, grads)}
    return loss.detach(), tree_map(lambda t: by_id[id(t)], params)


def make_train_step(model: Model, opt: Optimizer, *,
                    n_micro: int = 1) -> Callable:
    """Returns step(state, batch) -> (state, metrics)."""

    def grads_of(params, batch):
        if n_micro == 1:
            return _value_and_grad(model, params, batch)
        micro = {k: x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
                 for k, x in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        gsum = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                              device=t.device), params)
        for i in sampled(range(n_micro), model.device, own_graph=True):
            loss, grads = _value_and_grad(
                model, params, {k: x[i] for k, x in micro.items()})
            loss_sum = loss_sum + loss
            gsum = tree_map(lambda a, g: a + g, gsum, grads)
        inv = 1.0 / n_micro
        return loss_sum * inv, tree_map(lambda g: g * inv, gsum)

    def step(state, batch):
        loss, grads = grads_of(state["params"], batch)
        new_params, new_opt, metrics = opt.update(
            grads, state["opt"], state["params"])
        metrics["loss"] = loss
        return {"params": new_params, "opt": new_opt}, metrics

    return step


class Trainer:
    """Synchronous training driver with checkpoint/restart + watchdog."""

    def __init__(self, model: Model, opt_cfg: OptConfig,
                 tcfg: TrainConfig, dataset):
        self.model = model
        self.opt = Optimizer(opt_cfg)
        self.tcfg = tcfg
        self.dataset = dataset
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        self.watchdog = StragglerWatchdog(factor=tcfg.straggler_factor)
        self.step_fn = make_train_step(model, self.opt, n_micro=tcfg.n_micro)
        self.state: Optional[Dict[str, Any]] = None
        self.step = 0
        self.history: list = []

    def init_state(self, seed: int = 0):
        params = self.model.init(seed)
        self.state = {"params": params, "opt": self.opt.init(params)}
        self.step = 0
        return self.state

    def restore(self) -> bool:
        """Restore the latest checkpoint; returns True if one was found."""
        if self.ckpt.latest() is None:
            return False
        params_abs = self.model.abstract_params()
        state_abs = {"params": params_abs, "opt": self.opt.init(params_abs)}
        loaded, step, _extra = load_checkpoint(
            self.tcfg.ckpt_dir, state_abs, device=self.model.device)
        self.state = loaded
        self.step = step
        return True

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The dataset's batch on the model's device: integer arrays
        (tokens, labels) as int64, float arrays (an encoder-decoder's
        ``frames``) in the model's dtype."""
        return {k: torch.from_numpy(v).to(
                    self.model.device, dtype=torch.int64
                    if v.dtype.kind in "iu" else self.model.dtype)
                for k, v in self.dataset.batch_at(step).items()}

    def run(self, n_steps: int, *, fail_at: Optional[int] = None):
        """Train; optionally inject a failure at ``fail_at`` (fault drill)."""
        assert self.state is not None
        losses = []
        while self.step < n_steps:
            if fail_at is not None and self.step == fail_at:
                fail_at = None  # fire once
                raise SimulatedFailure(self.step)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state,
                                               self._batch(self.step))
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.watchdog.record(self.step, dt)
            losses.append(loss)
            self.history.append({"step": self.step, "loss": loss, "dt": dt})
            self.step += 1
            if self.step % self.tcfg.ckpt_every == 0:
                self.ckpt.save_async(self.step, self.state,
                                     extra={"data_step": self.step})
        self.ckpt.save_async(self.step, self.state,
                             extra={"data_step": self.step})
        self.ckpt.wait()
        return losses

    def run_with_recovery(self, n_steps: int, fail_at: Optional[int] = None):
        """The fault drill: crash at fail_at, restore, resume, finish.

        The save still in flight when the failure fires is let land first
        (its commit is atomic either way), so the drill always restores the
        newest checkpoint; the reference looks for it while the write may
        still run, and restores the one before when it loses that race."""
        try:
            return self.run(n_steps, fail_at=fail_at), False
        except SimulatedFailure:
            self.ckpt.wait()
            self.state = None
            if not self.restore():
                self.init_state(0)
            return self.run(n_steps), True
