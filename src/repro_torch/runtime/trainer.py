"""Fault-tolerant training runtime on one device (port of
``repro.runtime.trainer``).

Behaviours carried over from the reference:
  * a train step with the parameters and optimizer moments updated in
    place (the port's form of the reference's donated state);
  * checkpoint/restart: atomic async checkpoints every ``ckpt_every``;
    ``run()`` auto-resumes from the latest complete checkpoint, and an
    exception inside the step loop triggers restore-and-continue with
    bounded retries (``max_restarts``; ``fail_at`` injects one fault);
  * straggler detection: a per-step wall-time EWMA and deviation; slow
    steps are logged with a z-score;
  * deterministic data: the loader is keyed by (seed, host, step), so a
    resume replays the exact batch stream;
  * microbatch gradient accumulation in ``accum_dtype``.

The port runs on one device: there is no mesh and no sharding (the
reference's ``parallel/sharding.py`` is not ported yet; ROADMAP).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, HostDataLoader
from repro_torch.models import lm
from repro_torch.optim import optimizers as opt
from repro_torch.tree import leaves

log = logging.getLogger("repro_torch.trainer")


@dataclass
class TrainerConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    microbatches: int = 1
    peak_lr: float = 3e-4
    warmup_steps: int = 10
    schedule: str = "cosine"            # cosine | wsd
    adamw: opt.AdamWConfig = field(default_factory=opt.AdamWConfig)
    accum_dtype: str = "float32"        # bf16 for the ~0.5T archs
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_async: bool = True
    log_every: int = 10
    seed: int = 0
    max_restarts: int = 3
    straggler_ewma: float = 0.9
    straggler_zscore: float = 3.0


def make_schedule(tc: TrainerConfig) -> Callable:
    if tc.schedule == "wsd":
        stable = max(1, int(0.8 * tc.steps) - tc.warmup_steps)
        decay = max(1, tc.steps - tc.warmup_steps - stable)
        return opt.wsd_schedule(tc.peak_lr, tc.warmup_steps, stable, decay)
    return opt.cosine_schedule(tc.peak_lr, tc.warmup_steps, tc.steps)


def init_state(generator, cfg: ArchConfig, tc: TrainerConfig, device=None):
    """{"params", "opt": {"mu", "count"}, "step"} — the reference's tree.
    ``generator``: a ``torch.Generator`` on the device, or an int seed."""
    dev = _device.resolve(device)
    params = lm.init_lm(generator, cfg, dev)
    return {"params": params,
            "opt": opt.init_adamw(params, tc.adamw),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def build_train_step(cfg: ArchConfig, tc: TrainerConfig):
    """``train_step(state, batch) -> (state, metrics)``: loss and
    gradients (summed over ``tc.microbatches`` slices of the batch in
    ``tc.accum_dtype``), one AdamW step at the schedule's lr for
    ``state["step"]``, all written into ``state`` in place.  ``batch``
    holds (B, T) int tensors on the state's device."""
    schedule = make_schedule(tc)

    def loss_and_grads(plist, params, batch):
        loss, metrics = lm.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, plist, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, plist)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(state, batch):
        params = state["params"]
        plist = leaves(params)
        for p in plist:
            p.requires_grad_(True)
        n = tc.microbatches
        if n > 1:
            adt = _device.dtype(tc.accum_dtype)
            gsum = [torch.zeros(p.shape, dtype=adt, device=p.device)
                    for p in plist]
            lsum, msum = torch.zeros((), device=plist[0].device), {}
            for i in range(n):
                mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                      for k, v in batch.items()}
                l, m, g = loss_and_grads(plist, params, mb)
                lsum = lsum + l.float()
                for acc, gi in zip(gsum, g):
                    acc.add_(gi.to(adt))
                for k, v in m.items():
                    msum[k] = msum.get(k, 0) + v
            loss = lsum / n
            grads = [g / n for g in gsum]
            metrics = {k: v / n for k, v in msum.items()}
        else:
            loss, metrics, grads = loss_and_grads(plist, params, batch)
        lr = schedule(int(state["step"]))
        _, _, gnorm = opt.adamw_update(grads, state["opt"], params, lr,
                                       tc.adamw)
        state["step"].add_(1)
        return state, dict(metrics, loss=loss, lr=lr, grad_norm=gnorm)

    return train_step


class Trainer:
    def __init__(self, cfg: ArchConfig, tc: TrainerConfig, mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "the port trains on one device; meshes and sharding are not "
                "ported yet: the reference's parallel/sharding.py (ROADMAP)")
        self.cfg, self.tc = cfg, tc
        self.device = _device.resolve(device)
        self.loader = HostDataLoader(DataConfig(
            vocab=cfg.vocab, seq_len=tc.seq_len,
            global_batch=tc.global_batch, seed=tc.seed))
        self.ckpt = (ckpt.CheckpointManager(tc.ckpt_dir)
                     if tc.ckpt_dir else None)
        self._step_fn = None
        self.state = None
        self.step_times: list[float] = []
        self._ewma = None
        self._ewvar = 0.0
        self.restarts = 0

    def compile(self):
        """Draw the initial state on the device from ``tc.seed`` and build
        the step function."""
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        self.state = init_state(gen, self.cfg, self.tc, self.device)
        self._step_fn = build_train_step(self.cfg, self.tc)
        return self

    def batch(self, step: int) -> dict:
        """The loader's batch for ``step`` as int64 tensors on the device."""
        return {k: torch.from_numpy(v).to(self.device, torch.int64)
                for k, v in self.loader.batch_at(step).items()}

    # ------------------------------------------------------------------
    def _record_step_time(self, dt: float, step: int):
        self.step_times.append(dt)
        if self._ewma is None:
            self._ewma = dt
            return
        a = self.tc.straggler_ewma
        dev = dt - self._ewma
        self._ewvar = a * self._ewvar + (1 - a) * dev * dev
        self._ewma = a * self._ewma + (1 - a) * dt
        z = dev / max(np.sqrt(self._ewvar), 1e-9)
        if z > self.tc.straggler_zscore and len(self.step_times) > 5:
            log.warning("straggler suspected at step %d: %.3fs (z=%.1f, "
                        "ewma %.3fs) — flagged for hot-spare rotation",
                        step, dt, z, self._ewma)

    def _maybe_restore(self):
        if self.ckpt is None:
            return 0
        restored, step = self.ckpt.restore_latest(self.state)
        if restored is None:
            return 0
        ckpt.copy_into(self.state, restored)
        log.info("restored checkpoint at step %s", step)
        return int(step)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, fail_at: Optional[int] = None):
        """Train to tc.steps with restore-on-failure. `fail_at` injects a
        fault once (for tests / chaos drills).  Returns [(step, loss)] at
        every ``log_every`` steps and the last."""
        if self._step_fn is None:
            self.compile()
        step = self._maybe_restore()
        injected = False
        history = []
        while step < self.tc.steps:
            try:
                batch = self.batch(step)
                if fail_at is not None and step == fail_at and not injected:
                    injected = True
                    raise RuntimeError("injected node failure")
                t0 = time.perf_counter()
                self.state, metrics = self._step_fn(self.state, batch)
                self._sync()
                self._record_step_time(time.perf_counter() - t0, step)
                step += 1
                if step % self.tc.log_every == 0 or step == self.tc.steps:
                    history.append((step, float(metrics["loss"])))
                    log.info("step %d loss %.4f lr %.2e", step,
                             float(metrics["loss"]), metrics["lr"])
                if self.ckpt and step % self.tc.ckpt_every == 0:
                    self.ckpt.save(self.state, step,
                                   blocking=not self.tc.ckpt_async)
            except Exception as e:  # noqa: BLE001 — node-failure recovery
                self.restarts += 1
                if self.restarts > self.tc.max_restarts:
                    raise
                log.warning("step %d failed (%s); restoring from latest "
                            "checkpoint (restart %d/%d)", step, e,
                            self.restarts, self.tc.max_restarts)
                step = self._maybe_restore()
        if self.ckpt:
            self.ckpt.save(self.state, step, blocking=True)
        return history
