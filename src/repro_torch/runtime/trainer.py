"""Fault-tolerant training runtime, on one device or a mesh (port of
``repro.runtime.trainer``).

Behaviours carried over from the reference:
  * a train step with the parameters and optimizer moments updated in
    place (the port's form of the reference's donated state), compiled:
    the step reads its batch from static device buffers and computes the
    learning rate and AdamW's bias corrections on the device, so on the
    card it is captured once into a CUDA graph (forward with remat,
    backward, clipping and AdamW, a mesh's collectives on NCCL included)
    and replayed (``runtime.graphs.Program``: the first call runs
    eagerly, the second captures).  ``cuda_graphs=False`` runs the same
    step eagerly on the card, the comparison; a gloo mesh runs eagerly
    (its collectives are host calls); a capture or a replay that fails
    raises, and is never retried as an eager step;
  * a ``("data", "model")`` mesh (``Trainer(mesh=)``; without one, the
    elastic data mesh over every rank of the running process group,
    ``make_data_mesh``, or one device when none runs): one process per
    mesh device.  The parameters and AdamW moments are sharded by the
    reference's rules (``parallel.sharding.train_state_specs``) with FSDP
    whenever ``needs_fsdp`` holds: each rank draws only its shards, each
    F-sharded leaf is gathered over "data" for the step, the gradients
    are averaged over "data" (an all-reduce per dtype; an F-sharded
    leaf's by a reduce-scatter, which leaves each rank only its block),
    and AdamW runs on the shards
    (its global norm and factored moments reduce over the split axes).
    Each rank reads the global batch and keeps its rows
    (``batch_specs``; with microbatches the reference's resplit: rank r
    of D holds block r of every microbatch).  The model axis trains every
    mixer kind, the dense FFN and the MoE's experts (``models.lm``) on
    the placements the specs give, the moves of ``fit_spec`` included
    (the vocabulary onto d_model or replicated, the experts onto d_ff,
    query heads onto head_dim), where the model code follows them
    (``parallel.sharding.check_model_axis``);
  * checkpoint/restart: atomic async checkpoints every ``ckpt_every``;
    ``run()`` auto-resumes from the latest complete checkpoint, and an
    exception inside the step loop triggers restore-and-continue with
    bounded retries (``max_restarts``; ``fail_at`` injects one fault).
    Checkpoints hold whole leaves whatever the mesh (a mesh's saves
    gather, and block): the elastic re-mesh is a restart on another
    mesh, each rank cutting its shards from the restored leaves;
  * straggler detection: a per-step wall-time EWMA and deviation; slow
    steps are logged with a z-score;
  * deterministic data: the loader is keyed by (seed, host, step), so a
    resume replays the exact batch stream;
  * microbatch gradient accumulation in ``accum_dtype``.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, HostDataLoader
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.optim import optimizers as opt
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as rules
from repro_torch.runtime import graphs
from repro_torch.tree import leaves, tree_map

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


def make_data_mesh():
    """Elastic data mesh over every rank of the running process group:
    (data = world size, model = 1)."""
    return mesh_mod.make_local_mesh(dist.get_world_size(), 1)


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


def init_mesh_state(generator, cfg: ArchConfig, tc: TrainerConfig,
                    device, mesh, fsdp: bool):
    """This rank's shards of ``init_state``'s tree on ``mesh`` (the
    parameters those of the one-device draw, cut as it is drawn) and the
    tree's specs.  The moments are laid out from the whole parameters'
    shapes (a factored moment stays factored where a shard's dim is 1)."""
    dev = _device.resolve(device)
    full = init_state(None, cfg, tc, "meta")
    specs = rules.train_state_specs(cfg, full, fsdp, mesh)
    axes = comm.MeshAxes(mesh)
    mu = rules.map_specs(
        lambda m, s: torch.zeros(rules.local_shape(m.shape, s, axes.sizes),
                                 dtype=m.dtype, device=dev),
        full["opt"]["mu"], specs["opt"]["mu"])
    state = {"params": lm.init_lm(generator, cfg, dev, mesh=mesh, fsdp=fsdp),
             "opt": {"mu": mu,
                     "count": torch.zeros((), dtype=torch.int32,
                                          device=dev)},
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    return state, specs, full


class MeshPlan:
    """How the step treats each parameter leaf of a rank on a mesh: the
    dims it is split on over "data" (FSDP: gathered for the step, the
    gradient reduce-scattered back) and the axes of every dim (the optimizer's
    ``split``)."""

    def __init__(self, axes: comm.MeshAxes, pspecs, params):
        self.axes = axes
        self.data_dims, self.split = [], []
        for spec, p in zip(leaves(pspecs), leaves(params)):
            names = rules.dim_axes(spec, p.dim())
            self.split.append(tuple(tuple(axes.axes[n] for n in ns)
                                    for ns in names))
            self.data_dims.append(tuple(d for d, ns in enumerate(names)
                                        if "data" in ns))

    def gather(self, i: int, p: torch.Tensor) -> torch.Tensor:
        """Leaf ``i`` whole over "data" (itself when not split on it)."""
        for d in self.data_dims[i]:
            p = self.axes.data.all_gather(p, d)
        return p


def build_train_step(cfg: ArchConfig, tc: TrainerConfig, plan=None):
    """``train_step(state, batch) -> (state, metrics)``: loss and
    gradients (summed over ``tc.microbatches`` slices of the batch in
    ``tc.accum_dtype``), one AdamW step at the schedule's lr for
    ``state["step"]``, all written into ``state`` in place.  ``batch``
    holds (B, T) int tensors on the state's device.  Nothing is read on
    the host: ``metrics`` ("loss", "lr", "grad_norm", ...) are 0-d
    tensors on the device.

    ``plan`` (a ``MeshPlan``): ``state`` holds this rank's shards and
    ``batch`` its rows; the step runs with the mesh active, gathers the
    F-sharded leaves over "data", averages the gradients and the metrics
    over "data" (and over "pod", where the plan's mesh has one: the
    production mesh the dry run counts, ``launch.steps``) and steps AdamW
    on the shards."""
    schedule = make_schedule(tc)

    def loss_and_grads(plist, params, batch):
        loss, metrics = lm.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, plist, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, plist)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(state, batch):
        if plan is None:
            return local_step(state, state["params"], leaves(state["params"]),
                              batch)
        with comm.use(plan.axes):
            local = leaves(state["params"])
            with torch.no_grad():
                plist = [plan.gather(i, p) for i, p in enumerate(local)]
            whole = {id(p): w for p, w in zip(local, plist)}
            return local_step(state, tree_map(lambda p: whole[id(p)],
                                              state["params"]), plist,
                              batch)

    def local_step(state, params, plist, batch):
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
        split = None
        if plan is not None:
            data = plan.axes.data
            grads = data.mean_flat(grads, plan.data_dims)
            names = sorted(metrics)
            avg = data.all_reduce(torch.stack(
                [loss.float()] + [metrics[k].float() for k in names]),
                mean=True)
            pod = plan.axes.axes.get("pod")
            if pod is not None:
                # the production mesh's pods: data parallel over them too
                grads = pod.mean_flat(grads)
                avg = pod.all_reduce(avg, mean=True)
            avg = avg.unbind(0)
            loss, metrics = avg[0], dict(zip(names, avg[1:]))
            params, split = state["params"], plan.split
        lr = schedule(state["step"])
        _, _, gnorm = opt.adamw_update(grads, state["opt"], params, lr,
                                       tc.adamw, split)
        state["step"].add_(1)
        return state, dict(metrics, loss=loss, lr=lr, grad_norm=gnorm)

    return train_step


class GraphStepError(RuntimeError):
    """A training step's CUDA graph failed to capture or to replay."""


class Trainer:
    def __init__(self, cfg: ArchConfig, tc: TrainerConfig, mesh=None,
                 device=None, cuda_graphs: Optional[bool] = None):
        """``mesh``: a ``("data", "model")`` ``DeviceMesh`` holding this
        rank (``launch.mesh.make_local_mesh``); None trains on
        ``make_data_mesh()`` when a process group runs, else on one
        device.  ``cuda_graphs`` (default None: on the card, not on the
        CPU nor on a gloo mesh) replays the compiled step from a CUDA
        graph; ``False`` runs it eagerly; ``True`` on the CPU or on a gloo
        mesh raises."""
        self.cfg, self.tc = cfg, tc
        self.device = _device.resolve(device)
        on_card = self.device.type == "cuda"
        if cuda_graphs and not on_card:
            raise ValueError(f"cuda_graphs=True needs a CUDA device; the "
                             f"trainer runs on {self.device}")
        if mesh is None and dist.is_initialized():
            mesh = make_data_mesh()
        self.mesh = mesh
        self.axes = self.fsdp = self.plan = self.specs = None
        self._rows = None
        if mesh is not None:
            self._init_mesh(cuda_graphs)
            if self.axes.data.backend == "gloo":
                on_card = False
        self.cuda_graphs = on_card if cuda_graphs is None else cuda_graphs
        self.loader = HostDataLoader(DataConfig(
            vocab=cfg.vocab, seq_len=tc.seq_len,
            global_batch=tc.global_batch, seed=tc.seed))
        self.ckpt = (ckpt.CheckpointManager(tc.ckpt_dir)
                     if tc.ckpt_dir else None)
        self._step_fn = None
        self.program: Optional[graphs.Program] = None
        self.state = None
        self._full = None
        self._batch = None
        self.step_times: list[float] = []
        # {"step", "loss", "aux", "lr", "grad_norm"} at every logged step
        # (aux: the summed MoE load-balancing loss, 0 without MoE)
        self.logged: list[dict] = []
        self._ewma = None
        self._ewvar = 0.0
        self.restarts = 0

    def _init_mesh(self, cuda_graphs):
        """This rank's axes, FSDP by the reference's rule, and its rows of
        every global batch."""
        mesh = self.mesh
        sizes = rules.mesh_sizes(mesh)
        if tuple(sizes) != ("data", "model"):
            raise ValueError(f"a training mesh has axes ('data', 'model'), "
                             f"got {tuple(sizes)} "
                             f"(launch.mesh.make_local_mesh)")
        self.fsdp = rules.needs_fsdp(self.cfg, mesh)
        rules.check_model_axis(self.cfg, sizes["model"], None,
                               sizes["data"], self.fsdp)
        axes = self.axes = comm.MeshAxes(mesh, fsdp=self.fsdp)
        backends = {a.backend for a in axes.axes.values()}
        if "gloo" in backends and cuda_graphs:
            raise ValueError("a gloo mesh's collectives are host calls, "
                             "which a CUDA graph cannot capture: pass "
                             "cuda_graphs=False or use an NCCL mesh")
        if "nccl" in backends and self.device.type != "cuda":
            raise ValueError(f"an NCCL mesh trains on CUDA, not "
                             f"{self.device}")
        B, mb, D = self.tc.global_batch, self.tc.microbatches, \
            axes.data.size
        if B % (mb * D):
            raise ValueError(f"global batch {B} does not split into {mb} "
                             f"microbatches over a data axis of {D}")
        # block r of every microbatch (the reference's resplit keeps each
        # microbatch's rows on "data")
        per = B // (mb * D)
        self._rows = np.array([i * (B // mb) + axes.data.index * per + j
                               for i in range(mb) for j in range(per)])

    def compile(self, keep_graph: bool = False):
        """Draw the initial state on the device from ``tc.seed`` (on a
        mesh, this rank's shards), allocate the static batch buffers and
        wrap the step function in the program that runs it on them (the
        reference's ``jax.jit`` of the step).  ``keep_graph`` keeps the
        captured graph's template so that its nodes can be counted and its
        instantiation timed (``graphs.Program``)."""
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        rows = self.tc.global_batch
        if self.mesh is None:
            self.state = init_state(gen, self.cfg, self.tc, self.device)
        else:
            self.state, self.specs, self._full = init_mesh_state(
                gen, self.cfg, self.tc, self.device, self.mesh, self.fsdp)
            self.plan = MeshPlan(self.axes, self.specs["params"],
                                 self.state["params"])
            rows = len(self._rows)
        self._step_fn = build_train_step(self.cfg, self.tc, self.plan)
        shape = (rows, self.tc.seq_len)
        self._batch = {k: torch.zeros(shape, dtype=torch.int64,
                                      device=self.device)
                       for k in ("tokens", "labels")}
        pool = torch.cuda.graph_pool_handle() if self.cuda_graphs else None
        # bound to the state and the buffers, not to self: a dropped
        # trainer's graph is then freed without the collector
        self.program = graphs.Program(
            lambda f=self._step_fn, s=self.state, b=self._batch: f(s, b)[1],
            pool, keep_graph)
        return self

    def batch(self, step: int) -> dict:
        """The loader's batch for ``step`` copied into the static batch
        buffers (the same int64 device tensors every step); on a mesh,
        this rank's rows of it."""
        for k, v in self.loader.batch_at(step).items():
            if self._rows is not None:
                v = v[self._rows]
            self._batch[k].copy_(torch.from_numpy(v))
        return self._batch

    def step(self) -> dict:
        """One training step on the batch buffers, synced; returns its
        metrics (0-d device tensors, overwritten by the next step).  Raises
        ``GraphStepError`` where the call captured or replayed the graph
        and failed."""
        graphed = self.program.pool is not None and self.program.calls > 0
        try:
            metrics = self.program()
            self._sync()
        except Exception as e:
            if graphed:
                raise GraphStepError(f"the training step's CUDA graph "
                                     f"failed: {e}") from e
            raise
        return metrics

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
        """Restore the latest checkpoint into the state, if there is one;
        on a mesh each rank reads the whole leaves and keeps its shards
        (the elastic re-mesh).  Returns its step (0 without one)."""
        if self.ckpt is None:
            return 0
        if self.mesh is None:
            restored, step = self.ckpt.restore_latest(self.state)
        else:
            restored, step = self.ckpt.restore_latest(self._full)
            if restored is not None:
                restored = rules.shard_tree(restored, self.specs,
                                            self.axes.coords,
                                            self.axes.sizes)
        if restored is None:
            return 0
        ckpt.copy_into(self.state, restored)
        log.info("restored checkpoint at step %s (mesh %s)", step,
                 None if self.axes is None else self.axes.sizes)
        return int(step)

    def save(self, step: int, blocking: bool = True):
        """Checkpoint the state as step ``step``: whole leaves on a mesh,
        every rank taking part (and waiting for the write)."""
        if self.mesh is None:
            self.ckpt.save(self.state, step, blocking=blocking)
        else:
            self.ckpt.save(self.state, step, specs=self.specs,
                           axes=self.axes)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, fail_at: Optional[int] = None):
        """Train to tc.steps with restore-on-failure. `fail_at` injects a
        fault once (for tests / chaos drills).  Returns [(step, loss)] at
        every ``log_every`` steps and the last."""
        if self.program is None:
            self.compile()
        step = self._maybe_restore()
        injected = False
        history = []
        while step < self.tc.steps:
            try:
                self.batch(step)
                if fail_at is not None and step == fail_at and not injected:
                    injected = True
                    raise RuntimeError("injected node failure")
                t0 = time.perf_counter()
                metrics = self.step()
                self._record_step_time(time.perf_counter() - t0, step)
                step += 1
                if step % self.tc.log_every == 0 or step == self.tc.steps:
                    rec = {k: float(metrics[k])
                           for k in ("loss", "aux", "lr", "grad_norm")}
                    self.logged.append(dict(rec, step=step))
                    history.append((step, rec["loss"]))
                    log.info("step %d loss %.4f lr %.2e", step, rec["loss"],
                             rec["lr"])
                if self.ckpt and step % self.tc.ckpt_every == 0:
                    self.save(step, blocking=not self.tc.ckpt_async)
            except GraphStepError:
                raise
            except Exception as e:  # noqa: BLE001 — node-failure recovery
                self.restarts += 1
                if self.restarts > self.tc.max_restarts:
                    raise
                log.warning("step %d failed (%s); restoring from latest "
                            "checkpoint (restart %d/%d)", step, e,
                            self.restarts, self.tc.max_restarts)
                step = self._maybe_restore()
        if self.ckpt:
            self.save(step)
        return history
