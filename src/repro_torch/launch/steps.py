"""Step functions and meta-device input stand-ins for every (arch x shape)
cell (port of ``repro.launch.steps``).

For each shape kind the cell runs one step of the port's own program:

  train_4k     -> the trainer's step (``runtime.trainer.build_train_step``):
                  forward + backward (remat recomputes included) + AdamW,
                  over ``microbatches_for`` microbatches
  prefill_32k  -> ``lm.prefill`` of the whole prompt; on a mesh, whose
                  attention refuses a whole-prompt prefill, the serving
                  path's chunks of ``PREFILL_CHUNK`` tokens
                  (``lm.prefill_chunk_scan``, then ``lm.prefill_sample``)
  decode_*     -> ``lm.decode_step``: ONE new token against a cache of
                  seq_len

The stand-ins are tensors on ``torch.device("meta")``: shapes and dtypes,
no storage, in place of the reference's ``ShapeDtypeStruct``s.  On a mesh
(anything with ``axis_names`` and a ``shape`` mapping, e.g. the
production mesh's ``SimpleNamespace``) they are one rank's shards, cut by
``parallel.sharding``'s rules (``params_specs`` without FSDP for serving,
as the port's executor places them; ``train_state_specs`` with
``needs_fsdp`` for training; ``cache_specs``, the slots replicated over
"data" where the batch does not divide it, as the executor does), and the
step runs on a ``parallel.comm.DryMeshAxes``.  ``count_cell`` takes the
place of the reference's ``lower_cell``: torch does not lower, so it runs
the step once on the stand-ins under ``launch.op_cost.OpCounter``.

Optimizer-state dtype policy scales with arch size (bf16 / factored
moments for the 30B..480B archs), by the reference's thresholds.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import op_cost
from repro_torch.models import lm
from repro_torch.optim import optimizers as opt
from repro_torch.parallel import comm
from repro_torch.parallel import sharding
from repro_torch.runtime import trainer as trainer_mod
from repro_torch.tree import tree_map_with_path

META = torch.device("meta")
# the prompt chunk of a prefill cell on a mesh
PREFILL_CHUNK = 2048


def adamw_config_for(cfg: ArchConfig) -> opt.AdamWConfig:
    n = sharding.estimate_params(cfg)
    if n > 100e9:
        # Adafactor regime: factored v, no momentum (arctic-480b)
        return opt.AdamWConfig(moment_dtype="bfloat16", factored=True,
                               momentum=False)
    if n > 15e9:
        return opt.AdamWConfig(moment_dtype="bfloat16")
    return opt.AdamWConfig()


def microbatches_for(cfg: ArchConfig, shape: ShapeConfig, mesh,
                     budget_bytes: float = 3e9) -> int:
    """Gradient-accumulation factor sizing the per-layer activation
    checkpoints (B_local * T * d * 2 bytes * L) to ~3 GB (the reference's
    rule; ``mesh`` None is one device)."""
    dp = 1 if mesh is None else sharding.axis_size(
        mesh, sharding.dp_axes(mesh))
    b_local = max(1, shape.global_batch // dp)
    ckpt = b_local * shape.seq_len * cfg.d_model * 2 * cfg.n_layers
    mb = 1
    while ckpt / mb > budget_bytes and mb < b_local:
        mb *= 2
    return mb


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=_device.dtype(dtype), device=META)


# ------------------------------------------------------------------ specs

def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta stand-ins for every model input of the cell (global shapes)."""
    B, T = shape.global_batch, shape.seq_len
    dt = cfg.act_dtype
    if shape.kind == "train":
        batch = {"labels": _meta((B, T), torch.int32)}
        if cfg.frontend_stub:
            batch["embeds"] = _meta((B, T, cfg.d_model), dt)
        else:
            batch["tokens"] = _meta((B, T), torch.int32)
        return {"batch": batch}
    caches = lm.init_caches(cfg, B, T, device=META)
    if shape.kind == "prefill":
        spec = {"caches": caches}
        if cfg.frontend_stub:
            spec["embeds"] = _meta((B, T, cfg.d_model), dt)
        else:
            spec["tokens"] = _meta((B, T), torch.int32)
        return spec
    # decode: one new token against a cache of seq_len
    return {"caches": caches, "tokens": _meta((B,), torch.int32)}


def _local(tree, specs, sizes):
    """Meta stand-ins of one rank's blocks of ``tree`` under ``specs``."""
    return sharding.map_specs(
        lambda t, s: _meta(sharding.local_shape(t.shape, s, sizes), t.dtype),
        tree, specs)


def _drop_data(specs):
    """Specs with every "data" entry removed (the slots replicated, as the
    executor places a slot count that does not divide the data axis)."""
    def drop(_, s):
        return sharding.P(*[None if a == "data" or (
            isinstance(a, tuple) and "data" in a) else a for a in s])
    return tree_map_with_path(drop, specs)


def check_cell(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """Raise ``ValueError`` (``parallel.sharding.check_model_axis``) where
    the port cannot split the cell's model over the mesh's model axis
    (the trainer's FSDP rule for a train cell)."""
    if mesh is None:
        return
    sizes = sharding.mesh_sizes(mesh)
    train = shape.kind == "train"
    sharding.check_model_axis(
        cfg, sizes.get("model", 1), None if train else shape.seq_len,
        sizes.get("data", 1), train and sharding.needs_fsdp(cfg, mesh))


# ------------------------------------------------------------------ cells

@dataclass
class Cell:
    """One rank's step of a cell: ``fn(*args)`` on the meta stand-ins
    ``args``, inside ``comm.use(axes)`` (``axes`` None: one device).
    ``parts`` names the arguments' parts: ``params``, ``optimizer`` (a
    train cell's moments and counters) or ``caches`` (a serving cell's),
    and ``inputs`` (tokens, embeds, labels)."""
    fn: Callable
    args: tuple
    axes: Optional[comm.DryMeshAxes]
    parts: Dict[str, Any]
    microbatches: int = 1

    def run(self):
        with comm.use(self.axes):
            return self.fn(*self.args)

    def argument_bytes(self) -> Dict[str, int]:
        """This rank's argument bytes by part, and their ``total``."""
        out = {k: op_cost.tree_bytes(v) for k, v in self.parts.items()}
        out["total"] = sum(out.values())
        return out


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh=None,
               record=None) -> Cell:
    """The cell's step on one rank of ``mesh`` (None: one device), its
    collectives reported to ``record(kind, nbytes, axis)``."""
    check_cell(cfg, shape, mesh)
    sizes = None if mesh is None else sharding.mesh_sizes(mesh)
    fsdp = mesh is not None and shape.kind == "train" and \
        sharding.needs_fsdp(cfg, mesh)
    axes = None if mesh is None else comm.DryMeshAxes(
        sizes, record or (lambda kind, nbytes, axis: None), fsdp)
    spec = input_specs(cfg, shape)
    dp = 1 if mesh is None else sharding.axis_size(
        mesh, sharding.dp_axes(mesh))

    if shape.kind == "train":
        tc = trainer_mod.TrainerConfig(
            steps=1000, seq_len=shape.seq_len,
            global_batch=shape.global_batch, adamw=adamw_config_for(cfg),
            microbatches=microbatches_for(cfg, shape, mesh),
            accum_dtype=("bfloat16"
                         if sharding.estimate_params(cfg) > 100e9
                         else "float32"))
        state = trainer_mod.init_state(None, cfg, tc, META)
        batch = spec["batch"]
        plan = None
        if mesh is not None:
            specs = sharding.train_state_specs(cfg, state, fsdp, mesh)
            state = _local(state, specs, sizes)
            batch = _local(batch, sharding.batch_specs(mesh, batch), sizes)
            plan = trainer_mod.MeshPlan(axes, specs["params"],
                                        state["params"])
        step = trainer_mod.build_train_step(cfg, tc, plan)
        parts = {"params": state["params"],
                 "optimizer": [state["opt"], state["step"]],
                 "inputs": batch}
        return Cell(step, (state, batch), axes, parts, tc.microbatches)

    params = lm.init_lm(None, cfg, device=META)
    caches = spec["caches"]
    tok_key = ("embeds" if cfg.frontend_stub and shape.kind == "prefill"
               else "tokens")
    tok = spec[tok_key]
    if mesh is not None:
        params = _local(params, sharding.params_specs(cfg, params, False,
                                                      mesh), sizes)
        c_spec = sharding.cache_specs(cfg, mesh, caches, shape.global_batch)
        t_spec = sharding.batch_specs(mesh, {tok_key: tok})[tok_key]
        if shape.global_batch % dp:
            c_spec, t_spec = _drop_data(c_spec), _drop_data(t_spec)
        caches = _local(caches, c_spec, sizes)
        tok = _local(tok, t_spec, sizes)
    parts = {"params": params, "caches": caches, "inputs": tok}

    if shape.kind == "prefill":
        def prefill_step(params, caches, tok):
            kw = {tok_key: tok}
            if mesh is None:
                return lm.prefill(params, cfg, caches, **kw)
            return _chunked_prefill(params, cfg, caches, tok_key, tok)
        return Cell(prefill_step, (params, caches, tok), axes, parts)

    def serve_step(params, caches, tokens):
        return lm.decode_step(params, cfg, tokens, caches)
    return Cell(serve_step, (params, caches, tok), axes, parts)


def _chunked_prefill(params, cfg, caches, tok_key, tok):
    """The serving path's prefill: the prompt in ``PREFILL_CHUNK``-token
    chunks (``lm.prefill_chunk_scan``), the last one through
    ``lm.prefill_sample`` (its logits and a greedy token)."""
    B, T = tok.shape[:2]
    C = min(PREFILL_CHUNK, T)
    chunks = tok.reshape(B, T // C, C, *tok.shape[2:])
    caches = lm.prefill_chunk_scan(params, cfg, caches,
                                   **{tok_key: chunks[:, :-1]})
    return lm.prefill_sample(
        params, cfg, caches, None,
        lambda s, logits: (torch.argmax(logits, dim=-1), s),
        **{tok_key: chunks[:, -1]})


def count_cell(cfg: ArchConfig, shape: ShapeConfig, mesh=None) -> dict:
    """Run the cell's step once on meta stand-ins under
    ``op_cost.OpCounter``; returns this rank's ``flops``, ``bytes``
    (unfused: an upper bound), ``collectives`` (bytes by kind and
    ``total``), ``argument_bytes`` (its shards of params, optimizer
    moments and caches by part: exact), ``peak_bytes`` (the live-bytes
    peak of the run, arguments included), ``ops``, ``microbatches`` and
    ``seconds``.  ``collectives_by_axis`` holds the bytes by mesh axis."""
    counter = op_cost.OpCounter()
    cell = build_cell(cfg, shape, mesh, counter.record)
    arg_bytes = cell.argument_bytes()
    counter.start(cell.args)
    t0 = time.perf_counter()
    grad = torch.enable_grad() if shape.kind == "train" else torch.no_grad()
    with grad, counter:
        cell.run()
    return {"flops": counter.flops, "bytes": counter.bytes,
            "collectives": counter.collective_bytes(),
            "collectives_by_axis": dict(counter.by_axis),
            "collective_calls": counter.collective_calls,
            "argument_bytes": arg_bytes, "peak_bytes": counter.peak_bytes,
            "ops": counter.ops, "microbatches": cell.microbatches,
            "seconds": time.perf_counter() - t0}
