"""Optimizers and schedules (port of ``repro.optim.optimizers``).

AdamW with
  * configurable moment dtypes — bf16 first/second moments with an
    error-feedback residual buffer ``ef`` (keeps what the bf16 rounding of
    ``m`` lost);
  * an optional Adafactor-style factored second moment (``v_row``/``v_col``
    over the last two dims);
  * ``momentum=False``: the momentum-free Adafactor regime;
  * global-norm clipping.

Schedules: WSD (warmup-stable-decay) and cosine, as functions of the step:
a Python int (the learning rate as a float) or a 0-d int tensor (a 0-d
fp32 tensor on its device, computed there with the reference's branches,
so a training step never reads its step on the host).  The optimizer
state mirrors the reference's tree,
``{"mu": per-parameter dicts, "count": int32 scalar}``, so it bridges and
checkpoints one to one.  The moment arithmetic is fp32, as in the
reference; ``adamw_update`` writes the new parameters and moments into
their tensors in place (the port's form of the reference's donated state).

On a mesh (``split``: per leaf, the mesh axes each dim of its shard is cut
along) every leaf is a rank's shard: the global norm sums each shard's
squares and all-reduces them over exactly the axes the leaf is split on
(a leaf replicated over an axis counts once), and the factored second
moment's row and column means all-reduce over the axes of the dim they
reduce (what GSPMD inserts for the reference).  With every axis of size
1 the arithmetic is the one-device path's, bit for bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.tree import leaves, tree_map


# ----------------------------------------------------------------- schedules

def _f32(x) -> float:
    return float(np.float32(x))


def _warm(peak_lr, warmup_steps, s):
    return peak_lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)


def wsd_schedule(peak_lr, warmup_steps, stable_steps, decay_steps,
                 final_frac=0.1):
    """MiniCPM's warmup-stable-decay schedule."""
    def lr(step):
        if isinstance(step, torch.Tensor):
            s = step.float()
            in_decay = torch.clamp((s - warmup_steps - stable_steps)
                                   / max(decay_steps, 1), 0.0, 1.0)
            decay = peak_lr * (1.0 - (1.0 - final_frac) * in_decay)
            return torch.where(s < warmup_steps,
                               _warm(peak_lr, warmup_steps, s), decay)
        step = float(step)
        if step < warmup_steps:
            return _f32(peak_lr * min(1.0, step / max(warmup_steps, 1)))
        in_decay = min(max((step - warmup_steps - stable_steps)
                           / max(decay_steps, 1), 0.0), 1.0)
        return _f32(peak_lr * (1.0 - (1.0 - final_frac) * in_decay))
    return lr


def cosine_schedule(peak_lr, warmup_steps, total_steps, final_frac=0.1):
    def lr(step):
        if isinstance(step, torch.Tensor):
            s = step.float()
            t = torch.clamp((s - warmup_steps)
                            / max(total_steps - warmup_steps, 1), 0.0, 1.0)
            cos = final_frac + (1 - final_frac) * 0.5 * (
                1 + torch.cos(math.pi * t))
            return torch.where(s < warmup_steps,
                               _warm(peak_lr, warmup_steps, s),
                               peak_lr * cos)
        step = float(step)
        if step < warmup_steps:
            return _f32(peak_lr * min(1.0, step / max(warmup_steps, 1)))
        t = min(max((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi
                                                                  * t))
        return _f32(peak_lr * cos)
    return lr


# ----------------------------------------------------------------- clipping

def global_norm(tree, split=None):
    """fp32 L2 norm over every leaf, as a 0-d tensor.  ``split`` (a mesh):
    per leaf in ``leaves`` order, a tuple per dim of the ``comm.Axis``es
    the leaf's shard is cut along; each leaf's sum of squares is then
    all-reduced over its axes, one collective per axis, and the leaves'
    sums are added in the one-device order."""
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    if split is not None:
        order = {}
        for dims in split:
            for ax in (a for d in dims for a in d):
                order.setdefault(ax.name, ax)
        for ax in order.values():
            idx = [i for i, dims in enumerate(split)
                   if any(a.name == ax.name for d in dims for a in d)]
            red = ax.all_reduce(torch.stack([sq[i] for i in idx]))
            for j, i in enumerate(idx):
                sq[i] = red[j]
    return torch.sqrt(sum(sq))


def _mean(x, dim, axes=()):
    """The mean over ``dim`` of a tensor whose ``dim`` is cut along
    ``axes`` (equal blocks: the mean of the ranks' means)."""
    m = torch.mean(x, dim=dim)
    for ax in axes:
        m = ax.all_reduce(m, mean=True)
    return m


def _clip_scale(norm, max_norm):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    """(grads scaled to a global norm <= max_norm in their own dtypes,
    the norm before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# ----------------------------------------------------------------- AdamW

class AdamWConfig(NamedTuple):
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"      # "bfloat16" halves optimizer memory
    factored: bool = False             # Adafactor-style v for huge archs
    momentum: bool = True              # False => Adafactor regime (no m/ef)
    error_feedback: bool = True        # residual buffer for bf16 moments
    clip_norm: float = 1.0


def _factored_dims(shape):
    """Last two non-trivial dims, Adafactor convention; None if ndim < 2."""
    if len(shape) < 2 or shape[-1] == 1 or shape[-2] == 1:
        return None
    return len(shape) - 2, len(shape) - 1


def init_adamw(params, cfg: AdamWConfig):
    """Zero moments beside each parameter, on its device."""
    mdt = _device.dtype(cfg.moment_dtype)

    def per_leaf(p):
        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=p.device)
        st = {"m": zeros(p.shape, mdt)} if cfg.momentum else {}
        fd = _factored_dims(tuple(p.shape)) if cfg.factored else None
        if fd is not None:
            r, c = fd
            vr = list(p.shape)
            del vr[c]
            vc = list(p.shape)
            del vc[r]
            st["v_row"] = zeros(tuple(vr), torch.float32)
            st["v_col"] = zeros(tuple(vc), torch.float32)
        else:
            st["v"] = zeros(p.shape, mdt)
        if cfg.momentum and cfg.error_feedback and mdt != torch.float32:
            st["ef"] = zeros(p.shape, mdt)
        return st

    dev = leaves(params)[0].device
    return {"mu": tree_map(per_leaf, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def _update_leaf(g, st, p, lr, b1c, b2c, clip, cfg: AdamWConfig,
                 dims=None):
    """One parameter's AdamW step in fp32, written into p and st.
    ``dims``: per dim of ``p``, the mesh axes its shard is cut along."""
    gf = (g.float() * clip).to(g.dtype).float()
    if "m" in st:
        gf_m = gf + st["ef"].float() if "ef" in st else gf
        m_new = cfg.b1 * st["m"].float() + (1 - cfg.b1) * gf_m
        st["m"].copy_(m_new)
        if "ef" in st:      # error feedback: keep what bf16 rounding lost
            st["ef"].copy_(m_new - st["m"].float())
    else:
        m_new = gf          # momentum-free (Adafactor regime)
    if "v_row" in st:
        # the last two dims (the parameter's full shape chose to factor)
        r, c = p.dim() - 2, p.dim() - 1
        ax_r, ax_c = (((), ()) if dims is None else (dims[r], dims[c]))
        g2 = gf * gf
        vr = cfg.b2 * st["v_row"] + (1 - cfg.b2) * _mean(g2, c, ax_c)
        vc = cfg.b2 * st["v_col"] + (1 - cfg.b2) * _mean(g2, r, ax_r)
        st["v_row"].copy_(vr)
        st["v_col"].copy_(vc)
        # reconstruct v ~= vr * vc / mean(vr)
        denom = torch.clamp(_mean(vr, -1, ax_r).unsqueeze(-1), min=1e-30)
        v_hat = (vr / denom).unsqueeze(c) * vc.unsqueeze(r)
    else:
        v_hat = cfg.b2 * st["v"].float() + (1 - cfg.b2) * gf * gf
        st["v"].copy_(v_hat)
    m_hat = m_new / b1c if "m" in st else m_new
    update = m_hat / (torch.sqrt(v_hat / b2c) + cfg.eps)
    update = update + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * update)


@torch.no_grad()
def adamw_update(grads, state, params, lr, cfg: AdamWConfig, split=None):
    """One AdamW step: clips ``grads`` to ``cfg.clip_norm``, then updates
    ``params`` and ``state["mu"]`` in place and advances
    ``state["count"]``.  ``lr``: a float or a 0-d fp32 tensor.  The count
    and the bias corrections stay on the device (reference
    ``adamw_update``), so the step reads nothing on the host.  ``split``:
    on a mesh, the leaves' shard axes (``global_norm``).  Returns (params,
    state, grad norm before clipping, a 0-d fp32 tensor)."""
    count = state["count"] + 1
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    gnorm = global_norm(grads, split)
    clip = _clip_scale(gnorm, cfg.clip_norm)
    if not isinstance(lr, torch.Tensor):
        lr = _f32(lr)
    flat_p = leaves(params)
    flat_g = leaves(grads)
    flat_s = leaves(state["mu"], is_leaf=lambda t: isinstance(t, dict)
                    and ("v" in t or "v_row" in t))
    flat_d = [None] * len(flat_p) if split is None else split
    for g, st, p, dims in zip(flat_g, flat_s, flat_p, flat_d):
        if p.dim() >= 3 and p.numel() >= (1 << 26):
            # layer-stacked giants: one stack entry at a time, so the fp32
            # temporaries are one layer, not the whole stack (as the
            # reference's lax.map); the stack dim is never split
            for i in range(p.shape[0]):
                _update_leaf(g[i], {k: v[i] for k, v in st.items()}, p[i],
                             lr, b1c, b2c, clip, cfg,
                             None if dims is None else dims[1:])
        else:
            _update_leaf(g, st, p, lr, b1c, b2c, clip, cfg, dims)
    state["count"].copy_(count)
    return params, state, gnorm

