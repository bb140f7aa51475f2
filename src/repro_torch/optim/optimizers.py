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

def global_norm(tree):
    """fp32 L2 norm over every leaf, as a 0-d tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


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
def _update_leaf(g, st, p, lr, b1c, b2c, clip, cfg: AdamWConfig):
    """One parameter's AdamW step in fp32, written into p and st."""
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
        r, c = _factored_dims(tuple(p.shape))
        g2 = gf * gf
        vr = cfg.b2 * st["v_row"] + (1 - cfg.b2) * torch.mean(g2, dim=c)
        vc = cfg.b2 * st["v_col"] + (1 - cfg.b2) * torch.mean(g2, dim=r)
        st["v_row"].copy_(vr)
        st["v_col"].copy_(vc)
        # reconstruct v ~= vr * vc / mean(vr)
        denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=1e-30)
        v_hat = (vr / denom).unsqueeze(c) * vc.unsqueeze(r)
    else:
        v_hat = cfg.b2 * st["v"].float() + (1 - cfg.b2) * gf * gf
        st["v"].copy_(v_hat)
    m_hat = m_new / b1c if "m" in st else m_new
    update = m_hat / (torch.sqrt(v_hat / b2c) + cfg.eps)
    update = update + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * update)


@torch.no_grad()
def adamw_update(grads, state, params, lr, cfg: AdamWConfig):
    """One AdamW step: clips ``grads`` to ``cfg.clip_norm``, then updates
    ``params`` and ``state["mu"]`` in place and advances
    ``state["count"]``.  ``lr``: a float or a 0-d fp32 tensor.  The count
    and the bias corrections stay on the device (reference
    ``adamw_update``), so the step reads nothing on the host.  Returns
    (params, state, grad norm before clipping, a 0-d fp32 tensor)."""
    count = state["count"] + 1
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    gnorm = global_norm(grads)
    clip = _clip_scale(gnorm, cfg.clip_norm)
    if not isinstance(lr, torch.Tensor):
        lr = _f32(lr)
    flat_p = leaves(params)
    flat_g = leaves(grads)
    flat_s = leaves(state["mu"], is_leaf=lambda t: isinstance(t, dict)
                    and ("v" in t or "v_row" in t))
    for g, st, p in zip(flat_g, flat_s, flat_p):
        if p.dim() >= 3 and p.numel() >= (1 << 26):
            # layer-stacked giants: one stack entry at a time, so the fp32
            # temporaries are one layer, not the whole stack (as the
            # reference's lax.map)
            for i in range(p.shape[0]):
                _update_leaf(g[i], {k: v[i] for k, v in st.items()}, p[i],
                             lr, b1c, b2c, clip, cfg)
        else:
            _update_leaf(g, st, p, lr, b1c, b2c, clip, cfg)
    state["count"].copy_(count)
    return params, state, gnorm

