"""RG-LRU recurrent block (RecurrentGemma) — diagonal vector-state mixer
(port of ``repro.models.rglru``).

The state is a width-d vector with an elementwise recurrence

    a_t = exp(-c * softplus(Lambda) * sigma(W_a x_t))        (gate)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (sigma(W_x x_t) * x_t)

so decode is elementwise work with no kernel of its own (the reference has
none either).  Train/prefill scan over T with a log-depth doubling scan
(the reference's ``jax.lax.associative_scan``).

Block layout follows RecurrentGemma: linear in -> causal conv(4) -> RG-LRU
-> gated (GeGLU-style) linear out.

On a mesh's "model" axis (``parallel.comm.model_axis()``) every path,
training included, runs on this rank's width slice under the reference's
rules: ``in_x``, ``in_y``, the conv filter, ``Lambda`` and the state h
are column-parallel (the replicated conv bias is cut to the slice), and
``out`` is row-parallel (a partial sum the LM all-reduces).  The gate
matrices ``w_a`` and ``w_x`` hold this rank's output columns over the
*whole* input, so the post-conv x is all-gathered over "model" before the
two gate products.  In training that gather is
``comm.gather_from(partial=True)`` (the gathered x feeds only this
rank's gate columns: its gradient is summed over the axis before each
rank keeps its slice) and the bias cut is ``comm.split_to`` (the
replicated bias takes its whole gradient on every rank).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import device as _device
from repro_torch.models import layers
from repro_torch.parallel import comm

# causal-conv width (RecurrentGemma block); the mixer registry's cache_spec
# must describe carries of exactly this width
CONV_WIDTH = 4

_C = 8.0  # RecurrentGemma's fixed gate sharpness constant


class RGLRUState(NamedTuple):
    h: torch.Tensor       # (B, width) fp32
    conv: torch.Tensor    # (B, conv_width-1, width)


def init_rglru(generator, d_model, width, dtype, device, reps,
               conv_width=CONV_WIDTH):
    s, sw = d_model ** -0.5, width ** -0.5
    r = layers.randn
    return {
        "in_x": r(generator, (reps, d_model, width), s, dtype, device),
        "in_y": r(generator, (reps, d_model, width), s, dtype, device),
        "conv": layers.init_conv1d(generator, width, conv_width, dtype,
                                   device, reps),
        "w_a": r(generator, (reps, width, width), sw, dtype, device),
        "w_x": r(generator, (reps, width, width), sw, dtype, device),
        "Lambda": torch.full((reps, width), -4.0, dtype=torch.float32,
                             device=device),   # softplus^-1 region
        "out": r(generator, (reps, width, d_model), sw, dtype, device),
    }


def _gelu(x):
    """jax.nn.gelu's default, the tanh approximation, in fp32."""
    return F.gelu(x.float(), approximate="tanh")


def _gates(p, x, tp=None):
    """x: (..., width) -> (log_a, gated_input) in fp32.  On a mesh ``x``
    is this rank's slice: the gate products take the whole of it."""
    xa = x if tp is None else comm.gather_from(tp, x, x.dim() - 1,
                                               partial=True)
    r = torch.sigmoid(layers.dot(xa, p["w_a"]).float())
    i = torch.sigmoid(layers.dot(xa, p["w_x"]).float())
    log_a = -_C * F.softplus(p["Lambda"]) * r          # <= 0
    gated = i * x.float()
    return log_a, gated


def _scan_rglru(log_a, gated, h0):
    """h_t = a_t h_{t-1} + b_t over axis 1 (T), from h0 (B, width).

    A doubling (Hillis-Steele) scan of the reference's combine
    (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2): ceil(log2 T) steps, each a
    multiply-add against the prefix shifted by 1, 2, 4, ... positions.  The
    shapes are static, so the scan is the same kernels on every call."""
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated
    T, d = a.shape[1], 1
    while d < T:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a * h0[:, None, :] + b


def rglru_train(p, x):
    """Full-sequence RG-LRU block: x (B, T, d) -> (B, T, d); on a mesh's
    "model" axis this rank's width slice (a partial sum of the output)."""
    B = x.shape[0]
    tp = comm.model_axis()
    xb = layers.dot(x, p["in_x"])
    yb = _gelu(layers.dot(x, p["in_y"]))
    xb = layers.conv1d_fwd(layers.conv_block(p["conv"], xb.shape[-1]), xb)
    log_a, gated = _gates(p, xb, tp)
    h = _scan_rglru(log_a, gated, torch.zeros(
        (B, xb.shape[-1]), dtype=torch.float32, device=x.device))
    out = (h * yb).to(x.dtype)
    return layers.dot_rows(out, p["out"])


def rglru_prefill(p, x, state: RGLRUState, valid_len=None):
    """``valid_len`` (optional int, 0-d or per-row (B,) int tensor):
    positions >= valid_len are padding — their gates are forced to the
    identity (log_a = 0, input 0), so the carried h and the conv carry are
    exactly those after the valid prefix (padded output rows are garbage;
    callers ignore them)."""
    T = x.shape[1]
    tp = comm.model_axis()
    xb = layers.dot(x, p["in_x"])
    yb = _gelu(layers.dot(x, p["in_y"]))
    conv_w = p["conv"]["w"].shape[0]
    full = torch.cat([state.conv.to(xb.dtype), xb], dim=1)
    new_conv = layers.conv1d_carry(full, conv_w - 1, valid_len)
    xb = layers.conv1d_fwd(layers.conv_block(p["conv"], xb.shape[-1]),
                           full)[:, -T:, :]
    log_a, gated = _gates(p, xb, tp)
    if valid_len is not None:
        vl = _device.as_int(valid_len, torch.int32, x.device).reshape(-1, 1)
        vm = (torch.arange(T, device=x.device)[None, :] < vl)[:, :, None]
        zero = torch.zeros((), dtype=log_a.dtype, device=x.device)
        log_a = torch.where(vm, log_a, zero)     # a = 1
        gated = torch.where(vm, gated, zero)     # b = 0
    h = _scan_rglru(log_a, gated, state.h)
    out = (h * yb).to(x.dtype)
    return layers.dot_rows(out, p["out"]), RGLRUState(
        h=h[:, -1, :], conv=new_conv.to(state.conv.dtype))


def rglru_decode(p, x_t, state: RGLRUState):
    """One-token decode: a handful of elementwise ops."""
    tp = comm.model_axis()
    xb = layers.dot(x_t, p["in_x"])
    yb = _gelu(layers.dot(x_t, p["in_y"]))
    xb, new_conv = layers.conv1d_decode(
        layers.conv_block(p["conv"], xb.shape[-1]), xb, state.conv)
    log_a, gated = _gates(p, xb, tp)
    a = torch.exp(log_a)
    h = a * state.h + torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) \
        * gated
    out = (h * yb).to(x_t.dtype)
    return layers.dot_rows(out, p["out"]), RGLRUState(h=h, conv=new_conv)
