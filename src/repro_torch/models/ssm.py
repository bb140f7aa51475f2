"""Mamba-2 (SSD) mixer layer (port of ``repro.models.ssm``).

Decode shares the paper's persistent-state structure: per head h a state
S^(h) in R^{d_state x d_head} updated as S <- g*S + B x^T with output
y = S^T C — the GDN recurrence *without* the delta rule.  With
``use_pallas`` both serving paths run the hand-written GDN kernels with
``delta_rule=False``: C is the one q head and B the one k head shared by
every value head (``n_groups = 1``), beta is one.

Projections are kept separate (w_z / w_x / w_B / w_C / w_dt); the causal
conv(4) applies depthwise to x, B and C with separate filters.  The kernel
paths update ``state.S`` in place.

On a mesh's "model" axis (``parallel.comm.model_axis()``) every path,
training included, runs on this rank's shards under the reference's
rules: its heads of z, x, dt, the state S, A_log, dt_bias and D, its rows
of ``out_proj`` (a partial sum the LM all-reduces), and its ``d_state``
slice of the B and C conv carries.  ``w_B``, ``w_C`` and their conv
filters are replicated, so each rank convolves its slice of B and C and
one all-gather assembles them before the kernel, which takes them as its
one shared k and q head.  The RMSNorm over d_inner takes the mean over
"model" of each rank's mean square (at one rank the unsharded
arithmetic, bit for bit) and scales by its slice of the replicated
scale.  In training these are the differentiable collectives of
``parallel.comm``: B and C gathered with ``gather_from(partial=True)``
(they feed only this rank's heads, so their gradient is summed over the
axis before each rank keeps its slice), the mean square through
``mean_over``, and every replicated leaf cut to the rank's slice
(``w_B``, ``w_C``, the conv filters of B and C, the conv biases, the norm
scale) through ``split_to``, whose backward gathers the slices'
gradients: each such leaf takes its whole gradient on every rank.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import gdn as gdn_core
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.gdn_layer import mask_ragged_inputs
from repro_torch.parallel import comm

# causal-conv width (fixed, as in Mamba-2); the mixer registry's cache_spec
# must describe carries of exactly this width
CONV_WIDTH = 4


class SSMState(NamedTuple):
    S: torch.Tensor          # (B, nheads, d_state, headdim) fp32
    conv_x: torch.Tensor     # (B, conv_width-1, d_inner)
    conv_B: torch.Tensor     # (B, conv_width-1, d_state)
    conv_C: torch.Tensor     # (B, conv_width-1, d_state)


def init_ssm(generator, d_model, d_inner, headdim, d_state, dtype, device,
             reps, conv_width=CONV_WIDTH):
    nheads = d_inner // headdim
    s = d_model ** -0.5
    r = layers.randn

    def const(value):
        return torch.full((reps, nheads), value, dtype=torch.float32,
                          device=device)

    return {
        "w_z": r(generator, (reps, d_model, d_inner), s, dtype, device),
        "w_x": r(generator, (reps, d_model, d_inner), s, dtype, device),
        "w_B": r(generator, (reps, d_model, d_state), s, dtype, device),
        "w_C": r(generator, (reps, d_model, d_state), s, dtype, device),
        "w_dt": r(generator, (reps, d_model, nheads), s, dtype, device),
        "conv_x": layers.init_conv1d(generator, d_inner, conv_width, dtype,
                                     device, reps),
        "conv_B": layers.init_conv1d(generator, d_state, conv_width, dtype,
                                     device, reps),
        "conv_C": layers.init_conv1d(generator, d_state, conv_width, dtype,
                                     device, reps),
        "A_log": const(0.0),
        "dt_bias": const(0.5),
        "D": const(1.0),
        "norm": layers.init_rmsnorm(d_inner, device, reps),
        "out_proj": r(generator, (reps, d_inner, d_model), d_inner ** -0.5,
                      dtype, device),
    }


def _silu(x):
    return F.silu(x.float()).to(x.dtype)


def _ssd_terms(p, x_in, B_in, C_in, dt, headdim):
    """Post-conv activations -> kernel inputs: the heads of x
    (..., nheads, hd), v = x dt in x's dtype, log g (..., nheads) fp32."""
    nheads = p["A_log"].shape[0]
    dt_s = F.softplus(dt.float() + p["dt_bias"])
    log_g = -torch.exp(p["A_log"]) * dt_s
    xh = x_in.reshape(*x_in.shape[:-1], nheads, headdim)
    v = (xh.float() * dt_s[..., None]).to(x_in.dtype)
    return xh, v, log_g


def _block(tp, t, n):
    """A replicated leaf's slice of this rank's ``n`` last-dim entries
    (its gradient gathered over "model": ``comm.split_to``)."""
    return t if tp is None else comm.split_to(tp, t, n)


def _rmsnorm(tp, p, x, eps=1e-6):
    """RMSNorm over the whole d_inner, which a mesh splits: the mean over
    "model" of each rank's mean square (``comm.mean_over``: its gradient
    the mean of the ranks' gradients, each partial), then this rank's
    slice of the scale."""
    if tp is None:
        return layers.rmsnorm_fwd(p, x, eps)
    xf = x.float()
    var = comm.mean_over(tp, torch.mean(xf * xf, dim=-1, keepdim=True))
    scale = _block(tp, p["scale"], x.shape[-1])
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _out(p, y, z, xh, x_dtype, tp=None):
    d_shape = (1,) * (y.dim() - 2) + (p["D"].shape[0], 1)
    y = y + p["D"].reshape(d_shape) * xh.to(y.dtype)
    y = y.reshape(*y.shape[:-2], -1)
    y = _rmsnorm(tp, p["norm"], y.to(x_dtype))
    y = y * _silu(z)
    return layers.dot_rows(y, p["out_proj"])


def _gather_bc(tp, Bi, Ci):
    """The whole of B and C from every rank's ``d_state`` slice (one
    all-gather of the two side by side; nothing off a mesh).  In training
    the gathered B and C feed only this rank's heads: their gradient is
    summed over "model" before each rank keeps its slice."""
    if tp is None:
        return Bi, Ci
    ns = Bi.shape[-1]
    bc = comm.gather_from(tp, torch.cat([Bi, Ci], -1), -1, partial=True)
    bc = bc.unflatten(-1, (tp.size, 2, ns))
    return bc[..., 0, :].flatten(-2), bc[..., 1, :].flatten(-2)


def ssm_train(p, x, *, d_inner, headdim, d_state, chunk=64):
    """Full-sequence SSD through the differentiable chunkwise path (fp32,
    S0 = 0, delta_rule=False).  x: (B, T, d) -> (B, T, d); on a mesh's
    "model" axis this rank's heads (a partial sum of the output)."""
    B = x.shape[0]
    tp = comm.model_axis()
    ns = d_state if tp is None else d_state // tp.size
    nx = p["w_x"].shape[-1]
    z = layers.dot(x, p["w_z"])
    xi = _silu(layers.conv1d_fwd(layers.conv_block(p["conv_x"], nx),
                                 layers.dot(x, p["w_x"])))
    Bi = _silu(layers.conv1d_fwd(layers.conv_block(p["conv_B"], ns),
                                 layers.dot(x, _block(tp, p["w_B"], ns))))
    Ci = _silu(layers.conv1d_fwd(layers.conv_block(p["conv_C"], ns),
                                 layers.dot(x, _block(tp, p["w_C"], ns))))
    Bi, Ci = _gather_bc(tp, Bi, Ci)
    dt = layers.dot(x, p["w_dt"])
    xh, v, log_g = _ssd_terms(p, xi, Bi, Ci, dt, headdim)
    S0 = torch.zeros((B, xh.shape[-2], d_state, headdim),
                     dtype=torch.float32, device=x.device)
    O, _ = gdn_core.gdn_prefill(
        Ci[:, :, None, :].float(), Bi[:, :, None, :].float(), v.float(),
        log_g, torch.ones_like(log_g), S0, chunk=chunk, delta_rule=False)
    return _out(p, O.to(x.dtype), z, xh, x.dtype, tp)


def _conv_prefill(conv_p, u, cache, valid_len=None):
    """Seeded causal conv; returns (activated output, new cache tail).

    With ``valid_len`` set (an int, a 0-d or a per-row (B,) tensor) the
    carry is the last ``w - 1`` *valid* inputs, rows ``[valid_len,
    valid_len + w - 1)`` of cache‖u: the carry serial decode would hold
    after the valid prefix (``layers.conv1d_carry``)."""
    T = u.shape[1]
    w = conv_p["w"].shape[0]
    full = torch.cat([cache.to(u.dtype), u], dim=1)
    out = layers.conv1d_fwd(conv_p, full)[:, -T:, :]
    return _silu(out), layers.conv1d_carry(full, w - 1, valid_len)


def ssm_prefill(p, x, state: SSMState, *, d_inner, headdim, d_state,
                chunk=64, use_pallas=False, valid_len=None):
    """Prompt processing; returns (out (B, T, d), new state).
    ``valid_len`` (optional int or (B,) tensor) masks a ragged tail."""
    tp = comm.model_axis()
    ns, nx = state.conv_B.shape[-1], state.conv_x.shape[-1]
    z = layers.dot(x, p["w_z"])
    xi, cx = _conv_prefill(layers.conv_block(p["conv_x"], nx),
                           layers.dot(x, p["w_x"]), state.conv_x, valid_len)
    Bi, cB = _conv_prefill(layers.conv_block(p["conv_B"], ns),
                           layers.dot(x, _block(tp, p["w_B"], ns)),
                           state.conv_B, valid_len)
    Ci, cC = _conv_prefill(layers.conv_block(p["conv_C"], ns),
                           layers.dot(x, _block(tp, p["w_C"], ns)),
                           state.conv_C, valid_len)
    Bi, Ci = _gather_bc(tp, Bi, Ci)
    dt = layers.dot(x, p["w_dt"])
    xh, v, log_g = _ssd_terms(p, xi, Bi, Ci, dt, headdim)
    ones = torch.ones_like(log_g)
    if use_pallas:
        O, S = ops.gdn_prefill(Ci[:, :, None, :], Bi[:, :, None, :], v,
                               log_g, ones, state.S, chunk=chunk,
                               delta_rule=False, valid_len=valid_len)
    else:
        Bk, vk, log_gk = Bi[:, :, None, :], v, log_g
        if valid_len is not None:
            Bk, vk, log_gk, ones = mask_ragged_inputs(valid_len, Bk, vk,
                                                      log_gk, ones)
        O, S = gdn_core.gdn_prefill(
            Ci[:, :, None, :].float(), Bk.float(), vk.float(), log_gk, ones,
            state.S.float(), chunk=chunk, delta_rule=False)
        S = S.to(state.S.dtype)
    out = _out(p, O.to(x.dtype), z, xh, x.dtype, tp)
    return out, SSMState(S=S, conv_x=cx.to(state.conv_x.dtype),
                         conv_B=cB.to(state.conv_B.dtype),
                         conv_C=cC.to(state.conv_C.dtype))


def ssm_decode(p, x_t, state: SSMState, *, d_inner, headdim, d_state,
               use_pallas=False):
    """One-token decode step (the fused persistent-state step without the
    delta rule).  x_t: (B, d_model)."""
    tp = comm.model_axis()
    ns, nx = state.conv_B.shape[-1], state.conv_x.shape[-1]
    z = layers.dot(x_t, p["w_z"])
    xi, cx = layers.conv1d_decode(layers.conv_block(p["conv_x"], nx),
                                  layers.dot(x_t, p["w_x"]), state.conv_x)
    Bi, cB = layers.conv1d_decode(layers.conv_block(p["conv_B"], ns),
                                  layers.dot(x_t, _block(tp, p["w_B"], ns)),
                                  state.conv_B)
    Ci, cC = layers.conv1d_decode(layers.conv_block(p["conv_C"], ns),
                                  layers.dot(x_t, _block(tp, p["w_C"], ns)),
                                  state.conv_C)
    xi, Bi, Ci = _silu(xi), _silu(Bi), _silu(Ci)
    Bi, Ci = _gather_bc(tp, Bi, Ci)
    dt = layers.dot(x_t, p["w_dt"])
    xh, v, log_g = _ssd_terms(p, xi, Bi, Ci, dt, headdim)
    g = torch.exp(log_g)
    ones = torch.ones_like(g)
    if use_pallas:
        o, S = ops.gdn_decode(Ci[:, None, :].contiguous(),
                              Bi[:, None, :].contiguous(), v.contiguous(),
                              state.S, g.contiguous(), ones,
                              delta_rule=False)
    else:
        o, S = gdn_core.gdn_decode(
            Ci[:, None, :].float(), Bi[:, None, :].float(), v.float(),
            state.S.float(), g, ones, fused=True, delta_rule=False)
        S = S.to(state.S.dtype)
    out = _out(p, o.to(x_t.dtype), z, xh, x_t.dtype, tp)
    return out, SSMState(S=S, conv_x=cx, conv_B=cB, conv_C=cC)
