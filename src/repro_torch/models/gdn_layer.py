"""Gated DeltaNet mixer layer (port of ``repro.models.gdn_layer``).

Projects the residual stream to q/k (h_k heads) and v (h_v = R*h_k heads,
Grouped Value Attention), computes the per-head gates (paper Eqs. 5-6),
L2-normalizes q/k and runs

  * train: the differentiable chunkwise gated delta rule in fp32 from a
    zero state (``core.gdn.gdn_prefill`` under autograd);
  * prefill: chunkwise gated delta rule — ``core.gdn.gdn_prefill`` (plain
    PyTorch) or, with ``use_pallas``, ``kernels.ops.gdn_prefill`` (the
    hand-written CUDA kernel on the card);
  * decode: the fused one-read-one-write step — ``core.gdn.gdn_decode`` or
    ``kernels.ops.gdn_decode``.

``use_pallas`` keeps the reference's name for the switch that selects the
hand-written kernels.  The kernel paths update ``state.S`` in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.core import gdn as gdn_core
from repro_torch.kernels import ops
from repro_torch.models import layers


class GDNState(NamedTuple):
    S: torch.Tensor       # (B, Hv, d_k, d_v) fp32 — the persistent state


def init_gdn(generator, d_model, n_k_heads, n_v_heads, head_dim, dtype,
             device, reps):
    s = d_model ** -0.5
    hv, hk, hd = n_v_heads, n_k_heads, head_dim
    r = layers.randn
    return {
        "wq": r(generator, (reps, d_model, hk, hd), s, dtype, device),
        "wk": r(generator, (reps, d_model, hk, hd), s, dtype, device),
        "wv": r(generator, (reps, d_model, hv, hd), s, dtype, device),
        "wo": r(generator, (reps, hv, hd, d_model), (hv * hd) ** -0.5, dtype,
                device),
        "w_alpha": r(generator, (reps, d_model, hv), s, dtype, device),
        "w_beta": r(generator, (reps, d_model, hv), s, dtype, device),
        "A_log": torch.zeros((reps, hv), dtype=torch.float32, device=device),
        "dt_bias": torch.full((reps, hv), 0.5, dtype=torch.float32,
                              device=device),
    }


def _l2norm(x, eps=1e-6):
    xf = x.float()
    n = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf / n).to(x.dtype)


def _heads(x, w):
    """x (B, T, d) @ w (d, H, k) -> (B, T, H, k) in x's dtype."""
    d, H, k = w.shape
    return layers.dot(x, w.reshape(d, H * k)).reshape(*x.shape[:-1], H, k)


def _proj(p, x):
    """x: (B, T, d) -> q,k (B,T,Hk,hd), v (B,T,Hv,hd), log_g/beta (B,T,Hv)."""
    q = _l2norm(_heads(x, p["wq"]))
    k = _l2norm(_heads(x, p["wk"]))
    v = _heads(x, p["wv"])
    alpha = layers.dot(x, p["w_alpha"]).float()
    b = layers.dot(x, p["w_beta"]).float()
    log_g = gdn_core.log_gate(alpha, p["A_log"], p["dt_bias"])
    return q, k, v, log_g, torch.sigmoid(b)


def _out(O, wo):
    """O (..., Hv, hd) @ wo (Hv, hd, d) -> (..., d)."""
    Hv, hd, d = wo.shape
    return layers.dot_rows(O.reshape(*O.shape[:-2], Hv * hd),
                           wo.reshape(Hv * hd, d))


def gdn_train(p, x, *, chunk=64):
    """Full-sequence gated delta rule for training (differentiable
    chunkwise path, fp32, S0 = 0).  x: (B, T, d) -> (B, T, d)."""
    B = x.shape[0]
    hv, hd = p["wv"].shape[1], p["wv"].shape[2]
    q, k, v, log_g, beta = _proj(p, x)
    S0 = torch.zeros((B, hv, q.shape[-1], hd), dtype=torch.float32,
                     device=x.device)
    O, _ = gdn_core.gdn_prefill(q.float(), k.float(), v.float(), log_g, beta,
                                S0, chunk=chunk)
    return _out(O.to(x.dtype), p["wo"])


def mask_ragged_inputs(valid_len, k, v, log_g, beta):
    """Zero the inputs at padded positions (>= ``valid_len``): a padded
    token with k = v = beta = 0 and log_g = 0 is an exact no-op on the
    state.  ``valid_len``: int, or (B,) int tensor."""
    vl = _device.as_int(valid_len, torch.int32, k.device).reshape(-1, 1)
    vm = torch.arange(k.shape[1], device=k.device)[None, :] < vl
    zero = torch.zeros((), dtype=k.dtype, device=k.device)
    zf = torch.zeros((), dtype=log_g.dtype, device=k.device)
    k = torch.where(vm[:, :, None, None], k, zero)
    v = torch.where(vm[:, :, None, None], v, zero)
    log_g = torch.where(vm[:, :, None], log_g, zf)
    beta = torch.where(vm[:, :, None], beta, zf)
    return k, v, log_g, beta


def gdn_prefill(p, x, state: GDNState, *, chunk=64, use_pallas=False,
                valid_len=None):
    """Prompt processing; returns (out (B, T, d), final state).
    ``valid_len`` (optional int or (B,) tensor) masks a ragged tail."""
    q, k, v, log_g, beta = _proj(p, x)
    if use_pallas:
        O, S = ops.gdn_prefill(q, k, v, log_g, beta, state.S, chunk=chunk,
                               valid_len=valid_len)
    else:
        if valid_len is not None:
            k, v, log_g, beta = mask_ragged_inputs(valid_len, k, v, log_g,
                                                   beta)
        O, S = gdn_core.gdn_prefill(q.float(), k.float(), v.float(), log_g,
                                    beta, state.S.float(), chunk=chunk)
        S = S.to(state.S.dtype)
    return _out(O.to(x.dtype), p["wo"]), GDNState(S=S)


def gdn_decode(p, x_t, state: GDNState, *, use_pallas=False, fused=True):
    """One-token decode step: Alg. 2 (fused, default) or the Alg. 1
    three-pass reference (``fused=False``, plain path only).
    x_t: (B, d_model)."""
    q, k, v, log_g, beta = _proj(p, x_t[:, None, :])
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    g = torch.exp(log_g[:, 0])
    beta = beta[:, 0]
    if use_pallas and fused:
        o, S = ops.gdn_decode(q.contiguous(), k.contiguous(), v.contiguous(),
                              state.S, g.contiguous(), beta.contiguous())
    else:
        o, S = gdn_core.gdn_decode(q.float(), k.float(), v.float(),
                                   state.S.float(), g, beta, fused=fused)
        o = o.to(x_t.dtype)
        S = S.to(state.S.dtype)
    return _out(o, p["wo"]), GDNState(S=S)
