"""Gated DeltaNet (GDN) recurrence in PyTorch — the paper's core primitive.

The port of ``repro.core.gdn``: the math that the ``use_pallas_serving=False``
path runs.  Every function takes arbitrary leading batch dims in place of
the reference's ``vmap``:

  q, k : (..., d_k)      v : (..., d_v)      S : (..., d_k, d_v)
  g, beta, log_g : (...)                      retrieval r = S^T k

  * gates (paper Eqs. 5-6):  log g = -sigmoid(alpha) exp(A_log) softplus(dt_bias)
  * decode_step_naive (Alg. 1) / decode_step_fused (Alg. 2) / ssd_decode_step
  * prefill_sequential (oracle) / prefill_chunkwise (gated UT transform)
  * batched GVA wrappers gdn_decode / gdn_prefill, (B, H, ...) layouts.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------- gates

def log_gate(alpha, A_log, dt_bias):
    """log g_t = -sigma(alpha_t) * exp(A_log) * softplus(dt_bias) <= 0."""
    return -torch.sigmoid(alpha) * torch.exp(A_log) * F.softplus(dt_bias)


def gates(alpha, b, A_log, dt_bias):
    """Paper Eqs. (5)-(6). Returns (g, beta), both in (0, 1)."""
    return torch.exp(log_gate(alpha, A_log, dt_bias)), torch.sigmoid(b)


# ---------------------------------------------------------------- decode steps

def _retrieve(x, S):
    """x^T S over the last two dims: (..., d_k) x (..., d_k, d_v)."""
    return torch.matmul(x.unsqueeze(-2), S).squeeze(-2)


def _outer(k, dv):
    return k.unsqueeze(-1) * dv.unsqueeze(-2)


def decode_step_naive(q, k, v, S, g, beta, *, scale=None):
    """Alg. 1 — three logical passes over S (retrieval, update, output)."""
    scale = (1.0 / math.sqrt(q.shape[-1])) if scale is None else scale
    r = _retrieve(k, S)
    dv = beta.unsqueeze(-1) * (v - r)
    S_new = g[..., None, None] * S + _outer(k, dv)
    return scale * _retrieve(q, S_new), S_new


def decode_step_fused(q, k, v, S, g, beta, *, scale=None):
    """Alg. 2 — one read pass ([k; q] @ S) and one write pass, via
    S_t^T q = g S_{t-1}^T q + (q . k) dv."""
    scale = (1.0 / math.sqrt(q.shape[-1])) if scale is None else scale
    rr = torch.matmul(torch.stack([k, q], dim=-2), S)   # (..., 2, d_v)
    r, sq = rr[..., 0, :], rr[..., 1, :]
    dv = beta.unsqueeze(-1) * (v - r)
    alpha = (q * k).sum(-1, keepdim=True)
    o = scale * (g.unsqueeze(-1) * sq + alpha * dv)
    S_new = g[..., None, None] * S + _outer(k, dv)
    return o, S_new


def ssd_decode_step(q, k, v, S, g, *, scale=None):
    """Mamba-2 / SSD decode: S_t = g S + k v^T; o = scale S_t^T q."""
    scale = 1.0 if scale is None else scale
    S_new = g[..., None, None] * S + _outer(k, v)
    return scale * _retrieve(q, S_new), S_new


# ---------------------------------------------------------------- prefill

def prefill_sequential(q, k, v, log_g, beta, S0, *, scale=None,
                       delta_rule=True):
    """Token-by-token loop of the fused step (the oracle).

    q, k: (..., T, d_k); v: (..., T, d_v); log_g, beta: (..., T);
    S0: (..., d_k, d_v).  Returns O (..., T, d_v), S_final (..., d_k, d_v).
    """
    d_k = q.shape[-1]
    if scale is None:
        scale = (1.0 / math.sqrt(d_k)) if delta_rule else 1.0
    S = S0
    outs = []
    for t in range(q.shape[-2]):
        g_t = torch.exp(log_g[..., t])
        if delta_rule:
            o, S = decode_step_fused(q[..., t, :], k[..., t, :],
                                     v[..., t, :], S, g_t, beta[..., t],
                                     scale=scale)
        else:
            o, S = ssd_decode_step(q[..., t, :], k[..., t, :],
                                   v[..., t, :], S, g_t, scale=scale)
        outs.append(o)
    return torch.stack(outs, dim=-2), S


# Within a chunk of length C with cumulative log-decay L_t = sum_{r<=t} log g_r:
#   (I + A) U = beta * (V - gamma_prev * (K @ S0)),
#       A[t,s] = beta_t exp(L_{t-1} - L_s) (k_t . k_s),  s < t
#   O  = scale (gamma * (Q @ S0) + M @ U),  M[t,s] = exp(L_t - L_s) (q_t . k_s)
#   S_C = exp(L_C) S0 + (exp(L_C - L) * K)^T @ U
# Every decay ratio exp(L_a - L_b) kept has a >= b, so it is <= 1.

def _tril_mask(C, device, diagonal):
    return torch.ones(C, C, dtype=torch.bool, device=device).tril(diagonal)


def _decay(L_a, L_b, keep):
    """exp(L_a[t] - L_b[s]) where ``keep`` (s before t), 0 elsewhere.  The
    difference is masked before the exp: an entry above the diagonal
    would be exp of a rise past fp32's range wherever a chunk's decay
    passes -88 (mamba2 at full width), and its 0 gradient times that inf
    is a NaN in the backward (the reference exponentiates every entry).
    The kept entries are the same bits."""
    d = L_a.unsqueeze(-1) - L_b.unsqueeze(-2)
    return torch.exp(d.masked_fill(~keep, float("-inf")))


def _chunk_delta(q, k, v, log_g, beta, S0, scale):
    C = q.shape[-2]
    L = torch.cumsum(log_g, dim=-1)
    L_prev = L - log_g
    gamma = torch.exp(L)
    gamma_prev = torch.exp(L_prev)
    kT = k.transpose(-1, -2)
    below = _tril_mask(C, q.device, -1)
    decayA = _decay(L_prev, L, below)
    A = beta.unsqueeze(-1) * decayA * torch.matmul(k, kT)
    A = torch.where(below, A, torch.zeros_like(A))
    rhs = beta.unsqueeze(-1) * (v - gamma_prev.unsqueeze(-1)
                                * torch.matmul(k, S0))
    eye = torch.eye(C, dtype=q.dtype, device=q.device)
    U = torch.linalg.solve_triangular(eye + A, rhs, upper=False)
    causal = _tril_mask(C, q.device, 0)
    M = _decay(L, L, causal) * torch.matmul(q, kT)
    M = torch.where(causal, M, torch.zeros_like(M))
    O = scale * (gamma.unsqueeze(-1) * torch.matmul(q, S0)
                 + torch.matmul(M, U))
    w = torch.exp(L[..., -1:] - L)
    S_new = (torch.exp(L[..., -1])[..., None, None] * S0
             + torch.matmul((w.unsqueeze(-1) * k).transpose(-1, -2), U))
    return O, S_new


def _chunk_ssd(q, k, v, log_g, S0, scale):
    C = q.shape[-2]
    L = torch.cumsum(log_g, dim=-1)
    gamma = torch.exp(L)
    causal = _tril_mask(C, q.device, 0)
    M = _decay(L, L, causal) * torch.matmul(q, k.transpose(-1, -2))
    M = torch.where(causal, M, torch.zeros_like(M))
    O = scale * (gamma.unsqueeze(-1) * torch.matmul(q, S0)
                 + torch.matmul(M, v))
    w = torch.exp(L[..., -1:] - L)
    S_new = (torch.exp(L[..., -1])[..., None, None] * S0
             + torch.matmul((w.unsqueeze(-1) * k).transpose(-1, -2), v))
    return O, S_new


def prefill_chunkwise(q, k, v, log_g, beta, S0, *, chunk=64, scale=None,
                      delta_rule=True):
    """Chunk-parallel prefill; T must be a multiple of ``min(chunk, T)``.

    q, k: (..., T, d_k); v: (..., T, d_v); log_g, beta: (..., T);
    S0: (..., d_k, d_v).
    """
    T, d_k = q.shape[-2], q.shape[-1]
    chunk = min(chunk, T)
    if T % chunk:
        raise ValueError(f"T={T} not a multiple of chunk={chunk}")
    if scale is None:
        scale = (1.0 / math.sqrt(d_k)) if delta_rule else 1.0
    S = S0
    outs = []
    for c in range(0, T, chunk):
        sl = slice(c, c + chunk)
        if delta_rule:
            O, S = _chunk_delta(q[..., sl, :], k[..., sl, :], v[..., sl, :],
                                log_g[..., sl], beta[..., sl], S, scale)
        else:
            O, S = _chunk_ssd(q[..., sl, :], k[..., sl, :], v[..., sl, :],
                              log_g[..., sl], S, scale)
        outs.append(O)
    return torch.cat(outs, dim=-2), S


# ---------------------------------------------------------------- batched GVA

def gva_expand(x, n_rep: int):
    """Repeat q/k heads to match v-heads: (B, Hk, ...) -> (B, Hk*R, ...)."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=1)


def gdn_decode(q, k, v, S, g, beta, *, fused=True, scale=None,
               delta_rule=True):
    """Batched GDN decode step.

    q, k: (B, Hk, d_k); v: (B, Hv, d_v); S: (B, Hv, d_k, d_v);
    g, beta: (B, Hv).  Returns o (B, Hv, d_v), S_new (a new tensor).
    """
    R = v.shape[1] // q.shape[1]
    qe, ke = gva_expand(q, R), gva_expand(k, R)
    if delta_rule:
        fn = decode_step_fused if fused else decode_step_naive
        return fn(qe, ke, v, S, g, beta, scale=scale)
    return ssd_decode_step(qe, ke, v, S, g, scale=scale)


def gdn_prefill(q, k, v, log_g, beta, S0, *, chunk=64, scale=None,
                delta_rule=True):
    """Batched chunkwise prefill.

    q, k: (B, T, Hk, d_k); v: (B, T, Hv, d_v); log_g, beta: (B, T, Hv);
    S0: (B, Hv, d_k, d_v).  Returns O (B, T, Hv, d_v), S (B, Hv, d_k, d_v).
    """
    R = v.shape[2] // q.shape[2]
    qe = gva_expand(q.transpose(1, 2), R)           # (B, Hv, T, d_k)
    ke = gva_expand(k.transpose(1, 2), R)
    O, S = prefill_chunkwise(qe, ke, v.transpose(1, 2),
                             log_g.transpose(1, 2), beta.transpose(1, 2),
                             S0, chunk=chunk, scale=scale,
                             delta_rule=delta_rule)
    return O.transpose(1, 2), S
