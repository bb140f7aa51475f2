"""Plain PyTorch versions of the port's kernels (port of
``repro.kernels.ref``).

These are what the ops wrappers run for tensors on the CPU, and what
``chip_smoke.py`` holds each CUDA kernel against on the card.  They return
new tensors (the kernels update the state in place; ``ops`` hides the
difference).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import gdn


def gdn_decode_ref(q, k, v, S, g, beta, *, scale=None, delta_rule=True):
    """Plain version of ``kernels.gdn_decode``.  q, k: (B, Hk, d_k);
    v: (B, Hv, d_v); S: (B, Hv, d_k, d_v); g, beta: (B, Hv).  Returns
    (o (B, Hv, d_v) in v's dtype, S_new in S's dtype)."""
    R = v.shape[1] // q.shape[1]
    if scale is None:
        scale = (1.0 / math.sqrt(q.shape[-1])) if delta_rule else 1.0
    qe = gdn.gva_expand(q, R).float()
    ke = gdn.gva_expand(k, R).float()
    vf, Sf = v.float(), S.float()
    if delta_rule:
        o, S_new = gdn.decode_step_fused(qe, ke, vf, Sf, g, beta,
                                         scale=scale)
    else:
        o, S_new = gdn.ssd_decode_step(qe, ke, vf, Sf, g, scale=scale)
    return o.to(v.dtype), S_new.to(S.dtype)


def valid_mask(valid_len, rows: int, T: int, device):
    """(rows, T) bool: position < valid_len[row] (valid_len (rows,))."""
    vl = torch.as_tensor(valid_len, dtype=torch.int32, device=device)
    vl = vl.reshape(-1).expand(rows)
    return torch.arange(T, device=device)[None, :] < vl[:, None]


def gdn_prefill_ref(q, k, v, log_g, beta, S0, valid_len=None, *,
                    scale=None, delta_rule=True, n_rep: int = 1):
    """Plain version of ``kernels.gdn_prefill``: a sequential scan per row.

    q, k: (BHk, T, d_k) with BHk = BHv / n_rep (value row r uses q/k row
    r // n_rep — the GVA mapping of a (B, Hv) row layout); v: (BHv, T, d_v);
    log_g, beta: (BHv, T); S0: (BHv, d_k, d_v); valid_len: optional (BHv,)
    int — positions >= valid_len are padding (k, v, beta, log g zeroed, an
    exact no-op on the state).  Returns (O (BHv, T, d_v) in v's dtype,
    S (BHv, d_k, d_v) in S0's dtype)."""
    if scale is None:
        scale = (1.0 / math.sqrt(q.shape[-1])) if delta_rule else 1.0
    qf = torch.repeat_interleave(q.float(), n_rep, dim=0)
    kf = torch.repeat_interleave(k.float(), n_rep, dim=0)
    vf, lg, bf = v.float(), log_g.float(), beta.float()
    if valid_len is not None:
        vm = valid_mask(valid_len, vf.shape[0], vf.shape[1], vf.device)
        zero = torch.zeros((), dtype=vf.dtype, device=vf.device)
        kf = torch.where(vm[..., None], kf, zero)
        vf = torch.where(vm[..., None], vf, zero)
        lg = torch.where(vm, lg, zero)
        bf = torch.where(vm, bf, zero)
    O, S = gdn.prefill_sequential(qf, kf, vf, lg, bf, S0.float(),
                                  scale=scale, delta_rule=delta_rule)
    return O.to(v.dtype), S.to(S0.dtype)


# ------------------------------------------------------------ flash attention

FLASH_NEG_INF = -1e30


def _flash_mask(T: int, window=None, valid_len=None, device=None):
    """(rows or 1, 1, T, T) bool: the flash kernels' score mask — causal,
    ``(q - k) < window``, and ``k < valid_len[row]`` (valid_len (rows,))."""
    pos = torch.arange(T, device=device)
    keep = pos[:, None] >= pos[None, :]
    if window is not None:
        keep = keep & ((pos[:, None] - pos[None, :]) < window)
    keep = keep[None, None]
    if valid_len is not None:
        vl = torch.as_tensor(valid_len, device=device).reshape(-1)
        keep = keep & (pos[None, None, None, :] < vl[:, None, None, None])
    return keep


def _flash_scores(q, k, valid_len, scale, window):
    """Masked fp32 scores (BH, G, T, T) of q (BH, G, T, hd), k (BH, T, hd)."""
    s = scale * torch.matmul(q.float(), k.float().unsqueeze(1).transpose(-1,
                                                                         -2))
    keep = _flash_mask(q.shape[2], window, valid_len, q.device)
    return torch.where(keep, s, torch.full((), FLASH_NEG_INF,
                                           device=q.device))


def flash_fwd_ref(q, k, v, valid_len=None, *, scale=None, window=None):
    """Plain version of ``kernels.flash_attn.flash_fwd``, dense in fp32.

    q: (BH, G, T, hd); k, v: (BH, T, hd); valid_len: optional (BH,) int.
    Returns (o in q's dtype, m, l (BH, G, T) fp32): the row max of the
    masked scores and the row sum of exp(s - m)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _flash_scores(q, k, valid_len, scale, window)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.matmul(p, v.float().unsqueeze(1)) / torch.clamp(
        l, min=1e-30)[..., None]
    return o.to(q.dtype), m, l


def flash_bwd_ref(q, k, v, o, m, l, do, valid_len=None, *, scale=None,
                  window=None):
    """Plain version of ``kernels.flash_attn.flash_bwd``, dense in fp32:
    p = exp(s - m) / max(l, 1e-30) from the forward's statistics,
    delta = rowsum(do * o).  Returns (dq, dk, dv) in q's, k's, v's dtypes
    (dk, dv summed over the G query heads of each kv head)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dof = do.float()
    delta = torch.sum(dof * o.float(), dim=-1)
    s = _flash_scores(q, k, valid_len, scale, window)
    p = torch.exp(s - m[..., None]) / torch.clamp(l, min=1e-30)[..., None]
    dp = torch.matmul(dof, v.float().unsqueeze(1).transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dq = scale * torch.matmul(ds, k.float().unsqueeze(1))
    dk = scale * torch.matmul(ds.transpose(-1, -2), q.float()).sum(1)
    dv = torch.matmul(p.transpose(-1, -2), dof).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ attention decode

def attn_decode_visible(length, T: int, window=None):
    """(B, T) bool: the slots of a (rolling) cache of ``T`` slots that a
    one-token query sees, with ``length`` (B,) the raw token count (may
    exceed T).  Slot t is occupied iff t < min(length, T); with a window
    it holds absolute position (length-1) - ((length-1-t) mod T) and is
    visible iff that position >= length - window (the TPU kernel's rule,
    ``repro/kernels/attn_decode.py``)."""
    L = length.long().reshape(-1, 1)
    t = torch.arange(T, device=length.device)[None, :]
    keep = t < torch.clamp(L, max=T)
    if window is not None:
        p_abs = (L - 1) - torch.remainder(L - 1 - t, T)
        keep = keep & (p_abs >= L - window)
    return keep


def attn_decode_ref(q, k_cache, v_cache, length, *, scale=None, window=None):
    """Plain version of ``kernels.attn_decode``: dense fp32 softmax over the
    visible slots (``attn_decode_visible``).  q: (B, Hq, d); k_cache,
    v_cache: (B, Hkv, T, d); length: (B,) int.  Masked slots get p = 0
    exactly, so a row with no visible slot (length 0) gives 0.  Returns o
    (B, Hq, d) in q's dtype."""
    B, Hq, d = q.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(B, Hkv, Hq // Hkv, d).float()
    s = scale * torch.matmul(qg, k_cache.float().transpose(-1, -2))
    keep = attn_decode_visible(length, T, window)[:, None, None, :]
    s = torch.where(keep, s, torch.full((), FLASH_NEG_INF, device=q.device))
    p = torch.where(keep, torch.exp(s - s.amax(-1, keepdim=True)),
                    torch.zeros((), device=q.device))
    o = torch.matmul(p, v_cache.float()) / torch.clamp(
        p.sum(-1, keepdim=True), min=1e-30)
    return o.reshape(B, Hq, d).to(q.dtype)
