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
