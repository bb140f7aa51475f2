"""Public entry points of the port's kernels (port of
``repro.kernels.ops``).

Dispatch only: a CUDA tensor goes to the hand-written kernel (which
launches or raises), a CPU tensor to the plain PyTorch version in ``ref``
(as does a meta tensor: ``launch.op_cost`` counts on the meta device),
any other device raises.  Both GDN paths update the recurrent state in
place and return it, so callers see one semantics.  The GVA row mapping
and the (B, T, H, d) <-> (B*H, T, d) layout of ``gdn_prefill`` live here,
at the public function.
"""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.kernels import attn_decode as _attn
from repro_torch.kernels import gdn_decode as _decode
from repro_torch.kernels import gdn_prefill as _prefill
from repro_torch.kernels import ref


def _on_cuda(S) -> bool:
    """True on a CUDA tensor (the kernel), False on a CPU one or a meta
    one (the plain version: the dry run counts a step's operations on the
    meta device, where no kernel runs); any other device raises."""
    if S.is_cuda:
        return True
    if S.device.type not in ("cpu", "meta"):
        raise ValueError(f"no kernel or plain version for device "
                         f"{S.device}")
    return False


def gdn_decode(q, k, v, S, g, beta, *, scale=None, delta_rule=True):
    """Fused persistent-state GDN decode step (paper Alg. 2).

    q, k: (B, Hk, d_k); v: (B, Hv, d_v); S: (B, Hv, d_k, d_v) fp32,
    updated in place; g, beta: (B, Hv).  Returns (o (B, Hv, d_v) in v's
    dtype, S)."""
    if _on_cuda(S):
        return _decode.gdn_decode(q, k, v, S, g.float(), beta.float(),
                                  scale=scale, delta_rule=delta_rule)
    o, S_new = ref.gdn_decode_ref(q, k, v, S, g, beta, scale=scale,
                                  delta_rule=delta_rule)
    S.copy_(S_new)
    return o, S


def gdn_prefill(q, k, v, log_g, beta, S0, *, chunk=64, scale=None,
                delta_rule=True, valid_len=None):
    """Chunkwise prefill with the state resident on chip across chunks.

    q, k: (B, T, Hk, d_k); v: (B, T, Hv, d_v); log_g, beta: (B, T, Hv);
    S0: (B, Hv, d_k, d_v) fp32, overwritten in place with the final state.
    ``valid_len`` (optional int, or (B,) int tensor): positions >= valid_len
    are padding, an exact no-op on the state.  Returns
    (O (B, T, Hv, d_v) in v's dtype, S0)."""
    B, T, Hk, d_k = q.shape
    Hv, d_v = v.shape[2], v.shape[3]
    qh = q.transpose(1, 2).reshape(B * Hk, T, d_k).contiguous()
    kh = k.transpose(1, 2).reshape(B * Hk, T, d_k).contiguous()
    vh = v.transpose(1, 2).reshape(B * Hv, T, d_v).contiguous()
    lgh = log_g.transpose(1, 2).reshape(B * Hv, T).float().contiguous()
    bh = beta.transpose(1, 2).reshape(B * Hv, T).float().contiguous()
    S0h = S0.view(B * Hv, d_k, d_v)
    vlh = None
    if valid_len is not None:
        vl = _device.as_int(valid_len, torch.int32, S0.device)
        vlh = torch.repeat_interleave(vl.reshape(-1).expand(B), Hv)
    if _on_cuda(S0):
        O, _ = _prefill.gdn_prefill(qh, kh, vh, lgh, bh, S0h, vlh,
                                    chunk=chunk, scale=scale,
                                    delta_rule=delta_rule, n_rep=Hv // Hk)
    else:
        O, S = ref.gdn_prefill_ref(qh, kh, vh, lgh, bh, S0h, vlh,
                                   scale=scale, delta_rule=delta_rule,
                                   n_rep=Hv // Hk)
        S0h.copy_(S)
    return O.reshape(B, Hv, T, d_v).transpose(1, 2), S0


def attn_decode(q, k_cache, v_cache, length, *, scale=None, window=None):
    """Flash-decode GQA attention of one token against a KV cache.

    q: (B, Hq, d); k_cache, v_cache: (B, Hkv, T, d); length: (B,) int32,
    the raw token count (may exceed T on a rolling cache: the kernel owns
    the occupancy clamp and masks ``window`` on absolute wrapped
    positions).  Returns o (B, Hq, d) in q's dtype.  The TPU tiling knob
    ``block_t`` has no counterpart."""
    if _on_cuda(k_cache):
        return _attn.attn_decode(q, k_cache, v_cache, length, scale=scale,
                                 window=window)
    return ref.attn_decode_ref(q, k_cache, v_cache, length, scale=scale,
                               window=window)


__all__ = ["gdn_decode", "gdn_prefill", "attn_decode", "ref"]
