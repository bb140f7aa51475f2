"""GQA / sliding-window attention: full-sequence training and serving
over a rolling KV cache (port of ``repro.models.attention``).

  * ``attn_train``         — full-sequence causal (optionally windowed)
                             attention for training: the hand-written flash
                             kernels (``use_flash_kernel``) or
                             ``blockwise_attention``, an online-softmax
                             loop over KV blocks that never materializes
                             the (T, T) scores;
  * ``attn_prefill``       — causal attention over a fresh prompt, fills the
                             cache;
  * ``attn_prefill_chunk`` — one prompt chunk continuing from the cache
                             (RoPE/visibility resume at ``cache.length``,
                             ragged ``valid_len`` tails);
  * ``attn_decode_xla``    — one token against the cache (the reference's
                             plain-XLA decode; its name is kept), the
                             mixers' decode;
  * ``attn_decode_pallas`` — one token through the flash-decode kernel
                             (``kernels.ops.attn_decode``), which no mixer
                             calls, as in the reference.

On a mesh's "model" axis (``parallel.comm.model_axis()``) the projections
hold this rank's heads while the KV cache holds a slice of the *context*
(the reference's ``cache_specs``: (B, Hkv, Tmax / M, hd) on rank r holds
positions [r Tmax / M, (r + 1) Tmax / M)): ``attn_decode_xla`` and
``attn_prefill_chunk`` gather the new tokens' q, k, v heads over "model",
write each position into the rank that owns it, and compute flash-decode
split-K — each rank's (max, sum) over its slice, merged in rank order,
then the probability-weighted values all-reduced — before keeping the
local heads for ``wo``.  Where the axis does not divide the KV heads
(recurrentgemma's one MQA head), ``fit_spec`` places it on ``wk`` /
``wv``'s head_dim instead: each rank projects its half of every KV head,
and k and v are gathered along head_dim before RoPE (which mixes the two
halves of head_dim) and before the cache write.  A rolling (``swa``)
cache of ``size`` slots is split the same way: rank r holds slots
[r size / M, (r + 1) size / M).  At a model axis of 1 this is the
unsharded arithmetic bit for bit.

KV cache layout: (B, Hkv, Tmax, hd) + lengths (B,) int32.  A rolling (SWA)
cache of ``size`` slots holds token p at slot p mod size.  The functions
write the new keys/values and lengths into the cache tensors in place and
return the cache.  Score and value products accumulate in fp32 from the
activation-dtype cache, as the reference's ``preferred_element_type``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.kernels import flash_attn, ops
from repro_torch.models import layers
from repro_torch.parallel import comm

_NEG = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, Hkv, Tmax, hd)
    v: torch.Tensor       # (B, Hkv, Tmax, hd)
    length: torch.Tensor  # (B,) int32 — tokens seen (may exceed Tmax when
                          # the cache rolls)


def init_attention(generator, d_model, n_heads, n_kv_heads, head_dim,
                   dtype, device, reps):
    s = d_model ** -0.5
    r = layers.randn
    return {
        "wq": r(generator, (reps, d_model, n_heads, head_dim), s, dtype,
                device),
        "wk": r(generator, (reps, d_model, n_kv_heads, head_dim), s, dtype,
                device),
        "wv": r(generator, (reps, d_model, n_kv_heads, head_dim), s, dtype,
                device),
        "wo": r(generator, (reps, n_heads, head_dim, d_model),
                (n_heads * head_dim) ** -0.5, dtype, device),
    }


def _proj_heads(x, w):
    d, H, k = w.shape
    return layers.dot(x, w.reshape(d, H * k)).reshape(*x.shape[:-1], H, k)


def _qkv(p, x, positions, rope_theta):
    q = layers.apply_rope(_proj_heads(x, p["wq"]), positions, rope_theta)
    k = layers.apply_rope(_proj_heads(x, p["wk"]), positions, rope_theta)
    return q, k, _proj_heads(x, p["wv"])


def _apply_head_mask(o, head_mask):
    """Zero the TP-padding heads (see ArchConfig.head_mask)."""
    if head_mask is None:
        return o
    shape = (1,) * (o.dim() - 2) + (o.shape[-2], 1)
    return o * head_mask.reshape(shape).to(o.dtype)


def _out(o, wo):
    H, hd, d = wo.shape
    return layers.dot_rows(o.reshape(*o.shape[:-2], H * hd),
                           wo.reshape(H * hd, d))


def _f32_matmul(a, b):
    """fp32 product of activation-dtype operands (bf16 x bf16 products are
    exact in fp32, so this is the reference's fp32-accumulated dot)."""
    return torch.matmul(a.float(), b.float())


def blockwise_attention(q, k, v, *, window=None, block_kv=512):
    """Causal (optionally sliding-window) attention, looped over KV blocks.

    q: (B, T, Hq, hd); k, v: (B, T, Hkv, hd).  Returns (B, T, Hq, hd).
    Memory per block: O(T * block_kv) scores instead of O(T^2); each block
    step is recomputed in the backward pass (the reference's
    ``jax.checkpoint`` on its scan step), so no block's scores are kept."""
    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    bkv = min(block_kv, T)
    if T % bkv:
        raise ValueError(f"T={T} is not a multiple of block_kv={bkv}")
    qg = q.reshape(B, T, Hkv, G, hd).permute(0, 2, 3, 1, 4)   # (B,Hkv,G,T,hd)
    q_pos = torch.arange(T, device=q.device)

    def step(m, l, acc, k_blk, v_blk, kv0):
        # activation-dtype operands, fp32 products (as the reference's
        # preferred_element_type)
        s = scale * _f32_matmul(qg, k_blk.permute(0, 2, 3, 1).unsqueeze(2))
        kv_pos = kv0 + torch.arange(bkv, device=q.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        if window is not None:
            mask = mask & ((q_pos[:, None] - kv_pos[None, :]) < window)
        s = torch.where(mask, s, torch.full((), _NEG, device=q.device))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = corr * l + p.sum(-1)
        acc_new = corr[..., None] * acc + _f32_matmul(
            p.to(v_blk.dtype), v_blk.permute(0, 2, 1, 3).unsqueeze(2))
        return m_new, l_new, acc_new

    m = torch.full((B, Hkv, G, T), _NEG, device=q.device)
    l = torch.zeros((B, Hkv, G, T), device=q.device)
    acc = torch.zeros((B, Hkv, G, T, hd), device=q.device)
    for j in range(T // bkv):
        blk = slice(j * bkv, (j + 1) * bkv)
        if torch.is_grad_enabled():
            m, l, acc = checkpoint(step, m, l, acc, k[:, blk], v[:, blk],
                                   j * bkv, use_reentrant=False)
        else:
            m, l, acc = step(m, l, acc, k[:, blk], v[:, blk], j * bkv)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, hd).to(q.dtype)


def attn_train(p, x, *, rope_theta=10000.0, window=None, block_kv=512,
               use_flash_kernel=False, head_mask=None):
    """Full-sequence causal attention for training.  x: (B, T, d).
    ``use_flash_kernel`` runs ``kernels.flash_attn.flash_attention`` (the
    hand-written kernels on the card, their plain versions on the CPU);
    otherwise ``blockwise_attention``.  On a mesh's "model" axis it runs
    on this rank's heads (the caller's ``copy_to`` / ``reduce_from``
    carry the column / row split): the kernels at the local shape."""
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    tp = comm.model_axis()
    if tp is not None and p["wk"].shape[-1] != p["wq"].shape[-1]:
        q, k, v = _qkv_train_split(tp, p, x, positions, rope_theta)
    else:
        q, k, v = _qkv(p, x, positions, rope_theta)
    if use_flash_kernel:
        o = flash_attn.flash_attention(q, k, v, window=window)
    else:
        o = blockwise_attention(q, k, v, window=window, block_kv=block_kv)
    if tp is not None and head_mask is not None:
        n = q.shape[-2]
        head_mask = head_mask.narrow(0, tp.index * n, n)
    return _out(_apply_head_mask(o, head_mask), p["wo"])


def _qkv_train_split(tp, p, x, positions, rope_theta):
    """q, k, v of this rank's query heads in training where ``fit_spec``
    split the KV heads on head_dim (the axis does not divide them): k and
    v are gathered along head_dim over "model" before RoPE (which mixes
    the two halves of head_dim), then each rank keeps the KV head its
    query heads read (its query heads all sit in one GQA group: the axis
    is a multiple of the KV heads); their gradients, partial on each
    rank, are summed over the axis before each rank keeps its block."""
    q = layers.apply_rope(_proj_heads(x, p["wq"]), positions, rope_theta)
    # each rank's query heads take their part of k's and v's gradient
    k = comm.gather_from(tp, _proj_heads(x, p["wk"]), -1, partial=True)
    v = comm.gather_from(tp, _proj_heads(x, p["wv"]), -1, partial=True)
    n_q, n_kv = q.shape[-2], k.shape[-2]
    if tp.size % n_kv:
        raise ValueError(f"a model axis of {tp.size} splits neither the "
                         f"{n_kv} KV heads nor a whole number of them "
                         f"per query-head group")
    kv = tp.index * n_q // (n_q * tp.size // n_kv)
    k = layers.apply_rope(k.narrow(-2, kv, 1), positions, rope_theta)
    return q, k, v.narrow(-2, kv, 1)


def attn_prefill(p, x, cache: KVCache, *, rope_theta=10000.0, window=None,
                 head_mask=None):
    """Causal (optionally windowed) attention over the prompt; fills the
    cache.  All rows share length T; rolling caches keep the last ``size``
    tokens at slot p mod size."""
    if comm.model_axis() is not None:
        raise NotImplementedError(
            "attn_prefill on a mesh: the serving path stages prompts "
            "through attn_prefill_chunk")
    B, T, _ = x.shape
    pos = torch.arange(T, device=x.device)
    q, k, v = _qkv(p, x, pos.expand(B, T), rope_theta)
    Hq, hd = q.shape[2], q.shape[3]
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, hd).permute(0, 2, 3, 1, 4)   # (B,Hkv,G,T,hd)
    kh = k.permute(0, 2, 1, 3)                                 # (B,Hkv,T,hd)
    vh = v.permute(0, 2, 1, 3)
    s = (1.0 / math.sqrt(hd)) * _f32_matmul(
        qg, kh.unsqueeze(2).transpose(-1, -2))
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask = mask & ((pos[:, None] - pos[None, :]) < window)
    s = torch.where(mask, s, torch.full((), _NEG, device=x.device))
    pr = torch.softmax(s, dim=-1)
    o = _f32_matmul(pr.to(v.dtype), vh.unsqueeze(2))           # (B,Hkv,G,T,hd)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, hd).to(x.dtype)
    size = cache.k.shape[2]
    if T >= size:
        cache.k.copy_(torch.roll(kh[:, :, -size:], T % size, dims=2))
        cache.v.copy_(torch.roll(vh[:, :, -size:], T % size, dims=2))
    else:
        cache.k[:, :, :T] = kh.to(cache.k.dtype)
        cache.v[:, :, :T] = vh.to(cache.v.dtype)
    cache.length.add_(T)
    return _out(_apply_head_mask(o, head_mask), p["wo"]), cache


def attn_prefill_chunk(p, x, cache: KVCache, *, rope_theta=10000.0,
                       window=None, head_mask=None, valid_len=None):
    """One prompt chunk continuing from the cache — exactly equivalent to
    decoding it token by token.  A pre-chunk slot is visible to the query
    at position ``pos`` iff occupied and among the ``size`` most recent
    positions at ``pos``; in-chunk visibility is causal.  With
    ``valid_len`` (int or (B,) tensor) only the first valid_len tokens of
    each row are real: padded positions are not inserted into the rolling
    buffer and ``length`` advances by valid_len only.
    x: (B, C, d) with C <= cache size.  Returns (out (B, C, d), cache)."""
    tp = comm.model_axis()
    if tp is not None:
        return _attn_prefill_chunk_split(tp, p, x, cache, rope_theta,
                                         head_mask, valid_len)
    B, C, _ = x.shape
    size = cache.k.shape[2]
    if C > size:
        raise ValueError(f"prefill chunk of {C} tokens exceeds the rolling "
                         f"KV buffer ({size}); lower the chunk size")
    dev = x.device
    length = cache.length.long()
    ar = torch.arange(C, device=dev)
    pos = length[:, None] + ar[None, :]                         # (B, C)
    q, k, v = _qkv(p, x, pos, rope_theta)
    Hq, hd = q.shape[2], q.shape[3]
    Hkv = cache.k.shape[1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, C, Hkv, G, hd).permute(0, 2, 3, 1, 4)     # (B,Hkv,G,C,hd)
    neg = torch.full((), _NEG, device=dev)

    # scores against the pre-chunk cache
    t_idx = torch.arange(size, device=dev)
    Lc = length[:, None]
    p_t = (Lc - 1) - torch.remainder(Lc - 1 - t_idx[None, :], size)
    occupied = t_idx[None, :] < Lc
    vis = occupied[:, None, :] & (p_t[:, None, :] > pos[:, :, None] - size)
    s_cache = scale * _f32_matmul(qg, cache.k.unsqueeze(2).transpose(-1, -2))
    s_cache = torch.where(vis[:, None, None], s_cache, neg)

    # in-chunk causal scores
    kc = k.permute(0, 2, 1, 3)                                  # (B,Hkv,C,hd)
    vc = v.permute(0, 2, 1, 3)
    s_chunk = scale * _f32_matmul(qg, kc.unsqueeze(2).transpose(-1, -2))
    causal = ar[:, None] >= ar[None, :]
    s_chunk = torch.where(causal, s_chunk, neg)

    # two-part online-softmax combine (as the reference)
    m_cache = s_cache.amax(-1)
    e_cache = torch.exp(s_cache - m_cache[..., None])
    l_cache = e_cache.sum(-1)
    o_cache = _f32_matmul(e_cache.to(cache.v.dtype), cache.v.unsqueeze(2))
    m_chunk = s_chunk.amax(-1)
    e_chunk = torch.exp(s_chunk - m_chunk[..., None])
    l_chunk = e_chunk.sum(-1)
    o_chunk = _f32_matmul(e_chunk.to(vc.dtype), vc.unsqueeze(2))
    m = torch.maximum(m_cache, m_chunk)
    w_cache = torch.exp(m_cache - m)
    w_chunk = torch.exp(m_chunk - m)
    l_tot = w_cache * l_cache + w_chunk * l_chunk
    o = ((w_cache[..., None] * o_cache + w_chunk[..., None] * o_chunk)
         / torch.clamp(l_tot, min=1e-30)[..., None])
    o = o.permute(0, 3, 1, 2, 4).reshape(B, C, Hq, hd).to(x.dtype)
    out = _out(_apply_head_mask(o, head_mask), p["wo"])

    # rolling insert of the chunk: C <= size positions have distinct slots,
    # so a padded position (>= valid_len) rewrites its slot's old contents
    # and leaves the buffer as if it had been skipped (a wrapped slot may
    # still hold a visible valid token)
    slots = torch.remainder(pos, size)                          # (B, C)
    b_idx = torch.arange(B, device=dev)[:, None].expand(B, C)
    new_k = k.to(cache.k.dtype)                                 # (B,C,Hkv,hd)
    new_v = v.to(cache.v.dtype)
    if valid_len is not None:
        vl = _device.as_int(valid_len, torch.int64, dev)
        keep = (ar[None, :] < vl.reshape(-1, 1))[:, :, None, None]
        new_k = torch.where(keep, new_k, cache.k[b_idx, :, slots])
        new_v = torch.where(keep, new_v, cache.v[b_idx, :, slots])
    cache.k[b_idx, :, slots] = new_k
    cache.v[b_idx, :, slots] = new_v
    adv = C if valid_len is None else _device.as_int(
        valid_len, cache.length.dtype, dev)
    cache.length.add_(adv)
    return out, cache


def _cache_insert(cache: KVCache, k_t, v_t):
    """Insert one token per row at its rolling slot. k_t: (B, Hkv, hd)."""
    size = cache.k.shape[2]
    slot = torch.remainder(cache.length.long(), size)
    b_idx = torch.arange(cache.k.shape[0], device=cache.k.device)
    cache.k[b_idx, :, slot] = k_t.to(cache.k.dtype)
    cache.v[b_idx, :, slot] = v_t.to(cache.v.dtype)
    cache.length.add_(1)
    return cache


def attn_decode_xla(p, x_t, cache: KVCache, *, rope_theta=10000.0,
                    window=None, head_mask=None):
    """One-token decode against the cache.  x_t: (B, d_model).
    Returns (out (B, d_model), cache)."""
    tp = comm.model_axis()
    if tp is not None:
        return _attn_decode_split(tp, p, x_t, cache, rope_theta, head_mask)
    B = x_t.shape[0]
    pos = cache.length.long()
    x = x_t[:, None, :]
    q, k, v = _qkv(p, x, pos[:, None], rope_theta)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    cache = _cache_insert(cache, k, v)
    size = cache.k.shape[2]
    Hq, hd = q.shape[1], q.shape[2]
    Hkv = cache.k.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd)
    s = (1.0 / math.sqrt(hd)) * _f32_matmul(qg, cache.k.transpose(-1, -2))
    valid = torch.arange(size, device=x_t.device)[None, :] < \
        cache.length[:, None]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), _NEG, device=x_t.device))
    pr = torch.exp(s - s.amax(-1, keepdim=True))
    pr = pr / torch.clamp(pr.sum(-1, keepdim=True), min=1e-30)
    o = _f32_matmul(pr.to(cache.v.dtype), cache.v)
    o = o.reshape(B, Hq, hd).to(x_t.dtype)
    return _out(_apply_head_mask(o, head_mask), p["wo"]), cache


# ------------------------------------------- context-split (model axis)

def _qkv_split(tp, p, x, positions, rope_theta):
    """The whole q, k and v (every head) of the new tokens from this
    rank's projections, in one all-gather over "model", and the number of
    query heads this rank holds.  KV heads the axis does not divide come
    split on head_dim (``fit_spec``): gathered along it, then rotated."""
    q = layers.apply_rope(_proj_heads(x, p["wq"]), positions, rope_theta)
    k, v = _proj_heads(x, p["wk"]), _proj_heads(x, p["wv"])
    n_local, lead = q.shape[-2], q.dim() - 2
    if k.shape[-1] == q.shape[-1]:
        k = layers.apply_rope(k, positions, rope_theta)
        q, k, v = tp.all_gather_cat([q, k, v], [-2, -2, -2], lead)
    else:
        q, k, v = tp.all_gather_cat([q, k, v], [-2, -1, -1], lead)
        k = layers.apply_rope(k, positions, rope_theta)
    return q, k, v, n_local


def _merge_stats(tp, m_r, l_r):
    """Global max and softmax denominator from each rank's (max, sum of
    exp(s - max)) over its context slice, merged in rank order (at one
    rank: the rank's own, bit for bit)."""
    g = tp.all_gather(torch.stack([m_r, l_r])[None], 0)
    ms, ls = g[:, 0], g[:, 1]
    m = ms[0]
    for r in range(1, tp.size):
        m = torch.maximum(m, ms[r])
    l = torch.exp(ms[0] - m) * ls[0]
    for r in range(1, tp.size):
        l = l + torch.exp(ms[r] - m) * ls[r]
    return m, l


def _local_out(tp, p, o, n_local, head_mask):
    """Keep this rank's ``n_local`` query heads of the full ``o`` (..., Hq,
    hd) and project them through its ``wo`` rows: a partial sum the
    caller all-reduces."""
    o = o.narrow(-2, tp.index * n_local, n_local)
    if head_mask is not None:
        head_mask = head_mask.narrow(0, tp.index * n_local, n_local)
    return _out(_apply_head_mask(o, head_mask), p["wo"])


def _attn_decode_split(tp, p, x_t, cache: KVCache, rope_theta, head_mask):
    """``attn_decode_xla`` on a context-sharded cache (module docstring)."""
    B = x_t.shape[0]
    dev = x_t.device
    pos = cache.length.long()
    q, k, v, n_local = _qkv_split(tp, p, x_t[:, None, :], pos[:, None],
                                  rope_theta)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    S = cache.k.shape[2]
    off = tp.index * S
    # the new token goes to the rank owning its slot; one position per
    # row, so the clamped index of the other ranks rewrites its own value
    slot = torch.remainder(pos, S * tp.size) - off
    inside = ((slot >= 0) & (slot < S))[:, None, None]
    idx = torch.clamp(slot, 0, S - 1)
    b_idx = torch.arange(B, device=dev)
    cache.k[b_idx, :, idx] = torch.where(inside, k.to(cache.k.dtype),
                                         cache.k[b_idx, :, idx])
    cache.v[b_idx, :, idx] = torch.where(inside, v.to(cache.v.dtype),
                                         cache.v[b_idx, :, idx])
    cache.length.add_(1)
    Hq, hd = q.shape[1], q.shape[2]
    Hkv = cache.k.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd)
    s = (1.0 / math.sqrt(hd)) * _f32_matmul(qg, cache.k.transpose(-1, -2))
    valid = (off + torch.arange(S, device=dev))[None, :] < \
        cache.length[:, None]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), _NEG, device=dev))
    m_r = s.amax(-1)
    m, l = _merge_stats(tp, m_r, torch.exp(s - m_r[..., None]).sum(-1))
    pr = torch.exp(s - m[..., None]) / torch.clamp(l, min=1e-30)[..., None]
    o = tp.all_reduce(_f32_matmul(pr.to(cache.v.dtype), cache.v))
    o = o.reshape(B, Hq, hd).to(x_t.dtype)
    return _local_out(tp, p, o, n_local, head_mask), cache


def _attn_prefill_chunk_split(tp, p, x, cache: KVCache, rope_theta,
                              head_mask, valid_len):
    """``attn_prefill_chunk`` on a context-sharded cache: the scores
    against the pre-chunk cache are split over the ranks' slices (merged
    as in ``_attn_decode_split``), the in-chunk causal part is computed
    whole on every rank, and each rank writes the chunk positions its
    slice owns."""
    B, C, _ = x.shape
    S = cache.k.shape[2]
    size = S * tp.size
    if C > size:
        raise ValueError(f"prefill chunk of {C} tokens exceeds the rolling "
                         f"KV buffer ({size}); lower the chunk size")
    dev = x.device
    length = cache.length.long()
    ar = torch.arange(C, device=dev)
    pos = length[:, None] + ar[None, :]                         # (B, C)
    q, k, v, n_local = _qkv_split(tp, p, x, pos, rope_theta)
    Hq, hd = q.shape[2], q.shape[3]
    Hkv = cache.k.shape[1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, C, Hkv, G, hd).permute(0, 2, 3, 1, 4)     # (B,Hkv,G,C,hd)
    neg = torch.full((), _NEG, device=dev)

    # scores against this rank's slice of the pre-chunk cache
    t_idx = tp.index * S + torch.arange(S, device=dev)
    Lc = length[:, None]
    p_t = (Lc - 1) - torch.remainder(Lc - 1 - t_idx[None, :], size)
    occupied = t_idx[None, :] < Lc
    vis = occupied[:, None, :] & (p_t[:, None, :] > pos[:, :, None] - size)
    s_cache = scale * _f32_matmul(qg, cache.k.unsqueeze(2).transpose(-1, -2))
    s_cache = torch.where(vis[:, None, None], s_cache, neg)
    m_r = s_cache.amax(-1)
    m_cache, l_cache = _merge_stats(
        tp, m_r, torch.exp(s_cache - m_r[..., None]).sum(-1))
    e_cache = torch.exp(s_cache - m_cache[..., None])
    o_cache = tp.all_reduce(
        _f32_matmul(e_cache.to(cache.v.dtype), cache.v.unsqueeze(2)))

    # in-chunk causal scores, whole on every rank
    kc = k.permute(0, 2, 1, 3)                                  # (B,Hkv,C,hd)
    vc = v.permute(0, 2, 1, 3)
    s_chunk = scale * _f32_matmul(qg, kc.unsqueeze(2).transpose(-1, -2))
    causal = ar[:, None] >= ar[None, :]
    s_chunk = torch.where(causal, s_chunk, neg)
    m_chunk = s_chunk.amax(-1)
    e_chunk = torch.exp(s_chunk - m_chunk[..., None])
    l_chunk = e_chunk.sum(-1)
    o_chunk = _f32_matmul(e_chunk.to(vc.dtype), vc.unsqueeze(2))
    m = torch.maximum(m_cache, m_chunk)
    w_cache = torch.exp(m_cache - m)
    w_chunk = torch.exp(m_chunk - m)
    l_tot = w_cache * l_cache + w_chunk * l_chunk
    o = ((w_cache[..., None] * o_cache + w_chunk[..., None] * o_chunk)
         / torch.clamp(l_tot, min=1e-30)[..., None])
    o = o.permute(0, 3, 1, 2, 4).reshape(B, C, Hq, hd).to(x.dtype)
    out = _local_out(tp, p, o, n_local, head_mask)

    # each slot of this slice takes the chunk position that lands on it
    # (c = (t - length) mod size, when c < valid_len): a gather, so
    # positions owned by other ranks never collide with this rank's
    c_idx = torch.remainder(t_idx[None, :] - Lc, size)           # (B, S)
    limit = (C if valid_len is None else
             _device.as_int(valid_len, torch.int64, dev).reshape(-1, 1))
    hit = (c_idx < limit)[:, None, :, None]
    src = torch.clamp(c_idx, max=C - 1)[:, :, None, None].expand(
        B, S, Hkv, hd)
    for buf, new in ((cache.k, k), (cache.v, v)):
        rows = torch.gather(new.to(buf.dtype), 1, src).permute(0, 2, 1, 3)
        buf.copy_(torch.where(hit, rows, buf))
    adv = C if valid_len is None else _device.as_int(
        valid_len, cache.length.dtype, dev)
    cache.length.add_(adv)
    return out, cache


def attn_decode_pallas(p, x_t, cache: KVCache, *, rope_theta=10000.0,
                       window=None):
    """One-token decode through the flash-decode kernel (the reference's
    name is kept).  x_t: (B, d_model).  Returns (out (B, d_model), cache).

    As in the reference: the raw ``cache.length`` goes to the kernel, which
    owns the occupancy clamp; ``window`` is accepted but not forwarded (a
    ``swa`` cache is ``min(window, max_len)`` slots, so the buffer is the
    window) and no head mask is applied — on head-padded configs the
    padded heads' outputs are not zeroed, unlike ``attn_decode_xla``."""
    pos = cache.length.long()
    q, k, v = _qkv(p, x_t[:, None, :], pos[:, None], rope_theta)
    cache = _cache_insert(cache, k[:, 0], v[:, 0])
    o = ops.attn_decode(q[:, 0].contiguous(), cache.k, cache.v, cache.length)
    return _out(o, p["wo"]), cache
