"""Shared model layers: RMSNorm, RoPE, SwiGLU MLP, embeddings, logits,
causal conv1d, cross entropy (port of ``repro.models.layers``).

Functional style over plain parameter dicts of tensors.  Matmuls run in
the activation dtype (bf16 on the card, which accumulates in fp32 and
rounds the result to bf16 — the reference's ``preferred_element_type``
then ``astype``); norms in fp32.

On a mesh's "model" axis (``parallel.comm.model_axis()``) the embedding
table holds this rank's vocab rows: ``embed_fwd`` looks up the tokens it
owns and all-reduces; in training the gradient reaches only the rows a
rank owns (``comm.reduce_from``).  Where ``fit_spec`` moved the axis
onto d_model (a vocabulary it does not divide) the table holds this
rank's d_model columns: the lookup is gathered along d_model
(``comm.gather_from``, whose backward keeps the rank's columns of the
gradient); where it dropped the axis (FSDP took d_model) the table is
whole on every rank and the lookup is the plain one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import device as _device
from repro_torch.parallel import comm


def dot(x, w):
    """x (..., d) @ w (d, n) -> (..., n) in x's dtype."""
    return torch.matmul(x, w.to(x.dtype))


def dot_rows(x, w):
    """``dot`` through a row-parallel weight (a mixer's output projection,
    the MLP's ``wo``): on a mesh's "model" axis ``w`` holds this rank's
    rows and the result is a partial sum, kept in fp32 (``bmm_f32``) so
    that the LM's sum over the axis rounds to x's dtype once, as the
    one-device product rounds its whole sum; off a mesh, on an axis of one
    rank, or in fp32, ``dot``."""
    tp = comm.model_axis()
    if tp is None or tp.size == 1 or x.dtype == torch.float32:
        return dot(x, w)
    out = bmm_f32(x.reshape(1, -1, x.shape[-1]), w.to(x.dtype)[None])
    return out.reshape(*x.shape[:-1], w.shape[-1])


def randn(generator, shape, std, dtype, device):
    """N(0, std^2) in fp32 from ``generator`` on ``device``, cast to dtype
    (the reference's ``(normal(key, shape) * s).astype(dtype)``)."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


# ------------------------------------------------------------------ RMSNorm

def init_rmsnorm(d, device, reps=None):
    shape = (d,) if reps is None else (reps, d)
    return {"scale": torch.ones(shape, dtype=torch.float32, device=device)}


def rmsnorm_fwd(p, x, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


# ------------------------------------------------------------------ RoPE

def rope_freqs(head_dim, theta=10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta=10000.0):
    """x: (..., T, H, hd) or (..., H, hd), positions broadcastable to the
    leading dims of x without the head axis."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ MLP

def init_mlp(generator, d_model, d_ff, dtype, device, reps):
    s_in, s_ff = d_model ** -0.5, d_ff ** -0.5
    return {
        "wi_gate": randn(generator, (reps, d_model, d_ff), s_in, dtype, device),
        "wi_up": randn(generator, (reps, d_model, d_ff), s_in, dtype, device),
        "wo": randn(generator, (reps, d_ff, d_model), s_ff, dtype, device),
    }


def mlp_fwd(p, x):
    g = dot(x, p["wi_gate"])
    u = dot(x, p["wi_up"])
    return dot_rows(F.silu(g) * u, p["wo"])


# ------------------------------------------------------------------ Embedding

def init_embedding(generator, vocab, d_model, dtype, device):
    return {"table": randn(generator, (vocab, d_model), d_model ** -0.5,
                           dtype, device)}


def embed_fwd(p, tokens, on="vocab"):
    """The tokens' rows of the table; ``on``: the dim of the table that
    the active model axis splits ("vocab", "d_model" or None: whole,
    ``parallel.sharding.model_dims``)."""
    tp = comm.model_axis()
    if tp is None or on is None:
        return p["table"][tokens]
    if on == "d_model":
        return comm.gather_from(tp, p["table"][tokens], -1)
    # vocab-parallel: each rank holds rows [index * n, (index + 1) * n)
    n = p["table"].shape[0]
    local = tokens - tp.index * n
    hit = (local >= 0) & (local < n)
    x = p["table"][torch.where(hit, local, torch.zeros_like(local))]
    x = torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
    # in training each rank's rows take the gradient of the tokens they
    # own (the sum's backward is the identity)
    return comm.reduce_from(tp, x)


def logits_matmul(x, w):
    """x (..., d) @ w (d, V) with an fp32 result: ``bmm_f32`` at E = 1."""
    out = bmm_f32(x.reshape(1, -1, x.shape[-1]), w[None])
    return out.reshape(*x.shape[:-1], w.shape[-1])


def bmm_f32(x, w):
    """Batched x (E, M, d) @ w (E, d, n) with an fp32 result: the LM head
    (E = 1) and the MoE expert products, the reference's
    ``preferred_element_type=float32`` products of activation-dtype
    operands.  On the card bf16 operands go through ``_MatmulF32``, which
    keeps the fp32 accumulator and never materializes an fp32 copy of a
    weight (on the meta device too, where ``launch.op_cost`` counts the
    card's step); elsewhere (fp32 configs, the CPU, which has no kernel
    for the ``out_dtype`` overload) both operands are fp32."""
    if x.device.type in ("cuda", "meta") and \
            x.dtype == w.dtype == torch.bfloat16:
        return _MatmulF32.apply(x, w)
    return torch.bmm(x.float(), w.float())


class _MatmulF32(torch.autograd.Function):
    """bf16 x (E, M, d) @ w (E, d, n) -> fp32 through ``torch.bmm(...,
    out_dtype=torch.float32)``, with a gradient (that overload has none).
    The one rule for the cotangent's precision: the fp32 cotangent is
    rounded to bf16 once and both gradients are bf16 products with fp32
    accumulation, rounded to bf16 — as a TPU's default matmul precision
    takes the reference's fp32 cotangent.  Keeping it fp32 would need fp32
    copies of the weights (1.9 GB per expert leaf at mixtral-8x7b's
    width, 0.5 GB for its head) and fp32 products on the CUDA cores.
    x's gradient sums over the weight's n (the LM head's vocabulary:
    122,753 terms at minicpm-2b), which cuBLAS may split, adding the
    split partial sums in bf16 where torch allows it (``torch.backends.
    cuda.matmul.allow_bf16_reduced_precision_reduction``, on by default):
    so it comes from an fp32-output product, rounded to bf16 once.  w's
    gradient sums over the rows and keeps the bf16-output product (an
    fp32 one would be an fp32 copy of the weight)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.bmm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(w.dtype)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.bmm(g, w.transpose(1, 2),
                           out_dtype=torch.float32).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.bmm(x.transpose(1, 2), g)
        return gx, gw


def logits_fwd(p, x, table=None):
    """Project to vocab. ``table`` given => tied embeddings."""
    w = table if table is not None else p["table"]
    return logits_matmul(x, w.t())


# ------------------------------------------------------------ causal conv1d
# (mamba2 / RG-LRU mixers; decode keeps a (width-1)-token cache)

def init_conv1d(generator, channels, width, dtype, device, reps):
    return {"w": randn(generator, (reps, width, channels), width ** -0.5,
                       dtype, device),
            "b": torch.zeros((reps, channels), dtype=dtype, device=device)}


def conv_block(p, n):
    """A conv's filter and bias for ``n`` channels: on a mesh, each leaf
    holding more (a replicated one) cut to this rank's slice, its
    gradient gathered over "model" in training (``comm.split_to``)."""
    tp = comm.model_axis()
    return p if tp is None else {k: comm.split_to(tp, v, n)
                                 for k, v in p.items()}


def conv1d_fwd(p, x):
    """Causal depthwise conv over (B, T, C): the reference's sum of the
    ``width`` shifted products in x's dtype, in order, then the bias."""
    width, T = p["w"].shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = pad[:, 0:T, :] * p["w"][0]
    for i in range(1, width):
        out = out + pad[:, i:i + T, :] * p["w"][i]
    return out + p["b"]


def conv1d_decode(p, x_t, cache):
    """One-step conv. x_t: (B, C); cache: (B, width-1, C).  The window's
    products summed in fp32, cast to x's dtype, then the bias.  Returns
    (y, new cache)."""
    full = torch.cat([cache, x_t[:, None, :]], dim=1)        # (B, width, C)
    y = torch.einsum("bwc,wc->bc", full.float(),
                     p["w"].float()).to(x_t.dtype) + p["b"]
    return y, full[:, 1:, :]


def conv1d_carry(full, n, valid_len=None):
    """The conv carry after a prefill block: the ``n`` rows of ``full``
    (B, n + T, C) = cache ‖ block that follow the valid prefix, i.e. rows
    [valid_len, valid_len + n) — the last ``n`` rows without ``valid_len``.
    ``valid_len`` (int, 0-d or (B,) int tensor) becomes a gather index
    built on the device, never a host value, so the carry is safe inside a
    CUDA graph capture."""
    if valid_len is None:
        return full[:, -n:, :]
    B, C = full.shape[0], full.shape[-1]
    vl = _device.as_int(valid_len, torch.int64, full.device).reshape(-1, 1)
    idx = (vl + torch.arange(n, device=full.device)[None, :]).expand(B, n)
    return torch.gather(full, 1, idx[:, :, None].expand(B, n, C))


# ------------------------------------------------------------------ loss

def cross_entropy(logits, labels, z_loss=0.0):
    """logits: (..., V) fp32; labels: (...) int.  Mean over all positions;
    ``z_loss`` adds z_loss * logsumexp^2 per position."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return _ce_mean(lse, ll, z_loss)


def cross_entropy_split(tp, logits, labels, z_loss=0.0):
    """``cross_entropy`` of logits whose vocabulary the model axis ``tp``
    splits: ``logits`` (..., V / M) fp32 holds this rank's block of the
    vocabulary.  The log-sum-exp's max (gathered, no gradient), its sum
    and the labels' logits cross the axis as one value per position
    (``comm.reduce_from``: every rank's loss is the same), where gathering
    the logits would move V / M of them per position."""
    n = logits.shape[-1]
    m = tp.all_gather(logits.detach().amax(-1)[None], 0).amax(0)
    lse = torch.log(comm.reduce_from(
        tp, torch.exp(logits - m[..., None]).sum(-1))) + m
    idx = labels.long() - tp.index * n
    inside = (idx >= 0) & (idx < n)
    picked = torch.gather(logits, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
    ll = comm.reduce_from(tp, torch.where(inside, picked,
                                          torch.zeros_like(picked)))
    return _ce_mean(lse, ll, z_loss)


def _ce_mean(lse, ll, z_loss):
    loss = lse - ll
    if z_loss > 0.0:
        loss = loss + z_loss * lse ** 2
    return torch.mean(loss)
