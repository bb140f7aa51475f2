"""Unified hybrid causal LM for training and serving (port of
``repro.models.lm``).

A model is a cycled ``pattern`` of mixer kinds plus a dense SwiGLU FFN per
layer.  Layers are grouped into (pattern, repeats) groups with parameters
and caches stacked on a leading repeats axis, exactly the nesting of the
reference's ``init_lm``/``init_caches``, so the numpy bridge maps one tree
onto the other.  The reference's ``lax.scan`` over repeats is a loop over
that axis here.

Caches are updated in place: every function writes each layer's new cache
back into the stacked buffers it was given (the port's form of buffer
donation) and returns them.

Training runs each group's repeats in a loop; with ``cfg.remat`` each
repeat is recomputed in the backward pass (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint`` of its scanned block), and so is each
cross-entropy chunk.

Entry points:
  init_lm(generator, cfg, device)            -> params
  forward_hidden(params, cfg, tokens|embeds) -> ((B, T, d) hidden, aux)
  loss_fn(params, cfg, batch)                -> (loss, {"ce", "aux"})
                                                (chunked cross entropy)
  cache_specs(cfg, batch, max_len)           -> CacheSpec (stacked)
  init_caches(cfg, batch, max_len, device)   -> caches
  prefill(params, cfg, caches, tokens|embeds)-> (last-token logits, caches)
  prefill_chunk(params, cfg, caches, ...)    -> (hidden (B, C, d), caches)
  prefill_chunk_scan(params, cfg, caches, ..)-> caches after n chunks
  prefill_sample(params, cfg, caches, sampler, sample_fn, ...)
                                             -> (token, sampler, caches)
  decode_step(params, cfg, tokens, caches)   -> (logits (B, V) fp32, caches)
  decode_steps(params, cfg, tokens, caches, k, sampler, sample_fn)
                                             -> k fused decode+sample steps
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers
from repro_torch.models.mixers import CacheSpec, get_mixer
from repro_torch.tree import leaves, tree_map


# ---------------------------------------------------------------- grouping

def build_groups(cfg: ArchConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """[(pattern kinds, repeats)] covering cfg.n_layers."""
    L, P = cfg.n_layers, len(cfg.pattern)
    groups = []
    if L // P:
        groups.append((cfg.pattern, L // P))
    if L % P:
        groups.append((tuple(cfg.pattern[: L % P]), 1))
    return groups


# ---------------------------------------------------------------- init

def _check_ffn(cfg: ArchConfig):
    if cfg.ffn not in ("dense", "none"):
        raise NotImplementedError(
            f"ffn={cfg.ffn!r}: MoE FFNs are not ported yet: the reference's "
            f"models/moe.py (ROADMAP)")


def _init_position(generator, kind, cfg, dtype, device, reps):
    """Stacked (reps, ...) params of one pattern position."""
    p = {"norm1": layers.init_rmsnorm(cfg.d_model, device, reps),
         "mixer": get_mixer(kind).init_params(generator, cfg, dtype, device,
                                              reps)}
    if cfg.ffn == "dense":
        p["norm2"] = layers.init_rmsnorm(cfg.d_model, device, reps)
        p["mlp"] = layers.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype,
                                   device, reps)
    return p


def init_lm(generator, cfg: ArchConfig, device=None):
    """Random params drawn on ``device`` (default ``cuda``) from
    ``generator`` — a ``torch.Generator`` on that device, or an int seed.
    Same shapes, scales and dtypes as the reference's ``init_lm``; the
    draws themselves differ (the tests bridge the reference's params in)."""
    _check_ffn(cfg)
    dev = _device.resolve(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    dtype = _device.dtype(cfg.act_dtype)
    params: Dict[str, Any] = {
        "embed": layers.init_embedding(generator, cfg.vocab, cfg.d_model,
                                       dtype, dev),
        "final_norm": layers.init_rmsnorm(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": layers.randn(
            generator, (cfg.d_model, cfg.vocab), cfg.d_model ** -0.5, dtype,
            dev)}
    params["groups"] = [
        [_init_position(generator, kind, cfg, dtype, dev, reps)
         for kind in kinds]
        for kinds, reps in build_groups(cfg)]
    return params


def param_count(params) -> int:
    return sum(t.numel() for t in leaves(params))


# ---------------------------------------------------------------- train

def _layer_train(kind, cfg: ArchConfig, lp, x):
    h = layers.rmsnorm_fwd(lp["norm1"], x, cfg.norm_eps)
    x = x + get_mixer(kind).train(lp["mixer"], cfg, h)
    return _ffn_fwd(cfg, lp, x)


def _unstack(tree, reps: int):
    """The per-repeat slices of a stacked tree, from one ``unbind`` per
    leaf (whose backward stacks the repeats' gradients once, where indexing
    each repeat would scatter each into a zeroed full-size buffer)."""
    parts = {id(t): t.unbind(0) for t in leaves(tree)}
    return [tree_map(lambda t, r=r: parts[id(t)][r], tree)
            for r in range(reps)]


def forward_hidden(params, cfg: ArchConfig, tokens=None, embeds=None):
    """Returns (final hidden (B, T, d), total MoE aux loss — 0, as no MoE
    FFN is ported)."""
    _check_ffn(cfg)
    x = _embed(params, cfg, tokens, embeds)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for (kinds, reps), gp in zip(build_groups(cfg), params["groups"]):

        def block(x, lp_slice, kinds=kinds):
            for i, kind in enumerate(kinds):
                x = _layer_train(kind, cfg, lp_slice[i], x)
            return x

        for lp_slice in _unstack(gp, reps):
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, lp_slice, use_reentrant=False)
            else:
                x = block(x, lp_slice)
    return x, aux_total


def loss_fn(params, cfg: ArchConfig, batch, *, t_chunk=1024, z_loss=1e-4,
            aux_weight=0.01):
    """Cross entropy chunked over T (never materializes (B, T, V) fp32
    logits: each chunk's logits are recomputed in the backward pass).
    ``batch``: {"tokens" or "embeds", "labels" (B, T)}.  Returns
    (loss, {"ce", "aux"}) as 0-d fp32 tensors."""
    labels = batch["labels"]
    h, aux = forward_hidden(params, cfg, batch.get("tokens"),
                            batch.get("embeds"))
    B, T, _ = h.shape
    tc = min(t_chunk, T)
    n = T // tc

    def chunk_loss(hc, lc):
        return layers.cross_entropy(_logits(params, cfg, hc), lc,
                                    z_loss=z_loss)

    if n <= 1:
        ce = chunk_loss(h, labels)
    else:
        losses = []
        for i in range(n):
            hc, lc = h[:, i * tc:(i + 1) * tc], labels[:, i * tc:(i + 1) * tc]
            losses.append(checkpoint(chunk_loss, hc, lc, use_reentrant=False)
                          if torch.is_grad_enabled() else chunk_loss(hc, lc))
        ce = torch.mean(torch.stack(losses))
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------- caches

def cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> CacheSpec:
    """Declarative spec of the stacked per-group cache tree: leaves are
    (repeats, batch, ...)."""
    return CacheSpec([
        [get_mixer(kind).cache_spec(cfg, batch, max_len).stack(reps).tree
         for kind in kinds]
        for kinds, reps in build_groups(cfg)])


def init_caches(cfg: ArchConfig, batch: int, max_len: int, device=None):
    return cache_specs(cfg, batch, max_len).zeros(device)


# ---------------------------------------------------------------- forward

def _ffn_fwd(cfg: ArchConfig, lp, x):
    if cfg.ffn == "none":
        return x
    h = layers.rmsnorm_fwd(lp["norm2"], x, cfg.norm_eps)
    return x + layers.mlp_fwd(lp["mlp"], h)


def _write_back(dst, src):
    """Copy a layer's new cache into its slice of the stacked buffers
    (a no-op for leaves the mixer already updated in place)."""
    for d, s in zip(leaves(dst), leaves(src)):
        if s is not d:
            d.copy_(s)


def _run_cached(params, cfg: ArchConfig, x, caches, mode: str,
                valid_len=None):
    _check_ffn(cfg)
    for (kinds, reps), gp, gc in zip(build_groups(cfg), params["groups"],
                                     caches):
        for r in range(reps):
            for i, kind in enumerate(kinds):
                lp = tree_map(lambda a: a[r], gp[i])
                c = tree_map(lambda a: a[r], gc[i])
                mixer = get_mixer(kind)
                h = layers.rmsnorm_fwd(lp["norm1"], x, cfg.norm_eps)
                if mode == "prefill":
                    mix, nc = mixer.prefill(lp["mixer"], cfg, h, c)
                elif mode == "chunk":
                    mix, nc = mixer.prefill_chunk(lp["mixer"], cfg, h, c,
                                                  valid_len=valid_len)
                else:
                    mix, nc = mixer.decode(lp["mixer"], cfg, h, c)
                _write_back(c, nc)
                x = _ffn_fwd(cfg, lp, x + mix)
    return x, caches


def _embed(params, cfg, tokens, embeds):
    x = embeds if embeds is not None else layers.embed_fwd(params["embed"],
                                                           tokens)
    return x.to(_device.dtype(cfg.act_dtype))


def _logits(params, cfg: ArchConfig, h):
    if cfg.tie_embeddings:
        return layers.logits_fwd(params["embed"], h)
    return layers.logits_matmul(h, params["lm_head"]["w"])


def prefill(params, cfg: ArchConfig, caches, tokens=None, embeds=None):
    """Process the prompt; returns (last-token logits (B, V) fp32, caches)."""
    x, caches = _run_cached(params, cfg, _embed(params, cfg, tokens, embeds),
                            caches, "prefill")
    x = layers.rmsnorm_fwd(params["final_norm"], x[:, -1], cfg.norm_eps)
    return _logits(params, cfg, x), caches


def prefill_chunk(params, cfg: ArchConfig, caches, tokens=None, embeds=None,
                  valid_len=None):
    """One prompt chunk continuing from ``caches`` (no logits).
    ``valid_len`` (int or (B,) int tensor) marks a ragged chunk: the caches
    end exactly as for the unpadded prefix; hidden rows at padded positions
    are garbage.  Returns (hidden (B, C, d), caches)."""
    return _run_cached(params, cfg, _embed(params, cfg, tokens, embeds),
                       caches, "chunk", valid_len=valid_len)


def prefill_chunk_scan(params, cfg: ArchConfig, caches, tokens=None,
                       embeds=None, valid_lens=None):
    """``prefill_chunk`` over n equal chunks in order.  tokens: (B, n, C)
    or embeds (B, n, C, d); ``valid_lens`` (n,) per-chunk valid counts, or
    (n, B) per row (a 0 entry is an exact no-op chunk; a host int 0 is not
    run at all).  Returns caches."""
    xs = tokens if tokens is not None else embeds
    for i in range(xs.shape[1]):
        vl = None if valid_lens is None else valid_lens[i]
        if isinstance(vl, int) and vl == 0:
            continue
        if tokens is not None:
            _, caches = prefill_chunk(params, cfg, caches, tokens=xs[:, i],
                                      valid_len=vl)
        else:
            _, caches = prefill_chunk(params, cfg, caches, embeds=xs[:, i],
                                      valid_len=vl)
    return caches


def prefill_sample(params, cfg: ArchConfig, caches, sampler, sample_fn,
                   tokens=None, embeds=None, valid_len=None):
    """Final prompt chunk + the fused admit head: the last *valid*
    position's logits are sampled by ``sample_fn(sampler, logits)``
    (a per-row valid_len of 0 is clamped to position 0).
    Returns (token (B,) int32, sampler, caches)."""
    x, caches = prefill_chunk(params, cfg, caches, tokens=tokens,
                              embeds=embeds, valid_len=valid_len)
    if valid_len is None:
        h_last = x[:, -1]
    elif isinstance(valid_len, int):
        h_last = x[:, valid_len - 1]
    else:
        vl = torch.as_tensor(valid_len, device=x.device).long()
        idx = torch.clamp(vl.reshape(-1) - 1, min=0).expand(x.shape[0])
        h_last = x[torch.arange(x.shape[0], device=x.device), idx]
    h = layers.rmsnorm_fwd(params["final_norm"], h_last, cfg.norm_eps)
    tok, sampler = sample_fn(sampler, _logits(params, cfg, h))
    return tok.to(torch.int32), sampler, caches


def decode_step(params, cfg: ArchConfig, tokens_t, caches):
    """One decode step. tokens_t: (B,) int. Returns (logits (B, V) fp32,
    caches)."""
    x, caches = _run_cached(params, cfg, _embed(params, cfg, tokens_t, None),
                            caches, "decode")
    x = layers.rmsnorm_fwd(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x), caches


def _greedy_sample(sampler, logits):
    """Default sampler: argmax, state untouched (never done)."""
    return torch.argmax(logits, dim=-1).to(torch.int32), sampler


def decode_steps(params, cfg: ArchConfig, tokens, caches, k: int,
                 sampler=None, sample_fn=None):
    """``k`` fused decode+sample steps, all on the device (no host sync).

    ``sampler`` carries a ``"done"`` (B,) bool tensor; ``sample_fn(sampler,
    logits) -> (tokens, sampler)``.  Slots done before a step re-feed their
    last token (their caches advance with garbage, as in the reference —
    admit rewrites the whole slot) and the step is marked invalid for them.
    Returns (toks (k, B) int32, valid (k, B) bool, tokens (B,), caches,
    sampler)."""
    if sample_fn is None:
        sample_fn = _greedy_sample
    if sampler is None:
        sampler = {"done": torch.zeros(tokens.shape, dtype=torch.bool,
                                       device=tokens.device)}
    toks, valid = [], []
    for _ in range(k):
        live = ~sampler["done"]
        logits, caches = decode_step(params, cfg, tokens, caches)
        nxt, sampler = sample_fn(sampler, logits)
        tokens = torch.where(live, nxt.to(tokens.dtype), tokens)
        toks.append(tokens)
        valid.append(live)
    return (torch.stack(toks), torch.stack(valid), tokens, caches, sampler)
