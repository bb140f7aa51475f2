"""Unified hybrid causal LM for training and serving (port of
``repro.models.lm``).

A model is a cycled ``pattern`` of mixer kinds plus a per-layer FFN
(dense SwiGLU, MoE, MoE beside a dense MLP, or none).  Layers are grouped
into (pattern, repeats) groups with parameters and caches stacked on a
leading repeats axis, exactly the nesting of the reference's
``init_lm``/``init_caches``, so the numpy bridge maps one tree onto the
other.  The reference's ``lax.scan`` over repeats is a loop over
that axis here.

Caches are updated in place: every function writes each layer's new cache
back into the stacked buffers it was given (the port's form of buffer
donation) and returns them.

On a mesh (``parallel.comm.use``) the serving functions run on this rank's
shards, Megatron-style: the vocab-parallel embedding all-reduces, each
mixer's and FFN's output is a row-parallel partial sum all-reduced over
"model" (the mixers and the MLP are column-parallel before their per-head
or per-unit blocks; in a bf16 model the partial sums stay fp32,
``layers.dot_rows``, and the sum rounds once), and the logits are
gathered over "model" before any sampler sees them, so every rank
samples from the full vocabulary.

Training on a mesh (``runtime.trainer``, the mesh active) runs the same
split through the differentiable collectives of ``parallel.comm``: each
mixer and FFN input goes through ``copy_to`` (its gradient all-reduced
over "model"), each row-parallel output through ``reduce_from``, the
vocab-parallel embedding's sum through ``reduce_from``, and the cross
entropy of each rank's vocab block of the logits crosses the axis as one
value per position (``layers.cross_entropy_split``), so every "model"
rank computes the same loss
and the gradients of the replicated leaves agree bit for bit: every
mixer kind splits its heads or width as in serving (a replicated leaf
that a rank uses only a slice of takes its whole gradient through
``comm.split_to``), and the MoE its experts (the router reads the FFN
input before ``copy_to``; ``moe.moe_fwd``).  The data axis holds each
rank's rows; only the MoE's batch statistics cross it.  A model axis
that does not divide a split dim is refused before the first step
(``parallel.sharding.check_model_axis``).

Training runs each group's repeats in a loop; with ``cfg.remat`` each
repeat is recomputed in the backward pass (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint`` of its scanned block), and so is each
cross-entropy chunk.  No forward draws a random number, so the recompute
neither saves nor restores the RNG state (which would read the generator
inside a CUDA graph capture of the training step).

Entry points:
  init_lm(generator, cfg, device)            -> params
  forward_hidden(params, cfg, tokens|embeds) -> ((B, T, d) hidden, aux)
  loss_fn(params, cfg, batch)                -> (loss, {"ce", "aux"})
                                                (chunked cross entropy)
  cache_specs(cfg, batch, max_len)           -> CacheSpec (stacked)
  checkpoint_specs(cfg, batch, max_len)      -> CacheSpec (rollback image)
  init_caches(cfg, batch, max_len, device)   -> caches
  prefill(params, cfg, caches, tokens|embeds)-> (last-token logits, caches)
  prefill_chunk(params, cfg, caches, ...)    -> (hidden (B, C, d), caches)
  prefill_chunk_scan(params, cfg, caches, ..)-> caches after n chunks
  prefill_sample(params, cfg, caches, sampler, sample_fn, ...)
                                             -> (token, sampler, caches)
  decode_step(params, cfg, tokens, caches)   -> (logits (B, V) fp32, caches)
  decode_steps(params, cfg, tokens, caches, k, sampler, sample_fn)
                                             -> k fused decode+sample steps
  verify_steps(params, cfg, draft_params, draft_cfg, tokens, drafts,
               caches, draft_caches, run, draft_run, sampler, sample_fn)
                                             -> speculative verify with a
                                                per-position commit
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, moe
from repro_torch.models.mixers import CacheSpec, get_mixer
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as rules
from repro_torch.tree import copy_leaves, leaves, tree_map


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

def _init_position(generator, kind, cfg, dtype, device, reps,
                   experts=None):
    """Stacked (reps, ...) params of one pattern position (``experts``:
    the range of MoE experts to keep, all by default)."""
    p = {"norm1": layers.init_rmsnorm(cfg.d_model, device, reps),
         "mixer": get_mixer(kind).init_params(generator, cfg, dtype, device,
                                              reps)}
    if cfg.ffn != "none":
        p["norm2"] = layers.init_rmsnorm(cfg.d_model, device, reps)
        if cfg.ffn == "dense":
            p["mlp"] = layers.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                       dtype, device, reps)
        if cfg.ffn in ("moe", "moe+dense"):
            p["moe"] = moe.init_moe(generator, cfg.d_model, cfg.d_ff,
                                    cfg.moe_experts, dtype, device, reps,
                                    experts=experts)
        if cfg.ffn == "moe+dense":
            p["mlp"] = layers.init_mlp(generator, cfg.d_model,
                                       cfg.d_ff_dense or cfg.d_ff, dtype,
                                       device, reps)
    return p


def init_lm(generator, cfg: ArchConfig, device=None, mesh=None,
            fsdp: bool = False):
    """Random params drawn on ``device`` (default ``cuda``) from
    ``generator`` — a ``torch.Generator`` on that device, or an int seed.
    Same shapes, scales and dtypes as the reference's ``init_lm``; the
    draws themselves differ (the tests bridge the reference's params in).

    With ``mesh`` (a serving ``DeviceMesh`` holding this rank) the tree
    holds only this rank's shards under ``parallel.sharding``'s rules:
    every leaf is drawn whole in the one-device order and cut at once, so
    the generator advances as there and the shards are the one-device
    draw's, while the expert matrices, drawn one at a time, are kept for
    this rank's experts only: no rank ever holds more than its shards and
    one whole non-expert leaf.  ``fsdp`` takes the rules' FSDP specs (the
    trainer's, ``parallel.sharding.needs_fsdp``): "data" also splits the
    large matrices."""
    dev = _device.resolve(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    dtype = _device.dtype(cfg.act_dtype)
    cut, experts = _mesh_cut(cfg, mesh, fsdp)
    params: Dict[str, Any] = {
        "embed": cut(("embed",), layers.init_embedding(
            generator, cfg.vocab, cfg.d_model, dtype, dev)),
        "final_norm": layers.init_rmsnorm(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = cut(("lm_head",), {"w": layers.randn(
            generator, (cfg.d_model, cfg.vocab), cfg.d_model ** -0.5, dtype,
            dev)})
    params["groups"] = [
        [cut(("groups", g, i), _init_position(
            generator, kind, cfg, dtype, dev, reps, experts(g, i)))
         for i, kind in enumerate(kinds)]
        for g, (kinds, reps) in enumerate(build_groups(cfg))]
    return params


def _mesh_cut(cfg: ArchConfig, mesh, fsdp: bool = False):
    """(cut(key path, subtree) -> this rank's shards of it, experts(group,
    position) -> the range of experts this rank keeps) for ``init_lm``;
    without a mesh, the identity and every expert."""
    if mesh is None:
        return (lambda path, tree: tree), (lambda g, i: None)
    full = init_lm(None, cfg, device="meta")
    specs = rules.params_specs(cfg, full, fsdp, mesh)
    axes = comm.MeshAxes(mesh)

    def sub(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def cut(path, tree):
        return rules.shard_tree(tree, sub(specs, path), axes.coords,
                                axes.sizes, full=sub(full, path))

    def experts(g, i):
        spec = sub(specs, ("groups", g, i)).get("moe", {}).get("wi_gate")
        if spec is None:
            return None
        idx, n = rules.shard_block(spec, 1, axes.coords, axes.sizes)
        step = cfg.moe_experts // n
        return range(idx * step, (idx + 1) * step)

    return cut, experts


def param_count(params) -> int:
    return sum(t.numel() for t in leaves(params))


# ---------------------------------------------------------------- train

def _layer_train(kind, cfg: ArchConfig, lp, x):
    mixer = get_mixer(kind)
    h = layers.rmsnorm_fwd(lp["norm1"], x, cfg.norm_eps)
    tp = comm.model_axis()
    if tp is not None:
        h = comm.copy_to(tp, h)
    mix = mixer.train(lp["mixer"], cfg, h)
    if tp is not None:
        mix = comm.reduce_from(tp, mix).to(x.dtype)
    return _ffn_fwd(cfg, lp, x + mix, decode=False, train=True)


def _unstack(tree, reps: int):
    """The per-repeat slices of a stacked tree, from one ``unbind`` per
    leaf (whose backward stacks the repeats' gradients once, where indexing
    each repeat would scatter each into a zeroed full-size buffer)."""
    parts = {id(t): t.unbind(0) for t in leaves(tree)}
    return [tree_map(lambda t, r=r: parts[id(t)][r], tree)
            for r in range(reps)]


def forward_hidden(params, cfg: ArchConfig, tokens=None, embeds=None):
    """Returns (final hidden (B, T, d), total MoE aux loss: the sum over
    the MoE layers, 0 without one)."""
    x = _embed(params, cfg, tokens, embeds)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    # the recompute of a remat block runs in the backward pass, on
    # autograd's device thread: it enters the mesh it ran on itself
    axes = comm.active()
    for (kinds, reps), gp in zip(build_groups(cfg), params["groups"]):

        def block(x, lp_slice, kinds=kinds):
            aux = []
            with comm.use(axes):
                for i, kind in enumerate(kinds):
                    x, a = _layer_train(kind, cfg, lp_slice[i], x)
                    if a is not None:
                        aux.append(a)
            return x, aux

        for lp_slice in _unstack(gp, reps):
            if cfg.remat and torch.is_grad_enabled():
                x, aux = checkpoint(block, x, lp_slice, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = block(x, lp_slice)
            for a in aux:
                aux_total = aux_total + a
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

    axes = comm.active()

    def chunk_loss(hc, lc):
        with comm.use(axes):        # recomputed on autograd's thread
            tp = comm.model_axis()
            logits = _local_logits(params, cfg, hc)
            if tp is None or tp.size == 1:
                return layers.cross_entropy(logits, lc, z_loss=z_loss)
            return layers.cross_entropy_split(tp, logits, lc, z_loss=z_loss)

    if n <= 1:
        ce = chunk_loss(h, labels)
    else:
        losses = []
        for i in range(n):
            hc, lc = h[:, i * tc:(i + 1) * tc], labels[:, i * tc:(i + 1) * tc]
            losses.append(checkpoint(chunk_loss, hc, lc, use_reentrant=False,
                                     preserve_rng_state=False)
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


def checkpoint_specs(cfg: ArchConfig, batch: int, max_len: int) -> CacheSpec:
    """Spec of the speculative-decode rollback image, stacked like
    ``cache_specs``, from each mixer's ``checkpoint_spec`` (for every
    built-in kind equal to its ``cache_spec``)."""
    return CacheSpec([
        [get_mixer(kind).checkpoint_spec(cfg, batch, max_len).stack(reps)
         .tree for kind in kinds]
        for kinds, reps in build_groups(cfg)])


# ---------------------------------------------------------------- forward

def _ffn_fwd(cfg: ArchConfig, lp, x, decode: bool, train: bool = False):
    """x + the layer's FFN of x; returns (x, MoE aux loss or None).  The
    MoE runs its capacity dispatch on blocks and its dense all-expert
    product at decode; arctic's dense MLP is added beside it.
    ``train``: the MoE takes its capacity groups and load statistics over
    the data axis's global batch, as the reference's sharded step."""
    if cfg.ffn == "none":
        return x, None
    h = layers.rmsnorm_fwd(lp["norm2"], x, cfg.norm_eps)
    tp = comm.model_axis()
    hin = h if tp is None else comm.copy_to(tp, h)
    y, aux = None, None
    if "moe" in lp:
        if decode:
            y = moe.moe_decode(lp["moe"], hin, top_k=cfg.moe_top_k)
        else:
            # the router reads h before copy_to (moe.moe_fwd)
            y, aux = moe.moe_fwd(lp["moe"], hin, top_k=cfg.moe_top_k,
                                 group_size=cfg.moe_group_size,
                                 capacity_factor=cfg.moe_capacity_factor,
                                 data=comm.data_axis() if train else None,
                                 route=h)
    if "mlp" in lp:
        m = layers.mlp_fwd(lp["mlp"], hin)
        y = m if y is None else y + m
    if tp is not None:
        y = comm.reduce_from(tp, y).to(x.dtype)
    return x + y, aux


def _run_cached(params, cfg: ArchConfig, x, caches, mode: str,
                valid_len=None):
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
                tp = comm.model_axis()
                if tp is not None:
                    mix = tp.all_reduce(mix).to(x.dtype)
                # the layer's new cache into its slice of the stacked
                # buffers (a no-op where the mixer updated it in place)
                copy_leaves(c, nc)
                x, _ = _ffn_fwd(cfg, lp, x + mix,
                                decode=(mode == "decode"))
    return x, caches


def _embed(params, cfg, tokens, embeds):
    x = embeds if embeds is not None else layers.embed_fwd(params["embed"],
                                                           tokens)
    return x.to(_device.dtype(cfg.act_dtype))


def _local_logits(params, cfg: ArchConfig, h):
    """fp32 logits of this rank's vocab block on a model axis (a
    column-parallel projection), of the whole vocabulary off one."""
    tp = comm.model_axis()
    if tp is not None:
        h = comm.copy_to(tp, h)
    if cfg.tie_embeddings:
        return layers.logits_fwd(params["embed"], h)
    return layers.logits_matmul(h, params["lm_head"]["w"])


def _logits(params, cfg: ArchConfig, h):
    """fp32 logits over the whole vocabulary: on a model axis each rank's
    vocab block, gathered (every rank samples from the whole)."""
    out = _local_logits(params, cfg, h)
    tp = comm.model_axis()
    return out if tp is None else comm.gather_from(tp, out, out.dim() - 1)


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
    (n, B) per row (a 0 entry is an exact no-op chunk).  Returns caches."""
    xs = tokens if tokens is not None else embeds
    for i in range(xs.shape[1]):
        vl = None if valid_lens is None else valid_lens[i]
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
        vl = _device.as_int(valid_len, torch.int64, x.device)
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


def _commit_where(emit, run, com):
    """``com = where(emit, run, com)`` leaf by leaf, in place; ``emit`` is
    (B,) over the slot axis (axis 1 of every stacked leaf)."""
    for r, c in zip(leaves(run), leaves(com)):
        m = emit.reshape((1, emit.shape[0]) + (1,) * (r.ndim - 2))
        torch.where(m, r, c, out=c)


def verify_steps(params, cfg: ArchConfig, draft_params, draft_cfg, tokens,
                 drafts, caches, draft_caches, run, draft_run, sampler,
                 sample_fn):
    """Speculative verify: score K drafted tokens per slot with the target
    and commit each slot's state only through the tokens it emits.

    K+1 teacher-forced ``decode_step`` positions feed the slot's last
    emitted token, then its K drafts: the arithmetic of plain decode, so
    every emitted token and the state it leaves are bitwise plain
    decode's.  Position j samples with ``sample_fn(sampler, logits,
    active)`` (``sampling.sample_where``: only active rows advance their
    key), and a slot keeps accepting while its sample equals the draft it
    feeds next.  A slot emits 1..K+1 tokens, none if it entered done.

    The port's decode updates caches in place, so the run-ahead cannot
    happen in the committed trees: ``run`` / ``draft_run`` (the
    executor's checkpoint buffers) get a copy of ``caches`` /
    ``draft_caches`` first, every position decodes in them, and
    ``caches`` / ``draft_caches`` take the run-ahead state with a
    ``where`` at each position where the slot is active.  A slot whose
    draft is rejected at once ends the tick with the state of one plain
    decode step; a slot done at entry keeps its committed state bitwise.
    Bytes per tick and tree: one copy of the state (read and write), then
    per position the decode's own state read and write plus the commit's
    two reads and one write.

    tokens: (B,) int32; drafts: (K, B) int32 (K may be 0: one position).
    Returns ``(toks (K+1, B), valid (K+1, B), last tokens (B,), caches,
    draft_caches, run, draft_run, sampler)``."""
    tokens = tokens.to(torch.int32)
    drafts = drafts.to(torch.int32)
    inp = torch.cat([tokens[None], drafts], dim=0)
    nxt = torch.cat([drafts, torch.full_like(tokens[None], -1)], dim=0)
    copy_leaves(run, caches)
    copy_leaves(draft_run, draft_caches)
    acc = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    last = tokens
    toks, valid = [], []
    for j in range(inp.shape[0]):
        active = acc & ~sampler["done"]
        logits, _ = decode_step(params, cfg, inp[j], run)
        decode_step(draft_params, draft_cfg, inp[j], draft_run)
        tok, sampler = sample_fn(sampler, logits, active)
        tok = torch.where(active, tok.to(torch.int32), last)
        _commit_where(active, run, caches)
        _commit_where(active, draft_run, draft_caches)
        # stop at the first mismatch, and at EOS / budget exhaustion even
        # when the draft guessed the EOS token
        acc = active & (tok == nxt[j]) & ~sampler["done"]
        last = tok
        toks.append(tok)
        valid.append(active)
    return (torch.stack(toks), torch.stack(valid), last, caches,
            draft_caches, run, draft_run, sampler)
