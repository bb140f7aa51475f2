"""Mixture-of-Experts FFN (port of ``repro.models.moe``).

Top-k softmax router with GShard/Switch capacity dispatch at prefill and
in training: tokens are processed in groups of ``group_size`` with a
per-group expert capacity C = group_size * k * cf / E, dispatched and
combined by one-hot (G, S, E, C) products; a slot past its expert's
capacity is dropped.  Decode runs the dense all-expert product (every
expert on every row, each weighted by its renormalised gate).  The
Switch load-balancing auxiliary loss comes with the capacity path.

As in the reference, each expert product takes its operands in the
activation dtype and keeps an fp32 result: ``h`` and ``u`` stay fp32
through the SiLU, ``silu(h) * u`` and the output of ``wo`` are cast back
(``layers.bmm_f32``).  The top-k is a stable descending sort, so ties go
to the lower expert index as ``jax.lax.top_k``'s do (``torch.topk``
breaks them otherwise; an all-zero hidden row gives an all-equal
softmax).  Every shape, the capacity included, is host arithmetic on
static shapes and the one-hots compare with an ``arange``, so the path
reads nothing on the host and can be captured in a CUDA graph.

On a mesh's "model" axis (``parallel.comm.model_axis()``) the experts are
sharded (expert parallelism, the reference's rules): each rank holds E/M
of them and the whole router, so every rank routes every token alike,
computes the capacity positions over all E experts (the cumsum needs
them), then keeps the dispatch, combine and gate columns of its own
experts.  Its output is a partial sum that the LM's FFN all-reduce adds
up (with arctic's row-parallel dense MLP in the same reduction).  A
decode step reads only this rank's expert weights.

In training on a mesh (``data``, the active "data" axis) the capacity
groups and the load-balancing statistics are the reference's over the
global batch, whose rows the data ranks hold in order: ``me`` and ``ce``
are averaged over the axis (``comm.mean_over``), and a group of
``S = min(group_size, global tokens)`` tokens that spans several ranks
takes its queue positions from the routing indices of every rank it
spans, gathered over the axis (small int tensors), each rank keeping its
own rows.  The model axis (expert parallelism) does not train yet
(``check_train_model_axis``).

Parameters are stacked (reps, ...) like every leaf of the port:
``router`` fp32 (d, E); ``wi_gate``, ``wi_up`` (E, d, f) and ``wo``
(E, f, d) in the activation dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.mixers.base import TRAIN_MODEL_AXIS_ITEM
from repro_torch.parallel import comm


def check_train_model_axis(model: int):
    """Raise on a model axis larger than 1 in training (expert
    parallelism's backward is not ported)."""
    if model > 1:
        raise NotImplementedError(
            f"training the MoE FFN on a model axis of {model} (expert "
            f"parallelism) is not ported: {TRAIN_MODEL_AXIS_ITEM}")


def _draw_experts(generator, shape, std, dtype, device, keep=None):
    """N(0, std^2) expert matrices of ``shape`` (reps, E, d_in, d_out) in
    ``dtype``, drawn one (d_in, d_out) matrix at a time into the
    preallocated leaf: the fp32 transient stays at one matrix, where a
    whole stacked leaf drawn in fp32 would be 30-36 GB at full width.
    ``keep`` (a range of experts) keeps only those, every matrix drawn all
    the same (a mesh rank's experts, the one-device draw's values).  A
    leaf on the ``meta`` device holds no values: nothing is drawn."""
    keep = range(shape[1]) if keep is None else keep
    out = torch.empty((shape[0], len(keep)) + tuple(shape[2:]), dtype=dtype,
                      device=device)
    if out.is_meta:
        return out
    for r in range(shape[0]):
        for e in range(shape[1]):
            m = layers.randn(generator, shape[2:], std, torch.float32, device)
            if e in keep:
                out[r, e - keep.start].copy_(m)
    return out


def init_moe(generator, d_model, d_ff, n_experts, dtype, device, reps,
             experts=None):
    """The router and the experts' SwiGLU weights (``experts``: the range
    of experts to keep, all by default)."""
    s, sf = d_model ** -0.5, d_ff ** -0.5
    return {
        "router": layers.randn(generator, (reps, d_model, n_experts), s,
                               torch.float32, device),
        "wi_gate": _draw_experts(generator, (reps, n_experts, d_model, d_ff),
                                 s, dtype, device, experts),
        "wi_up": _draw_experts(generator, (reps, n_experts, d_model, d_ff),
                               s, dtype, device, experts),
        "wo": _draw_experts(generator, (reps, n_experts, d_ff, d_model), sf,
                            dtype, device, experts),
    }


def one_hot(idx, n, dtype):
    """``F.one_hot(idx, n)`` in ``dtype`` from a comparison with an
    ``arange`` (no host read); an index >= n gives an all-zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def select_top_k(probs, k):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x, router, k):
    """fp32 router softmax, top-k and the renormalised gates."""
    probs = torch.softmax(torch.matmul(x.float(), router), dim=-1)
    gate, idx = select_top_k(probs, k)
    gate = gate / torch.clamp(torch.sum(gate, -1, keepdim=True), min=1e-9)
    return probs, gate, idx


def _experts(p, xe, dtype):
    """The SwiGLU of every expert on its rows: xe (E, M, d) -> (E, M, d)
    in ``dtype``, each product with an fp32 result."""
    h = layers.bmm_f32(xe, p["wi_gate"])
    u = layers.bmm_f32(xe, p["wi_up"])
    hh = (F.silu(h) * u).to(dtype)
    return layers.bmm_f32(hh, p["wo"]).to(dtype)


def _queue_positions(idx, E):
    """Queue position of each (token, slot) within its expert, per group,
    token-major and slot-minor: idx (G, S, k) -> (G, S, k)."""
    G, S, k = idx.shape
    flat = one_hot(idx, E, torch.int64).reshape(G, S * k, E)
    pos = torch.cumsum(flat, dim=1) - 1
    return torch.sum(pos * flat, dim=-1).reshape(G, S, k)


def moe_fwd(p, x, *, top_k=2, capacity_factor=1.25, group_size=1024,
            data=None):
    """x: (B, T, d) -> (y (B, T, d), aux_loss 0-d fp32).  ``data``: the
    training mesh's "data" axis, whose ranks hold the global batch's rows
    in order (module docstring)."""
    B, T, d = x.shape
    E = p["router"].shape[-1]
    N = B * T
    D = 1 if data is None else data.size
    S = min(group_size, N * D)
    if (N * D) % S:
        raise ValueError(f"{N * D} tokens do not split into groups of {S}")
    span = max(1, S // N)            # data ranks one group spans
    if N % S if span == 1 else S % N:
        raise ValueError(f"groups of {S} tokens straddle the data ranks' "
                         f"{N}-token blocks")
    G = N // S if span == 1 else 1
    C = max(1, int(S * top_k * capacity_factor / E))

    xf = x.reshape(G, min(S, N), d)
    probs, gate, idx = _route(xf, p["router"], top_k)          # (G, S, k)

    # ----- load-balancing aux loss (Switch-style), over the global batch
    me = torch.mean(probs, dim=(0, 1))                         # (E,)
    ce = torch.mean(one_hot(idx[..., 0], E, torch.float32), dim=(0, 1))
    if data is not None:
        me, ce = comm.mean_over(data, torch.stack([me, ce])).unbind(0)
    aux = E * torch.sum(me * ce)

    if span == 1:
        pos = _queue_positions(idx, E)
    else:
        # this rank's rows of a group spanning ``span`` ranks: the
        # positions over the whole group, from every rank's indices
        first = data.index // span * span
        grp = data.all_gather(idx, 1)[:, first * N:(first + span) * N]
        pos = _queue_positions(grp, E)[:, (data.index - first) * N:
                                       (data.index - first + 1) * N]
    oh = one_hot(idx, E, torch.int64)                          # (G, S, k, E)
    keep = pos < C
    gate_kept = gate * keep

    # dispatch and combine masks folded over k: (G, S, E, C); a dropped
    # slot's position one-hot is all zero
    pos_oh = one_hot(pos, C, x.dtype)                          # (G, S, k, C)
    ohx = oh.to(x.dtype)
    disp = torch.einsum("gske,gskc->gsec", ohx, pos_oh)
    comb = torch.einsum("gske,gskc->gsec",
                        ohx * gate_kept.to(x.dtype)[..., None], pos_oh)

    El = p["wi_gate"].shape[0]
    if El != E:                      # this rank's experts (on a mesh)
        disp, comb = (comm.model_axis().local(t, 2) for t in (disp, comb))
    xe = torch.einsum("gsec,gsd->egcd", disp, xf).reshape(El, G * C, d)
    ye = _experts(p, xe, x.dtype).reshape(El, G, C, d)
    y = torch.einsum("gsec,egcd->gsd", comb, ye)
    return y.reshape(B, T, d), aux


def moe_decode(p, x_t, *, top_k=2):
    """Single-token-per-sequence MoE: every expert on every row, weighted
    by the row's renormalised top-k gates. x_t: (B, d)."""
    B, d = x_t.shape
    E = p["router"].shape[-1]
    _, gate, idx = _route(x_t, p["router"], top_k)             # (B, k)
    w = torch.einsum("bke,bk->be", one_hot(idx, E, x_t.dtype),
                     gate.to(x_t.dtype))
    El = p["wi_gate"].shape[0]
    if El != E:                      # this rank's experts (on a mesh)
        w = comm.model_axis().local(w, 1)
    ye = _experts(p, x_t.expand(El, B, d), x_t.dtype)          # (El, B, d)
    return torch.einsum("ebd,be->bd", ye, w)
