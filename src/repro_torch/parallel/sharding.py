"""Sharding rules: params / batches / decode caches -> partition specs (port
of ``repro.parallel.sharding``), and the cut of a full tensor into one
rank's shard and its inverse.

Axes:
  * batch (DP)        -> ("pod", "data") when the pod axis exists
  * tensor (TP/EP)    -> "model"   (attention & GDN heads, FFN hidden,
                                    MoE experts, vocab)
  * FSDP/ZeRO         -> "data" additionally shards the non-model dim of
                          every large matrix + optimizer moments (see
                          ``needs_fsdp``)

Decode caches: batch on DP when it covers the axis; otherwise the *context*
dim is sharded on "model" (flash-decode split-K: each device scans a slice
of the KV cache) and linear-state archs shard heads on "model" (the paper's
head parallelism, scaled out).

The rules are pure functions of leaf shapes and of the mesh's axis names
and sizes: ``mesh`` is anything with ``axis_names`` and a ``shape`` mapping
axis name -> size, or a ``torch.distributed.device_mesh.DeviceMesh``
(``mesh_dim_names`` and a shape tuple).  A spec is a ``PartitionSpec``: one
entry per leading dim, an axis name, a tuple of axis names (major first)
or None.  Trees are the port's (dicts, lists, NamedTuples), whose key
paths give the reference's path strings (``path_str``).
"""
from __future__ import annotations

import math
import re
from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.tree import tree_map_with_path


class PartitionSpec:
    """Per-dim mesh axes of one leaf: an axis name, a tuple of axis names
    or None for each leading dim (the dims past its length are
    unsharded).  Not a tuple, so tree helpers treat it as a leaf; it
    compares equal to the tuple of its entries."""

    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self):
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            other = other.axes
        return isinstance(other, tuple) and self.axes == other

    def __hash__(self):
        return hash(self.axes)

    def __repr__(self):
        return f"P{self.axes!r}"


P = PartitionSpec


# ---------------------------------------------------------------- helpers

def _axis_names(mesh):
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of ``mesh``."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(_axis_names(mesh), (int(s) for s in shape)))


def mesh_axis(mesh, name: str) -> bool:
    return name in _axis_names(mesh)


def dp_axes(mesh):
    return ("pod", "data") if mesh_axis(mesh, "pod") else ("data",)


def axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    sizes = mesh_sizes(mesh)
    n = 1
    for a in names:
        n *= sizes[a]
    return n


def path_str(path) -> str:
    """A key path (dict keys, sequence indices, NamedTuple field names) as
    the reference's "/"-joined string, e.g. ``groups/0/1/mixer/wq``."""
    return "/".join(str(p) for p in path)


def fit_spec(spec: P, shape, mesh) -> P:
    """Make a spec valid for the leaf: every annotated dim must divide
    evenly.  Non-dividing axes are dropped; a dropped 'model' (TP) axis is
    re-placed on the last free dim it divides (e.g. head_dim when the head
    count is odd, vocab -> d_model for prime vocabs)."""
    axes = list(spec) + [None] * (len(shape) - len(spec))
    dropped = []
    for i, ax in enumerate(axes):
        if ax is None:
            continue
        if shape[i] % axis_size(mesh, ax) != 0:
            dropped.append(ax)
            axes[i] = None
    for ax in dropped:
        for i in range(len(shape) - 1, -1, -1):
            if axes[i] is None and shape[i] % axis_size(mesh, ax) == 0 \
                    and shape[i] > 1:
                axes[i] = ax
                break
    return P(*axes)


# ---------------------------------------------------------------- params

def param_spec(path: str, shape, fsdp: bool) -> P:
    """Partition spec for one parameter leaf, by key-path pattern."""
    F = "data" if fsdp else None
    M = "model"

    # --- embeddings / head
    if path.endswith("embed/table"):
        return P(M, F)                           # vocab-parallel
    if path.endswith("lm_head/w"):
        return P(F, M)

    # --- norms, scalars, gates
    if re.search(r"(norm\d?|final_norm)/scale", path) or path.endswith("/b"):
        return P(None)
    if re.search(r"(A_log|dt_bias|Lambda|/D)$", path):
        return P(M)

    # --- MoE (expert-parallel on model)
    if "/moe/" in path:
        if path.endswith("router"):
            return P(None, None)
        if path.endswith(("wi_gate", "wi_up")):
            return P(M, F, None)                 # (E, D, F)
        if path.endswith("wo"):
            return P(M, None, F)                 # (E, F, D)

    # --- dense MLP
    if "/mlp/" in path:
        if path.endswith(("wi_gate", "wi_up")):
            return P(F, M)
        if path.endswith("wo"):
            return P(M, F)

    # --- attention / GDN mixers
    if "/mixer/" in path:
        if path.endswith(("wq", "wk", "wv")):
            return P(F, M, None)                 # (D, H, hd): heads on TP
        if path.endswith("wo"):
            return P(M, None, F)                 # (H, hd, D)
        if path.endswith(("w_alpha", "w_beta")):
            return P(F, M)
        # ssm projections
        if path.endswith(("w_z", "w_x")):
            return P(F, M)                       # d_inner on TP
        if path.endswith(("w_B", "w_C")):
            return P(F, None)                    # head-shared: replicated
        if path.endswith("w_dt"):
            return P(F, M)
        if re.search(r"conv_x/w$", path):
            return P(None, M)
        if re.search(r"conv_[BC]/w$", path):
            return P(None, None)
        # rglru: column-parallel gates
        if path.endswith(("in_x", "in_y")):
            return P(F, M)
        if path.endswith(("w_a", "w_x")):
            return P(None, M)
        if re.search(r"conv/w$", path):
            return P(None, M)
        if path.endswith("out"):
            return P(M, F)
        if path.endswith("out_proj"):
            return P(M, F)
    if path.endswith("out_proj"):
        return P(M, F)

    return P()                                   # replicate by default


def check_model_axis(cfg: ArchConfig, model: int, max_len=None):
    """Raise ``ValueError`` where a model axis of ``model`` does not divide
    a dim that the port's model code splits where these rules place
    "model": the vocab, query heads, GDN k/v heads, SSD heads and
    d_state, the RG-LRU width, the MLP's d_ff, the MoE experts and, with
    ``max_len`` (serving), the KV context (``max_len``, a ``swa``
    window's slots).  Where one of these does not divide, the
    reference's ``fit_spec`` moves the axis onto another dim, which the
    model code does not follow (ROADMAP queue 1 item 4e).  The one move
    it follows: KV heads the axis does not divide (MQA) go to head_dim,
    which the axis must then divide."""
    if model == 1:
        return
    kinds = set(cfg.layer_kinds)
    dims = {"vocab": cfg.vocab}
    if kinds & {"attn", "swa"}:
        dims["n_heads"] = cfg.hq_eff
        if cfg.hkv_eff % model:         # fit_spec: onto head_dim
            dims["n_kv_heads or head_dim"] = cfg.head_dim
        if max_len is not None and "attn" in kinds:
            dims["max_len (the KV context)"] = max_len
        if max_len is not None and "swa" in kinds:
            dims["the swa window's KV slots"] = min(cfg.window, max_len)
    if kinds & {"gdn", "gdn_naive"}:
        dims.update(gdn_k_heads=cfg.gdn_k_heads,
                    gdn_v_heads=cfg.gdn_v_heads)
    if "ssm" in kinds:
        dims.update(ssm_heads=cfg.ssm_d_inner // cfg.ssm_headdim,
                    ssm_d_state=cfg.ssm_d_state)
    if "rglru" in kinds:
        dims["rglru_width"] = cfg.rglru_width
    if cfg.ffn == "dense":
        dims["d_ff"] = cfg.d_ff
    if cfg.ffn in ("moe", "moe+dense"):
        dims["moe_experts"] = cfg.moe_experts
    if cfg.ffn == "moe+dense":
        dims["d_ff_dense"] = cfg.d_ff_dense or cfg.d_ff
    bad = {k: v for k, v in dims.items() if v % model}
    if bad:
        raise ValueError(
            f"the model axis ({model}) must divide {bad}: the reference's "
            f"fit_spec would move it onto another dim, which the port's "
            f"model code does not follow (ROADMAP queue 1 item 4e)")


def _prepend_stack_dim(spec: P) -> P:
    """Layer-stacked params get a leading (repeats,) dim: unsharded."""
    return P(None, *spec)


def params_specs(cfg: ArchConfig, params_shape, fsdp: bool, mesh):
    """Tree of PartitionSpec matching a params (shape-)tree."""
    def leaf(path, l):
        ps = path_str(path)
        spec = param_spec(ps, l.shape, fsdp)
        if ps.startswith("groups/"):
            spec = _prepend_stack_dim(spec)
        # sanity: never annotate more axes than the leaf has dims
        if len(spec) > len(l.shape):
            spec = P(*list(spec)[: len(l.shape)])
        return fit_spec(spec, l.shape, mesh)
    return tree_map_with_path(leaf, params_shape)


def needs_fsdp(cfg: ArchConfig, mesh, hbm_budget_gb: float = 10.0) -> bool:
    """Shard params/moments over data too when TP alone won't fit HBM:
    bytes/param = 2 (bf16 param) + 2 (bf16 grad) + 10 (the optimizer's
    moments, conservatively), sharded on the model axis only."""
    n_params = estimate_params(cfg)
    per_dev = n_params * (2 + 2 + 10) / axis_size(mesh, "model")
    return per_dev > hbm_budget_gb * 1e9


def estimate_params(cfg: ArchConfig) -> int:
    from repro_torch.models.mixers import get_mixer
    d, V = cfg.d_model, cfg.vocab
    total = V * d * (1 if cfg.tie_embeddings else 2)
    for kind in cfg.layer_kinds:
        total += get_mixer(kind).param_count(cfg)
        if cfg.ffn in ("dense",):
            total += 3 * d * cfg.d_ff
        if cfg.ffn in ("moe", "moe+dense"):
            total += 3 * d * cfg.d_ff * cfg.moe_experts + d * cfg.moe_experts
        if cfg.ffn == "moe+dense":
            total += 3 * d * (cfg.d_ff_dense or cfg.d_ff)
    return int(total)


# ---------------------------------------------------------------- train state

def pspecs_for_opt(p: P) -> P:
    """An optimizer leaf's spec from its parameter's (the reference's
    identity)."""
    return p


def opt_moment_specs(mu_shape, pspecs):
    """Specs of AdamW's per-parameter moments (``opt["mu"]``): ``m``,
    ``v`` and ``ef`` follow their parameter; the factored ``v_row`` and
    ``v_col`` drop the entry of the dim they reduce, so each rank holds
    the rows (columns) of its own block of the parameter.  The
    reference's ``opt_moment_specs`` keeps the spec's leading entries,
    which is the same for ``v_row`` and puts ``v_col``'s last dim under
    the entry of the reduced one (GSPMD reshards it); the port's ranks
    keep the layout their update computes in."""
    def per_param(spec, st):
        # the parameter's dims: a moment's own, or one more than v_row's
        nd = len(st["v_row"].shape) + 1 if "v_row" in st \
            else len(st["v"].shape)
        axes = list(pspecs_for_opt(spec)) + [None] * (nd - len(spec))
        out = {}
        for k in st:
            if k == "v_row":
                out[k] = P(*axes[:nd - 1])
            elif k == "v_col":
                out[k] = P(*(axes[:nd - 2] + axes[nd - 1:]))
            else:
                out[k] = pspecs_for_opt(spec)
        return out

    return map_specs(lambda st, spec: per_param(spec, st), mu_shape, pspecs,
                     is_leaf=lambda x: isinstance(x, dict) and (
                         "v" in x or "v_row" in x))


def train_state_specs(cfg: ArchConfig, state_shape, fsdp: bool, mesh):
    """Specs of the train state ``{"params", "opt": {"mu", "count"},
    "step"}`` (the reference's ``Trainer._shardings``): params by
    ``params_specs``, the moments by ``opt_moment_specs``, the counters
    replicated."""
    pspecs = params_specs(cfg, state_shape["params"], fsdp, mesh)
    return {"params": pspecs,
            "opt": {"mu": opt_moment_specs(state_shape["opt"]["mu"], pspecs),
                    "count": P()},
            "step": P()}


def dim_axes(spec: P, ndim: int):
    """The mesh axis names of each of a leaf's ``ndim`` dims under
    ``spec`` (a tuple per dim, empty where it is not split)."""
    return tuple(_names(spec[d] if d < len(spec) else None)
                 for d in range(ndim))


# ---------------------------------------------------------------- batches

def batch_specs(mesh, batch_shape: dict) -> dict:
    dp = dp_axes(mesh)
    return {k: fit_spec(P(dp, *([None] * (len(v.shape) - 1))), v.shape, mesh)
            for k, v in batch_shape.items()}


# ---------------------------------------------------------------- caches

def cache_specs(cfg: ArchConfig, mesh, caches_shape, batch: int):
    """Decode/prefill cache specs (see the module docstring)."""
    dp = dp_axes(mesh)
    dp_ok = batch % axis_size(mesh, dp) == 0
    BD = dp if dp_ok else None

    def leaf_spec(path, leaf):
        ps = path_str(path)
        nd = len(leaf.shape)            # leading dim = layer-stack repeats
        if ps.endswith("/k") or ps.endswith("/v"):
            # KVCache (R, B, Hkv, S, hd): shard context dim on model
            spec = P(None, BD, None, "model", None)
        elif ps.endswith("length"):
            spec = P(None, BD)
        elif ps.endswith("/S"):
            # linear state (R, B, Hv, dk, dv): heads on model; dk
            # additionally on data at tiny batch
            spec = (P(None, BD, "model", None, None) if dp_ok
                    else P(None, None, "model", "data", None))
        elif ps.endswith("/h"):
            spec = P(None, BD, "model")
        elif "conv" in ps:
            spec = (P(None, BD, None, "model") if nd == 4
                    else P(*([None] * nd)))
        else:
            spec = P(*([None] * nd))
        return fit_spec(spec, leaf.shape, mesh)

    return tree_map_with_path(leaf_spec, caches_shape)


# ---------------------------------------------------------------- serving

def slot_specs(cfg: ArchConfig, mesh, caches_shape, max_slots: int):
    """Serving slot-buffer specs: the engine's cache tree with the slot
    axis (dim 1, after the layer-stack repeats) on "data" and GDN/SSM
    state heads and the attention KV context dim on "model" —
    ``cache_specs`` with batch = slots."""
    return cache_specs(cfg, mesh, caches_shape, max_slots)


def checkpoint_specs(cfg: ArchConfig, mesh, ckpt_shape, max_slots: int):
    """Speculative-decode checkpoint-buffer specs: the rollback image is
    leaf for leaf a slot-cache copy, so it shards under the slot rules and
    the verify's commit between the two trees needs no communication."""
    return cache_specs(cfg, mesh, ckpt_shape, max_slots)


def staging_specs(slot_spec_tree):
    """Staging-buffer specs from the slot specs: the staging tree is the
    same cache layout at slot count 1, so the slot ("data") entry is
    cleared while every other axis keeps its placement — the slot scatter
    moves data only along the slot axis, never resharding heads."""
    def drop_slot(_, spec: P) -> P:
        axes = list(spec)
        if len(axes) > 1:
            axes[1] = None
        return P(*axes)
    return tree_map_with_path(drop_slot, slot_spec_tree)


def sampler_specs(mesh, sampler_shape, max_slots: int):
    """Per-slot sampler arrays ((S,) / (S, 2) leaves): slot axis on the DP
    axes when it divides, replicated otherwise (a PRNG key's lane dim is
    never split)."""
    dp = dp_axes(mesh)
    dp_ok = max_slots % axis_size(mesh, dp) == 0
    return {k: P(dp if dp_ok else None, *([None] * (len(v.shape) - 1)))
            for k, v in sampler_shape.items()}


def token_slot_spec(mesh, max_slots: int) -> P:
    """The (S,) last-token vector: slot axis on DP when it divides."""
    dp = dp_axes(mesh)
    return P(dp) if max_slots % axis_size(mesh, dp) == 0 else P(None)


# ---------------------------------------------------------------- apply

def _names(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_block(spec: P, dim: int, coords: Dict[str, int],
                sizes: Dict[str, int]):
    """(block index, block count) of this rank along ``dim`` of a leaf with
    ``spec``: multi-axis entries are row-major, the first axis major."""
    idx, n = 0, 1
    for a in _names(spec[dim] if dim < len(spec) else None):
        idx = idx * sizes[a] + coords[a]
        n *= sizes[a]
    return idx, n


def local_shard(t: torch.Tensor, spec: P, coords: Dict[str, int],
                sizes: Dict[str, int]) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` (a view): along every
    annotated dim, block ``shard_block`` of ``shape[dim] / count``.
    ``coords`` / ``sizes`` map axis names to this rank's coordinate and
    the axis size."""
    for dim in range(len(spec)):
        idx, n = shard_block(spec, dim, coords, sizes)
        if n > 1:
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"divide into {n} shards ({spec})")
            step = t.shape[dim] // n
            t = t.narrow(dim, idx * step, step)
    return t


def gather_shard(t: torch.Tensor, spec: P, axes) -> torch.Tensor:
    """The inverse of ``local_shard``: all-gather every annotated dim over
    its axes (``axes``: axis name -> ``comm.Axis``), the minor axis of a
    multi-axis entry first.  Every rank of those axes must call it."""
    for dim in range(len(spec)):
        for a in reversed(_names(spec[dim])):
            if axes[a].size > 1:
                t = axes[a].all_gather(t, dim)
    return t


def map_specs(fn, tree, specs, is_leaf=None):
    """``fn(leaf, spec)`` over a tree and its spec tree (same nesting);
    ``is_leaf(node)`` true stops the descent at ``node``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k], is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, x, s, is_leaf)
                            for x, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, x, s, is_leaf)
                          for x, s in zip(tree, specs))
    return fn(tree, specs)


def shard_tree(tree, specs, coords, sizes, full=None):
    """``local_shard`` of every leaf of a full tree (contiguous copies).
    With ``full`` (the tree of the full leaves, e.g. on the meta device) a
    leaf may also come cut already along some of its dims, or all (drawn
    so: ``lm.init_lm(..., mesh=)`` keeps only this rank's experts, whose
    rows FSDP then cuts over "data"): each dim that is whole is cut, each
    that holds this rank's block is kept; a dim of any other size
    raises."""
    if full is None:
        return map_specs(lambda t, s: local_shard(t, s, coords, sizes)
                         .contiguous(), tree, specs)

    def cut(t, spec_shape):
        spec, shape = spec_shape
        want = local_shape(shape, spec, sizes)
        if t.dim() != len(shape) or any(
                n not in (f, w) for n, f, w in zip(t.shape, shape, want)):
            raise ValueError(f"a leaf of {tuple(t.shape)} is neither the "
                             f"full {shape} nor cut to its block under "
                             f"{spec}")
        for dim, (n, w) in enumerate(zip(t.shape, want)):
            if n != w:                    # whole along dim: this block
                idx, _ = shard_block(spec, dim, coords, sizes)
                t = t.narrow(dim, idx * w, w)
        return t.contiguous()
    return map_specs(cut, tree, map_specs(
        lambda f, spec: (spec, tuple(f.shape)), full, specs))


def local_shape(shape, spec: P, sizes: Dict[str, int]):
    """The shape of one rank's block of a leaf of ``shape``."""
    out = list(shape)
    for dim in range(len(spec)):
        n = math.prod(sizes[a] for a in _names(spec[dim]))
        out[dim] //= n
    return tuple(out)
