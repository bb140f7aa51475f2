"""Collectives over one rank's mesh axes (the port's stand-in for the
communication GSPMD inserts into the reference's sharded programs).

The port is multi-controller SPMD: one process per mesh device, each
holding its local shards and calling the same programs.  ``Axis`` is one
mesh axis as this rank sees it (its process group, size and coordinate)
with the collectives the port issues, all in a fixed order so that every
rank of an axis computes the same bits:

  * ``all_gather(t, dim)``: the ranks' tensors concatenated along ``dim``
    in axis order (``all_gather_cat``: several tensors, each along its own
    dim, in one collective);
  * ``all_reduce(t)``: the sum of the ranks' tensors, added in axis order
    in fp32 (floats) and cast back — a gather then a local sum, so the
    order is fixed whatever the backend;
  * ``mean_flat(ts, split)``: the mean of a list of tensors, of those in
    ``split`` only this rank's block (a reduce-scatter: an all-to-all of
    the ranks' blocks, then the same sum);
  * ``broadcast(t, src)``: ``t`` from axis coordinate ``src``.

On NCCL the collectives run on the device and can be captured in a CUDA
graph (they are issued at every axis size, 1 included).  Gloo has no
collectives on CUDA tensors beyond ``all_reduce`` and ``broadcast``, so a
gloo axis stages a CUDA tensor through host memory (a device sync: such
runs are eager); on CPU tensors it runs gloo directly, with no sync.  A
gloo axis of one rank issues nothing: its collectives return (a copy of)
the rank's own tensor.

Training differentiates through the collectives: the Megatron pairs are
``torch.autograd.Function``s over an ``Axis`` (``copy_to``: identity
forward, all-reduce backward, before a column-parallel product;
``reduce_from``: the all-reduce forward, identity backward, after a
row-parallel one; ``gather_from``: the all-gather forward, this rank's
block of the gradient backward, summed over the axis first where each
rank's gradient is partial; ``split_to``: this rank's block of a
replicated leaf forward, the ranks' blocks of its gradient gathered
backward, so that the replicated leaf takes its whole gradient on every
rank), and ``mean_over`` averages over an axis both ways (a batch
statistic over "data", a mean square over a dim split on "model").
Outside autograd (``torch.no_grad``, or an input that needs no gradient)
each is its plain collective, so the serving paths run the same calls
bit for bit.  The trainer averages a step's gradients over "data" with
``Axis.mean_flat``.

``use(mesh_axes)`` makes a mesh the active one for the model code
(``model_axis()``, ``data_axis()``): the executor enters it around every
program, the trainer around every step.
``stats`` counts the collectives issued from the host (``calls``, with
the host seconds spent in them and their bytes), and, kept by
``runtime.graphs``, those recorded into a CUDA graph by a capture
(``captured``, not in ``calls``) and those its replays ran
(``replayed``).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

stats = {"calls": 0, "seconds": 0.0, "bytes": 0, "captured": 0,
         "replayed": 0}


def reset_stats():
    stats.update(calls=0, seconds=0.0, bytes=0, captured=0, replayed=0)


class Axis:
    """One mesh axis of this rank: ``group`` (a process group), ``size``,
    ``index`` (this rank's coordinate) and ``backend``."""

    def __init__(self, name: str, group, size: int, index: int,
                 backend: str):
        self.name, self.group, self.size = name, group, size
        self.index, self.backend = index, backend

    @classmethod
    def of(cls, mesh, name: str) -> "Axis":
        group = mesh.get_group(name)
        return cls(name, group, dist.get_world_size(group),
                   mesh.get_local_rank(name), dist.get_backend(group))

    def __repr__(self):
        return (f"Axis({self.name!r}, size={self.size}, index={self.index}, "
                f"{self.backend})")

    def _count(self, t0: float, t: torch.Tensor):
        stats["calls"] += 1
        stats["seconds"] += time.perf_counter() - t0
        stats["bytes"] += t.nbytes

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _alone(self) -> bool:
        """A gloo axis of one rank: its collectives move nothing, so none
        is issued (an NCCL one still issues them, which a CUDA graph
        captures)."""
        return self.size == 1 and self.backend == "gloo"

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if self._alone():
            return t.clone()
        t0 = time.perf_counter()
        src = t.contiguous()
        if src.dtype == torch.bool:
            src = src.view(torch.uint8)
        if self.backend == "nccl":
            out = torch.empty((self.size,) + tuple(src.shape),
                              dtype=src.dtype, device=src.device)
            dist.all_gather_into_tensor(out, src, group=self.group)
            parts = list(out.unbind(0))
        else:
            host = src.cpu() if self._staged(src) else src
            parts = [torch.empty_like(host) for _ in range(self.size)]
            dist.all_gather(parts, host, group=self.group)
            if host is not src:
                parts = [p.to(src.device) for p in parts]
        out = parts[0] if self.size == 1 else torch.cat(parts, dim=dim)
        if t.dtype == torch.bool:
            out = out.view(torch.bool)
        self._count(t0, t)
        return out

    def all_gather_cat(self, ts, dims, lead: int):
        """The whole of each of ``ts`` (every rank's block of it along its
        dim in ``dims``) from one all-gather: the tensors share their
        first ``lead`` dims and dtype, and travel flattened past them."""
        flat = torch.cat([t.reshape(*t.shape[:lead], -1) for t in ts], -1)
        parts = self.all_gather(flat[None], 0).unbind(0)
        out, start = [], 0
        for t, dim in zip(ts, dims):
            n = math.prod(t.shape[lead:])
            out.append(torch.cat([p[..., start:start + n].reshape(t.shape)
                                  for p in parts], dim=dim))
            start += n
        return out

    def local(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's block of ``t`` (whole on every rank) along ``dim``:
        a view."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n)

    def block(self, t: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
        """``t`` cut to this rank's ``n`` entries along ``dim``, unless it
        holds just those already (a leaf the rules shard, where ``t``
        whole is a replicated one)."""
        return t if t.shape[dim] == n else self.local(t, dim)

    def all_reduce(self, t: torch.Tensor, mean: bool = False
                   ) -> torch.Tensor:
        """The ranks' sum of ``t`` (``mean``: divided by the axis size in
        fp32 before the cast back)."""
        parts = self.all_gather(t[None], 0).unbind(0)
        return parts[0] if self.size == 1 else _sum(parts, mean)

    def mean_flat(self, ts, split=None):
        """The mean over the axis of every tensor of ``ts``, from one
        collective or two per dtype: each dtype's tensors travel as one
        flat buffer (a step's gradients are hundreds of leaves, and gloo
        stages each collective through the host).  ``split[i]``, where
        not empty, holds the dims along which this rank keeps only its
        block of tensor ``i`` (an FSDP shard): those blocks come from a
        reduce-scatter (an all-to-all of the ranks' blocks, then the same
        sum in axis order), so a rank receives no more than its blocks.
        Returns the reduced tensors (or blocks) in order."""
        split = split or [()] * len(ts)
        out = [None] * len(ts)
        by_dtype: Dict[torch.dtype, list] = {}
        for i, t in enumerate(ts):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            whole = [i for i in idx if not split[i]]
            if whole:
                red = self.all_reduce(
                    torch.cat([ts[i].reshape(-1) for i in whole]), mean=True)
                _unflatten(red, [ts[i].shape for i in whole], whole, out)
            cut = [i for i in idx if split[i]]
            if cut:
                blocks = [[self._block(ts[i], split[i], r) for i in cut]
                          for r in range(self.size)]
                red = self._reduce_scatter(torch.cat(
                    [b.reshape(-1) for row in blocks for b in row]))
                _unflatten(red, [b.shape for b in blocks[0]], cut, out)
        return out

    def _block(self, t: torch.Tensor, dims, r: int) -> torch.Tensor:
        for d in dims:
            n = t.shape[d] // self.size
            t = t.narrow(d, r * n, n)
        return t

    def _reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of this rank's chunk of ``t`` (the
        ranks' chunks in axis order, equal in size): every rank sends
        chunk r to rank r, which sums what it receives as ``all_reduce``
        does."""
        if self._alone():
            return t.clone()
        t0 = time.perf_counter()
        src = t.contiguous()
        host = src.cpu() if self._staged(src) else src
        got = torch.empty_like(host)
        dist.all_to_all_single(got, host, group=self.group)
        if host is not src:
            got = got.to(src.device)
        self._count(t0, t)
        parts = got.view(self.size, -1).unbind(0)
        return parts[0] if self.size == 1 else _sum(parts, True)

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` (every rank's buffer of one shape) from coordinate
        ``src``, in place; returns ``t``."""
        if self._alone():
            return t
        t0 = time.perf_counter()
        buf = t.view(torch.uint8) if t.dtype == torch.bool else t
        host = buf.cpu() if self._staged(buf) else buf
        dist.broadcast(host, src=dist.get_global_rank(self.group, src),
                       group=self.group)
        if host is not buf:
            buf.copy_(host)
        self._count(t0, t)
        return t


def _sum(parts, mean: bool) -> torch.Tensor:
    """The sum of ``parts`` in order, in fp32 for floats and cast back
    (``mean``: divided by their number before the cast)."""
    n = len(parts)
    if not parts[0].is_floating_point():
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out // n if mean else out
    out = parts[0].float()
    for p in parts[1:]:
        out = out + p.float()
    return (out / n if mean else out).to(parts[0].dtype)


def _unflatten(flat, shapes, idx, out):
    """``out[i]`` for ``i`` in ``idx``: views of ``flat``'s consecutive
    runs in ``shapes``."""
    start = 0
    for i, shape in zip(idx, shapes):
        n = math.prod(shape)
        out[i] = flat[start:start + n].view(shape)
        start += n


# ------------------------------------------------- differentiable collectives

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.axis.all_reduce(g)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x, dim, partial):
        ctx.axis, ctx.dim, ctx.partial = axis, dim, partial
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = ctx.axis.all_reduce(g)
        return None, ctx.axis.local(g, ctx.dim).contiguous(), None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.local(x, dim)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.axis.all_gather(g.contiguous(), ctx.dim), None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x):
        ctx.axis = axis
        return axis.all_reduce(x, mean=True)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.axis.all_reduce(g, mean=True)


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to(axis: Axis, x: torch.Tensor) -> torch.Tensor:
    """``x`` (replicated over ``axis``) into a column-parallel product:
    identity forward, the gradient all-reduced over ``axis``."""
    return _CopyTo.apply(axis, x) if _tracked(x) else x


def reduce_from(axis: Axis, x: torch.Tensor) -> torch.Tensor:
    """The row-parallel partial sums ``x`` all-reduced over ``axis``; the
    gradient passes unchanged (every rank's loss is the same)."""
    return _ReduceFrom.apply(axis, x) if _tracked(x) else axis.all_reduce(x)


def gather_from(axis: Axis, x: torch.Tensor, dim: int,
                partial: bool = False) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim``; the
    gradient is this rank's block of the gradient, which every rank holds
    whole (the logits' loss), or, with ``partial`` (the gathered tensor
    feeds only this rank's heads), of its sum over the axis."""
    dim = dim % x.dim()
    return (_GatherFrom.apply(axis, x, dim, partial) if _tracked(x)
            else axis.all_gather(x, dim))


def split_to(axis: Axis, x: torch.Tensor, n: int,
             dim: int = -1) -> torch.Tensor:
    """``axis.block(x, n, dim)``: a replicated ``x`` cut to this rank's
    ``n`` entries along ``dim`` (``x`` itself where it holds just those, a
    leaf the rules shard).  The gradient of a cut ``x`` is the ranks'
    blocks of it gathered in axis order: each rank's block gets only this
    rank's part, and every rank's replicated leaf takes the whole, the
    same bits on each."""
    dim = dim % x.dim()
    if x.shape[dim] == n:
        return x
    return _SplitTo.apply(axis, x, dim) if _tracked(x) \
        else axis.local(x, dim)


def mean_over(axis: Axis, x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``axis``, and of its gradient:
    a batch statistic over the data axis (each rank's loss counts once in
    the data-parallel mean of the gradients), or a mean over a dim that
    the model axis splits (each rank's gradient of the mean is the part of
    its own slice's outputs).  Bitwise ``all_reduce(x) / size`` in fp32."""
    return _MeanOver.apply(axis, x) if _tracked(x) \
        else axis.all_reduce(x, mean=True)


class MeshAxes:
    """This rank's view of a ``DeviceMesh``: an ``Axis`` per dim name, its
    coordinates and the axis sizes."""

    def __init__(self, mesh):
        if mesh.get_coordinate() is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                             f"{mesh}")
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.axes: Dict[str, Axis] = {n: Axis.of(mesh, n)
                                      for n in self.names}
        self.sizes = {n: a.size for n, a in self.axes.items()}
        self.coords = {n: a.index for n, a in self.axes.items()}

    @property
    def data(self) -> Axis:
        return self.axes["data"]

    @property
    def model(self) -> Axis:
        return self.axes["model"]


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def use(axes: Optional[MeshAxes]):
    """Run the enclosed model code on ``axes``'s shards (None: unsharded)."""
    token = _ACTIVE.set(axes)
    try:
        yield axes
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[MeshAxes]:
    """The active mesh (None outside one).  Code that autograd runs again
    in the backward pass (``torch.utils.checkpoint``'s recompute, on the
    engine's device thread, which does not see this context) re-enters
    it with ``use(active())`` captured at the forward."""
    return _ACTIVE.get()


def model_axis() -> Optional[Axis]:
    """The active mesh's "model" axis, or None outside a mesh."""
    axes = _ACTIVE.get()
    return None if axes is None else axes.model


def data_axis() -> Optional[Axis]:
    """The active mesh's "data" axis, or None outside a mesh."""
    axes = _ACTIVE.get()
    return None if axes is None else axes.data
