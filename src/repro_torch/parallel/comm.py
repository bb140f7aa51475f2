"""Collectives over one rank's mesh axes (the port's stand-in for the
communication GSPMD inserts into the reference's sharded programs).

The port is multi-controller SPMD: one process per mesh device, each
holding its local shards and calling the same programs.  ``Axis`` is one
mesh axis as this rank sees it (its process group, size and coordinate)
with the three collectives the port issues, all in a fixed order so that
every rank of an axis computes the same bits:

  * ``all_gather(t, dim)``: the ranks' tensors concatenated along ``dim``
    in axis order (``all_gather_cat``: several tensors, each along its own
    dim, in one collective);
  * ``all_reduce(t)``: the sum of the ranks' tensors, added in axis order
    in fp32 (floats) and cast back — a gather then a local sum, so the
    order is fixed whatever the backend;
  * ``broadcast(t, src)``: ``t`` from axis coordinate ``src``.

On NCCL the collectives run on the device and can be captured in a CUDA
graph (they are issued at every axis size, 1 included).  Gloo has no
collectives on CUDA tensors beyond ``all_reduce`` and ``broadcast``, so a
gloo axis stages a CUDA tensor through host memory (a device sync: such
runs are eager); on CPU tensors it runs gloo directly, with no sync.

``use(mesh_axes)`` makes a mesh the active one for the model code
(``model_axis()``): the executor enters it around every program.
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

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
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

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        parts = self.all_gather(t[None], 0).unbind(0)
        if self.size == 1:                  # the one rank's own bits
            return parts[0]
        if not t.is_floating_point():
            out = parts[0]
            for p in parts[1:]:
                out = out + p
            return out
        out = parts[0].float()
        for p in parts[1:]:
            out = out + p.float()
        return out.to(t.dtype)

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` (every rank's buffer of one shape) from coordinate
        ``src``, in place; returns ``t``."""
        t0 = time.perf_counter()
        buf = t.view(torch.uint8) if t.dtype == torch.bool else t
        host = buf.cpu() if self._staged(buf) else buf
        dist.broadcast(host, src=dist.get_global_rank(self.group, src),
                       group=self.group)
        if host is not buf:
            buf.copy_(host)
        self._count(t0, t)
        return t


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


def model_axis() -> Optional[Axis]:
    """The active mesh's "model" axis, or None outside a mesh."""
    axes = _ACTIVE.get()
    return None if axes is None else axes.model
