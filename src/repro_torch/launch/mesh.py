"""Serving and production meshes over ``torch.distributed`` ranks (port of
``repro.launch.mesh``).

The port is multi-controller: each mesh device is one process (rank), and
a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names=("data", "model")`` (plus a leading ``"pod"`` for the
production mesh) over the first ranks of the default process group.
Every constructor validates the shape first (``validate_mesh_shape``),
before any process group is touched, so a bad shape fails with a
one-line ``ValueError``.

"Devices" are ranks: the world size of a gloo group (CPU ranks, or ranks
that share one card), or the cards ``torch.cuda.device_count()`` shows an
NCCL group, whose ranks each own a card.  ``init_ranks`` starts this
process's rank (``tcp://localhost:<port>``, no cluster discovery); an
NCCL rank ``r`` takes card ``first_card + r``, so several meshes (the
engines behind one router) each take their own slice of the cards.
"""
from __future__ import annotations

import math
import socket
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def visible_devices(backend: Optional[str] = None) -> int:
    """Mesh devices this process can build a mesh over: the cards for
    NCCL, the world size for gloo; 1 before any process group starts."""
    if backend is None:
        if not dist.is_initialized():
            return 1
        backend = dist.get_backend()
    if backend == "nccl":
        return torch.cuda.device_count()
    return dist.get_world_size() if dist.is_initialized() else 1


def validate_mesh_shape(shape: Sequence[int], axes: Sequence[str],
                        *, device_count: Optional[int] = None
                        ) -> Tuple[int, ...]:
    """Check a requested mesh topology before any process group sees it.

    Raises ``ValueError`` when the axis lists mismatch, an axis size is
    not a positive integer, names repeat, or the shape needs more devices
    than are visible.  Returns the shape as a tuple."""
    shape = tuple(shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(
            f"mesh shape {shape} has {len(shape)} axes but names {axes} "
            f"have {len(axes)}")
    for name, size in zip(axes, shape):
        if not isinstance(size, int) or isinstance(size, bool) or size < 1:
            raise ValueError(
                f"mesh axis {name!r} must be a positive int, got {size!r}")
    if len(set(axes)) != len(axes):
        raise ValueError(f"duplicate mesh axis names in {axes}")
    need = math.prod(shape)
    have = visible_devices() if device_count is None else device_count
    if need > have:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {need} devices but only "
            f"{have} are visible — shrink the mesh, or start {need} ranks, "
            f"one per mesh device (the serve CLI's --mesh spawns them; "
            f"otherwise torch.multiprocessing.spawn or torchrun "
            f"--nproc-per-node {need}, each calling init_ranks)")
    return shape


def _device_mesh(shape, axes):
    from torch.distributed.device_mesh import DeviceMesh
    backend = dist.get_backend()
    # a gloo mesh is a CPU mesh even when its ranks share a card: a
    # "cuda" mesh would bind each rank to the card of its index
    device_type = "cuda" if backend == "nccl" else "cpu"
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 devices per pod; multi_pod adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    validate_mesh_shape(shape, axes)
    return _device_mesh(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1):
    """Small mesh over the first ranks (tests / examples)."""
    validate_mesh_shape((data, model), ("data", "model"))
    return _device_mesh((data, model), ("data", "model"))


def make_serving_mesh(data: int = 1, model: int = 1):
    """Serving-engine mesh: slot-axis DP x head/context TP over the first
    ``data * model`` ranks (a rank outside it gets no coordinate)."""
    validate_mesh_shape((data, model), ("data", "model"))
    return _device_mesh((data, model), ("data", "model"))


def free_port() -> int:
    """A free TCP port on localhost for ``init_ranks``."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def host_store(world_size: int, port: Optional[int] = None):
    """A rendezvous store for ``init_ranks(store=)``: rank 0's (``port``
    None) on a port the system picks while binding it, so no other
    process can take the port between its choice and its use; the other
    ranks' connect to its ``port``."""
    if port is None:
        return dist.TCPStore("localhost", 0, world_size, is_master=True,
                             wait_for_workers=False)
    return dist.TCPStore("localhost", port, world_size, is_master=False)


def init_ranks(rank: int, world_size: int, port: int, backend: str, *,
               first_card: int = 0, store=None):
    """Join this process to the default group as ``rank`` of
    ``world_size`` at ``tcp://localhost:<port>``, or through ``store``
    (``host_store``: every rank passes one).  NCCL ranks each own a card,
    card ``first_card + rank``, set before the group starts."""
    if backend == "nccl":
        torch.cuda.set_device(first_card + rank)
    kw = ({"init_method": f"tcp://localhost:{port}"} if store is None
          else {"store": store})
    dist.init_process_group(backend, world_size=world_size, rank=rank, **kw)
