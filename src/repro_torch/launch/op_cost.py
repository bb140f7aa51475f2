"""Per-rank cost of one step from the ops it dispatches: the port's
counterpart of ``repro.launch.hlo_cost``, which reads the same three
roofline inputs out of the compiled per-device HLO.

``OpCounter`` is a ``TorchDispatchMode``: run a step under it (on the
meta device, ``launch.steps.count_cell``) and it counts, for this rank,

  * flops            — 2 * prod(result dims) * prod(contracting dims) of
                       every matmul-family op (``mm``, ``bmm``, ``addmm``,
                       ``baddbmm``, ``mv``, ``addmv``, ``dot``;
                       ``matmul``, ``einsum`` and ``linear``
                       reach the dispatcher as these).  Elementwise ops
                       are not counted, as in the reference;
  * bytes            — operand plus result bytes of every dispatched op
                       (a result that aliases an operand, an in-place
                       op's, counted once), leaving out the ops that move
                       nothing: views and shape-only ops (the reference's
                       ``_SKIP_BYTES``: bitcast, reshape, ...) and the
                       factories (its broadcast, iota and constants).
                       Eager torch fuses nothing, so this is the unfused
                       traffic of the step: an upper bound, where the
                       reference counts XLA's fusions once each.  A dtype
                       conversion is counted (the reference leaves
                       ``convert`` out as a CPU artifact; eager torch
                       really runs it);
  * collective bytes — the operand bytes of every collective of a
                       ``parallel.comm.DryAxis`` (``record``), by kind
                       and by mesh axis.

Python loops unroll in torch: a layer loop, the chunk loop of a prefill
or the microbatch loop dispatches every iteration, so the reference's
trip-count scaling of while bodies has nothing to do here.

It also tracks the live bytes of the run: the storages made inside it,
each counted from the op that makes it until it is freed, on top of the
step's arguments (``start(args)``), with the peak in ``peak_bytes``.
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# result dims x this many contracting dims of operand ``lhs``: (lhs index
# among the tensor operands, the contracting dim of lhs)
_MATMUL = {
    aten.mm: (0, 1),
    aten.bmm: (0, 2),
    aten.addmm: (1, 1),
    aten.baddbmm: (1, 2),
    aten.mv: (0, 1),
    aten.addmv: (1, 1),
    aten.dot: (0, 0),
}

# ops that move no bytes: shape-only ops and views beside ``is_view``
# (the reference's bitcast / reshape / tuple plumbing), and the factories
# (its broadcast / iota / constant)
_NO_BYTES = {
    aten._unsafe_view, aten.view, aten.reshape, aten.detach, aten.alias,
    aten.lift_fresh, aten.empty, aten.empty_like, aten.empty_strided,
    aten.new_empty, aten.new_empty_strided, aten.zeros, aten.zeros_like,
    aten.new_zeros, aten.ones, aten.ones_like, aten.new_ones, aten.full,
    aten.full_like, aten.new_full, aten.arange, aten.scalar_tensor,
    aten.set_, aten.resize_,
}


def _tensors(tree, out=None):
    """The tensors of nested lists, tuples and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def matmul_flops(packet, tensors, out) -> float:
    """2 * prod(result dims) * prod(contracting dims) of one matmul-family
    op (0 for any other op)."""
    lhs_dim = _MATMUL.get(packet)
    if lhs_dim is None:
        return 0.0
    i, d = lhs_dim
    return 2.0 * out.numel() * tensors[i].shape[d]


class OpCounter(TorchDispatchMode):
    """Counts flops, bytes, collective bytes by kind and live bytes of
    the ops dispatched while it is entered (see the module docstring).
    ``record`` is the ``record`` callback of a ``comm.DryMeshAxes``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {}
        self.by_axis: Dict[str, float] = {}
        self.collective_calls = 0
        self.ops = 0
        self.live = self.peak_bytes = 0
        self._known: Dict[int, int] = {}

    def start(self, args):
        """Count the storages of ``args`` (the step's arguments) as live
        from the start."""
        for t in _tensors(args):
            self._track(t.untyped_storage())

    def record(self, kind: str, nbytes: int, axis: str = ""):
        self.collectives[kind] = self.collectives.get(kind, 0.0) + nbytes
        self.by_axis[axis] = self.by_axis.get(axis, 0.0) + nbytes
        self.collective_calls += 1

    def collective_bytes(self) -> Dict[str, float]:
        """Bytes by kind plus their ``total`` (the reference's dict)."""
        out = dict(self.collectives)
        out["total"] = sum(self.collectives.values())
        return out

    def _forget(self, key: int, nbytes: int):
        self._known.pop(key, None)
        self.live -= nbytes

    def _track(self, storage):
        key = id(storage)
        if key in self._known:
            return
        n = storage.nbytes()
        self._known[key] = n
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(storage, self._forget, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self.ops += 1
        self.flops += matmul_flops(packet, ins, outs[0] if outs else None)
        if not (func.is_view or packet in _NO_BYTES):
            seen = {id(t.untyped_storage()): t for t in ins}
            self.bytes += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs
                if id(t.untyped_storage()) not in seen)
        for t in outs:
            self._track(t.untyped_storage())
        return out


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree``."""
    return sum(_nbytes(t) for t in _tensors(tree))
