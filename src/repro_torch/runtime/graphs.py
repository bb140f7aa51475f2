"""CUDA graphs of the port's compiled programs (its form of the
reference's jitted functions: the executor's programs,
``repro.serving.executor._jit``, and the trainer's step,
``repro.runtime.trainer``'s ``jax.jit`` of ``step_fn``).

A ``Program`` is a fixed-shape function of no arguments over static
device buffers: it reads its inputs from buffers its owner fills before
the call and writes its results into buffers its owner keeps (or returns
tensors that the next call overwrites).  On the card it runs eagerly on
its first call (which does the real work and warms cuBLAS and the
kernels' libraries), is captured into a ``torch.cuda.CUDAGraph`` on its
second and replayed from then on.  Capture runs no kernel, so no state
advances twice.  Without a pool it runs eagerly on every call (the CPU,
and ``cuda_graphs=False`` on the card).  A capture or replay that fails
raises; nothing falls back to the eager path.

All graphs of one owner share one memory pool: they replay one after
another on one stream, and no graph's output is read after another graph
has replayed (the decode tokens are read at once; every other result is
copied into the executor's buffers inside the graph).

The kernels' ``launches`` counters are Python integers bumped by each
wrapper when it launches.  A replay runs no wrapper, so each graph keeps
the counts its capture made and adds them on every replay; the capture
itself counts nothing.  Mesh collectives (``parallel.comm.stats``) are
kept alike: a capture moves the ones it recorded from ``calls`` to
``captured``, and each replay adds them to ``replayed``.

``capture_s`` is the time of the capture, instantiation included, except
in a program made with ``keep_graph=True``: that one keeps the captured
graph's template in host memory, instantiates it apart
(``instantiate_s``) and lets ``graph_nodes`` count its nodes and
``kernel_names`` name its kernels (diagnostics, off by default).
"""
from __future__ import annotations

import ctypes
import gc
import time
from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels import attn_decode, flash_attn, gdn_decode, \
    gdn_prefill
from repro_torch.parallel import comm

# the kernel modules whose wrappers count their launches
COUNTED = (gdn_decode, gdn_prefill, attn_decode, flash_attn)

Counts = Dict[Tuple[str, str], int]


def launch_counts() -> Counts:
    """Every kernel launch counter, keyed (module, kernel name)."""
    out = {}
    for mod in COUNTED:
        if isinstance(mod.launches, dict):
            for name, n in mod.launches.items():
                out[(mod.__name__, name)] = n
        else:
            out[(mod.__name__, "")] = mod.launches
    return out


def add_launches(delta: Counts, sign: int = 1):
    for mod in COUNTED:
        if isinstance(mod.launches, dict):
            for name in mod.launches:
                mod.launches[name] += sign * delta.get((mod.__name__, name),
                                                       0)
        else:
            mod.launches += sign * delta.get((mod.__name__, ""), 0)


class Program:
    """One compiled program: eager, or captured once and replayed."""

    def __init__(self, fn: Callable, pool=None, keep_graph: bool = False):
        self.fn = fn
        self.pool = pool
        self.keep_graph = keep_graph
        self.calls = 0
        self.graph = None
        self.out = None
        self.launches: Counts = {}     # launches one replay makes
        self.collectives = 0           # collectives one replay runs
        self.capture_s = self.instantiate_s = None

    def __call__(self):
        self.calls += 1
        if self.pool is None or self.calls == 1:
            return self.fn()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        add_launches(self.launches)
        comm.stats["replayed"] += self.collectives
        return self.out

    def _capture(self):
        before = launch_counts()
        calls = comm.stats["calls"]
        graph = torch.cuda.CUDAGraph(keep_graph=self.keep_graph)
        # A dropped engine's programs and executor form reference cycles
        # (each program's function holds the executor), which only the
        # collector frees; freeing their graphs during this capture
        # invalidates it.  So collect first, and not while capturing.
        gc.collect()
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            t0 = time.perf_counter()
            # entering torch.cuda.graph syncs and empties the cache, so the
            # eager first call's cached blocks go back to the device before
            # the pool takes its own
            with torch.cuda.graph(graph, pool=self.pool):
                out = self.fn()
            self.capture_s = time.perf_counter() - t0
            if self.keep_graph:
                t0 = time.perf_counter()
                graph.instantiate()
                self.instantiate_s = time.perf_counter() - t0
        finally:
            if gc_was_on:
                gc.enable()
            after = launch_counts()
            delta = {k: after[k] - before[k] for k in after}
            add_launches(delta, -1)        # the capture launched nothing
            self.collectives = comm.stats["calls"] - calls
            comm.stats["calls"] = calls
            comm.stats["captured"] += self.collectives
        self.launches = {k: n for k, n in delta.items() if n}
        self.graph, self.out = graph, out


_KERNEL_NODE = 0          # CU_GRAPH_NODE_TYPE_KERNEL


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2``."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _ok(err, what):
    if err:
        raise RuntimeError(f"{what} failed: CUresult {err}")


def _kernel_nodes(graph):
    """(libcuda, [(node, is a kernel node)]) of a kept graph."""
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_void_p),
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphGetNodes.restype = cu.cuGraphNodeGetType.restype = ctypes.c_int
    g = graph.raw_cuda_graph()
    n = ctypes.c_size_t(0)
    _ok(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _ok(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind = ctypes.c_int()
    out = []
    for node in nodes:
        _ok(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
            "cuGraphNodeGetType")
        out.append((node, kind.value == _KERNEL_NODE))
    return cu, out


def graph_nodes(graph) -> Tuple[int, int]:
    """(kernel nodes, all nodes) of the graph of a ``Program`` made with
    ``keep_graph=True``, read with libcuda's ``cuGraphGetNodes``."""
    _, nodes = _kernel_nodes(graph)
    return sum(k for _, k in nodes), len(nodes)


def kernel_names(graph) -> Dict[str, int]:
    """{kernel function name: kernel nodes} of a kept graph (the
    kernels every replay launches, counted exactly: the profiler can
    lose a record), from each node's parameters
    (``cuGraphKernelNodeGetParams``) and ``cuFuncGetName`` (or
    ``cuKernelGetName`` for a node that holds a library kernel)."""
    cu, nodes = _kernel_nodes(graph)
    cu.cuGraphKernelNodeGetParams_v2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_KernelNodeParams)]
    for fn in (cu.cuFuncGetName, cu.cuKernelGetName):
        fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    cu.cuGraphKernelNodeGetParams_v2.restype = ctypes.c_int
    params = _KernelNodeParams()
    name = ctypes.c_char_p()
    out: Dict[str, int] = {}
    for node, kernel in nodes:
        if not kernel:
            continue
        _ok(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
            "cuGraphKernelNodeGetParams")
        if params.func:
            _ok(cu.cuFuncGetName(ctypes.byref(name), params.func),
                "cuFuncGetName")
        else:
            _ok(cu.cuKernelGetName(ctypes.byref(name), params.kern),
                "cuKernelGetName")
        key = name.value.decode()
        out[key] = out.get(key, 0) + 1
    return out
