"""CUDA graphs of the executor's programs (the port's form of the
reference's jitted programs, ``repro.serving.executor._jit``).

A ``Program`` is a fixed-shape function of no arguments over static
device buffers: it reads its inputs from buffers the executor fills
before the call and writes its results into buffers the executor owns.
On the card it runs eagerly on its first call (which does the real work
and warms cuBLAS and the kernels' libraries), is captured into a
``torch.cuda.CUDAGraph`` on its second and replayed from then on.  Capture
runs no kernel, so no state advances twice.  Without a pool it runs
eagerly on every call (the CPU, and ``cuda_graphs=False`` on the card).
A capture or replay that fails raises; nothing falls back to the eager
path.

All graphs of one executor share one memory pool: they replay one after
another on one stream, and no graph's output is read after another graph
has replayed (the decode tokens are read at once; every other result is
copied into the executor's buffers inside the graph).

The kernels' ``launches`` counters are Python integers bumped by each
wrapper when it launches.  A replay runs no wrapper, so each graph keeps
the counts its capture made and adds them on every replay; the capture
itself counts nothing.
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels import attn_decode, flash_attn, gdn_decode, \
    gdn_prefill

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
    """One executor program: eager, or captured once and replayed."""

    def __init__(self, fn: Callable, pool=None):
        self.fn = fn
        self.pool = pool
        self.calls = 0
        self.graph = None
        self.out = None
        self.launches: Counts = {}     # launches one replay makes

    def __call__(self):
        self.calls += 1
        if self.pool is None or self.calls == 1:
            return self.fn()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        add_launches(self.launches)
        return self.out

    def _capture(self):
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        # A dropped engine's programs and executor form reference cycles
        # (each program's function holds the executor), which only the
        # collector frees; freeing their graphs during this capture
        # invalidates it.  So collect first, and not while capturing.
        gc.collect()
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                out = self.fn()
        finally:
            if gc_was_on:
                gc.enable()
            after = launch_counts()
            delta = {k: after[k] - before[k] for k in after}
            add_launches(delta, -1)        # the capture launched nothing
        self.launches = {k: n for k, n in delta.items() if n}
        self.graph, self.out = graph, out
