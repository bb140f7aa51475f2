"""Numpy bridge between the reference's trees and the port's.

The reference's params, caches, sampler state and training state
(``{"params", "opt": {"mu", "count"}, "step"}``, the per-parameter moment
dicts and the int32 scalars included) convert to numpy with
``jax.tree.map(np.asarray, tree)`` (done by the caller — this module never
imports jax).  ``to_torch`` turns such a numpy tree into the port's tree on
a device, keeping the nesting of ``lm.init_lm``/``lm.init_caches`` (dicts,
lists of per-group lists, stacked leaves); the reference's ``GDNState``,
``KVCache``, ``SSMState`` and ``RGLRUState`` NamedTuples become the port's
own NamedTuples of the same name.
``to_numpy`` is the inverse.  Both are bitwise.

Dtype mapping: float32/int32/bool map to themselves; bfloat16 (numpy's
``ml_dtypes`` extension type) is carried bit for bit through int16; uint32
(PRNG keys) becomes int64 holding the same values, the port's key
representation (``serving.sampling``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import KVCache
from repro_torch.models.gdn_layer import GDNState
from repro_torch.models.rglru import RGLRUState
from repro_torch.models.ssm import SSMState

NAMEDTUPLES = {"GDNState": GDNState, "KVCache": KVCache,
               "SSMState": SSMState, "RGLRUState": RGLRUState}


def _leaf_to_torch(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.astype(np.int64)).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _leaf_to_numpy(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(tree, device="cpu"):
    """Numpy tree (from the reference) -> the port's torch tree."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = NAMEDTUPLES.get(type(tree).__name__)
        if cls is None:
            raise TypeError(f"no port counterpart for {type(tree).__name__}")
        return cls(*(to_torch(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    return _leaf_to_torch(tree, device)


def to_numpy(tree):
    """The port's torch tree -> numpy tree (NamedTuples stay the port's)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return _leaf_to_numpy(tree)
