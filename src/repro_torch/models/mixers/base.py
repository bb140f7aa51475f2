"""SequenceMixer protocol + declarative persistent-state cache specs.

The port's counterpart of ``repro.models.mixers.base``.  A mixer kind is one
class implementing

  init_params(generator, cfg, dtype, device, reps) -> stacked parameter dict
  train(params, cfg, x)                            -> (B, T, d) mixed output
  prefill(params, cfg, x, cache)                   -> ((B, T, d), cache)
  prefill_chunk(params, cfg, x, cache, valid_len)  -> ((B, C, d), cache)
  decode(params, cfg, x_t, cache)                  -> ((B, d), cache)
  cache_spec(cfg, batch, max_len)                  -> CacheSpec
  checkpoint_spec(cfg, batch, max_len)             -> CacheSpec
  param_count(cfg)                                 -> parameters per layer

plus the declarative class attributes the serving executor consumes
(``kind``, ``is_attention``, ``quadratic``, ``state_passes``,
``supports_ragged_prefill``, ``supports_batched_ragged_prefill``).  On a
mesh's "model" axis every kind's ``train``, like its serving paths, runs
on this rank's shards (heads, ``d_state`` slice or width slice) and
returns a partial sum of its output.  Caches returned by
``prefill*``/``decode`` may share storage with the cache passed in (the
GDN kernels update the state in place); callers write them back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch import device as _device
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Shape/dtype/role of one cache leaf (role: "state" | "window" |
    "meta", as in the reference)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    role: str = "state"

    @property
    def nbytes(self) -> int:
        return int(math.prod(self.shape)) * self.dtype.itemsize

    def stack(self, reps: int) -> "ArraySpec":
        return ArraySpec((reps,) + tuple(self.shape), self.dtype, self.role)


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """A tree of ArraySpec leaves mirroring the runtime cache structure."""
    tree: Any

    def leaves(self):
        return [l for l in leaves(self.tree) if isinstance(l, ArraySpec)]

    def zeros(self, device=None):
        """Materialize the cache buffers this spec describes on ``device``
        (all-zero init is part of the contract: slot admit may skip
        clearing freed slots)."""
        dev = _device.resolve(device)
        return tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
            self.tree)

    def stack(self, reps: int) -> "CacheSpec":
        """Add a leading layer-stack dim to every leaf."""
        return CacheSpec(tree_map(lambda s: s.stack(reps), self.tree))

    def _role_bytes(self, role: str) -> int:
        return sum(l.nbytes for l in self.leaves() if l.role == role)

    @property
    def state_bytes(self) -> int:
        return self._role_bytes("state")

    @property
    def window_bytes(self) -> int:
        return self._role_bytes("window")

    @property
    def nbytes(self) -> int:
        return sum(l.nbytes for l in self.leaves())


class SequenceMixer:
    """Base class for registered mixer kinds."""

    kind: str = ""
    is_attention: bool = False
    quadratic: bool = False
    state_passes: int = 2
    supports_ragged_prefill: bool = False
    supports_batched_ragged_prefill: bool = False

    @classmethod
    def init_params(cls, generator, cfg, dtype, device, reps: int):
        raise NotImplementedError(cls.kind)

    @classmethod
    def train(cls, params, cfg, x):
        raise NotImplementedError(
            f"mixer kind {cls.kind!r} has no training path")

    @classmethod
    def prefill(cls, params, cfg, x, cache):
        raise NotImplementedError(cls.kind)

    @classmethod
    def prefill_chunk(cls, params, cfg, x, cache, valid_len=None):
        """Process one prompt chunk continuing from ``cache``; default
        ``prefill`` (right for position-independent recurrent kinds).  A
        ragged chunk (``valid_len`` set) is rejected unless the kind
        overrides this, exactly as in the reference."""
        if valid_len is not None:
            raise NotImplementedError(
                f"mixer kind {cls.kind!r} does not support ragged "
                f"(valid_len-masked) prefill chunks — override "
                f"prefill_chunk to mask padded positions")
        return cls.prefill(params, cfg, x, cache)

    @classmethod
    def decode(cls, params, cfg, x_t, cache):
        raise NotImplementedError(cls.kind)

    @classmethod
    def cache_spec(cls, cfg, batch: int, max_len: int) -> CacheSpec:
        raise NotImplementedError(cls.kind)

    @classmethod
    def checkpoint_spec(cls, cfg, batch: int, max_len: int) -> CacheSpec:
        """Per-slot rollback image of speculative decode: the buffer the
        verify runs ahead in while the committed state stays put.  Default:
        the full ``cache_spec`` (decode overwrites every leaf; a rolling
        KV insert destroys the wrapped position).  A narrower spec must
        keep the tree structure of ``cache_spec``: the verify commits leaf
        by leaf."""
        return cls.cache_spec(cfg, batch, max_len)

    @classmethod
    def param_count(cls, cfg) -> int:
        """Mixer parameter count per layer (sharding/footprint planning)."""
        raise NotImplementedError(cls.kind)


def state_dtype(cfg) -> torch.dtype:
    return _device.dtype(cfg.state_dtype)
