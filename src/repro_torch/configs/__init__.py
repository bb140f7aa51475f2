"""Architecture registry of the PyTorch port.

Only architectures whose every mixer kind and FFN the port implements are
listed; the reference registry (``repro.configs``) has ten more, which
join here together with their mixer kinds and FFNs (ROADMAP queue 1,
item 9).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.qwen3_next_gdn import CONFIG as qwen3_next_gdn

ARCHS = {c.name: c for c in [qwen3_next_gdn]}


def get_arch(name: str) -> ArchConfig:
    key = name.replace("_", "-")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(ARCHS)} "
                       f"(other archs need mixer kinds not yet ported — "
                       f"ROADMAP queue 1, item 9)")
    return ARCHS[key]


__all__ = ["ArchConfig", "ARCHS", "get_arch"]
