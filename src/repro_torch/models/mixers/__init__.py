"""Registry of SequenceMixer implementations (the port's counterpart of
``repro.models.mixers``).

One mixer kind == one module implementing the ``SequenceMixer`` protocol
and decorated with ``@register``; the LM and the serving executor reach
mixers only through ``get_mixer(kind)``.  Ported kinds — all six of the
reference's registry: ``gdn``, ``gdn_naive``, ``attn``, ``swa``, ``ssm``
(mamba2) and ``rglru`` (recurrentgemma).
"""
from __future__ import annotations

from typing import Dict, Type

from repro_torch.models.mixers.base import (ArraySpec, CacheSpec,
                                            SequenceMixer)

MIXERS: Dict[str, Type[SequenceMixer]] = {}


def register(cls: Type[SequenceMixer]) -> Type[SequenceMixer]:
    """Class decorator: make ``cls`` available as ``get_mixer(cls.kind)``."""
    if not cls.kind:
        raise ValueError(f"{cls.__name__} has no `kind`")
    MIXERS[cls.kind] = cls
    return cls


def get_mixer(kind: str) -> Type[SequenceMixer]:
    try:
        return MIXERS[kind]
    except KeyError:
        raise KeyError(f"unknown mixer kind {kind!r}; registered: "
                       f"{sorted(MIXERS)}") from None


# Built-in kinds self-register on import.
from repro_torch.models.mixers import attn as _attn      # noqa: E402,F401
from repro_torch.models.mixers import gdn as _gdn        # noqa: E402,F401
from repro_torch.models.mixers import gdn_naive as _naive  # noqa: E402,F401
from repro_torch.models.mixers import ssm as _ssm        # noqa: E402,F401
from repro_torch.models.mixers import rglru as _rglru    # noqa: E402,F401

__all__ = ["ArraySpec", "CacheSpec", "SequenceMixer", "MIXERS",
           "register", "get_mixer"]
