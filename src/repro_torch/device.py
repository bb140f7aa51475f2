"""Device and dtype resolution shared by the port's entry points.

Entry points (``lm.init_lm``, ``lm.init_caches``, ``DecodeEngine``, the
serve CLI) run on ``cuda`` unless the caller asks for the CPU.  Without a
card and without an explicit CPU request they raise: the port never falls
back to the CPU quietly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve(device: Optional[Union[str, torch.device]] = None
            ) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises.  A
    CUDA device gets its index (``cuda`` -> ``cuda:<current>``), so it
    compares equal to the device of the tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU (its kernels' plain versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_int(x, dtype: torch.dtype, device) -> torch.Tensor:
    """An int, or an int tensor, as a ``dtype`` tensor on ``device`` with no
    copy from host memory: a tensor is cast where it lies (moved first if
    it lies elsewhere), a host int is written by a fill kernel.  Either is
    safe inside a CUDA graph capture, which refuses a pageable
    host-to-device copy."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.full((), int(x), dtype=dtype, device=device)


def dtype(name) -> torch.dtype:
    """Config dtype string (``ArchConfig.act_dtype``/``state_dtype``) or
    torch dtype -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise KeyError(f"unsupported dtype {name!r}; have "
                       f"{sorted(_DTYPES)}") from None
