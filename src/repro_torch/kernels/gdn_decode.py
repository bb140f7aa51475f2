"""Fused persistent-state GDN decode kernel (paper Alg. 2) for Hopper.

Source: ``repro_torch/csrc/gdn_decode.cu`` (CUDA C++, sm_90a, built by nvcc
and bound with ctypes — see ``kernels/_build.py``).

Replaces ``repro/kernels/gdn_decode.py``: ``gdn_decode_pallas`` (``_kernel``
at line 35).  Bound on the card: bytes — the state is read once and
written once per token (B*Hv*dk*dv*4 bytes each way) against ~7*dk*dv FLOP
per head.  Design: grid (B, Hv, dv/32), one CTA per 32-column tile of one
head's state (columns are independent in this step, so no reduction
crosses CTAs); the tile stays in shared memory between the read and the
write pass, and S is updated in place (the port's form of the TPU kernel's
``input_output_aliases``).  The plain version is ``ref.gdn_decode_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel (incremented only where it is launched)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, _P]
MAX_DK = 256         # shared-memory tile (dk x 32 fp32) stays below 48 KB


@functools.cache
def _lib():
    lib = _build.load("gdn_decode")
    fn = lib.gdn_decode_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def check_inputs(q, k, v, S, g, beta):
    B, Hk, dk = q.shape
    if v.dim() != 3 or v.shape[0] != B:
        raise ValueError(f"v must be (B, Hv, dv), got {tuple(v.shape)}")
    Hv, dv = v.shape[1], v.shape[2]
    if Hv % Hk:
        raise ValueError(f"Hv={Hv} is not a multiple of Hk={Hk}")
    if k.shape != q.shape:
        raise ValueError(f"k {tuple(k.shape)} != q {tuple(q.shape)}")
    if S.shape != (B, Hv, dk, dv):
        raise ValueError(f"S must be {(B, Hv, dk, dv)}, got {tuple(S.shape)}")
    for name, t in (("g", g), ("beta", beta)):
        if t.shape != (B, Hv):
            raise ValueError(f"{name} must be {(B, Hv)}, got "
                             f"{tuple(t.shape)}")
    return B, Hk, Hv, dk, dv


def gdn_decode(q, k, v, S, g, beta, *, scale=None, delta_rule=True):
    """Launch the CUDA kernel on CUDA tensors.

    q, k: (B, Hk, d_k) and v: (B, Hv, d_v), float32 or bfloat16 (one dtype);
    S: (B, Hv, d_k, d_v) float32, updated in place; g, beta: (B, Hv)
    float32.  Returns (o (B, Hv, d_v) in v's dtype, S)."""
    global launches
    B, Hk, Hv, dk, dv = check_inputs(q, k, v, S, g, beta)
    tensors = (q, k, v, S, g, beta)
    if not all(t.is_cuda and t.device == S.device for t in tensors):
        raise ValueError("gdn_decode kernel: every input must be on one "
                         "CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (S.dtype == g.dtype == beta.dtype == torch.float32):
        raise TypeError("S, g and beta must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gdn_decode kernel needs contiguous inputs")
    if dk > MAX_DK:
        raise ValueError(f"d_k={dk} exceeds the kernel's {MAX_DK}")
    if scale is None:
        scale = (1.0 / dk ** 0.5) if delta_rule else 1.0
    o = torch.empty_like(v)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), S.data_ptr(),
                 g.data_ptr(), beta.data_ptr(), o.data_ptr(), B, Hk, Hv, dk,
                 dv, float(scale), int(bool(delta_rule)),
                 _DTYPE_CODE[q.dtype],
                 torch.cuda.current_stream(S.device).cuda_stream)
    if err:
        raise RuntimeError(f"gdn_decode kernel launch failed: cudaError {err}")
    launches += 1
    return o, S
