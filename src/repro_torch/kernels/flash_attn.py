"""Flash attention for training, forward and backward, on Hopper (port of
``repro.kernels.flash_attn``).

Sources: ``repro_torch/csrc/flash_fwd.cu`` (the forward) and
``repro_torch/csrc/flash_bwd.cu`` (the dq and the dk/dv kernels), CUDA C++
for sm_90a with the tile machinery of ``csrc/flash_common.cuh``, built by
nvcc and bound with ctypes (``kernels/_build.py``).

Replaces, in ``repro/kernels/flash_attn.py``: ``flash_fwd`` (line 105,
``_fwd_kernel`` at line 50) and ``flash_bwd`` (line 236, ``_dq_kernel`` at
line 166, ``_dkv_kernel`` at line 192).  Bound on the card: operations —
two causal products in the forward, three in dq, four in dk/dv, against
O(B*H*T*hd) bytes.  Design (see the sources): 64-row tiles in shared
memory, fp32 online softmax in registers, key tiles skipped outside the
window and past the causal diagonal; the forward saves the row max ``m``
and row sum ``l`` separately, as the backward reads both; dq runs one CTA
per query tile, dk/dv one CTA per key tile looping over the G query heads
of its kv head, so neither needs atomics.  The tile size is a constant of
the kernels.

Dispatch as in ``kernels.ops``: a CUDA tensor goes to the kernels (which
launch or raise), a CPU tensor to the plain versions ``ref.flash_fwd_ref``
and ``ref.flash_bwd_ref``.  ``delta = rowsum(do * o)`` is one fp32 torch
op outside the kernels, as in the reference.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ops import _on_cuda

# launches of each CUDA kernel (incremented only where it is launched)
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)     # the kernels' head-dim instantiations
_P = ctypes.c_void_p
_I = ctypes.c_int
_TAIL = [_I, _I, _I, _I, ctypes.c_float, _I, _I, _P]   # BH G T hd scale
                                                       # window dtype stream


@functools.cache
def _fn(lib: str, name: str, n_ptrs: int):
    fn = getattr(_build.load(lib), name)
    fn.argtypes = [_P] * n_ptrs + _TAIL
    fn.restype = ctypes.c_int
    return fn


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def _window(window) -> int:
    if window is None:
        return 0
    if window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    return int(window)


def _check(q, k, v, valid_len, *extra):
    """Shapes, dtypes, device and layout the kernels take; returns
    (BH, G, T, hd, valid_len as a contiguous (BH,) int32 tensor or None)."""
    if q.dim() != 4 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"q must be (BH, G, T, hd) and k, v (BH, T, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, G, T, hd = q.shape
    if k.shape != (BH, T, hd):
        raise ValueError(f"k must be {(BH, T, hd)}, got {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernels take {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    tensors = (q, k, v) + extra
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("flash kernels: every input must be on one CUDA "
                         "device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("flash kernels need contiguous, 16-byte aligned "
                         "inputs")
    if valid_len is not None:
        valid_len = torch.as_tensor(valid_len, dtype=torch.int32,
                                    device=q.device).reshape(-1)
        if valid_len.shape != (BH,):
            raise ValueError(f"valid_len must be ({BH},), got "
                             f"{tuple(valid_len.shape)}")
        valid_len = valid_len.contiguous()
    return BH, G, T, hd, valid_len


def _raise_on(err, name):
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1


def _vl_ptr(valid_len):
    return None if valid_len is None else valid_len.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd_cuda(q, k, v, valid_len, scale, window):
    BH, G, T, hd, vl = _check(q, k, v, valid_len)
    o = torch.empty_like(q)
    m = torch.empty((BH, G, T), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    err = _fn("flash_fwd", "flash_fwd_launch", 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), _vl_ptr(vl), BH, G, T, hd, scale, window,
        _DTYPE_CODE[q.dtype], _stream(q))
    _raise_on(err, "flash_fwd")
    return o, m, l


def _bwd_cuda(q, k, v, m, l, do, delta, valid_len, scale, window):
    BH, G, T, hd, vl = _check(q, k, v, valid_len, do, m, l, delta)
    if do.dtype != q.dtype:
        raise TypeError(f"do must be {q.dtype}, got {do.dtype}")
    if not (m.dtype == l.dtype == delta.dtype == torch.float32) or not (
            m.shape == l.shape == delta.shape == (BH, G, T)):
        raise ValueError(f"m, l and delta must be float32 {(BH, G, T)}")
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              m.data_ptr(), l.data_ptr(), delta.data_ptr())
    tail = (BH, G, T, hd, scale, window, _DTYPE_CODE[q.dtype], _stream(q))
    dq = torch.empty_like(q)
    err = _fn("flash_bwd", "flash_dq_launch", 9)(
        *common, dq.data_ptr(), _vl_ptr(vl), *tail)
    _raise_on(err, "flash_bwd_dq")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _fn("flash_bwd", "flash_dkv_launch", 10)(
        *common, dk.data_ptr(), dv.data_ptr(), _vl_ptr(vl), *tail)
    _raise_on(err, "flash_bwd_dkv")
    return dq, dk, dv


def flash_fwd(q, k, v, valid_len=None, *, scale=None, window=None):
    """q: (BH, G, T, hd); k, v: (BH, T, hd) -> (o, m, l).

    ``valid_len`` (optional (BH,) int): key positions >= valid_len are
    padding, masked out of every score row; output rows at padded query
    positions are garbage."""
    if _on_cuda(q):
        return _fwd_cuda(q, k, v, valid_len, _scale(q, scale),
                         _window(window))
    return ref.flash_fwd_ref(q, k, v, valid_len, scale=scale, window=window)


def flash_bwd(q, k, v, o, m, l, do, valid_len=None, *, scale=None,
              window=None):
    """Gradients of ``flash_fwd`` from its saved (o, m, l) -> (dq, dk, dv)
    in the dtypes of q, k, v."""
    if not _on_cuda(q):
        return ref.flash_bwd_ref(q, k, v, o, m, l, do, valid_len,
                                 scale=scale, window=window)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    return _bwd_cuda(q, k, v, m, l, do, delta, valid_len, _scale(q, scale),
                     _window(window))


# ----------------------------------------------------------------- autograd

def _heads_in(x, Hkv):
    """(B, T, H, hd) -> (B * Hkv, H // Hkv, T, hd), contiguous: query head
    h belongs to kv head h // G."""
    B, T, H, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * Hkv, H // Hkv, T, hd) \
        .contiguous()


def _kv_in(x):
    """(B, T, Hkv, hd) -> (B * Hkv, T, hd), contiguous."""
    return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3]).contiguous()


def _heads_out(x, B):
    """(B * Hkv, G, T, hd) -> (B, T, Hkv * G, hd)."""
    BH, G, T, hd = x.shape
    return x.reshape(B, BH // B * G, T, hd).permute(0, 2, 1, 3)


def _len_per_bh(valid_len, Hkv):
    """(B,) per-sequence lengths -> (B * Hkv,) per kernel row."""
    if valid_len is None:
        return None
    return torch.repeat_interleave(
        torch.as_tensor(valid_len).to(torch.int32).reshape(-1), Hkv)


class FlashAttention(torch.autograd.Function):
    """Causal GQA flash attention on (B, T, H, hd) with the kernels'
    backward.  The residuals are q, k, v, o and the statistics (m, l)."""

    @staticmethod
    def forward(ctx, q, k, v, window=None, valid_len=None):
        B, Hkv = q.shape[0], k.shape[2]
        qh, kh, vh = _heads_in(q, Hkv), _kv_in(k), _kv_in(v)
        vl = _len_per_bh(valid_len, Hkv)
        if vl is not None:
            vl = vl.to(q.device)
        oh, m, l = flash_fwd(qh, kh, vh, vl, window=window)
        ctx.save_for_backward(qh, kh, vh, oh, m, l)
        ctx.window, ctx.valid_len, ctx.B = window, vl, B
        return _heads_out(oh, B)

    @staticmethod
    def backward(ctx, do):
        qh, kh, vh, oh, m, l = ctx.saved_tensors
        B = ctx.B
        doh = _heads_in(do, kh.shape[0] // B)
        dq, dk, dv = flash_bwd(qh, kh, vh, oh, m, l, doh, ctx.valid_len,
                               window=ctx.window)
        T, hd = kh.shape[1], kh.shape[2]

        def kv_out(x):
            return x.reshape(B, -1, T, hd).transpose(1, 2)

        return _heads_out(dq, B), kv_out(dk), kv_out(dv), None, None


def flash_attention(q, k, v, window=None, valid_len=None):
    """Causal (optionally windowed) GQA flash attention.

    q: (B, T, Hq, hd); k, v: (B, T, Hkv, hd).  Returns (B, T, Hq, hd).
    ``valid_len`` (optional (B,) int) masks key positions >= valid_len out
    of every score row and of dk/dv; output and dq rows at padded query
    positions are garbage.  No gradient flows to ``valid_len``."""
    return FlashAttention.apply(q, k, v, window, valid_len)
