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
O(B*H*T*hd) bytes.  Design (see the sources): 64-row tiles, online
softmax in registers, key tiles skipped outside the window and past the
causal diagonal; the forward saves the row max ``m`` and row sum ``l``
separately, as the backward reads both.  bf16 inputs run all three
kernels on the tensor cores (``mma.sync``, cp.async rings, P and dS
rounded to bf16 for their products, fp32 sums); dq runs one CTA per 128
query rows that owns its rows; dk/dv runs one CTA per (key tile, kv row,
query head or heads), and the CTAs of one key tile's G query heads form
a thread block cluster (``cluster_size``) that sums their fp32 partials
through distributed shared memory in a fixed order and stores bf16 (one
launch, no atomics), so dq, dk and dv are all bitwise reproducible from
run to run.  At head dim 256 the forward and dq give each CTA 64 query
rows and dk/dv splits its CTAs between dK and dV (still one launch), so
that no thread holds more than 128 fp32 accumulators.  fp32 inputs run
exact fp32 kernels on the CUDA cores (dk/dv one CTA per key tile and
gradient, looping over the G query heads).  The tile size is a constant
of the kernels; a head dim outside ``HEAD_DIMS`` raises.

Dispatch as in ``kernels.ops``: a CUDA tensor goes to the kernels (which
launch or raise), a CPU tensor to the plain versions ``ref.flash_fwd_ref``
and ``ref.flash_bwd_ref``.  ``delta = rowsum(do * o)`` is one fp32 torch
op outside the kernels, as in the reference.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import device as _device
from repro_torch.kernels import _build, ref
from repro_torch.kernels.ops import _on_cuda

# launches of each CUDA kernel (incremented only where it is launched)
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' head-dim instantiations: every registered arch's attention
# head dim (h2o-danube-1.8b's 80, recurrentgemma-2b's 256 among them)
HEAD_DIMS = (64, 80, 128, 256)
MAX_CLUSTER = 8           # the portable thread-block-cluster size
# the cluster size the dk/dv kernel prefers: on the H100 clusters of 4
# CTAs (two heads each) beat clusters of 8 at the trained shape, G = 8
# (``python -m repro_torch.launch.profile_train --dkv-clusters``)
PREFERRED_CLUSTER = 4
_P = ctypes.c_void_p
_I = ctypes.c_int
_TAIL = [_I, _I, _I, _I, ctypes.c_float, _I, _I, _P]   # BH G T hd scale
                                                       # window dtype stream


@functools.cache
def _fn(lib: str, name: str, n_ptrs: int, extra: tuple = ()):
    fn = getattr(_build.load(lib), name)
    fn.argtypes = [_P] * n_ptrs + _TAIL + list(extra)
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
        valid_len = _lengths(valid_len, q.device)
        if valid_len.shape != (BH,):
            raise ValueError(f"valid_len must be ({BH},), got "
                             f"{tuple(valid_len.shape)}")
        valid_len = valid_len.contiguous()
    return BH, G, T, hd, valid_len


def _lengths(valid_len, device) -> torch.Tensor:
    """``valid_len`` as a flat int32 tensor on ``device``.  An int or a
    tensor goes through ``device.as_int`` (no copy from host memory, so
    safe inside a CUDA graph capture); a host sequence (a list, a numpy
    array) is copied from the host."""
    if isinstance(valid_len, (int, torch.Tensor)):
        out = _device.as_int(valid_len, torch.int32, device)
    else:
        out = torch.as_tensor(valid_len, dtype=torch.int32, device=device)
    return out.reshape(-1)


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
    args = (q, k, v, do, m, l, delta, vl, scale, window)
    return (_dq_cuda(*args),) + _dkv_cuda(*args)


def _ptrs(q, k, v, do, m, l, delta):
    return tuple(t.data_ptr() for t in (q, k, v, do, m, l, delta))


def _tail(q, scale, window):
    BH, G, T, hd = q.shape
    return (BH, G, T, hd, scale, window, _DTYPE_CODE[q.dtype], _stream(q))


def _dq_cuda(q, k, v, do, m, l, delta, vl, scale, window):
    """dq from checked inputs (``_bwd_cuda``): one launch."""
    dq = torch.empty_like(q)
    err = _fn("flash_bwd", "flash_dq_launch", 9)(
        *_ptrs(q, k, v, do, m, l, delta), dq.data_ptr(), _vl_ptr(vl),
        *_tail(q, scale, window))
    _raise_on(err, "flash_bwd_dq")
    return dq


def cluster_size(G: int) -> int:
    """CTAs of the bf16 dk/dv kernel's cluster over one key tile's G query
    heads (each CTA sums G / C heads in registers, in order): the largest
    divisor of G up to ``PREFERRED_CLUSTER``; where that is 1 but G fits a
    cluster (G = 5, 7), G itself, so that no CTA walks every head."""
    c = max(c for c in range(1, PREFERRED_CLUSTER + 1) if G % c == 0)
    return G if c == 1 and G <= MAX_CLUSTER else c


def _dkv_cuda(q, k, v, do, m, l, delta, vl, scale, window, cluster=None):
    """(dk, dv) in k's dtype from checked inputs (``_bwd_cuda``): one
    launch, which writes every row, summed over the G query heads in a
    fixed order.  ``cluster`` overrides ``cluster_size``'s choice, for
    ``launch.profile_train``'s study."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _fn("flash_bwd", "flash_dkv_launch", 10, (_I,))(
        *_ptrs(q, k, v, do, m, l, delta), dk.data_ptr(), dv.data_ptr(),
        _vl_ptr(vl), *_tail(q, scale, window),
        cluster_size(q.shape[1]) if cluster is None else cluster)
    _raise_on(err, "flash_bwd_dkv")
    return dk, dv


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


def _len_per_bh(valid_len, Hkv, device):
    """(B,) per-sequence lengths -> (B * Hkv,) per kernel row on
    ``device`` (``_lengths``)."""
    if valid_len is None:
        return None
    return torch.repeat_interleave(_lengths(valid_len, device), Hkv)


class FlashAttention(torch.autograd.Function):
    """Causal GQA flash attention on (B, T, H, hd) with the kernels'
    backward.  The residuals are q, k, v, o and the statistics (m, l)."""

    @staticmethod
    def forward(ctx, q, k, v, window=None, valid_len=None):
        B, Hkv = q.shape[0], k.shape[2]
        qh, kh, vh = _heads_in(q, Hkv), _kv_in(k), _kv_in(v)
        vl = _len_per_bh(valid_len, Hkv, q.device)
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
