"""One-token GQA flash-decode against a (rolling) KV cache, for Hopper.

Source: ``repro_torch/csrc/attn_decode.cu`` (CUDA C++, sm_90a, built by
nvcc and bound with ctypes — see ``kernels/_build.py``).

Replaces ``repro/kernels/attn_decode.py``: ``attn_decode_pallas`` (line
78, ``_kernel`` at line 28).  Bound on the card: bytes — every occupied K
and V row is read once against 4*G*d FLOP per row.  Design
(flash-decoding): the cache's T axis is split across CTAs, each CTA
holding the G query heads of one kv head so a K/V row is read once for
the group; each split writes its (m, l, acc) and a second kernel merges
the splits by log-sum-exp; cp.async keeps the next K/V tile in flight
while a CTA computes on the current one.  bf16 runs on the tensor cores
(``mma.sync``, fp32 accumulators, P rounded to bf16 as
``attn_decode_xla`` does); fp32 on the CUDA cores.  ``length`` is the raw
token count: the kernel clamps occupancy to the buffer and masks the
window on absolute wrapped positions itself.  The plain version is
``ref.attn_decode_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel pair (incremented only where it is launched)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _I, _P]
TILE = 64          # key rows per shared-memory tile (kTile in the source)
MAX_G = 16         # query heads per kv head
MAX_D = 128


@functools.cache
def _lib():
    fn = _build.load("attn_decode").attn_decode_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_len(B: int, Hkv: int, T: int, d: int, itemsize: int,
              sms: int) -> int:
    """Cache slots per split CTA, in whole 64-slot tiles: enough CTAs over
    the B * Hkv (batch row, kv head) pairs to keep about 72 KiB of K/V
    tiles in flight on each of the ``sms`` SMs, a CTA holding one tile of
    K and V (2 * 64 * d * itemsize bytes) in flight while it computes on
    another.  (Of the splits tried on the H100 at the three shapes of
    ``chip_smoke.py``, this picks the fastest at each.)"""
    per_sm = max(1, round(72 * 1024 / (2 * TILE * d * itemsize)))
    want = max(1, sms * per_sm // (B * Hkv))
    per = -(-T // want)
    return max(TILE, -(-per // TILE) * TILE)


def check_inputs(q, k_cache, v_cache, length):
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"q must be (B, Hq, d) and k/v caches (B, Hkv, T, "
                         f"d); got {tuple(q.shape)}, {tuple(k_cache.shape)},"
                         f" {tuple(v_cache.shape)}")
    B, Hq, d = q.shape
    Hkv, T = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != d:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if Hq % Hkv or Hq // Hkv > MAX_G:
        raise ValueError(f"Hq={Hq}, Hkv={Hkv}: the kernel takes Hq = G * "
                         f"Hkv with G <= {MAX_G}")
    if d % 16 or d > MAX_D:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 16 up "
                         f"to {MAX_D}")
    if length.shape != (B,) or length.dtype != torch.int32:
        raise ValueError(f"length must be ({B},) int32, got "
                         f"{tuple(length.shape)} {length.dtype}")
    return B, Hq, Hkv, T, d


def attn_decode(q, k_cache, v_cache, length, *, scale=None, window=None,
                split=None):
    """Launch the CUDA kernels on CUDA tensors.

    q: (B, Hq, d); k_cache, v_cache: (B, Hkv, T, d), one dtype (float32 or
    bfloat16); length: (B,) int32 raw token counts; ``window`` (optional)
    masks slots whose absolute position is < length - window; ``split``
    (cache slots per CTA) overrides ``split_len``'s choice, for
    ``launch.profile_decode``'s study.  Returns o (B, Hq, d) in q's
    dtype."""
    global launches
    B, Hq, Hkv, T, d = check_inputs(q, k_cache, v_cache, length)
    tensors = (q, k_cache, v_cache, length)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("attn_decode kernel: every input must be on one "
                         "CUDA device")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or \
            q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if not all(t.is_contiguous() for t in tensors) or \
            k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("attn_decode kernel needs contiguous inputs and "
                         "16-byte aligned caches")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if scale is None:
        scale = 1.0 / d ** 0.5
    if split is None:
        split = split_len(B, Hkv, T, d, q.element_size(),
                          sm_count(q.device))
    elif split < 1:
        raise ValueError(f"split must be positive, got {split}")
    n_split = -(-T // split)
    o = torch.empty_like(q)
    m_part = torch.empty(2, B * Hq * n_split, dtype=torch.float32,
                         device=q.device)
    acc_part = torch.empty(B * Hq * n_split * d, dtype=torch.float32,
                           device=q.device)
    err = _lib()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        length.data_ptr(), o.data_ptr(), m_part[0].data_ptr(),
        m_part[1].data_ptr(), acc_part.data_ptr(), B, Hq, Hkv, T, d, split,
        float(scale), 0 if window is None else int(window),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"attn_decode kernel launch failed: cudaError "
                           f"{err}")
    launches += 1
    return o
