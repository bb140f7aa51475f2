"""Chunkwise gated delta-rule prefill kernel (UT/WY transform) for Hopper.

Source: ``repro_torch/csrc/gdn_prefill.cu`` (CUDA C++, sm_90a, built by
nvcc and bound with ctypes — see ``kernels/_build.py``).

Replaces ``repro/kernels/gdn_prefill.py``: ``gdn_prefill_pallas``
(``_kernel`` at line 43, ``_kernel_ragged`` at line 107,
``_nilpotent_inv_apply`` at line 32).  Bound on the card: operations at
serving sizes (~8 MFLOP per row per 64-token chunk against ~0.2 MB moved).
Design: the TPU's sequential chunk grid axis is a loop over chunks inside
one CTA per (row, 32-column tile of d_v) with the state tile resident in
shared memory — S is read once and written once per sequence, in place.
Per chunk: the log-gate prefix sum by warp shuffles; (I + A)^{-1} as a
matrix (the four 16 x 16 diagonal blocks by forward substitution, one warp
each, then the off-diagonal blocks from products: the blocked inverse,
exact in exact arithmetic like the TPU kernel's nilpotent doubling),
applied to the right-hand side as one product; the fp32 products with the
inverse and M register-tiled over all 256 threads.  bf16 inputs at d_k =
128 and d_v a multiple of 8 (the served shape) run every product with k or
q on the tensor cores: Q K^T and K K^T exactly, K S, Q S and the state
update K^T (W U) against the three bf16 parts of the fp32 operand (a split
that keeps fp32 accuracy).  Every other shape (fp32 inputs, as the reduced
configurations serve; any d_k that fits shared memory, any d_v) runs those
products as plain CUDA-core loops.  The GVA q/k row is indexed directly;
``valid_len`` masks padding inside the kernel.  Chunks of up to 64 tokens.
The plain version is ``ref.gdn_prefill_ref``.
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
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P] + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, _P]
SMEM_LIMIT = 232448     # bytes of shared memory one H100 CTA may use
MAX_CHUNK = 64          # the kernel's chunk tile (shorter chunks pad it)
TC_KEY_DIM = 128        # d_k of the tensor-core kernel (bf16)


@functools.cache
def _lib():
    lib = _build.load("gdn_prefill")
    fn = lib.gdn_prefill_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    smem = lib.gdn_prefill_smem_bytes
    smem.argtypes = [ctypes.c_int] * 4
    smem.restype = ctypes.c_longlong
    return fn, smem


def gdn_prefill(q, k, v, log_g, beta, S, valid_len=None, *, chunk=64,
                scale=None, delta_rule=True, n_rep: int = 1):
    """Launch the CUDA kernel on CUDA tensors.

    q, k: (BHk, T, d_k) with BHk = BHv / n_rep — value row r reads q/k row
    r // n_rep (rows laid out (B, Hv) and (B, Hk)); v: (BHv, T, d_v);
    q/k/v float32 or bfloat16 (one dtype); log_g, beta: (BHv, T) float32;
    S: (BHv, d_k, d_v) float32, the initial state, overwritten in place
    with the final one; valid_len: optional (BHv,) int32.
    Returns (O (BHv, T, d_v) in v's dtype, S)."""
    global launches
    BHv, T, dv = v.shape
    BHk, _, dk = q.shape
    if BHk * n_rep != BHv or k.shape != q.shape or q.shape[1] != T:
        raise ValueError(f"q/k {tuple(q.shape)} do not match v "
                         f"{tuple(v.shape)} with n_rep={n_rep}")
    if S.shape != (BHv, dk, dv):
        raise ValueError(f"S must be {(BHv, dk, dv)}, got {tuple(S.shape)}")
    if log_g.shape != (BHv, T) or beta.shape != (BHv, T):
        raise ValueError("log_g and beta must be (BHv, T)")
    tensors = [q, k, v, log_g, beta, S]
    if valid_len is not None:
        if valid_len.shape != (BHv,) or valid_len.dtype != torch.int32:
            raise ValueError("valid_len must be an int32 (BHv,) tensor")
        tensors.append(valid_len)
    if not all(t.is_cuda and t.device == S.device for t in tensors):
        raise ValueError("gdn_prefill kernel: every input must be on one "
                         "CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (S.dtype == log_g.dtype == beta.dtype == torch.float32):
        raise TypeError("S, log_g and beta must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gdn_prefill kernel needs contiguous inputs")
    C = min(chunk, T)
    if T % C:
        raise ValueError(f"T={T} is not a multiple of chunk={C}")
    if C > MAX_CHUNK:
        raise ValueError(f"the kernel takes chunks of at most {MAX_CHUNK} "
                         f"tokens, got chunk={C}")
    if (q.dtype == torch.bfloat16 and dk == TC_KEY_DIM and dv % 8 == 0
            and not all(t.data_ptr() % 16 == 0 for t in (q, k, v, S))):
        raise ValueError("the tensor-core gdn_prefill kernel needs 16-byte "
                         "aligned q, k, v and S")
    if scale is None:
        scale = (1.0 / dk ** 0.5) if delta_rule else 1.0
    launch, smem_bytes = _lib()
    need = smem_bytes(C, dk, dv, _DTYPE_CODE[q.dtype])
    if need > SMEM_LIMIT:
        raise ValueError(f"chunk={C}, d_k={dk} needs {need} bytes of "
                         f"shared memory (> {SMEM_LIMIT})")
    O = torch.empty_like(v)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_g.data_ptr(),
                 beta.data_ptr(), S.data_ptr(),
                 valid_len.data_ptr() if valid_len is not None else None,
                 O.data_ptr(), BHv, n_rep, T, C, dk, dv, float(scale),
                 int(bool(delta_rule)), _DTYPE_CODE[q.dtype],
                 torch.cuda.current_stream(S.device).cuda_stream)
    if err:
        raise RuntimeError(f"gdn_prefill kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return O, S
