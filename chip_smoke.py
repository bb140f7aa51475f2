#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # every phase (needs one card)
    python3 chip_smoke.py --kernels-only  # build + kernel checks, then stop

Phases, in order; any failure exits non-zero and prints no result line:

  1. the card's name and power limit, torch/CUDA versions; build the
     hand-written kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a) and
     print each kernel's registers and spills (ptxas);
  2. each kernel against its plain PyTorch version on the card at the
     full-width shapes of qwen3-next-gdn (Hk=16, Hv=32, d=128, bf16 q/k/v,
     fp32 state), with its time (the kernel's own duration as the
     profiler records it, mean of 30 launches, each after a 256 MiB read
     that evicts the L2; CUDA events around each launch beside it), its
     bound, the plain version's time (CUDA events);
  3. full-width qwen3-next-gdn (48 layers, random bf16 weights drawn on the
     card from a seed): one ``decode_step`` with the kernels against one
     through the plain path;
  4. serving through ``DecodeEngine`` with the kernels (4 slots, max_len
     1024, prefill chunk 64, decode block 8): 6 requests, prompts of
     100-400 tokens, 32 new tokens each, one at temperature 0.8 / top-k
     40.  The kernels' launch counters are zeroed just before and read
     just after this run;
  5. training full-width qwen3-next-gdn through the port's ``Trainer``
     with ``use_flash_kernel`` (bf16, global batch 2, seq_len 2048, 3
     steps, a checkpoint into a temporary directory under ``build/``):
     first ``loss_fn`` and its gradients at the initial parameters through
     the flash kernels against the plain ``blockwise_attention`` path,
     then the 3 steps with the launch counters zeroed just before and read
     just after;
  6. full-width h2o-danube-1.8b (24 sliding-window layers, window 4096,
     random bf16 weights drawn on the card from seed 0): (i) served
     through ``DecodeEngine`` (4 slots, max_len 8192 — a 4096-slot rolling
     cache — prefill chunk 256, decode block 8) with prompts of 5000,
     4500, 1000 and 200 tokens, 32 new tokens each, one at temperature
     0.8 / top-k 40; (ii) the same four prompts prefilled through the
     port's chunked prefill, then on each of the 24 layers' wrapped caches
     ``attention.attn_decode_pallas`` (the flash-decode kernel) against
     ``attention.attn_decode_xla`` (the mixers' path) on clones of the
     cache with one ``x_t``, the kernel's launch counter zeroed just
     before (ii) and read just after.

Phase 2 also holds the three flash-attention kernels (forward, dq, dk/dv)
against their plain versions at the trained shape (B=2, T=2048, Hq=16,
Hkv=2, hd=128, bf16) and on windowed and ragged (``valid_len``) cases
(each call one kernel launch, by the profiler; dq, dk and dv checked
bitwise equal over 5 calls; SDPA's distance from the plain version
printed beside the kernels'), and the flash-decode kernel at three
bf16 shapes (qwen3-next-gdn's attention layer at the serving batch, an
h2o-danube-1.8b layer past its wrap, yi-9b at batch 1 over 32k slots;
one launch per call, bitwise equal over 5 calls), and times each beside
``F.scaled_dot_product_attention`` (the library yardstick, used nowhere
in the port).

The second line before the last is a JSON object with one entry per
kernel (the flash-decode entry carries its three shapes, its top-level
numbers are those of the h2o-danube-1.8b shape that phase 6 drives); the
line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# datasheet peaks of the H100 SXM (dense): HBM bandwidth, the fp32 rate
# outside the tensor cores and the bf16 tensor-core rate (fp32 accumulate)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12

CFG = dict(B=4, Hk=16, Hv=32, d=128)
# the trained attention shape: global batch 2, seq_len 2048, GQA 16:2
FLASH = dict(B=2, T=2048, Hq=16, Hkv=2, hd=128)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def ptxas_report(log):
    """(kernel, registers, spill line) per entry function of nvcc's
    ``-Xptxas -v`` output."""
    out, kernel, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        elif "spill stores" in line:
            spills = line.strip()
        else:
            r = re.search(r"Used (\d+) registers", line)
            if r and kernel:
                out.append((kernel, int(r.group(1)), spills))
                kernel, spills = None, ""
    return out


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name, got, want, rtol, atol):
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    bad = int((err > lim).sum())
    print(f"  {name}: max|diff| {float(err.max()):.3e} "
          f"(rtol {rtol}, atol {atol})")
    if bad or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: {bad} elements outside tolerance")
    return float(err.max())


# ---------------------------------------------------------------- phase 2

def decode_phase(ref, kdecode, time_launches):
    """gdn_decode at B=4, Hk=16, Hv=32, d=128; o is bf16 (one rounding:
    rtol = atol = 2e-2), the fp32 state differs only in summation order
    (rtol = atol = 1e-4)."""
    B, Hk, Hv, d = CFG["B"], CFG["Hk"], CFG["Hv"], CFG["d"]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q = rnd(B, Hk, d).to(torch.bfloat16)
    k = torch.nn.functional.normalize(rnd(B, Hk, d), dim=-1).to(
        torch.bfloat16)
    v = rnd(B, Hv, d).to(torch.bfloat16)
    S = rnd(B, Hv, d, d) * 0.2
    g = torch.sigmoid(rnd(B, Hv))
    beta = torch.sigmoid(rnd(B, Hv))
    errs = []
    for delta_rule in (True, False):
        S_k = S.clone()
        o_k, _ = kdecode.gdn_decode(q, k, v, S_k, g, beta,
                                    delta_rule=delta_rule)
        o_p, S_p = ref.gdn_decode_ref(q, k, v, S, g, beta,
                                      delta_rule=delta_rule)
        torch.cuda.synchronize()
        errs.append(check(f"gdn_decode delta_rule={delta_rule} o", o_k, o_p,
                          2e-2, 2e-2))
        errs.append(check(f"gdn_decode delta_rule={delta_rule} S", S_k, S_p,
                          1e-4, 1e-4))
    S_t = S.clone()
    ev_ms, ms = time_launches(
        lambda: kdecode.gdn_decode(q, k, v, S_t, g, beta),
        "gdn_decode_kernel")
    plain_ms, _ = time_launches(
        lambda: ref.gdn_decode_ref(q, k, v, S, g, beta))
    print(f"  gdn_decode: CUDA events around one launch {ev_ms * 1e3:.2f} "
          f"us, the kernel's own duration {ms * 1e3:.2f} us")
    state = B * Hv * d * d * 4
    nbytes = 2 * state + (2 * B * Hk * d + 2 * B * Hv * d) * 2 + 2 * B * Hv * 4
    flops = B * Hv * (7 * d * d + 8 * d)    # [k;q]S, S update, o
    return dict(name="gdn_decode", route="cuda",
                source="src/repro_torch/csrc/gdn_decode.cu",
                replaces="src/repro/kernels/gdn_decode.py:66",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                **bound("gdn_decode", nbytes, flops), library_ms=None)


def bound_ms(nbytes, fp32_flops, tc_flops=0):
    """The least time for the work: the larger of the bytes over the HBM
    rate and the operations over their peak rate — ``fp32_flops`` at the
    CUDA-core fp32 rate, ``tc_flops`` (bf16 x bf16 products accumulated in
    fp32) at the bf16 tensor-core rate.  Returns (ms, "bytes" or
    "operations", (bytes ms, fp32 ms, tensor-core ms))."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_fp32 = fp32_flops / FP32_FLOPS_PER_S * 1e3
    t_tc = tc_flops / BF16_TC_FLOPS_PER_S * 1e3
    t_ops = t_fp32 + t_tc
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", (t_bytes, t_fp32, t_tc))


def bound(name, nbytes, fp32_flops, tc_flops=0):
    ms, by, (t_bytes, t_fp32, t_tc) = bound_ms(nbytes, fp32_flops, tc_flops)
    print(f"  {name} bound: bytes {t_bytes * 1e3:.3f} us, operations "
          f"{(t_fp32 + t_tc) * 1e3:.3f} us (fp32 {t_fp32 * 1e3:.3f} us + "
          f"bf16 tensor-core {t_tc * 1e3:.3f} us)")
    return dict(bound_ms=ms, bound_by=by)


def flash_work(B, T, Hq, Hkv, hd):
    """What each flash kernel must do at a causal bf16 shape: the bytes
    it must move (each input read once, each output written once) and the
    FLOP of its products by the rate of the operands they take.  The
    forward (Q K^T, P V with P rounded to bf16), dq (Q K^T, dO V^T, dS K
    with dS rounded to bf16) and dk/dv (Q K^T, dO V^T, P^T dO, dS^T Q with
    P and dS rounded to bf16) feed the tensor cores bf16 x bf16 in every
    product."""
    pairs = B * Hq * T * (T + 1) // 2       # visible (q, k) pairs, causal
    prod = 2 * pairs * hd                   # FLOP of one causal product
    qo = B * Hq * T * hd * 2
    kv = 2 * B * Hkv * T * hd * 2
    stats = B * Hq * T * 4
    return {
        "flash_fwd": dict(nbytes=2 * qo + kv + 2 * stats, tc_flops=2 * prod,
                          fp32_flops=0),
        "flash_bwd_dq": dict(nbytes=3 * qo + kv + 3 * stats,
                             tc_flops=3 * prod, fp32_flops=0),
        "flash_bwd_dkv": dict(nbytes=2 * qo + 2 * kv + 3 * stats,
                              tc_flops=4 * prod, fp32_flops=0)}


def prefill_work(Hk, Hv, T, d, bf16):
    """What one gdn_prefill call must do for one staged prompt of T = C
    tokens (one chunk) over Hv value rows, d_k = d_v = d: the bytes it
    must move (q, k, v, O in bf16 or fp32, log g and beta, the fp32 state
    read and written, valid_len) and the FLOP of its products by the rate
    of the instructions the kernel issues.  Per row: Q K^T and K K^T (2 C^2
    d) multiply bf16 inputs exactly on the tensor cores; K S, Q S and the
    state update (6 C d^2) multiply them by the three bf16 parts of an
    fp32 operand, three tensor-core products each; applying the inverse
    and M U (2 C^2 d) take fp32 operands on the CUDA cores.  fp32 inputs
    count every product at the fp32 rate."""
    C = T
    exact, split, fp32 = 2 * C * C * d, 6 * C * d * d, 2 * C * C * d
    dsize = 2 if bf16 else 4
    nbytes = (2 * Hk * T * d + 2 * Hv * T * d) * dsize + 2 * Hv * T * 4 \
        + 2 * Hv * d * d * 4 + Hv * 4
    if not bf16:
        return dict(nbytes=nbytes, tc_flops=0,
                    fp32_flops=Hv * (exact + split + fp32))
    return dict(nbytes=nbytes, tc_flops=Hv * (exact + 3 * split),
                fp32_flops=Hv * fp32)


def prefill_inputs(B, T, gen, Hk=CFG["Hk"], Hv=CFG["Hv"], d=CFG["d"],
                   dtype=torch.bfloat16):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q = rnd(B, T, Hk, d).to(dtype)
    k = torch.nn.functional.normalize(rnd(B, T, Hk, d), dim=-1).to(dtype)
    v = rnd(B, T, Hv, d).to(dtype)
    log_g = -torch.nn.functional.softplus(rnd(B, T, Hv))
    beta = torch.sigmoid(rnd(B, T, Hv))
    S0 = rnd(B, Hv, d, d) * 0.1
    return q, k, v, log_g, beta, S0


def prefill_phase(ops, ref, kprefill, time_launches):
    """gdn_prefill at BH = 4*32 rows: T in {16, 64} (chunk = T), ragged
    valid_len per batch row including 0 and T; and T = 192 in chunks of 64
    with valid_len 192/0/100/64 (crossing chunk edges), both delta_rule
    values: the tensor-core kernel at d = 128, bf16.  Then the reduced
    configurations' shape on the CUDA-core kernel (Hk=2, Hv=4, d=16, fp32,
    T = 128 in chunks of 64, valid_len 128/0/70/64), both delta_rule values.
    The kernel's chunkwise UT transform with its blocked inverse and the
    plain sequential scan are two factorizations of one fp32 recurrence:
    the state within rtol = atol = 1e-4; O within 2e-2 in bf16 and 5e-4 in
    fp32 (the card tests' tolerances); a valid_len = 0 row keeps its state
    bitwise."""
    Hk, Hv, d = CFG["Hk"], CFG["Hv"], CFG["d"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = []
    full, reduced = (Hk, Hv, d, torch.bfloat16), (2, 4, 16, torch.float32)
    for T, chunk, lens, delta_rule, shape in (
            (16, 16, (16, 0, 9, 3), True, full),
            (64, 64, (64, 0, 33, 3), True, full),
            (192, 64, (192, 0, 100, 64), True, full),
            (192, 64, (192, 0, 100, 64), False, full),
            (128, 64, (128, 0, 70, 64), True, reduced),
            (128, 64, (128, 0, 70, 64), False, reduced)):
        B = CFG["B"]
        hk, hv, dd, dtype = shape
        q, k, v, lg, beta, S0 = prefill_inputs(B, T, gen, hk, hv, dd, dtype)
        valid = torch.tensor(lens, dtype=torch.int32, device="cuda")
        S_k = S0.clone()
        O_k, _ = ops.gdn_prefill(q, k, v, lg, beta, S_k, chunk=chunk,
                                 valid_len=valid, delta_rule=delta_rule)
        rows = [x.transpose(1, 2).reshape(B * x.shape[2], T, *x.shape[3:])
                .contiguous() for x in (q, k, v, lg, beta)]
        vl = torch.repeat_interleave(valid, hv)
        O_p, S_p = ref.gdn_prefill_ref(*rows, S0.reshape(B * hv, dd, dd),
                                       vl, delta_rule=delta_rule,
                                       n_rep=hv // hk)
        torch.cuda.synchronize()
        label = (f"gdn_prefill d={dd} {str(dtype)[6:]} T={T} chunk={chunk} "
                 f"delta_rule={delta_rule}")
        errs.append(check(f"{label} S", S_k.reshape(B * hv, dd, dd), S_p,
                          1e-4, 1e-4))
        if not torch.equal(S_k[1], S0[1]):
            raise AssertionError("valid_len=0 row changed its state")
        O_k = O_k.transpose(1, 2).reshape(B * hv, T, dd)
        mask = (torch.arange(T, device="cuda")[None, :] < vl[:, None])
        o_tol = 2e-2 if dtype == torch.bfloat16 else 5e-4
        errs.append(check(f"{label} O (valid rows)", O_k[mask], O_p[mask],
                          o_tol, o_tol))
    # time at the main path's shape: one staged prompt (B=1), a full
    # 64-token chunk, through the kernel's own wrapper (rows laid out by
    # ops.gdn_prefill)
    T = 64
    q, k, v, lg, beta, S0 = prefill_inputs(1, T, gen)
    rows_qk = [x.transpose(1, 2).reshape(Hk, T, d).contiguous()
               for x in (q, k)]
    v_r = v.transpose(1, 2).reshape(Hv, T, d).contiguous()
    lg_r, b_r = (x.transpose(1, 2).reshape(Hv, T).contiguous()
                 for x in (lg, beta))
    S_r = S0.reshape(Hv, d, d).clone()
    vl = torch.full((Hv,), T, dtype=torch.int32, device="cuda")
    ev_ms, ms = time_launches(
        lambda: kprefill.gdn_prefill(*rows_qk, v_r, lg_r, b_r, S_r, vl,
                                     chunk=T, n_rep=Hv // Hk),
        "gdn_prefill_tc_kernel")
    S_p0 = S0.reshape(Hv, d, d)
    plain_ms, _ = time_launches(
        lambda: ref.gdn_prefill_ref(*rows_qk, v_r, lg_r, b_r, S_p0, vl,
                                    n_rep=Hv // Hk), reps=5, warmup=1)
    print(f"  gdn_prefill: CUDA events around one launch {ev_ms * 1e3:.2f} "
          f"us, the kernel's own duration {ms * 1e3:.2f} us")
    w = prefill_work(Hk, Hv, T, d, q.dtype == torch.bfloat16)
    return dict(name="gdn_prefill", route="cuda",
                source="src/repro_torch/csrc/gdn_prefill.cu",
                replaces="src/repro/kernels/gdn_prefill.py:116",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                **bound("gdn_prefill", w["nbytes"], w["fp32_flops"],
                        w["tc_flops"]),
                library_ms=None)


def _flash_inputs(B, T, Hq, Hkv, hd, dtype, gen):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    G = Hq // Hkv
    return (rnd(B * Hkv, G, T, hd), rnd(B * Hkv, T, hd), rnd(B * Hkv, T, hd),
            rnd(B * Hkv, G, T, hd))


def _flash_check(ref, kflash, label, q, k, v, do, vl=None, window=None):
    """The three kernels against the dense plain versions on one input.
    bf16 o/dq/dk/dv: one rounding step apart (rtol = atol = 2e-2); fp32
    outputs and the fp32 statistics m, l differ in summation order only
    (1e-4).  Rows at padded query positions are garbage in the reference
    and are skipped (their cotangent is zeroed)."""
    T, G = q.shape[2], q.shape[1]
    rows = torch.ones(q.shape[0], T, dtype=torch.bool, device="cuda")
    if vl is not None:
        rows = torch.arange(T, device="cuda")[None, :] < vl[:, None]
        do = do * rows[:, None, :, None].to(do.dtype)
    o, m, l = kflash.flash_fwd(q, k, v, vl, window=window)
    dq, dk, dv = kflash.flash_bwd(q, k, v, o, m, l, do, vl, window=window)
    po, pm, pl = ref.flash_fwd_ref(q, k, v, vl, window=window)
    pdq, pdk, pdv = ref.flash_bwd_ref(q, k, v, o, m, l, do, vl,
                                      window=window)
    torch.cuda.synchronize()
    tol = (2e-2, 2e-2) if q.dtype == torch.bfloat16 else (1e-4, 1e-4)
    r4 = rows[:, None].expand(-1, G, -1)
    errs = [check(f"{label} o", o[r4], po[r4], *tol),
            check(f"{label} m", m[r4], pm[r4], 1e-4, 1e-4),
            check(f"{label} l", l[r4], pl[r4], 1e-4, 1e-4),
            check(f"{label} dq", dq[r4], pdq[r4], *tol),
            check(f"{label} dk", dk, pdk, *tol),
            check(f"{label} dv", dv, pdv, *tol)]
    return errs[:3], errs[3:4], errs[4:]


def flash_phase(ref, kflash, time_launches, kernels_per_call):
    """The flash-attention kernels at the trained shape, plus a windowed
    case at either dtype and a ragged bf16 case, against their plain
    versions; then each timed beside its bound, the plain version and
    SDPA."""
    B, T, Hq, Hkv, hd = (FLASH[k] for k in ("B", "T", "Hq", "Hkv", "hd"))
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    q, k, v, do = _flash_inputs(B, T, Hq, Hkv, hd, bf, gen)
    errs = [_flash_check(ref, kflash, "flash full width", q, k, v, do)]
    errs.append(_flash_check(
        ref, kflash, "flash window=100 fp32",
        *_flash_inputs(1, 384, 4, 2, 128, torch.float32, gen), window=100))
    errs.append(_flash_check(
        ref, kflash, "flash window=100 bf16",
        *_flash_inputs(1, 384, 4, 2, 128, bf, gen), window=100))
    vl = torch.repeat_interleave(
        torch.tensor([300, 137], dtype=torch.int32, device="cuda"), 2)
    errs.append(_flash_check(ref, kflash, "flash valid_len=(300, 137) T=300",
                             *_flash_inputs(2, 300, 8, 2, 64, bf, gen), vl))
    err_fwd, err_dq, err_dkv = (max(max(e[i]) for e in errs)
                                for i in range(3))

    o, m, l = kflash.flash_fwd(q, k, v)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    bwd = (q, k, v, do, m, l, delta, None, hd ** -0.5, 0)
    # dq and dk/dv bitwise from run to run? (each dq CTA owns its rows; the
    # dk/dv clusters sum the G heads' partials in rank order)
    dk0, dv0 = kflash._dkv_cuda(*bwd)
    dq0 = kflash._dq_cuda(*bwd)
    n_dkv = n_dq = 0
    for _ in range(4):
        dk1, dv1 = kflash._dkv_cuda(*bwd)
        n_dkv = max(n_dkv, int((dk1 != dk0).sum() + (dv1 != dv0).sum()))
        n_dq = max(n_dq, int((kflash._dq_cuda(*bwd) != dq0).sum()))
    for name, n_diff, total in (("dq", n_dq, dq0.numel()),
                                ("dk and dv", n_dkv, 2 * dk0.numel())):
        print(f"  {name} run to run (5 calls): "
              + ("bitwise equal" if n_diff == 0 else
                 f"up to {n_diff} of {total} bf16 elements differ"))
        if n_diff:
            raise AssertionError(f"{name} not bitwise reproducible")
    timed = {}
    for name, fn, kern in (
            ("flash_fwd", lambda: kflash.flash_fwd(q, k, v), "flash_fwd_"),
            ("flash_bwd_dq", lambda: kflash._dq_cuda(*bwd),
             "flash_dq_"),
            ("flash_bwd_dkv", lambda: kflash._dkv_cuda(*bwd), "flash_dkv_")):
        ev, own = time_launches(fn, kern)
        per_call, names = kernels_per_call(fn)
        if per_call != 1:
            raise AssertionError(f"{name}: {per_call} kernels per call "
                                 f"({names})")
        timed[name] = own
        print(f"  {name}: one kernel per call; CUDA events around the call "
              f"{ev:.4f} ms, the kernel's own duration {own:.4f} ms")
    plain_fwd, _ = time_launches(lambda: ref.flash_fwd_ref(q, k, v), reps=5,
                                 warmup=1)
    plain_bwd, _ = time_launches(
        lambda: ref.flash_bwd_ref(q, k, v, o, m, l, do), reps=5, warmup=1)
    # the library yardstick: one SDPA call on the same inputs
    F = torch.nn.functional
    qs = q.reshape(B, Hq, T, hd).detach().requires_grad_(True)
    ks = k.reshape(B, Hkv, T, hd).detach().requires_grad_(True)
    vs = v.reshape(B, Hkv, T, hd).detach().requires_grad_(True)
    dos = do.reshape(B, Hq, T, hd)

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                              enable_gqa=True)

    with torch.no_grad():
        lib_fwd, _ = time_launches(sdpa)
    out = sdpa()
    lib_bwd, _ = time_launches(lambda: torch.autograd.grad(
        out, (qs, ks, vs), dos, retain_graph=True))
    print(f"  SDPA (is_causal, enable_gqa): forward {lib_fwd:.4f} ms, "
          f"backward (dq, dk, dv together) {lib_bwd:.4f} ms; plain: "
          f"forward {plain_fwd:.4f} ms, backward (all three) "
          f"{plain_bwd:.4f} ms")
    # the cost of bf16 rounding: the kernels' and SDPA's distance from the
    # plain fp32 version (its backward from its own forward)
    po, pm, pl = ref.flash_fwd_ref(q, k, v)
    plain = (po,) + ref.flash_bwd_ref(q, k, v, po, pm, pl, do)
    dq = kflash._dq_cuda(*bwd)
    kern = (o, dq, dk0, dv0)
    lib = [x.reshape(y.shape) for x, y in zip(
        (out,) + torch.autograd.grad(out, (qs, ks, vs), dos), plain)]
    torch.cuda.synchronize()
    print("  max|diff| from the plain version, kernels / SDPA: " + ", ".join(
        f"{n} {max_err(a, p):.3e} / {max_err(b, p):.3e}"
        for n, a, b, p in zip(("o", "dq", "dk", "dv"), kern, lib, plain)))

    work = flash_work(B, T, Hq, Hkv, hd)
    rows = []
    for name, err, plain_ms, lib_ms, src, line in (
            ("flash_fwd", err_fwd, plain_fwd, lib_fwd, "flash_fwd.cu", 105),
            ("flash_bwd_dq", err_dq, plain_bwd, lib_bwd, "flash_bwd.cu", 166),
            ("flash_bwd_dkv", err_dkv, plain_bwd, lib_bwd, "flash_bwd.cu",
             192)):
        w = work[name]
        b = bound(name, w["nbytes"], w["fp32_flops"], w["tc_flops"])
        all_tc = bound_ms(w["nbytes"], 0, w["tc_flops"] + w["fp32_flops"])[0]
        print(f"  {name} bound with every product on the tensor cores: "
              f"{all_tc * 1e3:.3f} us; the kernels' own duration "
              f"{timed[name] / b['bound_ms']:.2f}x the bound, "
              f"{timed[name] / lib_ms:.2f}x SDPA's "
              f"{'forward' if name == 'flash_fwd' else 'whole backward'}")
        rows.append(dict(name=name, route="cuda",
                         source=f"src/repro_torch/csrc/{src}",
                         replaces=f"src/repro/kernels/flash_attn.py:{line}",
                         max_abs_err=err, ms=timed[name], plain_ms=plain_ms,
                         **b, bound_all_tc_ms=all_tc, library_ms=lib_ms))
    return rows


def attn_decode_phase(ref, kattn, time_launches, kernels_per_call,
                      shapes):
    """The flash-decode kernel against its plain version at the three
    shapes, bf16 (o: one rounding step, rtol = atol = 2e-2), bitwise equal
    over 5 calls of one kernel launch each (profiler), each timed
    beside its bound (bytes of q, o and the occupied K/V rows; fp32 FLOP of
    the visible slots), the plain version and one SDPA call with the same
    boolean mask (``enable_gqa``)."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for label, B, Hq, Hkv, d, T, lengths, window in shapes:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
        q, k, v = rnd(B, Hq, d), rnd(B, Hkv, T, d), rnd(B, Hkv, T, d)
        length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        o = kattn.attn_decode(q, k, v, length, window=window)
        want = ref.attn_decode_ref(q, k, v, length, window=window)
        mask = ref.attn_decode_visible(length, T, window)[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)

        lib_o = sdpa()[:, :, 0]
        torch.cuda.synchronize()
        err = check(f"attn_decode {label}", o, want, 2e-2, 2e-2)
        check(f"attn_decode {label} vs SDPA", o, lib_o, 2e-2, 2e-2)

        def call():
            return kattn.attn_decode(q, k, v, length, window=window)

        n_diff = max(int((call() != o).sum()) for _ in range(4))
        per_call, names = kernels_per_call(call)
        print(f"  attn_decode {label}: 5 calls "
              + ("bitwise equal" if n_diff == 0 else
                 f"differ in up to {n_diff} of {o.numel()} elements")
              + f"; {per_call:g} kernel launch per call ({names})")
        if n_diff or per_call != 1:
            raise AssertionError(f"attn_decode {label}: not one launch per "
                                 f"call, or not bitwise reproducible")
        ev_ms, ms = time_launches(call, "attn_decode_")
        plain_ms, _ = time_launches(
            lambda: ref.attn_decode_ref(q, k, v, length, window=window))
        lib_ms, _ = time_launches(sdpa)
        occupied = int(torch.clamp(length, max=T).sum())
        visible = int(mask.sum())
        nbytes = 2 * B * Hq * d * 2 + 2 * occupied * Hkv * d * 2 + B * 4
        b = bound(f"attn_decode {label}", nbytes, 4 * Hq * d * visible)
        print(f"  attn_decode {label}: the kernel's own duration "
              f"{ms * 1e3:.2f} us (CUDA events {ev_ms * 1e3:.2f} us), bound "
              f"{b['bound_ms'] * 1e3:.2f} us by {b['bound_by']}, plain "
              f"{plain_ms * 1e3:.2f} us, SDPA {lib_ms * 1e3:.2f} us")
        rows.append(dict(shape=label, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, **b))
    main = rows[1]
    return dict(name="attn_decode", route="cuda",
                source="src/repro_torch/csrc/attn_decode.cu",
                replaces="src/repro/kernels/attn_decode.py:78",
                max_abs_err=max(x["max_abs_err"] for x in rows),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], shape=main["shape"],
                shapes=rows)


# ---------------------------------------------------------------- phase 3

def _one_step(cfg, params, lm, toks, tok):
    """Logits of one decode step with the kernels and one through the
    plain path, each from its own copy of the caches a 64-token plain
    prefill left."""
    plain = cfg.replace(use_pallas_serving=False)
    caches = lm.init_caches(plain, toks.shape[0], 1024, device="cuda")
    lm.prefill_chunk(params, plain, caches, tokens=toks)
    twin = [[type(c)(*(t.clone() for t in c)) for c in g] for g in caches]
    lk, caches = lm.decode_step(params, cfg, tok, caches)
    lp, _ = lm.decode_step(params, plain, tok, twin)
    torch.cuda.synchronize()
    for t in [lk] + [t for g in caches for c in g for t in c]:
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise AssertionError("non-finite logits or caches (kernels)")
    return lk, lp


def model_phase(cfg, params, lm):
    """One full-width decode step with the kernels against the plain path.

    fp32 activations (the same weights upcast): the paths differ only in
    summation order, so the logits agree to 1e-3 and the argmax is equal.
    bf16 activations (the serving dtype): a one-ulp difference of a bf16
    rounding grows through 48 layers of a random model, so the stated
    tolerance is relative to bf16 itself — the kernel path may be no
    further from the fp32 logits than twice the plain bf16 path is, and
    the argmax must agree wherever the plain top-two gap exceeds the
    plain path's own error."""
    from repro_torch.tree import tree_map
    B = CFG["B"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(1, cfg.vocab, (B, 64), generator=gen,
                         device="cuda")
    tok = torch.randint(1, cfg.vocab, (B,), generator=gen, device="cuda")
    cfg32 = cfg.replace(act_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    k32, truth = _one_step(cfg32, p32, lm, toks, tok)
    del p32
    err32 = max_err(k32, truth)
    same32 = bool((k32.argmax(-1) == truth.argmax(-1)).all())
    print(f"  fp32 decode_step logits: max|diff| {err32:.3e} (atol 1e-3), "
          f"argmax equal {same32}")
    if err32 > 1e-3 or not same32:
        raise AssertionError("fp32 decode_step: kernel path disagrees")
    lk, lp = _one_step(cfg, params, lm, toks, tok)
    if lk.shape != (B, cfg.vocab):
        raise AssertionError(f"logits shape {tuple(lk.shape)}")
    err_k, err_p = max_err(lk, truth), max_err(lp, truth)
    top2 = lp.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    same = lk.argmax(-1) == lp.argmax(-1)
    print(f"  bf16 decode_step logits: max|kernel - plain| "
          f"{max_err(lk, lp):.3e}; from fp32: kernel {err_k:.3e}, plain "
          f"{err_p:.3e} (limit 2x plain); argmax equal {same.tolist()}, "
          f"plain top-2 gaps {[round(float(x), 4) for x in gap]}")
    if err_k > 2 * err_p or not bool((same | (gap <= err_p)).all()):
        raise AssertionError("bf16 decode_step: kernel path disagrees")


# ---------------------------------------------------------------- phase 4

def serve_phase(cfg, params, engine_mod, kdecode, kprefill, card):
    Engine, Request = engine_mod.DecodeEngine, engine_mod.Request
    kw = dict(max_slots=4, max_len=1024, prefill_chunk=64, decode_block=8,
              seed=0, device="cuda")
    rng = np.random.default_rng(0)

    def requests(n, lo, hi, new):
        out = []
        for i in range(n):
            stoch = i == 2
            out.append(Request(
                rid=i, prompt=rng.integers(1, cfg.vocab,
                                           size=int(rng.integers(lo, hi + 1))),
                max_new_tokens=new, temperature=0.8 if stoch else 0.0,
                top_k=40 if stoch else 0))
        return out

    warm = Engine(cfg, params, **kw)        # first-call set-up, not timed
    for r in requests(2, 100, 130, 4):
        warm.submit(r)
    warm.run_until_done()
    del warm

    eng = Engine(cfg, params, **kw)
    reqs = requests(6, 100, 400, 32)
    kdecode.launches = kprefill.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gdn_decode": kdecode.launches,
                "gdn_prefill": kprefill.launches}
    m = eng.metrics()
    n_gdn = sum(k == "gdn" for k in cfg.layer_kinds)
    print(f"  prompts {[r.prompt_len for r in reqs]}, "
          f"{m['tokens']} tokens in {wall:.3f} s")
    for r in reqs:
        if len(r.output) != 32 or not all(0 <= t < cfg.vocab
                                          for t in r.output):
            raise AssertionError(f"request {r.rid}: bad output {r.output}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    if launches["gdn_decode"] != n_gdn * eng.decode_steps:
        raise AssertionError(
            f"gdn_decode launches {launches['gdn_decode']} != {n_gdn} x "
            f"{eng.decode_steps} decode steps")
    print(f"  launches {launches} = {n_gdn} GDN layers x "
          f"{eng.decode_steps} decode steps (+ prefill chunks)")
    print(f"  serve [{card}]: decode {m['decode_us_per_token']:.1f} "
          f"us/token ({m['decoded_tokens']} tokens over {m['ticks']} ticks), "
          f"mean TTFT {m['mean_ttft_s'] * 1e3:.1f} ms, "
          f"{m['tokens'] / wall:.1f} tok/s overall, "
          f"{m['mean_tokens_per_s']:.1f} tok/s per request")
    print("  streams (first 8 tokens): "
          + "; ".join(f"{r.rid}:{r.output[:8]}" for r in reqs))
    return launches


# ---------------------------------------------------------------- phase 5

def _loss_and_grad_norm(params, cfg, batch):
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import global_norm
    from repro_torch.tree import leaves
    loss, _ = lm.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves(params), allow_unused=True)
    norm = global_norm([g for g in grads if g is not None])
    return float(loss.detach()), float(norm)


def train_phase(cfg, card, kflash, kernel_mods):
    """Full-width training through the port's Trainer with the flash
    kernels.  Before training, ``loss_fn`` and its gradients at the initial
    parameters on the step-0 batch through the kernels against the plain
    ``blockwise_attention`` path: bf16 activations, so the limits are
    relative to bf16 (loss 1e-2, gradient global norm 2e-2).  Then 3 steps
    with every launch counter zeroed just before and read just after."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.lm import param_count
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves
    tcfg = cfg.replace(use_flash_kernel=True)
    steps, n_attn = 3, sum(k == "attn" for k in cfg.layer_kinds)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckdir:
        tc = TrainerConfig(
            steps=steps, seq_len=FLASH["T"], global_batch=FLASH["B"],
            warmup_steps=1, ckpt_dir=ckdir, ckpt_every=1000, log_every=1)
        tr = Trainer(tcfg, tc, device="cuda")
        t0 = time.perf_counter()
        tr.compile()
        torch.cuda.synchronize()
        params = tr.state["params"]
        print(f"  state drawn in {time.perf_counter() - t0:.1f} s: "
              f"{param_count(params) / 1e9:.3f} B {cfg.act_dtype} params, AdamW "
              f"fp32 moments; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        batch = tr.batch(0)
        for p in leaves(params):
            p.requires_grad_(True)
        t0 = time.perf_counter()
        lf, nf = _loss_and_grad_norm(params, tcfg, batch)
        t1 = time.perf_counter()
        lp, np_ = _loss_and_grad_norm(
            params, cfg.replace(use_flash_kernel=False), batch)
        t2 = time.perf_counter()
        dl, dn = abs(lf - lp) / abs(lp), abs(nf - np_) / np_
        print(f"  loss_fn at init, step-0 batch: flash {lf:.6f} "
              f"({t1 - t0:.1f} s with grads), plain {lp:.6f} "
              f"({t2 - t1:.1f} s): relative difference {dl:.3e} (limit "
              f"1e-2); grad global norm flash {nf:.6f}, plain {np_:.6f}: "
              f"{dn:.3e} (limit 2e-2)")
        if not (math.isfinite(lf) and math.isfinite(nf)) or dl > 1e-2 \
                or dn > 2e-2:
            raise AssertionError("flash and plain loss_fn disagree")

        for mod in kernel_mods:
            if isinstance(mod.launches, dict):
                for k in mod.launches:
                    mod.launches[k] = 0
            else:
                mod.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hist = tr.run()
        wall = time.perf_counter() - t0
        launches = dict(kflash.launches)
        others = {m.__name__: m.launches for m in kernel_mods
                  if not isinstance(m.launches, dict)}
        peak = torch.cuda.max_memory_allocated()
        losses = [l for _, l in hist]
        print(f"  losses {losses} (ln V = {math.log(cfg.vocab):.4f}); "
              f"step-1 loss against loss_fn at init: "
              f"{abs(losses[0] - lf) / lf:.3e}")
        if [s_ for s_, _ in hist] != list(range(1, steps + 1)) or not all(
                math.isfinite(l) for l in losses):
            raise AssertionError(f"bad training history {hist}")
        if abs(losses[0] - lf) / lf > 1e-3:
            raise AssertionError("step 1 does not compute loss_fn at init")
        if losses[0] < math.log(cfg.vocab) - 0.5:
            raise AssertionError("a random model beat the uniform loss")
        fwd_runs = 2 if cfg.remat else 1            # remat runs it again
        want = {"flash_fwd": fwd_runs * n_attn * steps,
                "flash_bwd_dq": n_attn * steps,
                "flash_bwd_dkv": n_attn * steps}
        print(f"  flash launches {launches} over {steps} steps (expected "
              f"{want}: {n_attn} attention layers, each forward run again "
              f"by remat); other kernels {others}")
        if launches != want or any(others.values()):
            raise AssertionError("unexpected kernel launches in training")
        st = sorted(tr.step_times[1:])
        step_s = st[len(st) // 2]
        tokens = FLASH["B"] * FLASH["T"]
        print(f"  train [{card}]: step times "
              f"{[round(t, 4) for t in tr.step_times]} s; median of steps "
              f"2-{steps} {step_s:.4f} s = {tokens / step_s:.1f} tokens/s; "
              f"peak memory {peak / 2**30:.2f} GiB "
              f"(max_memory_allocated); run() with its final checkpoint "
              f"{wall:.1f} s")
        mgr = CheckpointManager(ckdir)
        with open(pathlib.Path(ckdir) / f"step_{steps:09d}" /
                  "manifest.json") as f:
            manifest = json.load(f)
        state_bytes = sum(t.numel() * t.element_size()
                          for t in leaves(tr.state))
        print(f"  checkpoint: step {mgr.latest_step()}, "
              f"{manifest['nbytes'] / 2**30:.2f} GiB in "
              f"{len(manifest['keys'])} arrays")
        if mgr.latest_step() != steps or manifest["nbytes"] != state_bytes:
            raise AssertionError("the final checkpoint is incomplete")
    return launches


# ---------------------------------------------------------------- phase 6

DANUBE_PROMPTS = (5000, 4500, 1000, 200)


def _danube_serve(cfg, params, engine_mod, card):
    """(i) Four requests, two with prompts past the 4096-token window,
    through ``DecodeEngine`` to completion (after a short warm run)."""
    Engine, Request = engine_mod.DecodeEngine, engine_mod.Request
    kw = dict(max_slots=4, max_len=8192, prefill_chunk=256, decode_block=8,
              seed=0, device="cuda")
    rng = np.random.default_rng(6)
    warm = Engine(cfg, params, **kw)
    for i in range(2):
        warm.submit(Request(rid=i, prompt=rng.integers(1, cfg.vocab, 300),
                            max_new_tokens=4))
    warm.run_until_done()
    del warm
    eng = Engine(cfg, params, **kw)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, n),
                    max_new_tokens=32, temperature=0.8 if i == 2 else 0.0,
                    top_k=40 if i == 2 else 0)
            for i, n in enumerate(DANUBE_PROMPTS)]
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        if len(r.output) != 32 or not all(0 <= t < cfg.vocab
                                          for t in r.output):
            raise AssertionError(f"request {r.rid}: bad output {r.output}")
    m = eng.metrics()
    print(f"  serve [{card}]: prompts {[r.prompt_len for r in reqs]} "
          f"(window {cfg.window}), {m['tokens']} tokens in {wall:.3f} s = "
          f"{m['tokens'] / wall:.1f} tok/s; decode "
          f"{m['decode_us_per_token']:.1f} us/token ({m['decoded_tokens']} "
          f"tokens over {m['ticks']} ticks), mean TTFT "
          f"{m['mean_ttft_s'] * 1e3:.1f} ms")
    print("  streams (first 8 tokens): "
          + "; ".join(f"{r.rid}:{r.output[:8]}" for r in reqs))


def _danube_layers(cfg, params, lm, attention, kattn):
    """(ii) The four prompts prefilled in chunks of 256 (per-row ragged),
    then on every layer's cache the kernel path against the mixers' path
    on clones with one ``x_t``.  bf16 outputs: phase 3's rule — the kernel
    path no further from the fp32 truth (``attn_decode_xla`` on the same
    inputs upcast) than twice the plain bf16 path; the new caches bitwise
    equal (the same insert)."""
    from repro_torch.tree import tree_map
    B, C = len(DANUBE_PROMPTS), 256
    n = -(-max(DANUBE_PROMPTS) // C)
    gen = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(1, cfg.vocab, (B, n, C), generator=gen,
                         device="cuda")
    lens = torch.tensor(DANUBE_PROMPTS, device="cuda")
    starts = torch.arange(n, device="cuda")[:, None] * C
    vls = torch.clamp(lens[None, :] - starts, 0, C).to(torch.int32)
    caches = lm.init_caches(cfg, B, 8192, device="cuda")
    t0 = time.perf_counter()
    lm.prefill_chunk_scan(params, cfg, caches, tokens=toks, valid_lens=vls)
    torch.cuda.synchronize()
    kv_bytes = sum(t.numel() * t.element_size() for g in caches
                   for c in g for t in c)
    print(f"  prefilled rows of {list(DANUBE_PROMPTS)} tokens in {n} chunks "
          f"of {C} in {time.perf_counter() - t0:.2f} s; KV cache "
          f"{kv_bytes / 2**30:.3f} GiB")
    x_t = torch.randn(B, cfg.d_model, generator=gen, device="cuda").to(
        torch.bfloat16)
    kw = dict(rope_theta=cfg.rope_theta)
    kattn.launches = 0
    n_layers, worst = 0, 0.0
    for (kinds, reps), gp, gc in zip(lm.build_groups(cfg), params["groups"],
                                     caches):
        for r in range(reps):
            for i in range(len(kinds)):
                lp = tree_map(lambda a: a[r], gp[i])["mixer"]
                c = tree_map(lambda a: a[r], gc[i])
                ck = type(c)(*(t.clone() for t in c))
                cx = type(c)(*(t.clone() for t in c))
                ok, ck = attention.attn_decode_pallas(lp, x_t, ck, **kw)
                ox, cx = attention.attn_decode_xla(lp, x_t, cx,
                                                   window=cfg.window, **kw)
                c32 = type(c)(c.k.float(), c.v.float(), c.length.clone())
                truth, _ = attention.attn_decode_xla(
                    {k_: w.float() for k_, w in lp.items()}, x_t.float(),
                    c32, window=cfg.window, **kw)
                torch.cuda.synchronize()
                err_k, err_x = max_err(ok, truth), max_err(ox, truth)
                if not bool(torch.isfinite(ok.float()).all()) or (
                        err_k > 2 * err_x and not torch.equal(ok, ox)):
                    raise AssertionError(
                        f"layer {n_layers}: kernel {err_k:.3e} from fp32, "
                        f"plain {err_x:.3e}")
                if not all(torch.equal(a, b_) for a, b_ in zip(ck, cx)):
                    raise AssertionError(f"layer {n_layers}: the caches "
                                         f"differ")
                worst = max(worst, err_k / max(err_x, 1e-30))
                if n_layers == 0:
                    print(f"  layer 0: lengths {ck.length.tolist()} on "
                          f"{ck.k.shape[2]} slots; max|kernel - plain| "
                          f"{max_err(ok, ox):.3e}, from fp32: kernel "
                          f"{err_k:.3e}, plain {err_x:.3e} (limit 2x "
                          f"plain)")
                n_layers += 1
    launches = kattn.launches
    print(f"  {n_layers} layers: outputs within tolerance (worst kernel / "
          f"plain error ratio {worst:.3f}), caches bitwise equal; "
          f"attn_decode launches {launches}")
    if launches != n_layers or n_layers != cfg.n_layers:
        raise AssertionError(f"attn_decode launched {launches} times for "
                             f"{n_layers} layers")
    return {"attn_decode": launches}


def danube_phase(card, lm, attention, engine_mod, kattn, configs):
    cfg = configs.get_arch("h2o-danube-1.8b")
    t0 = time.perf_counter()
    params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    torch.cuda.synchronize()
    print(f"[6] full-width {cfg.name}: {lm.param_count(params) / 1e9:.3f} B "
          f"params ({cfg.act_dtype}) drawn in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    _danube_serve(cfg, params, engine_mod, card)
    return _danube_layers(cfg, params, lm, attention, kattn)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels, hold them against their plain "
                         "versions and stop")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from repro_torch import configs
        from repro_torch.kernels import _build, ops, ref
        from repro_torch.kernels import attn_decode as kattn
        from repro_torch.kernels import flash_attn as kflash
        from repro_torch.kernels import gdn_decode as kdecode
        from repro_torch.kernels import gdn_prefill as kprefill
        from repro_torch.launch.profile_decode import (ATTN_DECODE_SHAPES,
                                                       kernels_per_call,
                                                       time_launches)
        from repro_torch.models import attention, lm
        from repro_torch.runtime import trainer  # noqa: F401
        from repro_torch.serving import engine as engine_mod
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    _build.build_all()
    print(f"  built {sorted(_build.build_log) or 'nothing new'} in "
          f"{_build.build_seconds:.1f} s")
    for name, log in sorted(_build.build_log.items()):
        for kernel, regs, spills in ptxas_report(log):
            print(f"  {name}: {kernel}: {regs} registers, {spills}")

    print(f"[2] kernels vs plain versions, full-width shapes [{card}]")
    rows = [decode_phase(ref, kdecode, time_launches),
            prefill_phase(ops, ref, kprefill, time_launches)]
    rows += flash_phase(ref, kflash, time_launches, kernels_per_call)
    rows.append(attn_decode_phase(ref, kattn, time_launches,
                                  kernels_per_call, ATTN_DECODE_SHAPES))
    for r in rows:
        lib = "" if r["library_ms"] is None else \
            f", library {r['library_ms'] * 1e3:.2f} us"
        print(f"  {r['name']}: {r['ms'] * 1e3:.2f} us (bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}, plain "
              f"{r['plain_ms'] * 1e3:.2f} us{lib})")
    if args.kernels_only:
        print(json.dumps({"kernels": rows}))
        return 0

    cfg = configs.get_arch("qwen3-next-gdn").replace(use_pallas_serving=True)
    t0 = time.perf_counter()
    params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    torch.cuda.synchronize()
    print(f"[3] full-width {cfg.name}: {lm.param_count(params) / 1e9:.3f} B "
          f"params ({cfg.act_dtype}) drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    model_phase(cfg, params, lm)

    print(f"[4] serving through DecodeEngine [{card}]")
    launches = serve_phase(cfg, params, engine_mod, kdecode, kprefill,
                           card)
    del params
    torch.cuda.empty_cache()

    print(f"[5] training full-width {cfg.name} through Trainer with the "
          f"flash kernels [{card}]")
    launches.update(train_phase(cfg, card, kflash,
                                (kflash, kdecode, kprefill, kattn)))
    torch.cuda.empty_cache()

    launches.update(danube_phase(card, lm, attention, engine_mod, kattn,
                                 configs))
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
