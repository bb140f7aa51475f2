"""Where a decode tick's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        [--arch mamba2-1.3b] [--arch mixtral-8x7b --layers 16]

The full-width ``--arch`` (default qwen3-next-gdn; random bf16 weights
from ``--seed``; ``--layers`` cuts the depth of a model that does not fit
the card whole) in a ``DecodeEngine`` with ``--slots`` requests
resident.  Prints

  * the wall time of a decode step (host clock around ticks that end in a
    host sync) for three engines, measured in turns: the hand-written
    kernels replayed from CUDA graphs ("graphs", the default), the same
    kernels run eagerly ("eager", ``cuda_graphs=False``) and the plain
    path, eagerly ("plain");
  * for "graphs" and "eager", a ``torch.profiler`` breakdown of
    ``--ticks`` ticks: the device's busy share of the wall time, the
    kernels launched and the device's idle time per step (and per launch:
    the mean gap), and the top operators by device time and by host
    time;
  * where the arch's layers call the GDN decode kernel (gdn, or ssm with
    ``delta_rule=False``), the kernel alone at the served shape, by what
    precedes each launch (``decode_kernel_study``), against its per-call
    time in the profiled ticks.

``--attn-decode`` runs only ``attn_decode_study``: the flash-decode kernel
at the three shapes of ``chip_smoke.py``'s phase 2 with each split length
and ring depth in turn.

The card's name and power limit head the output.
"""
from __future__ import annotations

import argparse
import functools
import subprocess
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import lm
from repro_torch.serving.engine import DecodeEngine, Request


def _engine(cfg, params, args, cuda_graphs):
    eng = DecodeEngine(cfg, params, max_slots=args.slots, max_len=1024,
                       prefill_chunk=64, decode_block=args.block,
                       seed=args.seed, cuda_graphs=cuda_graphs)
    rng = np.random.default_rng(args.seed)
    for i in range(args.slots):
        eng.submit(Request(rid=i, prompt=rng.integers(1, cfg.vocab, 128),
                           max_new_tokens=1000))
    while len(eng.active) < args.slots:     # admit every request
        eng.step()
    for _ in range(2):                      # warm ticks: the tick's eager
        eng.step()                          # first call, then its capture
    return eng


def _step_ms(eng, ticks):
    torch.cuda.synchronize()
    steps0, t0 = eng.decode_steps, time.perf_counter()
    for _ in range(ticks):
        eng.step()                          # ends in the tick's host sync
    return (time.perf_counter() - t0) * 1e3 / (eng.decode_steps - steps0)


def _dev_us(evt):
    """Device microseconds of a kernel event (0 for host operators, whose
    kernels are listed as events of their own)."""
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def _kernel_split_us(prof, names, calls):
    """{name: device microseconds per call} of the kernels whose names
    hold each of ``names`` (a kernel counts under the first name it
    holds); names that match no kernel are left out."""
    out = {}
    for e in prof.key_averages():
        hit = next((n for n in names if n in e.key), None)
        if hit is not None and _dev_us(e):
            out[hit] = out.get(hit, 0.0) + _dev_us(e) / calls
    if not out:
        raise RuntimeError(f"the profiler recorded no kernel named any of "
                           f"{names}")
    return out


def time_launches(fn, kernel=None, flush="read", reps=30, warmup=3,
                  mean=False):
    """Time ``reps`` calls of ``fn``.  Before each call, ``flush`` is
    "read" (a 256 MiB read: evicts the 50 MB L2 and leaves it clean, as
    the served path's weight GEMVs leave it before each GDN layer),
    "write" (a 256 MiB write: leaves the L2 full of dirty lines) or "none"
    (the inputs stay warm in the L2); then a spin kernel keeps the card
    busy until the host has queued the call, so no host time falls
    between the events.

    Returns (median ms between CUDA events around each call — with
    ``mean``, their mean — mean ms per
    call of the CUDA kernels whose names hold ``kernel`` as the profiler
    (CUPTI) records them — the kernels' own durations, summed over the
    launches of one call — or None).  With a tuple of names for
    ``kernel`` the second value is {name: ms per call} instead, one entry
    for each name some kernel holds."""
    buf = torch.zeros(64 * 2**20, dtype=torch.float32, device="cuda")
    pre = {"read": buf.sum, "write": buf.zero_, "none": lambda: None}[flush]

    def run(events):
        for _ in range(reps):
            pre()
            torch.cuda._sleep(1_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()

    for _ in range(warmup):
        fn()
    events = []
    run(events)
    times = sorted(a.elapsed_time(b) for a, b in events)
    event_ms = sum(times) / reps if mean else times[reps // 2]
    if kernel is None:
        return event_ms, None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run([])
    if isinstance(kernel, tuple):
        return event_ms, {n: us / 1e3 for n, us in
                          _kernel_split_us(prof, kernel, reps).items()}
    return event_ms, _kernel_split_us(prof, (kernel,), reps)[kernel] / 1e3


def kernel_counts(fn, calls=10, windows=3):
    """{kernel name: device launches per call of ``fn``}, as the profiler
    records them in ``windows`` windows of ``calls`` calls each: for each
    name, the most that any window recorded.  The profiler (CUPTI) loses
    a record now and then and never adds one, so a window can only
    undercount; on the H100 it lost records in most windows of a replayed
    draft + verify, spin kernels most often, so no single window, and no
    marker kernel in it, vouches for the counts.  The maximum over the
    windows undercounts a kernel only where every window lost one of its
    records."""
    best = {}
    for _ in range(windows):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                best[e.key] = max(best.get(e.key, 0), e.count / calls)
    return best


def kernels_per_call(fn, calls=10, windows=3):
    """(device kernels launched per call of ``fn``, their names)."""
    counts = kernel_counts(fn, calls, windows)
    return sum(counts.values()), list(counts)


def gdn_decode_shape(cfg):
    """(Hk, Hv, d_k, d_v, delta_rule) of the GDN decode kernel's calls in
    ``cfg``'s decode step — gdn layers, or ssm layers (SSD: one q/k head,
    no delta rule) — or None where no layer calls it."""
    kinds = set(cfg.layer_kinds)
    if "gdn" in kinds:
        d = cfg.gdn_head_dim
        return cfg.gdn_k_heads, cfg.gdn_v_heads, d, d, True
    if "ssm" in kinds:
        return (1, cfg.ssm_d_inner // cfg.ssm_headdim, cfg.ssm_d_state,
                cfg.ssm_headdim, False)
    return None


def decode_kernel_study(cfg, batch):
    """The GDN decode kernel alone at the served shape (``batch`` slots),
    timed by CUDA events and by the profiler after each flush of
    ``time_launches``, to hold against its per-call time in serving."""
    from repro_torch.kernels import gdn_decode as kdecode
    gen = torch.Generator(device="cuda").manual_seed(0)
    Hk, Hv, dk, dv, delta_rule = gdn_decode_shape(cfg)
    q, k = (torch.nn.functional.normalize(
        torch.randn(batch, Hk, dk, generator=gen, device="cuda"), dim=-1)
        .to(torch.bfloat16) for _ in range(2))
    v = torch.randn(batch, Hv, dv, generator=gen, device="cuda").to(
        torch.bfloat16)
    S = 0.1 * torch.randn(batch, Hv, dk, dv, generator=gen, device="cuda")
    g, beta = (torch.rand(batch, Hv, generator=gen, device="cuda")
               for _ in range(2))
    for flush in ("read", "write", "none"):
        ev, own = time_launches(lambda: kdecode.gdn_decode(
            q, k, v, S, g, beta, delta_rule=delta_rule),
            "gdn_decode_kernel", flush=flush)
        print(f"gdn_decode kernel alone, B={batch}, after flush={flush}: "
              f"events {ev * 1e3:.2f} us, profiler {own * 1e3:.2f} us per "
              f"call")


# (label, B, Hq, Hkv, d, T, lengths, window): the flash-decode kernel's
# shapes in chip_smoke.py's phase 2; "b" is the shape its phase 6 drives
ATTN_DECODE_SHAPES = (
    ("a: qwen3-next-gdn attention, B=4, ragged", 4, 16, 2, 128, 1024,
     (1, 300, 777, 1024), None),
    ("b: h2o-danube-1.8b, B=4, wrapped, window 4096", 4, 32, 8, 80, 4096,
     (100, 4096, 4500, 9000), 4096),
    ("c: yi-9b, B=1, 32k", 1, 32, 4, 128, 32768, (32768,), None),
)


def attn_decode_study(splits=(64, 128, 192, 256, 512, 768, 1024, 2048),
                      stages=(2, 3)):
    """The flash-decode kernel (bf16) at ``ATTN_DECODE_SHAPES`` with its own
    split length and ring depth, then each of ``splits`` x ``stages``: the
    kernel's own duration after a read flush (``time_launches``)."""
    from repro_torch.kernels import attn_decode as kattn
    gen = torch.Generator(device="cuda").manual_seed(4)
    for label, B, Hq, Hkv, d, T, lengths, window in ATTN_DECODE_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for shape in ((B, Hq, d), (B, Hkv, T, d),
                                          (B, Hkv, T, d)))
        length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        own = (kattn.split_len(B, Hkv, T, d, 2, kattn.sm_count(q.device)),
               kattn.ring_stages(d, 2))
        grid = [own] + [(x, st) for x in splits for st in stages
                        if x <= T and (x, st) != own]
        for split, st in grid:
            fn = functools.partial(kattn.attn_decode, q, k, v, length,
                                   window=window, split=split, stages=st)
            _, ms = time_launches(fn, "attn_decode_")
            live = sum(kattn.live_splits(lengths, T, split)) * Hkv
            print(f"attn_decode {label}, split {split:5d}, {st} stages "
                  f"({live} live CTAs"
                  f"{', the default' if (split, st) == own else ''}): "
                  f"{ms * 1e3:.2f} us")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-next-gdn",
                    help="any arch of the port's registry, at full width")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: all)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--attn-decode", action="store_true",
                    help="only the flash-decode kernel's split study")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode measures the card: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    if args.attn_decode:
        attn_decode_study()
        return
    base = configs.get_arch(args.arch)
    if args.layers:
        base = base.replace(n_layers=args.layers)
    if gdn_decode_shape(base) is not None:
        decode_kernel_study(base, args.slots)
    params = lm.init_lm(args.seed, base)
    kernels = base.replace(use_pallas_serving=True)
    engines = {"graphs": _engine(kernels, params, args, None),
               "eager": _engine(kernels, params, args, False),
               "plain": _engine(base, params, args, False)}
    for name in ("graphs", "eager", "plain") * 2:
        print(f"decode step, {args.slots} slots, {name}: "
              f"{_step_ms(engines[name], args.ticks):.3f} ms")
    del engines["plain"]
    for name in ("graphs", "eager"):
        _breakdown(name, engines[name], args)


def _breakdown(name, eng, args):
    """The profiler's view of ``args.ticks`` ticks of ``eng``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps0 = eng.decode_steps
        for _ in range(args.ticks):
            eng.step()
        wall_us = (time.perf_counter() - t0) * 1e6
    steps = eng.decode_steps - steps0
    avg = prof.key_averages()
    kernels = [e for e in avg
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_total = sum(_dev_us(e) for e in kernels)
    launches = sum(e.count for e in kernels) / steps
    idle_us = (wall_us - dev_total) / steps
    print(f"{name}: profiled {steps} steps: wall "
          f"{wall_us / steps / 1e3:.3f} ms/step, device busy "
          f"{dev_total / steps / 1e3:.3f} ms/step ({100 * dev_total / wall_us:.1f}"
          f"% of wall, profiler on); {launches:.1f} kernels per step, the "
          f"device idle {idle_us / 1e3:.3f} ms per step = "
          f"{idle_us / launches:.2f} us per launch")
    print(f"{name}: top {args.top} kernels by device time (ms per step, "
          f"calls per step, us per call):")
    for e in sorted(kernels, key=_dev_us, reverse=True)[:args.top]:
        print(f"  {_dev_us(e) / steps / 1e3:9.4f}  {e.count / steps:7.1f}  "
              f"{_dev_us(e) / e.count:8.2f}  {e.key[:90]}")
    print(f"{name}: top {args.top} by host time (self ms per step, calls "
          f"per step):")
    host = [e for e in avg
            if e.device_type != torch.autograd.DeviceType.CUDA]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:args.top]:
        print(f"  {e.self_cpu_time_total / steps / 1e3:9.4f}  "
              f"{e.count / steps:7.1f}  {e.key[:90]}")


if __name__ == "__main__":
    main()
