"""Where a decode tick's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode

Full-width qwen3-next-gdn (random bf16 weights from ``--seed``) in a
``DecodeEngine`` with ``--slots`` requests resident.  Prints

  * the wall time of a decode step (host clock around ticks that end in a
    host sync), with the hand-written kernels and through the plain path,
    measured in turns (kernels, plain, kernels, plain);
  * a ``torch.profiler`` breakdown of ``--ticks`` kernel-path ticks: the
    device's busy share of the wall time and the top operators by device
    time and by host time;
  * the GDN decode kernel alone at the served shape, by what precedes
    each launch (``decode_kernel_study``), against its per-call time in
    the profiled ticks.

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


def _engine(cfg, params, args):
    eng = DecodeEngine(cfg, params, max_slots=args.slots, max_len=1024,
                       prefill_chunk=64, decode_block=args.block,
                       seed=args.seed)
    rng = np.random.default_rng(args.seed)
    for i in range(args.slots):
        eng.submit(Request(rid=i, prompt=rng.integers(1, cfg.vocab, 128),
                           max_new_tokens=1000))
    while len(eng.active) < args.slots:     # admit every request
        eng.step()
    eng.step()                              # one warm tick
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


def time_launches(fn, kernel=None, flush="read", reps=30, warmup=3):
    """Time ``reps`` calls of ``fn``.  Before each call, ``flush`` is
    "read" (a 256 MiB read: evicts the 50 MB L2 and leaves it clean, as
    the served path's weight GEMVs leave it before each GDN layer),
    "write" (a 256 MiB write: leaves the L2 full of dirty lines) or "none"
    (the inputs stay warm in the L2); then a spin kernel keeps the card
    busy until the host has queued the call, so no host time falls
    between the events.

    Returns (median ms between CUDA events around each call, mean ms per
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
    event_ms = sorted(a.elapsed_time(b) for a, b in events)[reps // 2]
    if kernel is None:
        return event_ms, None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run([])
    if isinstance(kernel, tuple):
        return event_ms, {n: us / 1e3 for n, us in
                          _kernel_split_us(prof, kernel, reps).items()}
    return event_ms, _kernel_split_us(prof, (kernel,), reps)[kernel] / 1e3


def kernels_per_call(fn, calls=10, tries=3):
    """(device kernels launched per call of ``fn``, their names), as the
    profiler records them.  Spin kernels pad the window on both sides and
    precede each call, and are not counted: the profiler can drop the
    records at the edge of a window, and now and then a whole window's.
    A window counts only if most of its spins were recorded (a test of
    the profiler, independent of ``fn``); up to ``tries`` windows, else
    it raises."""
    spins = 1 + calls + 4
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1_000_000)
            for _ in range(calls):
                torch.cuda._sleep(100_000)
                fn()
            for _ in range(4):
                torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = sum(e.count for e in events if "spin_kernel" in e.key)
        if seen >= spins - 2:
            kernels = [e for e in events if "spin_kernel" not in e.key]
            return (sum(e.count for e in kernels) / calls,
                    [e.key for e in kernels])
    raise RuntimeError(f"the profiler recorded too few of its windows' "
                       f"{spins} spin kernels in {tries} tries")


def decode_kernel_study(cfg, batch):
    """The GDN decode kernel alone at the served shape (``batch`` slots),
    timed by CUDA events and by the profiler after each flush of
    ``time_launches``, to hold against its per-call time in serving."""
    from repro_torch.kernels import gdn_decode as kdecode
    gen = torch.Generator(device="cuda").manual_seed(0)
    Hk, Hv, d = cfg.gdn_k_heads, cfg.gdn_v_heads, cfg.gdn_head_dim
    q, k = (torch.nn.functional.normalize(
        torch.randn(batch, Hk, d, generator=gen, device="cuda"), dim=-1)
        .to(torch.bfloat16) for _ in range(2))
    v = torch.randn(batch, Hv, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    S = 0.1 * torch.randn(batch, Hv, d, d, generator=gen, device="cuda")
    g, beta = (torch.rand(batch, Hv, generator=gen, device="cuda")
               for _ in range(2))
    for flush in ("read", "write", "none"):
        ev, own = time_launches(lambda: kdecode.gdn_decode(q, k, v, S, g,
                                                           beta),
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
    base = configs.get_arch("qwen3-next-gdn")
    decode_kernel_study(base, args.slots)
    params = lm.init_lm(args.seed, base)
    engines = {}
    for name, pallas in (("kernels", True), ("plain", False)):
        engines[name] = _engine(base.replace(use_pallas_serving=pallas),
                                params, args)
    for name in ("kernels", "plain", "kernels", "plain"):
        print(f"decode step, {args.slots} slots, {name}: "
              f"{_step_ms(engines[name], args.ticks):.3f} ms")
    eng = engines["kernels"]
    del engines["plain"]
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
    dev_total = sum(_dev_us(e) for e in avg)
    attributed = sum(e.self_device_time_total for e in avg
                     if e.device_type != torch.autograd.DeviceType.CUDA)
    print(f"profiled {steps} steps: wall {wall_us / steps / 1e3:.3f} ms/step, "
          f"device busy {dev_total / steps / 1e3:.3f} ms/step "
          f"({100 * dev_total / wall_us:.1f}% of wall, profiler on; "
          f"{attributed / steps / 1e3:.3f} ms/step attributed to operators)")
    print(f"top {args.top} kernels by device time (ms per step, calls per "
          f"step, us per call):")
    for e in sorted(avg, key=_dev_us, reverse=True)[:args.top]:
        print(f"  {_dev_us(e) / steps / 1e3:9.4f}  {e.count / steps:7.1f}  "
              f"{_dev_us(e) / e.count:8.2f}  {e.key[:90]}")
    print(f"top {args.top} by host time (self ms per step, calls per step):")
    host = [e for e in avg
            if e.device_type != torch.autograd.DeviceType.CUDA]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:args.top]:
        print(f"  {e.self_cpu_time_total / steps / 1e3:9.4f}  "
              f"{e.count / steps:7.1f}  {e.key[:90]}")


if __name__ == "__main__":
    main()
