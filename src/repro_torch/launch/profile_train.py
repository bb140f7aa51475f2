"""Where a full-width training step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_train

Full-width qwen3-next-gdn (random bf16 weights from ``--seed``) in the
port's ``Trainer`` with the flash kernels (``use_flash_kernel``), global
batch ``--global-batch`` x ``--seq-len`` tokens.  After ``--warm`` steps,
one step runs under ``torch.profiler`` and the script prints its wall time,
the device's busy share of it, the top kernels by device time, the flash
kernels' part, the top host operators, and the launches per step.  The
card's name and power limit head the output.

``--dkv-clusters`` runs only ``dkv_cluster_study``: the bf16 dk/dv kernel
at the trained attention shape with each thread-block-cluster size over
the G query heads in turn.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

from repro_torch import configs
from repro_torch.launch.profile_decode import _dev_us
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def dkv_cluster_study(clusters=(1, 2, 4, 8)):
    """The bf16 dk/dv kernel at the trained attention shape (B=2, T=2048,
    GQA 16:2, hd=128) with its own cluster size and then each of
    ``clusters``: the kernel's own duration after a read flush
    (``time_launches``), and its output against the first size's (each
    size sums the heads in another fixed order, so the bits may differ)."""
    from repro_torch.kernels import flash_attn as kflash
    from repro_torch.launch.profile_decode import time_launches
    gen = torch.Generator(device="cuda").manual_seed(3)
    BH, G, T, hd = 4, 8, 2048, 128
    q, do = (torch.randn(BH, G, T, hd, generator=gen, device="cuda")
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(BH, T, hd, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    o, m, l = kflash.flash_fwd(q, k, v)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    args = (q, k, v, do, m, l, delta, None, hd ** -0.5, 0)
    own = kflash.cluster_size(G)
    first = None
    for c in (own,) + tuple(x for x in clusters if x != own):
        dk, dv = kflash._dkv_cuda(*args, cluster=c)
        first = first or (dk, dv)
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip((dk, dv), first))
        _, ms = time_launches(lambda: kflash._dkv_cuda(*args, cluster=c),
                              "flash_dkv_")
        print(f"flash_bwd_dkv, G={G}, cluster {c} ({G // c} heads per "
              f"CTA{', the default' if c == own else ''}): {ms * 1e3:.2f} "
              f"us; max|diff| from cluster {own} {diff:.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--global-batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--warm", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--dkv-clusters", action="store_true",
                    help="only the dk/dv kernel's cluster-size study")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train measures the card: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    if args.dkv_clusters:
        dkv_cluster_study()
        return
    cfg = configs.get_arch("qwen3-next-gdn").replace(use_flash_kernel=True)
    tc = TrainerConfig(steps=args.warm + 1, seq_len=args.seq_len,
                       global_batch=args.global_batch, warmup_steps=1,
                       seed=args.seed)
    tr = Trainer(cfg, tc, device="cuda").compile()
    for step in range(args.warm):
        tr._step_fn(tr.state, tr.batch(step))
    batch = tr.batch(args.warm)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tr._step_fn(tr.state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avg = prof.key_averages()
    kernels = [e for e in avg if _dev_us(e)]
    dev_total = sum(_dev_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    flash = [e for e in kernels if "flash_" in e.key]
    tokens = args.global_batch * args.seq_len
    print(f"one step of {tokens} tokens under the profiler: wall "
          f"{wall_us / 1e3:.3f} ms, device busy {dev_total / 1e3:.3f} ms "
          f"({100 * dev_total / wall_us:.1f}% of wall), {launches} kernel "
          f"launches")
    print("flash kernels (ms per step, calls, us per call): " + "; ".join(
        f"{e.key} {_dev_us(e) / 1e3:.3f} {e.count} "
        f"{_dev_us(e) / e.count:.1f}" for e in flash))
    print(f"top {args.top} kernels by device time (ms per step, calls, us "
          f"per call, share of device time):")
    for e in sorted(kernels, key=_dev_us, reverse=True)[:args.top]:
        print(f"  {_dev_us(e) / 1e3:9.3f}  {e.count:7d}  "
              f"{_dev_us(e) / e.count:9.2f}  "
              f"{100 * _dev_us(e) / dev_total:5.1f}%  {e.key[:80]}")
    print(f"top {args.top} host operators by self time (ms per step, "
          f"calls):")
    host = [e for e in avg if e.device_type !=
            torch.autograd.DeviceType.CUDA]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:args.top]:
        print(f"  {e.self_cpu_time_total / 1e3:9.3f}  {e.count:7d}  "
              f"{e.key[:80]}")


if __name__ == "__main__":
    main()
