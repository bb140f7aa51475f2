"""Where a full-width training step's time goes on the card, replayed
from its CUDA graph and eagerly.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        [--arch mixtral-8x7b --layers 2]

The full-width ``--arch`` (default qwen3-next-gdn; random bf16 weights
from ``--seed``; ``--layers`` cuts the depth of a model whose training
state does not fit the card whole) in the port's ``Trainer`` with the
flash kernels (``use_flash_kernel``), global batch ``--global-batch`` x
``--seq-len`` tokens.  The trainer's step
program runs its eager first call, then captures its graph (capture and
instantiation timed, kernel nodes counted).  Then, on the same state, the
step is timed without the profiler in turns (replayed, eager, eager,
replayed: the eager step is the same step function called directly), and
one step of each runs under ``torch.profiler``: the script prints its wall
time, the device's busy share, the launches per step, the device's idle
time per launch, the flash kernels' part, the top kernels by device time
and the top host operators.  Device memory (allocated, reserved, and the
part of it in the graph's private pool) is printed after step 1, after
the capture and at the end.  The card's name and power limit head the
output.

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
from repro_torch.runtime.graphs import graph_nodes


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


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _profile(name, fn, args):
    """One call of ``fn`` (a whole step, synced) under the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        wall_us = _timed(fn) * 1e6
    avg = prof.key_averages()
    kernels = [e for e in avg if _dev_us(e)]
    dev_total = sum(_dev_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    flash = [e for e in kernels if "flash_" in e.key]
    tokens = args.global_batch * args.seq_len
    print(f"{name}: one step of {tokens} tokens under the profiler: wall "
          f"{wall_us / 1e3:.3f} ms, device busy {dev_total / 1e3:.3f} ms "
          f"({100 * dev_total / wall_us:.1f}% of wall), {launches} kernel "
          f"launches, the device idle {(wall_us - dev_total) / 1e3:.3f} ms "
          f"= {(wall_us - dev_total) / launches:.2f} us per launch")
    print(f"{name}: flash kernels (ms per step, calls, us per call): "
          + "; ".join(f"{e.key} {_dev_us(e) / 1e3:.3f} {e.count} "
                      f"{_dev_us(e) / e.count:.1f}" for e in flash))
    print(f"{name}: top {args.top} kernels by device time (ms per step, "
          f"calls, us per call, share of device time):")
    for e in sorted(kernels, key=_dev_us, reverse=True)[:args.top]:
        print(f"  {_dev_us(e) / 1e3:9.3f}  {e.count:7d}  "
              f"{_dev_us(e) / e.count:9.2f}  "
              f"{100 * _dev_us(e) / dev_total:5.1f}%  {e.key[:80]}")
    print(f"{name}: top {args.top} host operators by self time (ms per "
          f"step, calls):")
    host = [e for e in avg if e.device_type !=
            torch.autograd.DeviceType.CUDA]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:args.top]:
        print(f"  {e.self_cpu_time_total / 1e3:9.3f}  {e.count:7d}  "
              f"{e.key[:80]}")


def _memory(pool) -> str:
    """Allocated and reserved device memory, the reserved split between the
    graph's private pool (``pool``) and the rest."""
    in_pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                  if tuple(seg.get("segment_pool_id", ())) == tuple(pool))
    gib = 2 ** 30
    return (f"{torch.cuda.memory_allocated() / gib:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / gib:.2f} GiB reserved "
            f"({in_pool / gib:.2f} GiB of it in the graph's pool)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-next-gdn",
                    help="any arch of the port's registry, at full width")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: all)")
    ap.add_argument("--global-batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=2048)
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
    cfg = configs.get_arch(args.arch).replace(use_flash_kernel=True)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    tc = TrainerConfig(steps=8, seq_len=args.seq_len,
                       global_batch=args.global_batch, warmup_steps=1,
                       seed=args.seed)
    tr = Trainer(cfg, tc, device="cuda").compile(keep_graph=True)
    tr.batch(0)
    first = _timed(tr.step)                 # eager: warms cuBLAS, kernels
    print(f"memory after step 1: {_memory(tr.program.pool)}")
    second = _timed(tr.step)                # captures, then replays
    print(f"memory after step 2 (cache emptied, captured, replayed): "
          f"{_memory(tr.program.pool)}")
    prog = tr.program
    kernels, nodes = graph_nodes(prog.graph)
    print(f"step 1 (eager) {first:.3f} s; step 2 {second:.3f} s: capture "
          f"{prog.capture_s:.3f} s, instantiation {prog.instantiate_s:.3f} "
          f"s, one graph of {kernels} kernel nodes ({nodes} nodes)")
    steps = {"graphs": tr.step,
             "eager": lambda: tr._step_fn(tr.state, tr._batch)}
    for name in ("graphs", "eager", "eager", "graphs"):
        print(f"{name}: step {_timed(steps[name]):.4f} s (no profiler)")
    for name in ("graphs", "eager"):
        _profile(name, steps[name], args)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB (max_memory_allocated); after the eager steps: "
          f"{_memory(tr.program.pool)}")


if __name__ == "__main__":
    main()
