"""Serving launcher of the port: continuous-batching decode with persistent
state slots (the base flags of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-next-gdn \
        --requests 8 --max-new 16 --decode-block 4 --kernels

Runs on the card (``--device cuda``, the default) or, with
``--device cpu``, on the CPU through the kernels' plain versions.
``--kernels`` sets ``use_pallas_serving``: the GDN layers (``gdn``, and
``ssm`` with ``delta_rule=False``, e.g. ``--arch mamba2-1.3b``) then run
the hand-written CUDA kernels; ``rglru`` (``--arch recurrentgemma-2b``)
has none.  On the card every decode and prefill program
is replayed from a CUDA graph; ``--no-cuda-graphs`` runs them eagerly
(the comparison run: the streams are the same).  ``--full`` serves the full-width config with
weights drawn on the device from ``--seed``; the default is the reduced
config.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.models import lm
from repro_torch.serving.engine import DecodeEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--decode-block", type=int, default=4,
                    help="decode+sample steps fused per engine tick "
                         "(host syncs once per block)")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt chunk size for staged prefill")
    ap.add_argument("--staging-depth", type=int, default=2,
                    help="staging-buffer ring size: ahead-of-slot "
                         "prefills outstanding under saturation")
    ap.add_argument("--serialized", dest="overlap", action="store_false",
                    default=True,
                    help="disable prefill/decode overlap (admit prefills "
                         "behind a free slot)")
    ap.add_argument("--no-budget-ticks", dest="budget_ticks",
                    action="store_false", default=True,
                    help="always run full decode-block ticks")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="device top-k sampling (0 = disabled)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="device nucleus sampling (1.0 = disabled)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--kernels", action="store_true", default=False,
                    help="use_pallas_serving: run the GDN and SSD layers "
                         "through the hand-written CUDA kernels")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--no-cuda-graphs", dest="cuda_graphs",
                    action="store_false", default=None,
                    help="run the programs eagerly on the card instead of "
                         "replaying CUDA graphs")
    args = ap.parse_args(argv)

    cfg = configs.get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.kernels:
        cfg = cfg.replace(use_pallas_serving=True)
    params = lm.init_lm(args.seed, cfg, device=args.device)
    eng = DecodeEngine(cfg, params, max_slots=args.slots,
                       max_len=args.max_len, seed=args.seed,
                       decode_block=args.decode_block, overlap=args.overlap,
                       prefill_chunk=args.prefill_chunk,
                       budget_ticks=args.budget_ticks,
                       staging_depth=args.staging_depth, device=args.device,
                       cuda_graphs=args.cuda_graphs)
    print(f"engine: {args.slots} slots x (persistent state "
          f"{eng.state_bytes_per_slot / 2**10:.1f} KiB + window/KV "
          f"{eng.window_bytes_per_slot / 2**10:.1f} KiB) = "
          f"{eng.cache_bytes / 2**20:.2f} MiB slot buffers on "
          f"{eng.executor.device}, decode_block={args.decode_block}, "
          f"prefill={'overlapped' if args.overlap else 'serialized'} "
          f"chunks of {eng.prefill_chunk}, kernels={args.kernels}, "
          f"cuda_graphs={eng.executor.cuda_graphs}")
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab, size=rng.integers(4, 17),
                              dtype=np.int32)
        eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=args.max_new,
                           temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p))
    t0 = time.perf_counter()
    done = eng.run_until_done()
    dt = time.perf_counter() - t0
    m = eng.metrics()
    print(f"served {m['requests']} requests, {m['tokens']} tokens in "
          f"{dt:.2f}s ({m['tokens'] / dt:.1f} tok/s) over {m['ticks']} "
          f"engine ticks")
    print(f"  decode: {m['decode_us_per_token']:.0f} us/token "
          f"({m['decoded_tokens']} tokens in {m['decode_s']:.2f}s, "
          f"{m['stage_dispatches']} staged prefill + "
          f"{m['scatter_dispatches']} scatter dispatches)")
    print(f"  per-request means: ttft {m['mean_ttft_s'] * 1e3:.1f} ms, "
          f"latency {m['mean_latency_s'] * 1e3:.1f} ms, "
          f"{m['mean_tokens_per_s']:.1f} tok/s")
    print(f"  programs: {eng.executor.compiled_programs()}")
    for r in done[:4]:
        print(f"  req {r.rid}: ttft {r.ttft_s * 1e3:.1f} ms, "
              f"{len(r.output)} toks: {list(r.output)}")


if __name__ == "__main__":
    main()
