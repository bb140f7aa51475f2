"""Serving launcher of the port: continuous-batching decode with persistent
state slots (the one-engine flags of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-next-gdn \
        --requests 8 --max-new 16 --decode-block 4 --kernels
    # speculative decode, self-draft or a draft arch of the same vocab
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-next-gdn \
        --speculative --k-draft 4 --device cpu

Runs on the card (``--device cuda``, the default) or, with
``--device cpu``, on the CPU through the kernels' plain versions.
``--kernels`` sets ``use_pallas_serving``: the GDN layers (``gdn``, and
``ssm`` with ``delta_rule=False``, e.g. ``--arch mamba2-1.3b``) then run
the hand-written CUDA kernels; ``rglru`` (``--arch recurrentgemma-2b``)
has none.  On the card every decode and prefill program
is replayed from a CUDA graph; ``--no-cuda-graphs`` runs them eagerly
(the comparison run: the streams are the same).  ``--full`` serves the full-width config with
weights drawn on the device from ``--seed``; the default is the reduced
config.  Prompts are staged in batches (one scan and one admit program
per tick for every staged prompt) unless ``--no-prefill-batching`` or
``--plan-mode pow2``; ``--prefill-budget`` caps the packer's tokens per
tick.  ``--speculative`` drafts ``--k-draft`` tokens per slot with
``--draft-config`` (``self``, the default, shares the target's weights;
an arch of the same vocab draws its weights from ``--seed + 1``) and
verifies them in one program; the streams are those of plain decode.
The paging flags (``--swap-policy``, ``--idle-swap-ms``,
``--max-live-requests``, ``--async-paging``, ``--gather-ring``,
``--host-swap-bytes``, ``--swap-spool-dir``) are the reference's.

``--engines N`` fronts N engines with a ``Router`` (``--router-policy``);
all of them run on ``--device``.  ``--rpc`` puts each engine in its own
worker process (``serving.rpc.EngineProxy``; each draws the weights from
``--seed`` itself), ``--workers N`` is short for ``--rpc --engines N``.
``--roles`` gives per-engine roles, cycled over the engines (e.g.
``prefill,decode``): prefill engines pause every request at the admit
boundary and the router ships its image to the least-loaded decode
engine; the streams are the colocated ones.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-next-gdn \
        --requests 4 --max-new 6 --slots 2 --max-len 64 --kernels \
        --device cpu --rpc --workers 2 --roles prefill,decode

``--mesh DATA,MODEL`` (or ``data=D,model=M``) serves one engine sharded
over a ``("data", "model")`` mesh: the slot axis on "data" (``--slots`` is
padded to a multiple of it); on "model" the vocab, the MLP, attention
heads and KV context, GDN and SSD state heads, the RG-LRU width and the
MoE experts (expert parallelism), for every arch of the registry.  The
CLI starts one rank per mesh device itself
(``torch.multiprocessing.spawn``); each draws the weights from ``--seed``
and keeps only its shards (``lm.init_lm(..., mesh=)``: a rank of an MoE
model never holds all its experts), every rank serves the same requests
and rank 0 prints.  The backend is NCCL, one card per rank, on
the card, and gloo on the CPU; ``--gloo`` runs the ranks over gloo on
the cards there are (ranks may share a card; its collectives pass
through host memory and the programs run eagerly).  A mesh needing more
cards than NCCL sees raises.

``--mesh`` with ``--engines N`` (or ``--rpc``, ``--workers N``,
``--roles``) serves N mesh engines behind one ``Router`` in this
process, each in a worker process (``EngineProxy(mesh_shape=)``) that
starts its own ranks: on NCCL engine ``i`` takes the cards from ``i *
D * M`` on, and when the cards run out the engines share the first slice
(a note says so); on gloo every engine's ranks stay on ``--device``.
By design this differs from the reference, whose ``--engines N`` without
``--rpc`` builds N in-process engines over slices of one process's
devices: a mesh engine of the port is already a group of processes, so
here it always sits in a worker, and the ``topology:`` line says so.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-next-gdn \
        --requests 4 --max-new 6 --slots 2 --max-len 64 --kernels \
        --device cpu --workers 2 --roles prefill,decode --mesh 1,2

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-next-gdn \
        --requests 4 --max-new 6 --slots 4 --max-len 64 --kernels \
        --device cpu --mesh 2,2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --requests 4 --max-new 6 --slots 2 --max-len 64 --device cpu \
        --mesh 1,2
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import ServingTopology
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.serving.engine import (DecodeEngine, EngineProxy, Request,
                                        Router)


def _roles(args):
    """Per-engine roles, cycled over ``--roles`` (default: every engine
    serves both prefill and decode)."""
    roles = [r.strip() for r in (args.roles or "both").split(",")]
    for r in roles:
        if r not in ("prefill", "decode", "both"):
            raise SystemExit(f"--roles: unknown role {r!r} "
                             f"(prefill/decode/both)")
    return [roles[i % len(roles)] for i in range(args.engines)]


def _mesh_devices(args, topo, backend):
    """Each mesh engine's ``device``: on NCCL ``cuda:<first card>`` of its
    slice ``[i * D * M, (i + 1) * D * M)`` of the cards, as the
    reference's ``build_engines`` slices its devices (the first slice,
    shared, once the cards run out), on gloo ``--device``."""
    if backend != "nccl":
        return [args.device] * args.engines
    cards = mesh_mod.visible_devices("nccl")
    out, shared = [], []
    for i in range(args.engines):
        lo = i * topo.devices
        if lo + topo.devices > cards:
            lo = 0
            shared.append(i)
        out.append(f"cuda:{lo}")
    if shared:
        print(f"note: engines {shared[0]}..{args.engines - 1} share cards "
              f"0..{topo.devices - 1} with engine 0 (only {cards} visible) "
              f"— correct, but they time-slice the same hardware")
    return out


def build_engines(cfg, params, args, common, topo=None):
    """One engine per ``--engines``, each with its role, all on
    ``--device``; with ``--rpc`` each is an ``EngineProxy`` worker process
    that draws the weights from ``--seed`` itself, the workers started
    together.  With ``topo`` (``--mesh``) each worker serves that mesh on
    its slice of the cards (``_mesh_devices``)."""
    roles = _roles(args)
    if not args.rpc:
        return [DecodeEngine(cfg, params, role=role, **common)
                for role in roles]
    kw = [dict(common) for _ in roles]
    if topo is not None:
        backend = _backend(args)
        for k, dev in zip(kw, _mesh_devices(args, topo, backend)):
            k.update(device=dev, mesh_shape=topo.shape, mesh_axes=topo.axes,
                     backend=backend)
    for i, (role, k) in enumerate(zip(roles, kw)):
        print(f"spawning worker {i} (role={role}"
              + (f", {topo.data}x{topo.model} {k['backend']} mesh from "
                 f"{k['device']}" if topo is not None else "") + ")...")
    with ThreadPoolExecutor(len(roles)) as pool:
        futs = [pool.submit(EngineProxy, cfg, params_seed=args.seed,
                            role=role, **k) for role, k in zip(roles, kw)]
    engines, errors = [], []
    for f in futs:
        try:
            engines.append(f.result())
        except Exception as e:          # noqa: BLE001 — raised below
            errors.append(e)
    if errors:
        for e in engines:
            e.shutdown()
        raise errors[0]
    return engines


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
    ap.add_argument("--plan-mode", default="masked",
                    choices=("masked", "pow2"),
                    help="prefill chunk planning: 'masked' (default) "
                         "dispatches one scan shape + one fixed-size "
                         "valid_len-masked tail per prompt; 'pow2' keeps "
                         "the power-of-two tail decomposition as the "
                         "comparison baseline")
    ap.add_argument("--staging-depth", type=int, default=2,
                    help="staging-buffer ring size: ahead-of-slot "
                         "prefills outstanding under saturation")
    ap.add_argument("--no-prefill-batching", dest="prefill_batching",
                    action="store_false", default=None,
                    help="dispatch one prefill program per staged prompt "
                         "instead of fusing all staged prompts into one "
                         "batched fixed-shape program per tick")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="per-tick prefill token budget of the batched "
                         "packer under saturation (default: every "
                         "staging row gets a full scan + admit)")
    ap.add_argument("--swap-policy", default="manual",
                    choices=("manual", "idle", "pressure", "auto"),
                    help="slot-oversubscription eviction policy: "
                         "'manual' (pause/resume/preempt API only), "
                         "'idle' (swap out active requests whose "
                         "activity lease exceeds --idle-swap-ms; touch() "
                         "renews the lease), 'pressure' (evict the "
                         "lowest-priority active request when a strictly "
                         "higher-priority request waits without a free "
                         "slot), 'auto' (both)")
    ap.add_argument("--idle-swap-ms", type=float, default=None,
                    help="activity-lease duration for --swap-policy "
                         "idle/auto: an active request untouched this "
                         "long is swapped to host, freeing its slot")
    ap.add_argument("--max-live-requests", type=int, default=None,
                    help="admission cap on live sessions (queued + "
                         "staging + active + swapped) per engine "
                         "(default: unlimited)")
    ap.add_argument("--async-paging", action="store_true", default=False,
                    help="overlap swap transfers with the decode tick: "
                         "swap-outs drain to the host in the background "
                         "through a ring of gather buffers (harvested at "
                         "tick boundaries) and predictable resume grants "
                         "put their image back one tick ahead; streams "
                         "stay those of synchronous paging")
    ap.add_argument("--gather-ring", type=int, default=2,
                    help="gather buffers for async paging: how many "
                         "swap-out drains may be outstanding before a "
                         "dispatch force-harvests the oldest")
    ap.add_argument("--host-swap-bytes", type=int, default=None,
                    help="spill watermark: when in-memory swapped images "
                         "exceed this many bytes, the coldest dormant one "
                         "spills to --swap-spool-dir (default: 0 when a "
                         "spool dir is set)")
    ap.add_argument("--swap-spool-dir", default=None,
                    help="directory for spilled swap images (wire codec); "
                         "images reload on resume")
    ap.add_argument("--mesh", default=None,
                    help="engine mesh topology DATA,MODEL (slot axis on "
                         "'data', heads / KV context / vocab on 'model'); "
                         "one rank per mesh device")
    ap.add_argument("--gloo", action="store_true", default=False,
                    help="run the --mesh ranks over gloo on the card(s) "
                         "there are (ranks may share one; eager) instead "
                         "of NCCL with a card per rank")
    ap.add_argument("--engines", type=int, default=1,
                    help="number of engines behind the router")
    ap.add_argument("--rpc", action="store_true", default=False,
                    help="run each engine in its own worker process "
                         "(EngineWorker subprocess behind an "
                         "EngineProxy) instead of in-process")
    ap.add_argument("--workers", type=int, default=None,
                    help="shorthand for --rpc --engines N")
    ap.add_argument("--roles", default=None,
                    help="comma list of per-engine roles cycled over the "
                         "engines, e.g. 'prefill,decode' for "
                         "disaggregated serving (default: every engine "
                         "is 'both')")
    ap.add_argument("--router-policy", default="least_loaded",
                    choices=("least_loaded", "round_robin"))
    ap.add_argument("--serialized", dest="overlap", action="store_false",
                    default=True,
                    help="disable prefill/decode overlap (admit prefills "
                         "behind a free slot)")
    ap.add_argument("--no-budget-ticks", dest="budget_ticks",
                    action="store_false", default=True,
                    help="always run full decode-block ticks")
    ap.add_argument("--speculative", action="store_true", default=False,
                    help="draft-verify speculative decode: a draft model "
                         "proposes --k-draft tokens per slot, one verify "
                         "program scores them with the target and commits "
                         "each slot through the tokens it emits; streams "
                         "stay those of plain decode")
    ap.add_argument("--draft-config", default="self",
                    help="draft model for --speculative: 'self' (default; "
                         "the target drafts for itself) or an arch name "
                         "with the same vocab (weights from --seed + 1)")
    ap.add_argument("--k-draft", type=int, default=4,
                    help="draft tokens proposed per slot per speculative "
                         "tick")
    ap.add_argument("--adaptive-k-draft", dest="adaptive_k",
                    action="store_true", default=False,
                    help="acceptance-adaptive draft length within "
                         "[1, --k-draft]; streams unchanged")
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
    if args.workers is not None:
        args.rpc = True
        args.engines = args.workers
    if args.mesh is not None:
        return _spawn_mesh(args)
    _serve_main(args)


def _backend(args) -> str:
    return "gloo" if args.gloo or args.device == "cpu" else "nccl"


def _spawn_mesh(args):
    """``--mesh``: validate, pad the slots, pick the backend and start one
    rank per mesh device; with ``--engines N`` / ``--rpc`` serve mesh
    workers behind a router in this process instead."""
    topo = ServingTopology.parse(args.mesh, staging_depth=args.staging_depth)
    backend = _backend(args)
    cards = mesh_mod.visible_devices("nccl") if backend == "nccl" else None
    if cards is not None and topo.devices > cards:
        raise ValueError(
            f"--mesh {args.mesh} needs {topo.devices} cards for its NCCL "
            f"ranks (one each) but {cards} are visible — shrink the mesh, "
            f"or pass --gloo to run its ranks over gloo on the cards there "
            f"are (eager; ranks may share a card)")
    padded = topo.pad_slots(args.slots)
    if padded != args.slots:
        print(f"--slots {args.slots} padded to {padded} (a multiple of the "
              f"data axis {topo.data})")
        args.slots = padded
    if backend == "gloo" and args.device != "cpu":
        args.cuda_graphs = False     # gloo collectives are host calls
    if args.engines > 1 or args.rpc:
        args.rpc = True              # a mesh engine is a group of processes
        return _serve_main(args, topo=topo)
    port = mesh_mod.free_port()
    torch.multiprocessing.spawn(_rank_main, args=(args, topo, backend, port),
                                nprocs=topo.devices)


def _rank_main(rank, args, topo, backend, port):
    """One mesh rank of the serve CLI: rank 0 prints."""
    mesh_mod.init_ranks(rank, topo.devices, port, backend)
    if rank:
        sys.stdout = open(os.devnull, "w")
    if backend == "nccl":
        args.device = f"cuda:{rank}"
    try:
        print(f"mesh: data={topo.data} x model={topo.model}, "
              f"{topo.devices} {backend} ranks on {args.device}")
        _serve_main(args, mesh_mod.make_serving_mesh(topo.data, topo.model))
        torch.distributed.barrier()     # no rank tears down mid-collective
    finally:
        torch.distributed.destroy_process_group()


def _serve_main(args, mesh=None, topo=None):
    cfg = configs.get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.kernels:
        cfg = cfg.replace(use_pallas_serving=True)
    params = (None if args.rpc else
              lm.init_lm(args.seed, cfg, device=args.device, mesh=mesh))
    draft_cfg = draft_params = None
    if args.speculative and args.draft_config != "self":
        draft_cfg = configs.get_arch(args.draft_config)
        if args.reduced:
            draft_cfg = draft_cfg.reduced()
        if args.kernels:
            draft_cfg = draft_cfg.replace(use_pallas_serving=True)
        if draft_cfg.vocab != cfg.vocab:
            raise SystemExit(f"--draft-config {args.draft_config}: vocab "
                             f"{draft_cfg.vocab} != target vocab "
                             f"{cfg.vocab}")
        draft_params = lm.init_lm(args.seed + 1, draft_cfg,
                                  device=args.device, mesh=mesh)
    common = dict(max_slots=args.slots, max_len=args.max_len, seed=args.seed,
                  decode_block=args.decode_block, overlap=args.overlap,
                  prefill_chunk=args.prefill_chunk,
                  budget_ticks=args.budget_ticks,
                  staging_depth=args.staging_depth,
                  plan_mode=args.plan_mode,
                  prefill_batching=args.prefill_batching,
                  prefill_budget=args.prefill_budget,
                  speculative=args.speculative, draft_cfg=draft_cfg,
                  draft_params=draft_params, k_draft=args.k_draft,
                  adaptive_k=args.adaptive_k,
                  swap_policy=args.swap_policy,
                  idle_swap_ms=args.idle_swap_ms,
                  max_live_requests=args.max_live_requests,
                  async_paging=args.async_paging,
                  gather_ring=args.gather_ring,
                  host_swap_bytes=args.host_swap_bytes,
                  swap_spool_dir=args.swap_spool_dir,
                  device=args.device, cuda_graphs=args.cuda_graphs)
    if mesh is not None:
        common["mesh"] = mesh
    engines = build_engines(cfg, params, args, common, topo)
    try:
        router = Router(engines, policy=args.router_policy)
        print(f"topology: {args.engines} "
              f"{'worker process(es)' if args.rpc else 'engine(s)'} on "
              f"{args.device}"
              + (f", each a {topo.data}x{topo.model} {_backend(args)} mesh "
                 f"of {topo.devices} rank processes (--mesh engines always "
                 f"run in workers)" if topo is not None else "")
              + f" (staging ring depth {args.staging_depth}, "
              f"router={args.router_policy}, "
              f"roles={','.join(_roles(args))})")
        if not args.rpc:
            report(args, engines[0])
        serve(cfg, args, router, engines)
    finally:
        if args.rpc:
            for e in engines:
                e.shutdown()


def report(args, eng):
    """Print an in-process engine's slot, paging and speculative
    budgets."""
    print(f"engine: {args.slots} slots x (persistent state "
          f"{eng.state_bytes_per_slot / 2**10:.1f} KiB + window/KV "
          f"{eng.window_bytes_per_slot / 2**10:.1f} KiB) = "
          f"{eng.cache_bytes / 2**20:.2f} MiB slot buffers on "
          f"{eng.executor.device}, decode_block={args.decode_block}, "
          f"prefill={'overlapped' if args.overlap else 'serialized'} "
          f"chunks of {eng.prefill_chunk} ({eng.plan_mode} plans, "
          f"{'batched' if eng.prefill_batching else 'per-prompt'} "
          f"staging), kernels={args.kernels}, "
          f"cuda_graphs={eng.executor.cuda_graphs}")
    if (args.swap_policy != "manual" or args.max_live_requests
            or args.async_paging or args.swap_spool_dir):
        print(f"paging: swap_policy={args.swap_policy}"
              + (f", idle lease {args.idle_swap_ms:.0f} ms"
                 if args.idle_swap_ms is not None else "")
              + (f", max {args.max_live_requests} live sessions"
                 if args.max_live_requests else "")
              + (f", async (gather ring {args.gather_ring})"
                 if args.async_paging else ", synchronous")
              + (f", spool {args.swap_spool_dir} @ "
                 f"{(args.host_swap_bytes or 0) / 2**20:.1f} MiB watermark"
                 if args.swap_spool_dir else "")
              + f" — {eng.executor.swap_bytes_per_slot / 2**10:.1f} "
              f"KiB/swap from cache_spec")
    if args.speculative:
        ex = eng.executor
        print(f"speculative: draft={args.draft_config}, "
              f"k_draft={args.k_draft} — per slot "
              f"{ex.checkpoint_bytes_per_slot / 2**10:.1f} KiB rollback "
              f"checkpoint + {ex.draft_bytes_per_slot / 2**10:.1f} KiB "
              f"draft state ({ex.speculative_bytes / 2**20:.2f} MiB total, "
              f"from checkpoint_spec)")


def serve(cfg, args, router, engines):
    """Submit ``--requests`` prompts through the router, serve them and
    print the summary."""
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab, size=rng.integers(4, 17),
                              dtype=np.int32)
        router.submit(Request(rid=i, prompt=prompt,
                              max_new_tokens=args.max_new,
                              temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p))
    t0 = time.perf_counter()
    done = sorted(router.run_until_done(), key=lambda r: r.rid)
    dt = time.perf_counter() - t0
    m = router.metrics()
    print(f"served {m['requests']} requests, {m['tokens']} tokens in "
          f"{dt:.2f}s ({m['tokens'] / dt:.1f} tok/s) over {m['ticks']} "
          f"engine ticks (placed {m['placed']}, migrated {m['migrated']}"
          + (f", {m['handoffs']} prefill→decode handoffs"
             if m["handoffs"] else "") + ")")
    print(f"  decode: {m['decode_us_per_token']:.0f} us/token "
          f"({m['decoded_tokens']} tokens in {m['decode_s']:.2f}s, "
          f"{m['stage_dispatches']} staged prefill + "
          f"{m['scatter_dispatches']} scatter dispatches)")
    if args.speculative:
        print(f"  speculative: {m['drafted_tokens']} drafted / "
              f"{m['accepted_tokens']} accepted "
              f"({m['acceptance_rate']:.2f} acceptance), "
              f"{m['spec_ticks']} draft-verify ticks, "
              f"{m['syncs_per_token']:.3f} host syncs/token, "
              f"{m['draft_prefills']} draft-state rebuilds")
    print(f"  per-request means: ttft {m['mean_ttft_s'] * 1e3:.1f} ms, "
          f"latency {m['mean_latency_s'] * 1e3:.1f} ms, "
          f"{m['mean_tokens_per_s']:.1f} tok/s")
    if m["swap_outs"] or m["swapped"]:
        us_mb = (m["swap_s"] * 1e6 / (m["swap_bytes"] / 2**20)
                 if m["swap_bytes"] else 0.0)
        print(f"  paging: {m['swap_outs']} swap-outs / {m['swap_ins']} "
              f"swap-ins, {m['swap_bytes'] / 2**20:.2f} MiB moved "
              f"({us_mb:.0f} us/MiB), {m['swapped']} "
              f"session(s) parked on host at exit")
        print(f"    dispatch {m['swap_dispatch_s'] * 1e3:.2f} ms / stall "
              f"{m['swap_stall_s'] * 1e3:.2f} ms"
              + (f", {m['swap_harvests_overlapped']} overlapped + "
                 f"{m['swap_harvests_forced']} forced harvests, "
                 f"{m['swap_prefetch_hits']}/{m['swap_prefetches']} "
                 f"prefetch hits" if args.async_paging else "")
              + (f", {m['spills']} spills / {m['spill_loads']} reloads "
                 f"({m['spill_bytes'] / 2**20:.2f} MiB spooled)"
                 if args.swap_spool_dir else ""))
    if not args.rpc:
        print(f"  programs: "
              f"{[e.executor.compiled_programs() for e in engines]}")
    for r in done[:4]:
        print(f"  req {r.rid}: ttft {r.ttft_s * 1e3:.1f} ms, "
              f"{len(r.output)} toks: {list(r.output)}")


if __name__ == "__main__":
    main()
