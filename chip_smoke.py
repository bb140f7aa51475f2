#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # every phase (needs one card)
    python3 chip_smoke.py --kernels-only  # build + kernel checks, then stop
    python3 chip_smoke.py --mesh-train-faults  # build, phase 15 (b)-(d)
                                       # and phase 16 with their planted
                                       # faults, then stop
    python3 chip_smoke.py --mesh-workers  # build, phase 17, then stop
    python3 chip_smoke.py --model-moves   # build, phase 19's kernel rows
                                       # and phase 19, then stop

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
     40, through an eager engine (``cuda_graphs=False``), the default one
     (batched staging; every decode and prefill program replayed from a
     CUDA graph), a per-prompt one (``prefill_batching=False``) and a pow2
     one (``plan_mode="pow2"``), each graph engine serving the mix twice
     — "cold" (each program's eager first call and its capture), then
     "warm"; the eager engine once —
     with each engine's dispatches, scatters, programs and TTFT printed,
     the streams of the first three bitwise equal, the pow2 engine's warm
     streams bitwise its cold ones (in bf16 its tail chunks round
     otherwise; where its first token leaves the default's is printed),
     and the program shapes within the reference's bounds for each
     engine's path.  The kernels' launch counters are set to 0 just
     before and read just after the eager engine's warm run (the main
     path, counted at the wrappers): ``gdn_decode`` 36 x decode steps,
     ``gdn_prefill`` a multiple of 36 (one launch per layer and chunk,
     every staged row in it); the default graph engine's replays must add
     the same counts, and one replayed batched round (the scan of 4 chunks
     and the admit) under the profiler must run 36 x 5 prefill kernels;
     then the max |diff| of one staged row's caches, batched against per
     prompt; the pow2 and the batched streams bitwise equal in fp32
     activations (the reference's promise), and in bf16 through the plain
     path (no kernel), eagerly, the pow2 streams must leave the batched
     ones too if the kernel path's do (the witness that bf16 arithmetic,
     not a kernel, moves them); one replayed tick of 4 resident requests
     under the profiler must run 36 x k ``gdn_decode_kernel`` launches;
  9. (run right after phase 4, on its weights) speculative decode of the
     same model on phase 4's mix through CUDA graphs: a self-draft with
     k_draft 4, then a draft of the same architecture with weights from
     seed 1 and ``adaptive_k``, each cold, then warm (replayed; in the
     second, the rollback);
     both streams bitwise phase 4's plain ones; acceptance, ticks, syncs
     per token, decode us/token, programs and the checkpoint and draft
     bytes printed; ``gdn_decode`` launches added under replay = 36 x
     draft steps + 72 x verify positions, and one replayed draft + verify
     of each engine under the profiler must run 36 x k + 72 x (k + 1)
     ``gdn_decode_kernel`` launches;
  10. (run right after phase 9, on phase 4's weights) state paging of the
     same model on phase 4's mix through CUDA graphs, every stream bitwise
     phase 4's plain one: (a) synchronous — a pause after 2 decoded
     tokens, two steps, the resume; ``preempt()`` of the policy victim; a
     pause of a staged-ready request at the admit boundary (this engine
     serves the mix once first, so the paged run is warm and its decode
     us/token prints beside phase 4's); (b) ``swap_policy="pressure"``,
     two priority-1 requests arriving while four of priority 0 hold the
     slots; (c) ``async_paging`` through a gather ring of 2: three pauses
     in one tick (one forced harvest), a resume taken from a prefetch;
     (d) spill (``host_swap_bytes=0``, a spool directory under
     ``build/``): the spooled file written, read back and gone, its write
     and read seconds printed; (e) a self-draft speculative engine: a
     pause during a pending draft swapped out at the verify.  In each
     part the launch counters are set to 0 just before the paged run and
     read just after: ``gdn_decode`` added under replay 36 x decode
     steps (36 x draft steps + 72 x verify positions in (e)); no paging
     call adds or captures a program; every image is
     ``swap_bytes_per_slot`` bytes and ``swap_bytes`` whole images; no
     slot buffer (caches, sampler, tokens; draft caches and checkpoints)
     changes its address; swap-outs and ins, us/MiB, the gather / put /
     scatter and dispatch / stall splits and the overlap ratio printed;
  11. (run right after phase 10, on phase 4's weights) the router, engine
     roles and worker processes on phase 4's mix and engine settings,
     through CUDA graphs, every stream bitwise phase 4's plain one; the
     card's compute mode must be ``Default`` (several processes share
     it): (a) ``Router([prefill engine, decode engine])`` in this
     process, cold then warm: 6 handoffs per run; each engine's launches
     counted around its own steps: the prefill engine ``gdn_prefill`` 36
     x its batched chunks (4 per scan, 1 per admit) and no decode step or
     ``gdn_decode``, the decode engine ``gdn_decode`` 36 x its decode
     steps and no stage dispatch or ``gdn_prefill``; no paging call adds
     a program, no slot buffer moves; TTFT, the decode engine's us/token
     and each handoff's gather / put / scatter us/MiB printed; (b) two
     both-role engines: ``drain(1)`` while engine 1 holds 3 queued
     requests, a request paused on engine 0, engine 0's slots refilled,
     the request resumed and moved to engine 1 by ``rebalance_swapped``;
     (c) three ``EngineProxy`` workers started together
     (``params_seed=0``; prefill, decode and both; each one's spawn to
     first reply printed), prefill -> decode through the pipes, cold then
     warm: 6 handoffs per run, each handoff's ``withdraw_handoff`` +
     ``readmit_swapped`` seconds and tok/s printed, both workers exit 0
     after ``shutdown()``; (d) the both-role worker beside (b)'s engine
     1, ``round_robin``, killed before its first tick: dead [0], its 3
     queued requests re-homed and finished; the phase's wall time
     printed;
  5. training full-width qwen3-next-gdn, its depth cut to 12 of 48
     layers (``TRAIN_LAYERS``, for the time limit), through
     the port's ``Trainer`` with ``use_flash_kernel`` (bf16, global batch
     2, seq_len 2048, 5 steps): first ``loss_fn`` and its gradients at the initial parameters
     through the flash kernels against the plain ``blockwise_attention``
     path; then an eager trainer (``cuda_graphs=False``, no checkpoint)
     and the default one, which replays the step from one CUDA graph
     (step 1 eager, step 2 captured; a checkpoint into a temporary
     directory under ``build/``), each with the launch counters zeroed
     just before and read just after its run; per-step loss and gradient
     norm and a digest of the final state bitwise equal between the two;
     the flash launches exact in both runs (the ``kernels`` line takes the
     eager run's, counted at the wrappers; in the graph run replays add
     what the capture counted, so the captured graph's kernel nodes,
     named through libcuda, must hold one step's share of flash kernels:
     a replayed step under the profiler lost records); the graph's
     kernel nodes, capture and instantiation times, the step time (median
     of steps 3-5), peak allocated and reserved memory;
  6. full-width h2o-danube-1.8b (24 sliding-window layers, window 4096,
     random bf16 weights drawn on the card from seed 0): (i) served
     through ``DecodeEngine`` (4 slots, max_len 8192 — a 4096-slot rolling
     cache — prefill chunk 256, decode block 8) with prompts of 5000,
     4500, 1000 and 200 tokens, 32 new tokens each, one at temperature
     0.8 / top-k 40, eagerly and through CUDA graphs as in phase 4;
     (ii) the same four prompts prefilled through the port's chunked
     prefill, then on each of the 24 layers' wrapped caches
     ``attention.attn_decode_pallas`` (the flash-decode kernel) against
     ``attention.attn_decode_xla`` (the mixers' path) on clones of the
     cache with one ``x_t``, the kernel's launch counter zeroed just
     before (ii) and read just after;
  7. full-width mamba2-1.3b (48 ssm layers: SSD through both GDN kernels
     with ``delta_rule=False``, one q/k head for 64 value heads, d_k 128
     x d_v 64; random bf16 weights drawn on the card from seed 0): phase
     3's decode-step check, then phase 4's mix through the eager, the
     default (batched, CUDA graphs) and a per-prompt CUDA-graph engine,
     streams bitwise equal, launches counted at the wrappers in the eager
     warm run (48 x decode steps, 48 x prefill chunks) and one replayed
     batched round under the profiler (48 x 5 prefill kernels);
  8. full-width recurrentgemma-2b (RG-LRU + swa, window 2048; random bf16
     weights from seed 0): 4 requests of 300-2500 tokens, 16 new tokens
     each, eagerly and through CUDA graphs, streams bitwise equal; no
     hand-written kernel launches on this path;
  12. the MoE FFN at full width with the depth cut (neither model fits
     the card whole; random weights from seed 0, each model freed before
     the next): the sort-based top-k's ties on the card (those of
     ``jax.lax.top_k``); (a) mixtral-8x7b, 2 of 32 layers, fp32,
     dropless capacity: ``prefill(17)``'s last logits against
     ``prefill(16)`` + ``decode_step`` within rtol = atol = 2e-3; (b)
     mixtral-8x7b, 8 of 32 layers in bf16 (the depth cut for the
     script's time limit; 16 layers were 46.96 GB), the draw's
     seconds and peak memory, the bf16 fp32-output expert product
     (``layers.bmm_f32``) at the drawn full-width expert matrices
     against fp32 operands (rtol 1e-5, atol 1e-4), phase 4's mix and engine settings through
     the eager engine, the default CUDA-graph engine (its gate stages
     per prompt) and a self-draft speculative one (k_draft 4), the graph
     engines cold then warm: streams bitwise equal, every kernel counter
     zeroed before and all six 0 after, the warm TTFT, us/token and
     tok/s beside the floor of the dense all-expert decode; (c)
     arctic-480b, 2 of 35 layers (~55.4 GB), the product check on 16
     of its 128 experts, the eager and the default engine as (b); (d) mixtral-8x7b, 2 layers, bf16, training as phase
     5 (``loss_fn`` at init flash against plain, 4 steps eagerly, 4 from
     the step's CUDA graph, no checkpoint): loss, aux, grad norm and a
     state digest bitwise equal, the flash launches exact (at the
     wrappers eagerly, the graph's kernel nodes by name); the phase's wall
     time.
  13. (run right after phase 11, on phase 4's weights and mix) mesh
     serving (``DecodeEngine(mesh=)``): (a) a (1,1) NCCL mesh in this
     process on the default CUDA-graph engine, cold then warm, streams
     bitwise phase 4's graph engine's, its collectives captured (the
     warm run's run inside replayed graphs), us/token beside phase 4's
     and the collectives of one decode step; (b) a (2,1) and (c) a
     (1,2) mesh over two gloo ranks sharing the card (spawned processes,
     each drawing the weights from seed 0; eager: gloo stages each
     collective through host memory), each serving the mix: the ranks'
     streams equal, the first token index leaving the one-device
     streams printed, us/token, TTFT, the run's collectives and their
     host seconds, one decode step's collectives, seconds and
     ``gdn_decode`` launches (36 on every rank and layout), then one
     decode step on phase 3's state and tokens against the one-device
     step: no further from the fp32 logits than twice the one-device
     bf16 step (phase 3's rule), the argmax equal wherever the
     one-device top-2 gap exceeds its own error; in (c) request 0 paused
     after 2 tokens and resumed; (d) its image restored into a
     one-device eager engine, gathered back bitwise, its continuation
     compared with (c)'s and phase 4's; the phase's wall time.
  14. (run after phase 12) the mesh's model axis for the other kinds at
     full width: (a) mamba2-1.3b on phase 7's weights (drawn again from
     seed 0) and mix on a (1,1) NCCL mesh through CUDA graphs, cold then
     warm, streams bitwise phase 7's graph engine's, no collective issued
     from the host in the warm run; then (b) mamba2-1.3b, (c)
     recurrentgemma-2b (two of phase 8's prompts, one past its 2048
     window) and (d) mixtral-8x7b (8 of 32 layers, as phase 12 (b)) on
     a (1,2) mesh
     over two gloo ranks sharing the card, eager, two requests each: each
     rank draws only its shards from seed 0 (``lm.init_lm(..., mesh=)``:
     half the SSD heads, the RG-LRU width, the attention heads or
     head_dim, half of mixtral's experts), the ranks' streams equal, the
     first token index leaving the one-device streams printed, us/token,
     TTFT, the run's collectives and their seconds, one decode step's
     collectives, each rank's allocated bytes; mamba2's GDN kernels at
     the local shape (B 4, Hk 1, Hv 32), 48 ``gdn_decode`` launches per
     decode step on each rank, no kernel for the other two; then one
     decode step on the arch's fixed state (a plain prefill saved after
     (a), by phase 8 or by phase 12 (b)) against the one-device step by
     phase 3's rule; the phase's wall time.
  15. (run after phase 14) the trainer's mesh on full-width
     qwen3-next-gdn with the flash kernels, phase 5's batch (2 x 2048)
     and seed (phase 5's trainer freed first): (a) a (1,1) NCCL mesh in
     this process, phase 5's 12 layers, FSDP on by the reference's rule
     (``needs_fsdp`` and its per-device estimate printed), 5 steps
     through the step's CUDA graph: per-step loss, aux and grad norm and
     the final state digest bitwise phase 5's graph run, the replayed
     steps issuing no collective from the host (captured and replayed
     counts printed), the replayed step time beside phase 5's; (b)-(d)
     12 layers (three gdn, gdn, gdn, attn groups), eager: first the
     one-device yardsticks (2 steps with 2 microbatches, 3 with 1, that
     trainer kept), then two gloo ranks sharing the card, each drawing
     only its shards: (b) (2,1), FSDP on by the rule (0.79 B params x
     14 B > 10 GB), 2 steps, then a checkpoint; (c) (1,2), FSDP off, the
     flash kernels at the local heads, 2 steps; (d) (b)'s checkpoint
     restored into a (1,2) trainer and into the kept one-device one,
     step 3 on each.  Each run's loss and grad norm per step (relative
     1e-2 and 2e-2), and its parameters by phase 15's rule
     (``check_params``: the steps' bound, and at most ``SHARP_LIMIT`` of
     each leaf's sharp elements past one ulp + 0.05 sum(lr)), against
     the one-device run; (b), whose rows split as the one-device run's
     with 2 microbatches, also within that tight bound of it in all but
     0.1% of each leaf's sharp elements; the ranks' metrics equal; per
     rank and step the seconds, collectives and their bytes and seconds,
     the state's bytes and the allocated bytes; the flash launches at
     the wrappers per rank (the
     ``flash_*_data2`` and ``flash_*_model2`` rows).
  16. (run after phase 15) the model axis in training for every kind but
     gdn and attn, and the MoE's experts, each arch at full width with
     its depth cut (``MESH16``), the flash kernels on: mamba2-1.3b at 12
     of 48 layers (1 x 2048 tokens, fp32 activations: in bf16 at that
     depth a forward one bit off moves its parameters past the rule) and
     in bf16 at 2 layers, where the one-device run with a forward one bit
     off (1 in 1024 embedding entries, the witness) is made beside the
     yardstick and must read within the rule, recurrentgemma-2b at one
     (rglru, rglru, swa) group (1 x 4096, past its 2048 window; its one
     KV head split on head_dim), h2o-danube-1.8b at 2 layers (1 x 4608,
     past its 4096 window), mixtral-8x7b at 1 layer (2 x 2048; 4 of 8
     experts per rank).  Each arch's one-device eager yardstick (same
     depth, seed and batch, 2 steps) and two gloo ranks sharing the card
     that train each on (1,2), each rank drawing only its shards, 2 eager
     steps (mamba2's beside the yardsticks, the others after them);
     each held by phase 15's rule (loss 1e-2, grad norm 2e-2 and aux 1e-2
     relative per step; ``check_params``); the ranks' metrics equal; per
     rank the state's bytes, the peak, the collectives per step and their
     seconds; the flash launches at the wrappers per step (2 forward
     with remat, 1 dq, 1 dk/dv per attention layer) of the yardsticks (rows
     ``flash_*_gemma``, ``flash_*_danube``) and of each rank (rows
     ``flash_*_gemma_model2``, ``flash_*_danube_model2``,
     ``flash_*_mixtral_model2``).  ``--mesh-train-faults`` adds a
     planted fault (``FAULTS16``: mixtral's router gradient summed over
     "model" with the aux term inside the sum) that the rule must refuse,
     its worst share printed beside the sound run's.
  17. (run right after phase 13, on phase 4's weights, mix and engine
     settings; its workers, (b)'s yardstick images and (c)'s ranks start
     while phase 13's gloo ranks serve, for the time limit) mesh engines
     in worker processes behind the router (``EngineProxy(mesh_shape=)``;
     every worker draws seed 0 itself and each worker's spawn to first
     reply is printed): (a) two (1,1) NCCL
     mesh workers sharing card 0, through CUDA graphs, behind
     ``Router`` on ``least_loaded``, cold then warm: streams bitwise phase
     4's, each worker's ``gdn_decode`` 36 x its decode steps and
     ``gdn_prefill`` 36 x its batched chunks (its own launch counters);
     (b) a prefill-role worker on a (1,2) gloo mesh (two ranks on card
     0, eager) handing off to a one-device decode worker through graphs:
     6 handoffs, each one's ``withdraw_handoff`` + ``readmit_swapped``
     seconds, the prefill worker's host-group seconds per tick (the
     relay and the ranks' agreement after each op), ``gdn_prefill`` on
     each of its ranks 36 x its chunks, the first token index leaving
     phase 4's streams; every handed-off image held leaf by leaf by phase
     3's rule (no further from an fp32-activation one-device engine's
     image than twice the one-device bf16 engine's is; the sampler rows
     equal) and its worst relative distance from the one-device image
     printed; (c) beside (a), (b) and (d), a (2,1) gloo mesh of two
     spawned ranks on card 0 under ``swap_policy="idle"`` (``IDLE17``):
     the slots filled, two requests touched, each rank's scheduler clock
     planted at its own offset and rank 1's jumping past the lease: both
     ranks evict the two untouched requests at the same tick (rank 1's
     own clock would take all four), compare their slots after every
     tick, and the streams are bitwise phase 13 (b)'s; a rank that makes
     no progress for ``IDLE17_TIMEOUT_S`` reports it and exits, so ranks
     that disagree fail rather than wait; (d) rank 1 of (b)'s (1,2) worker killed in its
     first tick of a ``round_robin`` run beside (a)'s first worker:
     ``WorkerDied`` within ``DEATH17_BOUND_S`` (the time printed), its
     requests re-homed or failed, every finished stream bitwise phase
     4's.  ``--mesh-workers`` builds, serves phase 4's mix once for its
     streams and runs this phase alone ((c)'s ranks first serving phase
     13 (b)'s run for its streams).
  19. (run right after phase 2, on an empty card) ``fit_spec``'s moves
     of the model axis at
     full width, the model code following the placements the specs give
     (``parallel.sharding.model_dims``), on one world of 16 gloo ranks
     sharing card 0, started while this process makes the one-device
     yardsticks: (a) minicpm-2b (40 layers) on (1,2), its vocabulary of
     122,753 on d_model: phase 14's two requests served eagerly (the
     ranks' streams equal, the first token index leaving the one-device
     streams printed), one decode step's collectives equal to
     ``launch.steps.count_cell``'s dry count at (1,2), one decode step
     on a fixed state by phase 3's rule; (b) minicpm-2b trained through
     the flash kernels, 2 eager steps each by phase 15's rule against the
     one-device trainer of the same depth and seed: on (1,2) at the least
     depth at which ``needs_fsdp`` turns FSDP on (the table replicated
     over "model"), and on (1,4) at 2 layers and 512 tokens in fp32
     activations (the table on d_model, the tied logits' fp32 partial
     sums all-reduced; the flash kernels' fp32 path); the
     flash launches per rank (rows ``flash_*_minicpm_model2`` /
     ``_model4``); (c) on (1,16): mamba2-1.3b at 2 of 48 layers (the
     table and ``lm_head`` on d_model; its SSD layers through both GDN
     kernels at (B 4, Hk 1, Hv 4, d_k 128, d_v 64), rows
     ``gdn_*_mamba2_model16``), mixtral-8x7b at 1 of 32 layers (the
     experts on d_ff, ``wo`` on d_model) and arctic-480b at 1 of 35
     (query and KV heads on head_dim, ``wo`` on d_model): each rank's
     shards drawn alone, a 64-token prefill and a decode step, every
     rank's logits bitwise rank 0's and within phase 3's rule of the
     one-device step (made first and freed, arctic's layer ~28 GB), each
     rank's allocated bytes within 1% of the dry run's argument bytes for
     its params and caches.  ``--model-moves`` builds, holds phase 2's
     rows at phase 19's shapes and runs this phase alone.

Phase 2 also holds the GDN prefill at qwen3-next-gdn's served shape on
one staged prompt's unmasked chunks of T = C = 1, 2, 4, 8, 16 and 32 (the
pow2 plans' tails) against its plain version, and both GDN kernels at
mamba2-1.3b's shape (B=4, Hk=1,
Hv=64, d_k=128, d_v=64, bf16, ``delta_rule=False``; the prefill at T=64
and T=192 in chunks of 64 with ragged ``valid_len``), timed beside their
bounds as the rows ``gdn_decode_mamba2`` and ``gdn_prefill_mamba2``, both
GDN kernels at phase 13's local shapes (``gdn_*_model2``: B 4, Hk 8, Hv
16, d 128; ``gdn_*_data2``: B 2, Hk 16, Hv 32, d 128; the prefill timed
on one staged prompt; the rows' launches those of one rank's serve run
in phase 13 (c) and (b)), both GDN kernels at phase 14's local shape of
mamba2-1.3b (``gdn_*_mamba2_model2``: B 4, Hk 1, Hv 32, d_k 128, d_v 64,
no delta rule; the rows' launches those of one rank's serve run in
phase 14 (b)), and
the three flash-attention kernels (forward, dq, dk/dv)
against their plain versions at the trained shape (B=2, T=2048, Hq=16,
Hkv=2, hd=128, bf16), at phase 12 (d)'s (mixtral-8x7b: Hq=32, Hkv=8,
window 4096, otherwise the same), at phase 15's local shapes (rows
``flash_*_data2``: B 1, Hq 16, Hkv 2; ``flash_*_model2``: B 2, Hq 8,
Hkv 1; T 2048, hd 128), at head dims 80 and 256 in fp32 (a small
windowed shape) and at phase 16's shapes (``FLASH16``: one device's and
the (1,2) ranks' of recurrentgemma-2b at hd 256 and h2o-danube-1.8b at hd
80, past their windows, and the ranks' of mixtral-8x7b; SDPA with a mask
of the window) and on windowed and ragged (``valid_len``) cases
(each flash call one kernel launch, the kernel nodes of a captured
call; each flash-decode call one, by the profiler; dq, dk and dv checked
bitwise equal over 5 calls; SDPA's distance from the plain version
printed beside the kernels'), and the flash-decode kernel at three
bf16 shapes (qwen3-next-gdn's attention layer at the serving batch, an
h2o-danube-1.8b layer past its wrap, yi-9b at batch 1 over 32k slots;
one launch per call, bitwise equal over 5 calls), and times each beside
``F.scaled_dot_product_attention`` (the library yardstick, used nowhere
in the port).

The second line before the last is a JSON object with one entry per
kernel (the flash-decode entry carries its three shapes, its top-level
numbers are those of the h2o-danube-1.8b shape that phase 6 drives; the
two GDN entries carry phase 10's launches per part, ``launches_paging``,
and phase 11's, ``launches_disagg``, (c)'s as its workers report them,
beside phase
4's in ``launches``, and phase 17's by part, ``launches_mesh_workers``
(its workers' and ranks' own counts); the three flash entries carry
phase 12 (d)'s eager run in ``launches_moe``); the
line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
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
# the flash kernels' shape in phase 12 (d): mixtral-8x7b's attention at
# global batch 2 x seq_len 2048
MOE_FLASH = dict(B=2, T=2048, Hq=32, Hkv=8, hd=128, window=4096)
# the flash kernels' local shapes in phase 15's meshes: (2,1) halves the
# batch, (1,2) the query and KV heads
FLASH_MESH = {"data2": dict(FLASH, B=1), "model2": dict(FLASH, Hq=8, Hkv=1)}
# phase 16's trained attention shapes at head dims 256 and 80 (one
# device; its yardsticks) and their (1,2) local shapes, with mixtral's:
# recurrentgemma-2b (10 query heads padded to 16, one KV head: the model
# axis splits it on head_dim, each rank keeping the whole head), past its
# 2048 window; h2o-danube-1.8b past its 4096 window
FLASH16 = {
    "gemma": dict(B=1, T=4096, Hq=16, Hkv=1, hd=256, window=2048),
    "danube": dict(B=1, T=4608, Hq=32, Hkv=8, hd=80, window=4096),
    "gemma_model2": dict(B=1, T=4096, Hq=8, Hkv=1, hd=256, window=2048),
    "danube_model2": dict(B=1, T=4608, Hq=16, Hkv=4, hd=80, window=4096),
    "mixtral_model2": dict(B=2, T=2048, Hq=16, Hkv=4, hd=128, window=4096)}


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

def decode_work(B, Hk, Hv, dk, dv, delta_rule=True):
    """What one gdn_decode call must do: the bytes it must move (q, k, v
    and o in bf16, the fp32 state read and written, g and beta)
    and its fp32 FLOP per value head — [k; q] S (4 dk dv) and the state
    update (3 dk dv) with the delta rule; S^T q (2 dk dv) and the update
    without it (SSD) — plus the output's few per column."""
    state = B * Hv * dk * dv * 4
    nbytes = 2 * state + (2 * B * Hk * dk + 2 * B * Hv * dv) * 2 \
        + 2 * B * Hv * 4
    flops = B * Hv * ((7 if delta_rule else 5) * dk * dv + 8 * dv)
    return dict(nbytes=nbytes, fp32_flops=flops, tc_flops=0)


def decode_phase(ref, kdecode, time_launches, name="gdn_decode",
                 shape=(CFG["B"], CFG["Hk"], CFG["Hv"], CFG["d"], CFG["d"]),
                 delta_rules=(True, False)):
    """gdn_decode at ``shape`` = (B, Hk, Hv, d_k, d_v) — qwen3-next-gdn's
    (4, 16, 32, 128, 128) and mamba2-1.3b's (4, 1, 64, 128, 64) — bf16
    q/k/v, for each of ``delta_rules``, timed with the first; o is bf16
    (one rounding: rtol = atol = 2e-2), the fp32 state differs only in
    summation order (rtol = atol = 1e-4)."""
    B, Hk, Hv, dk, dv = shape
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q = rnd(B, Hk, dk).to(torch.bfloat16)
    k = torch.nn.functional.normalize(rnd(B, Hk, dk), dim=-1).to(
        torch.bfloat16)
    v = rnd(B, Hv, dv).to(torch.bfloat16)
    S = rnd(B, Hv, dk, dv) * 0.2
    g = torch.sigmoid(rnd(B, Hv))
    beta = torch.sigmoid(rnd(B, Hv))
    errs = []
    for delta_rule in delta_rules:
        S_k = S.clone()
        o_k, _ = kdecode.gdn_decode(q, k, v, S_k, g, beta,
                                    delta_rule=delta_rule)
        o_p, S_p = ref.gdn_decode_ref(q, k, v, S, g, beta,
                                      delta_rule=delta_rule)
        torch.cuda.synchronize()
        errs.append(check(f"{name} delta_rule={delta_rule} o", o_k, o_p,
                          2e-2, 2e-2))
        errs.append(check(f"{name} delta_rule={delta_rule} S", S_k, S_p,
                          1e-4, 1e-4))
    delta_rule = delta_rules[0]
    S_t = S.clone()
    ev_ms, ms = time_launches(
        lambda: kdecode.gdn_decode(q, k, v, S_t, g, beta,
                                   delta_rule=delta_rule),
        "gdn_decode_kernel")
    plain_ms, _ = time_launches(
        lambda: ref.gdn_decode_ref(q, k, v, S, g, beta,
                                   delta_rule=delta_rule))
    print(f"  {name} (B, Hk, Hv, d_k, d_v) = {shape}, delta_rule="
          f"{delta_rule}: CUDA events around one launch {ev_ms * 1e3:.2f} "
          f"us, the kernel's own duration {ms * 1e3:.2f} us")
    w = decode_work(B, Hk, Hv, dk, dv, delta_rule)
    return dict(name=name, route="cuda",
                source="src/repro_torch/csrc/gdn_decode.cu",
                replaces="src/repro/kernels/gdn_decode.py:66",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                **bound(name, w["nbytes"], w["fp32_flops"]),
                library_ms=None)


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


def flash_work(B, T, Hq, Hkv, hd, window=None):
    """What each flash kernel must do at a causal bf16 shape: the bytes
    it must move (each input read once, each output written once) and the
    FLOP of its products by the rate of the operands they take, over the
    visible (query, key) pairs only (with ``window``, W (W + 1) / 2 + (T -
    W) W of them per head).  The forward (Q K^T, P V with P rounded to
    bf16), dq (Q K^T, dO V^T, dS K with dS rounded to bf16) and dk/dv (Q
    K^T, dO V^T, P^T dO, dS^T Q with P and dS rounded to bf16) feed the
    tensor cores bf16 x bf16 in every product."""
    W = T if window is None else min(window, T)
    pairs = B * Hq * (W * (W + 1) // 2 + (T - W) * W)   # visible pairs
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


def prefill_work(Hk, Hv, T, d_k, d_v, bf16=True, delta_rule=True):
    """What one gdn_prefill call must do for one staged prompt of T = C
    tokens (one chunk) over Hv value rows: the bytes it must move (q, k,
    v, O in bf16 or fp32, log g and beta, the fp32 state read and
    written, valid_len) and the FLOP of its products
    by the rate of the instructions the kernel issues.  A causal C x C
    product costs half a full one: C^2 d.  Per row with the delta rule:
    Q K^T and K K^T (2 C^2 d_k) multiply bf16 inputs exactly on the tensor
    cores; K S, Q S and the state update (6 C d_k d_v) multiply them by the
    three bf16 parts of an fp32 operand, three tensor-core products each;
    applying the inverse and M U (2 C^2 d_v) take fp32 operands on the
    CUDA cores.  Without it (SSD) K K^T, K S and the inverse drop out:
    Q K^T (C^2 d_k), Q S and the update (4 C d_k d_v), M V (C^2 d_v).
    fp32 inputs count every product at the fp32 rate."""
    C = T
    n = 2 if delta_rule else 1              # causal C x C products
    exact, fp32 = n * C * C * d_k, n * C * C * d_v
    split = (6 if delta_rule else 4) * C * d_k * d_v
    dsize = 2 if bf16 else 4
    nbytes = (2 * Hk * T * d_k + 2 * Hv * T * d_v) * dsize \
        + 2 * Hv * T * 4 + 2 * Hv * d_k * d_v * 4 + Hv * 4
    if not bf16:
        return dict(nbytes=nbytes, tc_flops=0,
                    fp32_flops=Hv * (exact + split + fp32))
    return dict(nbytes=nbytes, tc_flops=Hv * (exact + 3 * split),
                fp32_flops=Hv * fp32)


def prefill_inputs(B, T, gen, Hk, Hv, d_k, d_v, dtype):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q = rnd(B, T, Hk, d_k).to(dtype)
    k = torch.nn.functional.normalize(rnd(B, T, Hk, d_k), dim=-1).to(dtype)
    v = rnd(B, T, Hv, d_v).to(dtype)
    log_g = -torch.nn.functional.softplus(rnd(B, T, Hv))
    beta = torch.sigmoid(rnd(B, T, Hv))
    S0 = rnd(B, Hv, d_k, d_v) * 0.1
    return q, k, v, log_g, beta, S0


# prefill checks: (T, chunk, valid_len per batch row, delta_rule, (Hk, Hv,
# d_k, d_v, dtype)) — qwen3-next-gdn's heads and the reduced
# configurations' width; mamba2-1.3b's one q/k head for 64 value heads
PREFILL_FULL = (CFG["Hk"], CFG["Hv"], CFG["d"], CFG["d"], torch.bfloat16)
PREFILL_REDUCED = (2, 4, 16, 16, torch.float32)
MAMBA2 = dict(B=4, Hk=1, Hv=64, d_k=128, d_v=64)
PREFILL_MAMBA2 = (MAMBA2["Hk"], MAMBA2["Hv"], MAMBA2["d_k"], MAMBA2["d_v"],
                  torch.bfloat16)
PREFILL_CASES = (
    (16, 16, (16, 0, 9, 3), True, PREFILL_FULL),
    (64, 64, (64, 0, 33, 3), True, PREFILL_FULL),
    (192, 64, (192, 0, 100, 64), True, PREFILL_FULL),
    (192, 64, (192, 0, 100, 64), False, PREFILL_FULL),
    (128, 64, (128, 0, 70, 64), True, PREFILL_REDUCED),
    (128, 64, (128, 0, 70, 64), False, PREFILL_REDUCED))
PREFILL_MAMBA2_CASES = (
    (64, 64, (64, 0, 33, 3), False, PREFILL_MAMBA2),
    (192, 64, (192, 0, 100, 64), False, PREFILL_MAMBA2))
# phase 14's local shape of mamba2-1.3b's SSD layers on the (1,2) mesh:
# half the value heads (B 4, Hk 1, Hv 32)
PREFILL_MAMBA2_MODEL2 = (MAMBA2["Hk"], MAMBA2["Hv"] // 2, MAMBA2["d_k"],
                         MAMBA2["d_v"], torch.bfloat16)
PREFILL_MAMBA2_MODEL2_CASES = tuple(
    c[:4] + (PREFILL_MAMBA2_MODEL2,) for c in PREFILL_MAMBA2_CASES)
# phase 13's local shapes of qwen3-next-gdn's GDN layers: the (1,2) mesh
# halves the heads (B 4, Hk 8, Hv 16), the (2,1) mesh the slots (B 2) and
# the batched staging ring's rows (one prompt per rank)
MESH_MODEL2 = (CFG["B"], CFG["Hk"] // 2, CFG["Hv"] // 2, CFG["d"], CFG["d"])
MESH_DATA2 = (CFG["B"] // 2, CFG["Hk"], CFG["Hv"], CFG["d"], CFG["d"])
PREFILL_MODEL2 = MESH_MODEL2[1:] + (torch.bfloat16,)
PREFILL_MESH_CASES = {
    "gdn_prefill_model2": (
        (64, 64, (64, 0, 33, 3), True, PREFILL_MODEL2),
        (192, 64, (192, 0, 100, 64), True, PREFILL_MODEL2)),
    "gdn_prefill_data2": (
        (64, 64, (64, 0), True, PREFILL_FULL),
        (192, 64, (100, 0), True, PREFILL_FULL))}


def prefill_phase(ops, ref, kprefill, time_launches, name="gdn_prefill",
                  cases=PREFILL_CASES, timed=PREFILL_FULL + (True,),
                  B=CFG["B"]):
    """gdn_prefill on each of ``cases`` at B batch rows: T in {16, 64}
    (chunk = T) and T = 192 in chunks of 64, ragged valid_len per batch
    row (crossing chunk edges, one row 0, one T).  qwen3-next-gdn's shape
    and mamba2-1.3b's (Hk = 1, Hv = 64, d_k = 128, d_v = 64) take the
    tensor-core kernel (bf16, d_k = 128), the reduced configurations'
    width (d = 16, fp32) the CUDA-core kernel.  The kernel's chunkwise UT
    transform with its blocked inverse and the plain sequential scan are
    two factorizations of one fp32 recurrence: the state within rtol =
    atol = 1e-4; O within 2e-2 in bf16 and 5e-4 in fp32 (the card tests'
    tolerances); a valid_len = 0 row keeps its state bitwise.  Then the
    kernel is timed at ``timed`` = (Hk, Hv, d_k, d_v, dtype, delta_rule)
    on one staged prompt's 64-token chunk."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = []
    for T, chunk, lens, delta_rule, shape in cases:
        lens = lens[:B]
        hk, hv, dk, dv, dtype = shape
        q, k, v, lg, beta, S0 = prefill_inputs(B, T, gen, hk, hv, dk, dv,
                                               dtype)
        valid = torch.tensor(lens, dtype=torch.int32, device="cuda")
        S_k = S0.clone()
        O_k, _ = ops.gdn_prefill(q, k, v, lg, beta, S_k, chunk=chunk,
                                 valid_len=valid, delta_rule=delta_rule)
        rows = [x.transpose(1, 2).reshape(B * x.shape[2], T, *x.shape[3:])
                .contiguous() for x in (q, k, v, lg, beta)]
        vl = torch.repeat_interleave(valid, hv)
        O_p, S_p = ref.gdn_prefill_ref(*rows, S0.reshape(B * hv, dk, dv),
                                       vl, delta_rule=delta_rule,
                                       n_rep=hv // hk)
        torch.cuda.synchronize()
        label = (f"{name} Hk={hk} Hv={hv} d_k={dk} d_v={dv} "
                 f"{str(dtype)[6:]} T={T} chunk={chunk} "
                 f"delta_rule={delta_rule}")
        errs.append(check(f"{label} S", S_k.reshape(B * hv, dk, dv), S_p,
                          1e-4, 1e-4))
        if lens[1] == 0 and not torch.equal(S_k[1], S0[1]):
            raise AssertionError("valid_len=0 row changed its state")
        O_k = O_k.transpose(1, 2).reshape(B * hv, T, dv)
        mask = (torch.arange(T, device="cuda")[None, :] < vl[:, None])
        o_tol = 2e-2 if dtype == torch.bfloat16 else 5e-4
        errs.append(check(f"{label} O (valid rows)", O_k[mask], O_p[mask],
                          o_tol, o_tol))
    # time at the main path's shape: one staged prompt (B=1), a full
    # 64-token chunk, through the kernel's own wrapper (rows laid out by
    # ops.gdn_prefill)
    Hk, Hv, dk, dv, dtype, delta_rule = timed
    T = 64
    q, k, v, lg, beta, S0 = prefill_inputs(1, T, gen, Hk, Hv, dk, dv, dtype)
    rows_qk = [x.transpose(1, 2).reshape(Hk, T, dk).contiguous()
               for x in (q, k)]
    v_r = v.transpose(1, 2).reshape(Hv, T, dv).contiguous()
    lg_r, b_r = (x.transpose(1, 2).reshape(Hv, T).contiguous()
                 for x in (lg, beta))
    S_r = S0.reshape(Hv, dk, dv).clone()
    vl = torch.full((Hv,), T, dtype=torch.int32, device="cuda")
    ev_ms, ms = time_launches(
        lambda: kprefill.gdn_prefill(*rows_qk, v_r, lg_r, b_r, S_r, vl,
                                     chunk=T, n_rep=Hv // Hk,
                                     delta_rule=delta_rule),
        "gdn_prefill_tc_kernel")
    S_p0 = S0.reshape(Hv, dk, dv)
    plain_ms, _ = time_launches(
        lambda: ref.gdn_prefill_ref(*rows_qk, v_r, lg_r, b_r, S_p0, vl,
                                    n_rep=Hv // Hk, delta_rule=delta_rule),
        reps=5, warmup=1)
    print(f"  {name} (Hk, Hv, d_k, d_v) = {(Hk, Hv, dk, dv)}, delta_rule="
          f"{delta_rule}: CUDA events around one launch {ev_ms * 1e3:.2f} "
          f"us, the kernel's own duration {ms * 1e3:.2f} us")
    w = prefill_work(Hk, Hv, T, dk, dv, dtype == torch.bfloat16, delta_rule)
    return dict(name=name, route="cuda",
                source="src/repro_torch/csrc/gdn_prefill.cu",
                replaces="src/repro/kernels/gdn_prefill.py:116",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                **bound(name, w["nbytes"], w["fp32_flops"],
                        w["tc_flops"]),
                library_ms=None)


POW2_CHUNKS = (1, 2, 4, 8, 16, 32)


def prefill_pow2_checks(ops, ref):
    """gdn_prefill as the pow2 plans' tail sub-chunks launch it: one staged
    prompt (B = 1) at qwen3-next-gdn's served shape (bf16, d_k 128: the
    tensor-core kernel, which pads its 64-token tile), unmasked chunks of
    T = C in ``POW2_CHUNKS``, each from the state the one before left
    (as a tail decomposes), against the plain sequential scan: the state
    within rtol = atol = 1e-4, O within 2e-2 (phase 2's tolerances).
    Checks only: the timed rows stay at their shapes."""
    hk, hv, dk, dv, dtype = PREFILL_FULL
    gen = torch.Generator(device="cuda").manual_seed(3)
    S_k = S_p = None
    for T in POW2_CHUNKS:
        q, k, v, lg, beta, S0 = prefill_inputs(1, T, gen, hk, hv, dk, dv,
                                               dtype)
        if S_k is None:
            S_k, S_p = S0.clone(), S0.reshape(hv, dk, dv).clone()
        O_k, _ = ops.gdn_prefill(q, k, v, lg, beta, S_k, chunk=64)
        rows = [x.transpose(1, 2).reshape(x.shape[2], T, *x.shape[3:])
                .contiguous() for x in (q, k, v, lg, beta)]
        O_p, S_p = ref.gdn_prefill_ref(*rows, S_p, None, n_rep=hv // hk)
        torch.cuda.synchronize()
        label = f"gdn_prefill pow2 tail T = C = {T}"
        check(f"{label} S", S_k.reshape(hv, dk, dv), S_p, 1e-4, 1e-4)
        check(f"{label} O", O_k[0].transpose(0, 1), O_p, 2e-2, 2e-2)


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


def flash_phase(ref, kflash, time_launches):
    """The flash-attention kernels at the trained shape, plus a windowed
    case at either dtype and a ragged bf16 case, against their plain
    versions; then each timed beside its bound, the plain version and
    SDPA; then phase 15's local shapes, head dims 80 and 256 in fp32 and
    phase 16's shapes (``FLASH16``), each held and timed."""
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
    # phase 12 (d)'s trained shape: mixtral-8x7b's 32:8 heads (one head per
    # dk/dv cluster rank), head dim 128, its window 4096 (>= T)
    mx = MOE_FLASH
    errs.append(_flash_check(
        ref, kflash, f"flash mixtral-8x7b window={mx['window']} bf16",
        *_flash_inputs(mx["B"], mx["T"], mx["Hq"], mx["Hkv"], mx["hd"], bf,
                       gen), window=mx["window"]))
    err_fwd, err_dq, err_dkv = (max(max(e[i]) for e in errs)
                                for i in range(3))

    rows = _flash_timed(ref, kflash, time_launches, FLASH, (q, k, v, do),
                        "", (err_fwd, err_dq, err_dkv))
    # phase 15's local shapes: held against the plain versions, timed
    for suffix, sh in FLASH_MESH.items():
        x = _flash_inputs(sh["B"], sh["T"], sh["Hq"], sh["Hkv"], sh["hd"],
                          bf, gen)
        e = _flash_check(ref, kflash, f"flash {suffix} {sh}", *x)
        rows += _flash_timed(ref, kflash, time_launches, sh, x,
                             f"_{suffix}", [max(v) for v in e])
    # head dims 80 and 256: the fp32 CUDA-core kernels at a small windowed
    # shape, then phase 16's bf16 shapes, each held and timed
    for hd, Hq, Hkv in ((80, 8, 2), (256, 16, 1)):
        _flash_check(ref, kflash, f"flash hd={hd} window=100 fp32",
                     *_flash_inputs(1, 384, Hq, Hkv, hd, torch.float32,
                                    gen), window=100)
    for suffix, sh in FLASH16.items():
        x = _flash_inputs(sh["B"], sh["T"], sh["Hq"], sh["Hkv"], sh["hd"],
                          bf, gen)
        e = _flash_check(ref, kflash, f"flash {suffix} {sh}", *x,
                         window=sh["window"])
        rows += _flash_timed(ref, kflash, time_launches, sh, x,
                             f"_{suffix}", [max(v) for v in e])
    return rows


def graph_kernels(fn):
    """{kernel name: launches} of one call of ``fn``, from the kernel nodes
    of a CUDA graph capturing it (exact, where the profiler can lose a
    record: it lost one ``flash_fwd`` record of 10 in each of 6 windows
    at head dims 80 and 256)."""
    from repro_torch.runtime.graphs import kernel_names
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    return kernel_names(graph)


def _flash_timed(ref, kflash, time_launches, shape,
                 inputs, suffix, errs):
    """The three flash kernels at ``shape`` on ``inputs`` (q, k, v, do):
    dq and dk/dv bitwise from run to run, each one kernel per call (the
    kernel nodes of a captured call), timed
    beside its bound, the plain version and SDPA; the rows are named with
    ``suffix``."""
    B, T, Hq, Hkv, hd = (shape[k] for k in ("B", "T", "Hq", "Hkv", "hd"))
    window = shape.get("window")
    q, k, v, do = inputs
    err_fwd, err_dq, err_dkv = errs
    o, m, l = kflash.flash_fwd(q, k, v, window=window)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    bwd = (q, k, v, do, m, l, delta, None, hd ** -0.5, window or 0)
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
        print(f"  {name}{suffix} run to run (5 calls): "
              + ("bitwise equal" if n_diff == 0 else
                 f"up to {n_diff} of {total} bf16 elements differ"))
        if n_diff:
            raise AssertionError(f"{name} not bitwise reproducible")
    timed = {}
    for name, fn, kern in (
            ("flash_fwd", lambda: kflash.flash_fwd(q, k, v, window=window),
             "flash_fwd_"),
            ("flash_bwd_dq", lambda: kflash._dq_cuda(*bwd),
             "flash_dq_"),
            ("flash_bwd_dkv", lambda: kflash._dkv_cuda(*bwd), "flash_dkv_")):
        ev, own = time_launches(fn, kern)
        names = graph_kernels(fn)
        if list(names.values()) != [1]:
            raise AssertionError(f"{name}: kernels per call {names}")
        timed[name] = own
        print(f"  {name}{suffix}: one kernel per call; CUDA events around "
              f"the call "
              f"{ev:.4f} ms, the kernel's own duration {own:.4f} ms")
    plain_fwd, _ = time_launches(
        lambda: ref.flash_fwd_ref(q, k, v, window=window), reps=5, warmup=1)
    plain_bwd, _ = time_launches(
        lambda: ref.flash_bwd_ref(q, k, v, o, m, l, do, window=window),
        reps=5, warmup=1)
    # the library yardstick: one SDPA call on the same inputs (with a
    # window that binds, causal through a boolean mask of the visible
    # pairs; a window of T or more is plain causal, so ``is_causal``,
    # which keeps SDPA on its flash backend)
    F = torch.nn.functional
    qs = q.reshape(B, Hq, T, hd).detach().requires_grad_(True)
    ks = k.reshape(B, Hkv, T, hd).detach().requires_grad_(True)
    vs = v.reshape(B, Hkv, T, hd).detach().requires_grad_(True)
    dos = do.reshape(B, Hq, T, hd)
    mask = None
    if window is not None and window < T:
        pos = torch.arange(T, device="cuda")
        gap = pos[:, None] - pos[None, :]
        mask = (gap >= 0) & (gap < window)

    def sdpa():
        return F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True)

    with torch.no_grad():
        lib_fwd, _ = time_launches(sdpa)
    out = sdpa()
    lib_bwd, _ = time_launches(lambda: torch.autograd.grad(
        out, (qs, ks, vs), dos, retain_graph=True))
    print(f"  SDPA{suffix} ({'is_causal' if mask is None else 'window mask'}"
          f", enable_gqa): forward {lib_fwd:.4f} "
          f"ms, "
          f"backward (dq, dk, dv together) {lib_bwd:.4f} ms; plain: "
          f"forward {plain_fwd:.4f} ms, backward (all three) "
          f"{plain_bwd:.4f} ms")
    # the cost of bf16 rounding: the kernels' and SDPA's distance from the
    # plain fp32 version (its backward from its own forward)
    po, pm, pl = ref.flash_fwd_ref(q, k, v, window=window)
    plain = (po,) + ref.flash_bwd_ref(q, k, v, po, pm, pl, do,
                                      window=window)
    dq = kflash._dq_cuda(*bwd)
    kern = (o, dq, dk0, dv0)
    lib = [x.reshape(y.shape) for x, y in zip(
        (out,) + torch.autograd.grad(out, (qs, ks, vs), dos), plain)]
    torch.cuda.synchronize()
    print("  max|diff| from the plain version, kernels / SDPA: " + ", ".join(
        f"{n} {max_err(a, p):.3e} / {max_err(b, p):.3e}"
        for n, a, b, p in zip(("o", "dq", "dk", "dv"), kern, lib, plain)))

    work = flash_work(B, T, Hq, Hkv, hd, window)
    rows = []
    for name, err, plain_ms, lib_ms, src, line in (
            ("flash_fwd", err_fwd, plain_fwd, lib_fwd, "flash_fwd.cu", 105),
            ("flash_bwd_dq", err_dq, plain_bwd, lib_bwd, "flash_bwd.cu", 166),
            ("flash_bwd_dkv", err_dkv, plain_bwd, lib_bwd, "flash_bwd.cu",
             192)):
        w = work[name]
        b = bound(name, w["nbytes"], w["fp32_flops"], w["tc_flops"])
        all_tc = bound_ms(w["nbytes"], 0, w["tc_flops"] + w["fp32_flops"])[0]
        print(f"  {name}{suffix} bound with every product on the tensor "
              f"cores: "
              f"{all_tc * 1e3:.3f} us; the kernels' own duration "
              f"{timed[name] / b['bound_ms']:.2f}x the bound, "
              f"{timed[name] / lib_ms:.2f}x SDPA's "
              f"{'forward' if name == 'flash_fwd' else 'whole backward'}")
        rows.append(dict(name=name + suffix, route="cuda",
                         source=f"src/repro_torch/csrc/{src}",
                         replaces=f"src/repro/kernels/flash_attn.py:{line}",
                         max_abs_err=err, ms=timed[name], plain_ms=plain_ms,
                         **b, bound_all_tc_ms=all_tc, library_ms=lib_ms))
    return rows


def attn_decode_phase(ref, kattn, time_launches, shapes):
    """The flash-decode kernel against its plain version at the three
    shapes, bf16 (o: one rounding step, rtol = atol = 2e-2), bitwise equal
    over 5 calls of one kernel launch each (the kernel nodes of a
    captured call), each timed
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
        names = graph_kernels(call)
        print(f"  attn_decode {label}: 5 calls "
              + ("bitwise equal" if n_diff == 0 else
                 f"differ in up to {n_diff} of {o.numel()} elements")
              + f"; kernels per call {names}")
        if n_diff or list(names.values()) != [1]:
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
    plain path's own error.  Returns the step's inputs, its fp32 logits
    and the kernel path's bf16 ones (phase 13's model-axis bound)."""
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
    return dict(toks=toks.cpu(), tok=tok.cpu(), truth=truth.cpu(),
                one=lk.cpu())


# ---------------------------------------------------------------- phase 4

def program_bounds(eng) -> dict:
    """The reference's bounds on the program shapes of ``eng``'s path:
    batched staging one scan and one admit per input kind, the per-prompt
    masked planner at most ``_MAX_SCAN_CHUNKS`` scans and one admit, the
    pow2 baseline scans of m in {1, 2, 4} and tails of every power of two
    below the chunk; decode one program per k bucket."""
    C = eng.executor.prefill_chunk
    if eng.prefill_batching:
        prefill = dict(prefill_scan=1, prefill_chunk=0, prefill_admit=1)
    elif eng.plan_mode == "masked":
        prefill = dict(prefill_scan=4, prefill_chunk=0, prefill_admit=1)
    else:
        prefill = dict(prefill_scan=3, prefill_chunk=C.bit_length() - 1,
                       prefill_admit=C.bit_length())
    return dict(prefill, decode=max(1, eng.decode_block).bit_length())


def first_difference(streams, ref):
    """Per request, the first token index where ``streams`` leaves
    ``ref`` (None: equal)."""
    return [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                 None) for x, y in zip(streams, ref)]


def serve_twice(Engine, cfg, params, kw, make_requests, card, label,
                variants=()):
    """The same request mix through several engines on one set of
    weights: ``cuda_graphs=False`` (eager), the default (every decode and
    prefill program replayed from a CUDA graph), then each of
    ``variants`` ((name, extra engine arguments, held to the default's
    streams), replayed from graphs).  Each graph engine serves the mix
    twice: "cold" takes every program through its first, eager call and
    its capture; "warm" replays.  The eager engine, which has nothing to
    capture, serves it once (its "warm" run).  Every stream must be bitwise that of the
    default engine (a variant not held to them: its warm streams bitwise
    its cold ones, and the first token index where each request leaves
    the default's stream is printed), and every engine's program shapes
    within the reference's bounds for its path.

    The kernels' launch counters are set to 0 just before the eager
    engine's warm run (the main path, every launch counted at its
    wrapper) and read just after it.  Every other engine's warm run
    reports the counts it added; where programs replay, each replay adds
    what its capture counted, so the callers hold those counts to the
    eager run's and to what the profiler sees of a replay.  Returns
    (default engine, {engine name: (kernel launches of its warm run,
    keyed as ``launch_counts``, its decode steps)}, {(engine name, run):
    streams})."""
    from repro_torch.runtime.graphs import add_launches, launch_counts
    streams, graph_eng, runs = {}, None, {}
    engines = [("eager", dict(cuda_graphs=False), True), ("graphs", {}, True)]
    engines += list(variants)
    held = {name for name, _, same in engines if same}
    for name, extra, _ in engines:
        eng = Engine(cfg, params, **kw, **extra)
        if name != "eager" and not eng.executor.cuda_graphs:
            raise AssertionError(f"{label} {name}: the engine on the card "
                                 f"replays no CUDA graphs")
        # the eager engine captures nothing: it serves the mix once
        for run in (("warm",) if name == "eager" else ("cold", "warm")):
            reqs = make_requests()
            eng.reset_metrics()                 # decode_steps = 0
            if name == "eager" and run == "warm":
                add_launches(launch_counts(), -1)       # zero every count
            before = launch_counts()
            t0 = time.perf_counter()
            for r in reqs:
                eng.submit(r)
            eng.run_until_done()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if run == "warm":
                after = launch_counts()
                runs[name] = ({k: after[k] - before[k] for k in after},
                              eng.decode_steps)
            for r in reqs:
                if len(r.output) != r.max_new_tokens or not all(
                        0 <= t < cfg.vocab for t in r.output):
                    raise AssertionError(f"request {r.rid}: bad output "
                                         f"{r.output}")
            streams[(name, run)] = [list(r.output) for r in reqs]
            m = eng.metrics()
            print(f"  {label} {name} {run} [{card}]: decode "
                  f"{m['decode_us_per_token']:.1f} us/token "
                  f"({m['decoded_tokens']} tokens over {m['ticks']} "
                  f"ticks), mean TTFT {m['mean_ttft_s'] * 1e3:.1f} ms, "
                  f"{m['tokens'] / wall:.1f} tok/s ({m['tokens']} tokens in "
                  f"{wall:.3f} s), {m['mean_tokens_per_s']:.1f} tok/s per "
                  f"request; {m['stage_dispatches']} prefill + "
                  f"{m['scatter_dispatches']} scatter dispatches "
                  f"({'batched' if eng.prefill_batching else 'per-prompt'}"
                  f", {eng.plan_mode} plans); programs "
                  f"{eng.executor.compiled_programs()}")
        progs = eng.executor.compiled_programs()
        over = {k: (progs[k], n) for k, n in program_bounds(eng).items()
                if progs[k] > n}
        if over:
            raise AssertionError(f"{label} {name}: program shapes beyond "
                                 f"the reference's bounds (got, bound): "
                                 f"{over}")
        if name == "graphs":
            graph_eng = eng
        else:
            del eng
    for key, got in streams.items():
        want = (streams[("graphs", key[1])] if key[0] in held
                else streams[(key[0], "cold")])
        if got != want:
            raise AssertionError(f"{label} {key[0]} {key[1]}: streams "
                                 f"differ from the default engine's"
                                 if key[0] in held else
                                 f"{label} {key[0]} warm: streams differ "
                                 f"from its cold run's")
    for name, _, same in engines:
        if not same:
            print(f"  {label} {name}: first token index leaving the "
                  f"default engine's stream, per request "
                  + str(first_difference(streams[(name, "warm")],
                                         streams[("graphs", "warm")])))
    print(f"  {label}: streams bitwise equal across {sorted(held)} "
          f"(first 8 tokens: "
          + "; ".join(f"{i}:{s[:8]}"
                      for i, s in enumerate(streams[("graphs", "warm")]))
          + ")")
    return graph_eng, runs, streams


def gdn_launches(runs, kdecode, kprefill, n_layers, label):
    """The GDN kernels' launches on the main path: the eager engine's
    warm run, counted at the wrappers — ``gdn_decode`` once per layer and
    decode step, ``gdn_prefill`` a positive multiple of the layers (one
    launch per layer and chunk, every staged row in it).  The default
    graph engine serves the same schedule, so the counts its replays
    added must be the same; every graph engine's decode launches are one
    per layer and decode step.  Prints each engine's prefill launches.
    Returns {decode name: n, prefill name: n} of the eager run."""
    dkey, pkey = (kdecode.__name__, ""), (kprefill.__name__, "")
    eager, steps = runs["eager"]
    got = {"decode": eager[dkey], "prefill": eager[pkey]}
    if got["decode"] != n_layers * steps or got["prefill"] <= 0 \
            or got["prefill"] % n_layers:
        raise AssertionError(f"{label} eager: launches {got} ({n_layers} "
                             f"layers, {steps} decode steps)")
    for name, (counts, steps_) in runs.items():
        if counts[dkey] != n_layers * steps_:
            raise AssertionError(f"{label} {name}: {counts[dkey]} "
                                 f"gdn_decode launches, not {n_layers} x "
                                 f"{steps_}")
    replayed = runs["graphs"][0]
    if (replayed[dkey], replayed[pkey]) != (got["decode"], got["prefill"]):
        raise AssertionError(f"{label}: the graph engine's replays added "
                             f"{replayed[dkey]} / {replayed[pkey]} launches "
                             f"where the eager engine launched {got}")
    print(f"  {label} launches in the eager warm run, counted at the "
          f"wrappers: gdn_decode {got['decode']} = {n_layers} layers x "
          f"{steps} decode steps, gdn_prefill {got['prefill']} = "
          f"{n_layers} x {got['prefill'] // n_layers} chunks; the default "
          f"graph engine's replays added the same; gdn_prefill per warm "
          f"run by engine (graph engines: added by replays) "
          f"{ {k: c[pkey] for k, (c, _) in runs.items()} }")
    return got


def profile_batched_round(eng, kernel_counts, n_layers, label):
    """One batched round replayed under the profiler: the (D, 4, C) scan
    and the admit over every staging row (greedy; rows taking 4, 3, ...
    full chunks, then tails of C/2, C/2 + 1, ... tokens), both programs
    captured by the serve runs.  Each layer launches the prefill kernel
    once per chunk of the scan and once for the admit, every row in the
    launch; no program may be added or captured (both replayed).  The rows
    are released afterwards."""
    from repro_torch.serving.executor import _MAX_SCAN_CHUNKS as M
    ex = eng.executor
    D, C = ex.staging_depth, ex.prefill_chunk
    for key in (("bscan", False), ("badmit", False, False)):
        if key not in ex._programs or ex._programs[key].graph is None:
            raise AssertionError(f"{label}: {key} was not captured")
    rng = np.random.default_rng(5)
    for row in range(D):
        ex.bstage_begin(row, seed=0, rid=1000 + row, temperature=0.0,
                        top_k=0, top_p=1.0, eos_id=None, budget=1)
    scan = [(row, rng.integers(1, eng.cfg.vocab, (M - row) * C), M - row)
            for row in range(D)]
    admit = [(row, rng.integers(1, eng.cfg.vocab, C // 2 + row),
              C // 2 + row) for row in range(D)]

    def round_():
        ex.bstage_chunk_scan(scan)
        ex.bstage_admit(admit)

    progs = ex.compiled_programs()
    counts = kernel_counts(round_, calls=1)
    ex.bscatter([], release_rows=range(D))
    if ex.compiled_programs() != progs:
        raise AssertionError(f"{label}: the profiled round added or "
                             f"captured a program")
    got = sum(n for name, n in counts.items() if "gdn_prefill" in name)
    print(f"  {label}: one replayed batched round ({D} rows, scan of {M} "
          f"chunks + admit) under the profiler: {got:g} gdn_prefill kernel "
          f"launches ({n_layers} x ({M} + 1) expected), "
          f"{sum(counts.values()):g} kernels in all")
    if got != n_layers * (M + 1):
        raise AssertionError(f"{label}: a replayed batched round ran {got} "
                             f"gdn_prefill launches, not {n_layers} x "
                             f"({M} + 1)")


def _phase4_prompts(vocab):
    """Phase 4's mix: 6 prompts of 100-400 tokens."""
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, size=int(rng.integers(100, 401)))
            for _ in range(6)]


def staged_row_diff(Engine, cfg, params, kw, Request, prompts):
    """Two prompts staged together (batched: one launch of each prefill
    program over both rows, the dense projections one product over both
    rows' tokens) and one at a time (per prompt), eagerly, each request
    finishing at its admit so its staged caches stay in place: the max
    |diff| of the first prompt's staged caches, batched against per
    prompt (printed; the streams are what is held equal)."""
    from repro_torch.tree import leaves
    rows = {}
    for batched in (True, False):
        eng = Engine(cfg, params, cuda_graphs=False,
                     prefill_batching=batched, **kw)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=1))
        eng.run_until_done()
        ex = eng.executor
        rows[batched] = ([t[:, 0].clone() for t in leaves(ex.bstaging)]
                         if batched else
                         [t[:, 0].clone() for t in leaves(ex.staging[0])])
        del eng, ex
    diffs = [max_err(a, b) for a, b in zip(rows[True], rows[False])]
    same = all(torch.equal(a, b) for a, b in zip(rows[True], rows[False]))
    print(f"  one staged row's caches (prompt of {len(prompts[0])} tokens "
          f"staged beside one of {len(prompts[1])}), batched against per "
          f"prompt: max|diff| {max(diffs):.3e} over {len(diffs)} leaves, "
          f"bitwise equal {same}")


def pow2_fp32_check(Engine, cfg, params, kw, make_requests):
    """The pow2 plans decompose a prompt's tail into other chunks (32 + 4
    tokens where the masked plan runs one padded 64-token chunk): other
    GDN chunk factorizations and other GEMM row counts, whose bf16
    roundings differ, so in bf16 their streams may leave the masked
    plans'.  The reference holds the two planners' streams equal in fp32
    (``tests/test_ragged_prefill.py``): here at full width too, the same
    weights upcast to fp32 activations, batched (masked) against pow2,
    eagerly."""
    from repro_torch.tree import tree_map
    cfg32 = cfg.replace(act_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    out = {}
    for name, extra in (("batched", {}), ("pow2", dict(plan_mode="pow2"))):
        eng = Engine(cfg32, p32, cuda_graphs=False, **kw, **extra)
        reqs = make_requests()
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        out[name] = [list(r.output) for r in reqs]
        del eng
    del p32
    torch.cuda.empty_cache()
    diff = first_difference(out["pow2"], out["batched"])
    print(f"  fp32 activations: pow2 against batched (masked) streams, "
          f"first differing token per request {diff}")
    if any(d is not None for d in diff):
        raise AssertionError("fp32: pow2 streams differ from the masked "
                             "plans'")


def pow2_plain_witness(Engine, cfg, params, kw, make_requests,
                       kernel_diff):
    """The second witness that the pow2 engine's bf16 streams leave the
    masked plans' through bf16 arithmetic and not through the port's
    kernels: the same weights and mix through the plain path
    (``use_pallas_serving=False``: no hand-written kernel may launch),
    batched (masked) against pow2, eagerly.  ``kernel_diff``, the first
    token index per request where the kernel path's pow2 streams leave
    the masked ones, may hold a difference only if the plain path's
    streams leave theirs too."""
    from repro_torch.runtime.graphs import launch_counts
    plain = cfg.replace(use_pallas_serving=False)
    before, out = launch_counts(), {}
    t0 = time.perf_counter()
    for name, extra in (("batched", {}), ("pow2", dict(plan_mode="pow2"))):
        eng = Engine(plain, params, cuda_graphs=False, **kw, **extra)
        reqs = make_requests()
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        out[name] = [list(r.output) for r in reqs]
        del eng
    torch.cuda.synchronize()
    if launch_counts() != before:
        raise AssertionError("a hand-written kernel launched on the plain "
                             "path")
    diff = first_difference(out["pow2"], out["batched"])
    print(f"  bf16, plain path (no kernel; {time.perf_counter() - t0:.1f} "
          f"s): pow2 against batched (masked) streams, first differing "
          f"token per request {diff}; kernel path {kernel_diff}")
    if any(d is not None for d in kernel_diff) and all(
            d is None for d in diff):
        raise AssertionError("bf16: the kernel path's pow2 streams leave "
                             "the masked plans' where the plain path's do "
                             "not")


def serve_phase(cfg, params, engine_mod, kdecode, kprefill, card,
                kernel_counts):
    Engine, Request = engine_mod.DecodeEngine, engine_mod.Request
    kw = dict(max_slots=4, max_len=1024, prefill_chunk=64, decode_block=8,
              seed=0, device="cuda")
    prompts = _phase4_prompts(cfg.vocab)
    print(f"  prompts {[len(p) for p in prompts]}, 32 new tokens each")

    def requests():
        return [Request(rid=i, prompt=p, max_new_tokens=32,
                        temperature=0.8 if i == 2 else 0.0,
                        top_k=40 if i == 2 else 0)
                for i, p in enumerate(prompts)]

    eng, runs, streams = serve_twice(
        Engine, cfg, params, kw, requests, card, "serve",
        variants=(("per-prompt", dict(prefill_batching=False), True),
                  ("pow2", dict(plan_mode="pow2"), False)))
    warm_us = eng.metrics()["decode_us_per_token"]     # its warm run
    step_ms = eng.decode_s / eng.decode_steps * 1e3
    n_gdn = sum(k == "gdn" for k in cfg.layer_kinds)
    got = gdn_launches(runs, kdecode, kprefill, n_gdn, "serve")
    launches = {"gdn_decode": got["decode"], "gdn_prefill": got["prefill"]}
    profile_batched_round(eng, kernel_counts, n_gdn, "serve")
    staged_row_diff(Engine, cfg, params, kw, Request, prompts[:2])
    pow2_fp32_check(Engine, cfg, params, kw, requests)
    pow2_plain_witness(Engine, cfg, params, kw, requests,
                       first_difference(streams[("pow2", "warm")],
                                        streams[("graphs", "warm")]))

    # one replayed tick under the profiler: 4 resident greedy requests,
    # ticks of k = 8 after the decode(8) graph has been captured
    for i in range(4):
        eng.submit(Request(rid=100 + i, prompt=prompts[i][:128],
                           max_new_tokens=200))
    while len(eng.active) < 4 or eng._stagings or eng.queue:
        eng.step()
    for _ in range(2):
        eng.step()
    if eng.executor._programs[("decode", 8, False)].graph is None:
        raise AssertionError("decode(8) was not captured")
    ks = []

    def tick():
        steps0 = eng.decode_steps
        eng.step()
        ks.append(eng.decode_steps - steps0)

    counts = kernel_counts(tick, calls=1)
    k = ks[-1]
    if set(ks) != {8}:
        raise AssertionError(f"profiled ticks of k = {ks}, not 8")
    got = sum(n for name, n in counts.items() if "gdn_decode_kernel" in name)
    print(f"  one replayed tick (k = {k}) under the profiler: {got:g} "
          f"gdn_decode_kernel launches ({n_gdn} x {k} expected), "
          f"{sum(counts.values()):g} kernels in all")
    if got != n_gdn * k:
        raise AssertionError(f"a replayed tick ran {got} gdn_decode_kernel "
                             f"launches, not {n_gdn} x {k}")
    return launches, streams[("graphs", "warm")], warm_us, step_ms


# ---------------------------------------------------------------- phase 18

def dryrun_phase(cfg, params, param_alloc, lm, ref, kdecode, time_launches,
                 step_ms, card):
    """(a) The dry run (``launch.steps.count_cell``, the step on meta
    stand-ins) of phase 4's decode step, held against the card: its
    argument bytes within 1% of what the allocator holds for the params
    (``param_alloc``, measured as they were drawn) and the caches; its
    peak beside ``max_memory_allocated`` of one eager ``lm.decode_step``;
    its unfused ``memory_s`` and ``memory_floor_s`` beside phase 4's
    replayed step (``step_ms``, None where phase 4 did not run).  (b) The
    paper's Table II on the card at batch 1, one full-width GDN layer:
    (i) the gdn_decode kernel alone (phase 2's check and timing at B 1),
    (ii) the gdn_naive mixer's decode (Alg. 1: three state reads and one
    write), (iii) the gdn mixer's decode through the kernel; each the
    mean CUDA-event time after phase 2's L2 flush, eagerly (the host's
    enqueue of an eager mixer may outlast the spin that hides it) and
    replayed from a CUDA graph of one call, beside the intensity
    model's bytes for its form (``mixer_decode_profile``; plus the
    layer's projection weights for the mixers, which read them) over the
    HBM rate, and the model's intensity.  Returns the gdn_decode_b1 row
    and its launches ((iii)'s one call, counted at the wrapper)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import intensity
    from repro_torch.launch import dryrun, steps
    from repro_torch.models.gdn_layer import GDNState
    from repro_torch.models.mixers import get_mixer
    from repro_torch.tree import leaves, tree_map

    t0 = time.perf_counter()
    shape = ShapeConfig("phase4_decode", PHASE4_KW["max_len"],
                        PHASE4_KW["max_slots"], "decode")
    cost = steps.count_cell(cfg, shape)
    args = cost["argument_bytes"]
    print(f"  [18] (a) count_cell of phase 4's decode step ({cfg.name}, "
          f"B {shape.global_batch}, max_len {shape.seq_len}, one device) "
          f"on meta in {cost['seconds']:.1f} s: {cost['ops']} ops, "
          f"{cost['flops'] / 1e9:.3f} GFLOP, {cost['bytes'] / 1e9:.3f} GB "
          f"unfused (an upper bound), arguments {args}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    caches = lm.init_caches(cfg, shape.global_batch, shape.seq_len,
                            device="cuda")
    tokens = torch.zeros(shape.global_batch, dtype=torch.int32,
                         device="cuda")
    torch.cuda.synchronize()
    card_args = param_alloc + torch.cuda.memory_allocated() - base
    gap = card_args / args["total"] - 1
    print(f"  [18] (a) argument bytes: counted {args['total']} B, the "
          f"allocator's for the params and caches {card_args} B "
          f"({gap * 100:+.4f}%)")
    if abs(gap) > 0.01:
        raise AssertionError(f"the dry run's argument bytes are "
                             f"{gap * 100:+.3f}% off the allocator's")
    other = torch.cuda.memory_allocated() - card_args
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        lm.decode_step(params, cfg, tokens, caches)
    torch.cuda.synchronize()
    card_peak = torch.cuda.max_memory_allocated() - other
    print(f"  [18] (a) peak: counted {cost['peak_bytes']} B (plain "
          f"versions on meta), one eager lm.decode_step's "
          f"max_memory_allocated {card_peak} B (less what else the card "
          f"held), ratio {cost['peak_bytes'] / card_peak:.4f}")
    memory_s = cost["bytes"] / dryrun.HBM_BW
    floor_s = dryrun.memory_floor_s(cfg, shape, None, args["params"])
    replayed = ("phase 4 not run" if step_ms is None else
                f"phase 4's replayed step {step_ms:.4f} ms "
                f"({step_ms / (floor_s * 1e3):.2f}x the floor)")
    print(f"  [18] (a) memory_s {memory_s * 1e3:.4f} ms (unfused), "
          f"memory_floor_s {floor_s * 1e3:.4f} ms, {replayed} [{card}]")
    del caches, tokens

    B1 = (1, CFG["Hk"], CFG["Hv"], CFG["d"], CFG["d"])
    row = decode_phase(ref, kdecode, time_launches, "gdn_decode_b1", B1,
                       delta_rules=(True,))
    gen = torch.Generator(device="cuda").manual_seed(18)
    lp = tree_map(lambda a: a[0], params["groups"][0][0]["mixer"])
    weights = sum(t.numel() * t.element_size() for t in leaves(lp))
    x = torch.randn((1, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    S = torch.zeros(B1[0], B1[2], B1[3], B1[4], device="cuda")
    state = GDNState(S=S)
    g, beta = torch.sigmoid(torch.randn((2, 1, B1[2]), generator=gen,
                                        device="cuda")).unbind(0)
    q = torch.randn((1, B1[1], B1[3]), generator=gen, device="cuda").to(
        torch.bfloat16)
    k = torch.nn.functional.normalize(torch.randn(
        (1, B1[1], B1[3]), generator=gen, device="cuda"), dim=-1).to(
        torch.bfloat16)
    v = torch.randn((1, B1[2], B1[4]), generator=gen, device="cuda").to(
        torch.bfloat16)
    naive, fused = get_mixer("gdn_naive"), get_mixer("gdn")
    with torch.no_grad():
        zero_launches()
        fused.decode(lp, cfg, x, state)
        launches = gdn_counts()["gdn_decode"]
        if launches != 1:
            raise AssertionError(f"the gdn mixer's decode launched "
                                 f"gdn_decode {launches} times, not once")
        forms = [
            ("(i) the gdn_decode kernel alone", "gdn", 0,
             lambda: kdecode.gdn_decode(q, k, v, S, g.contiguous(),
                                        beta.contiguous())),
            ("(ii) the gdn_naive mixer's decode", "gdn_naive", weights,
             lambda: naive.decode(lp, cfg, x, state)),
            ("(iii) the gdn mixer's decode (kernel)", "gdn", weights,
             lambda: fused.decode(lp, cfg, x, state))]
        for label, kind, w, fn in forms:
            ms, _ = time_launches(fn, mean=True)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                fn()
            graph_ms, _ = time_launches(graph.replay, mean=True)
            prof = intensity.mixer_decode_profile(cfg, kind, seq=1)
            nbytes = prof.total_bytes + w
            bound_us = nbytes / HBM_BYTES_PER_S * 1e6
            print(f"  [18] (b) {label}, batch 1: {ms * 1e3:.2f} us eager, "
                  f"{graph_ms * 1e3:.2f} us replayed from a CUDA graph "
                  f"(mean CUDA events) vs {bound_us:.2f} us for "
                  f"{nbytes:.0f} B (the model's {prof.total_bytes:.0f} B"
                  + (f" + {w} B of projection weights" if w else "")
                  + f"; {graph_ms * 1e3 / bound_us:.2f}x replayed); the "
                  f"model's intensity {prof.intensity:.4f} FLOP/B"
                  + (f", {prof.flops / nbytes:.4f} with the weights"
                     if w else "") + f" [{card}]")
            del graph
    print(f"  [18] took {time.perf_counter() - t0:.1f} s [{card}]")
    return row, launches


# ---------------------------------------------------------------- phase 9

def profile_verify(eng, kernel_counts, n_target, n_draft, label):
    """One speculative tick's programs replayed under the profiler: the
    draft (k steps of the draft model) and the verify (k + 1 positions of
    target and draft), greedy, at the largest k whose draft and verify
    the runs captured.  ``gdn_decode_kernel`` launches must be n_draft x
    k + (n_target + n_draft) x (k + 1), and no program may be added or
    captured (both replayed)."""
    ex = eng.executor
    if ex._stochastic():
        raise AssertionError(f"{label}: a slot is still stochastic")
    ks = [key[1] for key, prog in ex._programs.items()
          if key[0] == "verify" and key[1] >= 1 and not key[2]
          and prog.graph is not None
          and ("draft", key[1], False) in ex._programs
          and ex._programs[("draft", key[1], False)].graph is not None]
    if not ks:
        raise AssertionError(f"{label}: no greedy draft and verify pair "
                             f"was captured")
    k = max(ks)
    progs = ex.compiled_programs()
    counts = kernel_counts(lambda: ex.spec_verify(k, ex.spec_draft(k)),
                           calls=1)
    if ex.compiled_programs() != progs:
        raise AssertionError(f"{label}: the profiled tick added or "
                             f"captured a program")
    got = sum(n for name, n in counts.items() if "gdn_decode_kernel" in name)
    want = n_draft * k + (n_target + n_draft) * (k + 1)
    print(f"  [9] {label}: one replayed draft + verify (k = {k}) under the "
          f"profiler: {got:g} gdn_decode_kernel launches ({n_draft} x {k} "
          f"+ {n_target + n_draft} x {k + 1} expected), "
          f"{sum(counts.values()):g} kernels in all")
    if got != want:
        raise AssertionError(f"[9] {label}: a replayed draft + verify ran "
                             f"{got} gdn_decode_kernel launches, not {want}")


def spec_phase(cfg, params, lm, engine_mod, kdecode, card, plain,
               kernel_counts):
    """Speculative decode of full-width qwen3-next-gdn on phase 4's mix
    and engine settings, through CUDA graphs: (a) a self-draft with
    k_draft = 4; (b) a draft of the same architecture with weights drawn
    from seed 1, ``adaptive_k``; each served cold (every program's first
    call and capture), then warm (replayed: in (b) the rollback).  Every stream must be bitwise phase 4's plain
    ``plain``.  ``gdn_decode`` launches per run, counted under replay,
    must be (draft GDN layers) x (draft steps) + (target + draft GDN
    layers) x (verify positions): bookkeeping under replay, so one
    replayed draft + verify per engine runs under the profiler too."""
    from repro_torch.runtime.graphs import add_launches, launch_counts
    Engine, Request = engine_mod.DecodeEngine, engine_mod.Request
    kw = dict(max_slots=4, max_len=1024, prefill_chunk=64, decode_block=8,
              seed=0, device="cuda")
    prompts = _phase4_prompts(cfg.vocab)

    def requests():
        return [Request(rid=i, prompt=p, max_new_tokens=32,
                        temperature=0.8 if i == 2 else 0.0,
                        top_k=40 if i == 2 else 0)
                for i, p in enumerate(prompts)]

    t0 = time.perf_counter()
    dparams = lm.init_lm(torch.Generator(device="cuda").manual_seed(1), cfg,
                         device="cuda")
    torch.cuda.synchronize()
    print(f"  seed-1 draft weights drawn in {time.perf_counter() - t0:.1f} "
          f"s")
    n_gdn = sum(k == "gdn" for k in cfg.layer_kinds)
    out = {}
    for label, extra in (
            ("self-draft k=4", dict(k_draft=4)),
            ("seed-1 draft adaptive k<=4",
             dict(k_draft=4, adaptive_k=True, draft_cfg=cfg,
                  draft_params=dparams))):
        eng = Engine(cfg, params, speculative=True, **kw, **extra)
        if not eng.executor.cuda_graphs:
            raise AssertionError("the speculative engine replays no graphs")
        for run in ("cold", "warm"):
            reqs = requests()
            eng.reset_metrics()
            add_launches(launch_counts(), -1)           # zero every count
            t0 = time.perf_counter()
            for r in reqs:
                eng.submit(r)
            eng.run_until_done()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = launch_counts()[(kdecode.__name__, "")]
            streams = [list(r.output) for r in reqs]
            m = eng.metrics()
            want = n_gdn * eng.draft_steps + 2 * n_gdn * eng.verify_positions
            print(f"  [9] {label} {run} [{card}]: acceptance "
                  f"{m['acceptance_rate']:.4f} ({m['accepted_tokens']} of "
                  f"{m['drafted_tokens']} drafted), {m['spec_ticks']} "
                  f"ticks, {m['syncs_per_token']:.4f} syncs/token, decode "
                  f"{m['decode_us_per_token']:.1f} us/token "
                  f"({m['decoded_tokens']} tokens), mean TTFT "
                  f"{m['mean_ttft_s'] * 1e3:.1f} ms, {m['tokens'] / wall:.1f}"
                  f" tok/s ({wall:.3f} s), k effective "
                  f"{m['k_draft_effective']}, {m['draft_prefills']} draft "
                  f"rebuilds; gdn_decode launches {got} = {n_gdn} x "
                  f"{eng.draft_steps} draft steps + {2 * n_gdn} x "
                  f"{eng.verify_positions} verify positions; programs "
                  f"{eng.executor.compiled_programs()}")
            if streams != plain:
                raise AssertionError(f"[9] {label} {run}: streams differ "
                                     f"from plain decode's")
            if got != want:
                raise AssertionError(f"[9] {label} {run}: gdn_decode "
                                     f"launches {got} != {want}")
        print(f"  [9] {label}: checkpoint {m['checkpoint_bytes_per_slot']} "
              f"B/slot, draft {m['draft_bytes_per_slot']} B/slot, "
              f"{m['speculative_bytes']} B speculative buffers in all; "
              f"streams bitwise equal to plain decode")
        profile_verify(eng, kernel_counts, n_gdn, n_gdn, label)
        out[label] = m
        del eng
    del dparams
    return out


# ---------------------------------------------------------------- phase 10

# the executor's paging calls, each watched by watch_swaps
SWAP_CALLS = ("gather_slot_async", "gather_staging_async",
              "bgather_row_async", "harvest", "prestage_restore",
              "restore_slot")


def watch_swaps(eng):
    """Wrap ``eng``'s executor's paging calls: none may add or capture a
    program (``compiled_programs()`` the same before and after the call),
    and every image harvested or put back is ``swap_bytes_per_slot``
    bytes.  Returns the counts of calls made, by name."""
    ex, calls = eng.executor, {name: 0 for name in SWAP_CALLS}

    def wrap(name, fn):
        def call(*args, **kw):
            before = ex.compiled_programs()
            out = fn(*args, **kw)
            if ex.compiled_programs() != before:
                raise AssertionError(f"[10] {name} added or captured a "
                                     f"program")
            image = (out if name == "harvest" else args[0]
                     if name == "prestage_restore" else args[1]
                     if name == "restore_slot" else None)
            if image is not None and image.nbytes != ex.swap_bytes_per_slot:
                raise AssertionError(f"[10] {name}: an image of "
                                     f"{image.nbytes} B, not "
                                     f"{ex.swap_bytes_per_slot}")
            calls[name] += 1
            return out
        return call

    for name in SWAP_CALLS:
        setattr(ex, name, wrap(name, getattr(ex, name)))
    return calls


def buffer_ptrs(ex):
    """The address of every slot buffer the captured programs read: the
    caches, sampler and tokens, and a speculative engine's draft caches
    and checkpoints."""
    from repro_torch.tree import leaves
    trees = [ex.caches, ex.sampler, ex.tokens]
    if ex.speculative:
        trees += [ex.dcaches, ex.ckpt, ex.dckpt]
    return [t.data_ptr() for t in leaves(trees)]


def step_until(eng, pred, what, max_ticks=200):
    for _ in range(max_ticks):
        eng.step()
        if pred():
            return
    raise AssertionError(f"[10] never reached: {what}")


def paged_run(eng, script, plain, card, label):
    """One paged serve of phase 4's mix on ``eng``: the launch counters
    set to 0 just before, read just after; every stream bitwise
    ``plain``; ``gdn_decode`` launches added = 36 x decode steps (target
    and draft layers x verify positions on a speculative engine); every
    swap whole images; no slot buffer moved.  Prints the swap counts,
    us/MiB, the time split and the overlap ratio.  Returns (metrics,
    {"gdn_decode": launches, "gdn_prefill": launches})."""
    from repro_torch.kernels import gdn_decode as kdecode
    from repro_torch.kernels import gdn_prefill as kprefill
    from repro_torch.runtime.graphs import add_launches, launch_counts
    ex = eng.executor
    ptrs = buffer_ptrs(ex)
    calls = watch_swaps(eng)
    eng.reset_metrics()
    add_launches(launch_counts(), -1)               # zero every count
    t0 = time.perf_counter()
    reqs = script(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts[(kdecode.__name__, "")]
    prefills = counts[(kprefill.__name__, "")]
    streams = [list(r.output) for r in reqs]
    m = eng.metrics()
    n_gdn = sum(k == "gdn" for k in eng.cfg.layer_kinds)
    want = (n_gdn * eng.draft_steps + 2 * n_gdn * eng.verify_positions
            if eng.speculative else n_gdn * eng.decode_steps)
    print(f"  [10] {label} [{card}]: {m['swap_outs']} swap-outs / "
          f"{m['swap_ins']} swap-ins of {m['swap_bytes_per_slot']} B, "
          f"{m['swap_us_per_mb']:.1f} us/MiB (swap {m['swap_s'] * 1e3:.3f} "
          f"ms: gather {m['swap_gather_s'] * 1e3:.3f} / put "
          f"{m['swap_put_s'] * 1e3:.3f} / scatter "
          f"{m['swap_scatter_s'] * 1e3:.3f}; dispatch "
          f"{m['swap_dispatch_s'] * 1e3:.3f} / stall "
          f"{m['swap_stall_s'] * 1e3:.3f}), harvests "
          f"{m['swap_harvests_overlapped']} overlapped + "
          f"{m['swap_harvests_forced']} forced (overlap ratio "
          f"{m['swap_overlap_ratio']:.3f}), prefetches "
          f"{m['swap_prefetch_hits']}/{m['swap_prefetches']} hit; decode "
          f"{m['decode_us_per_token']:.1f} us/token, {wall:.3f} s; "
          f"gdn_decode launches {launches}, gdn_prefill {prefills}; swap "
          f"calls "
          f"{ {k: n for k, n in calls.items() if n} }")
    if streams != plain:
        raise AssertionError(f"[10] {label}: streams differ from phase 4's "
                             f"plain ones, first index per request "
                             f"{first_difference(streams, plain)}")
    if launches != want or launches <= 0:
        raise AssertionError(f"[10] {label}: gdn_decode launches "
                             f"{launches} != {want}")
    if m["swap_bytes"] != ((m["swap_outs"] + m["swap_ins"])
                           * ex.swap_bytes_per_slot):
        raise AssertionError(f"[10] {label}: swap_bytes {m['swap_bytes']} "
                             f"not whole images")
    if buffer_ptrs(ex) != ptrs:
        raise AssertionError(f"[10] {label}: a slot buffer moved")
    if m["swap_outs"] < 1 or m["swap_ins"] != m["swap_outs"] \
            or m["swapped"] or m["draining_swaps"]:
        raise AssertionError(f"[10] {label}: swaps out {m['swap_outs']}, "
                             f"in {m['swap_ins']}, {m['swapped']} still "
                             f"swapped")
    return m, {"gdn_decode": launches, "gdn_prefill": prefills}


def paging_phase(cfg, params, engine_mod, card, plain, plain_decode_us):
    """State paging of full-width qwen3-next-gdn on phase 4's mix and
    engine settings, through CUDA graphs, every stream bitwise phase 4's
    plain ``plain``: (a) synchronous pause / resume of an active request,
    ``preempt()`` of the policy victim and a pause at the admit boundary
    (its engine serves the mix once first, so this run is warm); (b) the
    pressure policy; (c) async paging, three pauses in one tick through a
    gather ring of 2, a resume taken from a prefetch; (d) spill to a
    spool directory with a watermark of 0 bytes; (e) a pause during a
    pending draft on a self-draft engine, swapped out at the verify.
    Returns the GDN kernels' launches of each part, by kernel."""
    Engine, Request = engine_mod.DecodeEngine, engine_mod.Request
    kw = dict(max_slots=4, max_len=1024, prefill_chunk=64, decode_block=8,
              seed=0, device="cuda")
    prompts = _phase4_prompts(cfg.vocab)

    def requests():
        return [Request(rid=i, prompt=p, max_new_tokens=32,
                        temperature=0.8 if i == 2 else 0.0,
                        top_k=40 if i == 2 else 0)
                for i, p in enumerate(prompts)]

    def decoded(r, n):
        return r.state == "active" and len(r.output) >= n + 1

    def part_a(eng):
        reqs = requests()
        for r in reqs:
            eng.submit(r)
        step_until(eng, lambda: decoded(reqs[0], 2), "rid 0 decoding")
        eng.pause(0)
        eng.step()
        eng.step()
        eng.resume(0)
        if eng.preempt() is None:
            raise AssertionError("[10] (a): no preempt victim")
        step_until(eng, lambda: any(st.ready for st in eng._stagings),
                   "a staged-ready request")
        st = next(st for st in eng._stagings if st.ready)
        rid = st.req.rid
        eng.pause(rid)
        if eng.swapped[rid].state is None:
            raise AssertionError("[10] (a): no admit-boundary image")
        eng.step()
        eng.resume(rid)
        eng.run_until_done()
        return reqs

    def part_b(eng):
        reqs = requests()
        for r in reqs[4:]:
            r.priority = 1
        for r in reqs[:4]:
            eng.submit(r)
        step_until(eng, lambda: len(eng.active) == 4, "4 active")
        for r in reqs[4:]:
            eng.submit(r)
        eng.run_until_done()
        if eng.swap_outs < 2:
            raise AssertionError("[10] (b): the priority-1 requests "
                                 "evicted fewer than 2")
        return reqs

    def part_c(eng):
        reqs = requests()
        for r in reqs:
            eng.submit(r)
        step_until(eng, lambda: len(eng.active) == 4 and all(
            decoded(r, 2) for r in eng.active.values()), "4 decoding")
        rids = sorted(r.rid for r in eng.active.values())[:3]
        for rid in rids:                        # 3 pauses, a ring of 2
            eng.pause(rid)
        if eng.swap_harvests_forced < 1:
            raise AssertionError("[10] (c): no forced harvest")
        for rid in rids:
            eng.resume(rid)
        eng.run_until_done()
        if eng.swap_prefetch_hits < 1:
            raise AssertionError("[10] (c): no resume took a prefetch")
        return reqs

    spill = {"write": [], "read": [], "bytes": []}

    def timed(fn, key):
        def call(rec):
            t0 = time.perf_counter()
            path = rec.spool
            fn(rec)
            spill[key].append(time.perf_counter() - t0)
            if key == "write":
                spill["bytes"].append(os.path.getsize(rec.spool))
            elif os.path.exists(path):
                raise AssertionError("[10] (d): the spool file outlived "
                                     "its reload")
        return call

    def part_d(eng):
        eng._spill = timed(eng._spill, "write")
        eng._load_spill = timed(eng._load_spill, "read")
        reqs = requests()
        for r in reqs:
            eng.submit(r)
        step_until(eng, lambda: decoded(reqs[0], 2), "rid 0 decoding")
        eng.pause(0)
        step_until(eng, lambda: eng.swapped[0].spool is not None,
                   "the image spilled", max_ticks=3)
        eng.resume(0)
        eng.run_until_done()
        if os.listdir(eng.swap_spool_dir):
            raise AssertionError("[10] (d): the spool dir is not empty")
        return reqs

    def part_e(eng):
        reqs = requests()
        for r in reqs:
            eng.submit(r)
        step_until(eng, lambda: decoded(reqs[0], 2) and eng._pending,
                   "a pending draft over rid 0")
        eng.pause(0)
        if reqs[0].state != "active" or 0 in eng.swapped:
            raise AssertionError("[10] (e): the pause was not deferred")
        eng.step()
        if 0 not in eng.swapped:
            raise AssertionError("[10] (e): no swap at the verify")
        eng.step()
        eng.resume(0)
        eng.run_until_done()
        return reqs

    out = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as spool:
        for part, label, extra, script in (
                ("a", "(a) sync, warm", {}, part_a),
                ("b", "(b) pressure", dict(swap_policy="pressure"), part_b),
                ("c", "(c) async, ring 2",
                 dict(async_paging=True, gather_ring=2), part_c),
                ("d", "(d) spill", dict(host_swap_bytes=0,
                                        swap_spool_dir=spool), part_d),
                ("e", "(e) speculative, self-draft k=4",
                 dict(speculative=True, k_draft=4), part_e)):
            eng = Engine(cfg, params, **kw, **extra)
            if not eng.executor.cuda_graphs:
                raise AssertionError("[10] the engine replays no graphs")
            if part == "a":                 # served whole once: warm
                reqs = requests()
                for r in reqs:
                    eng.submit(r)
                eng.run_until_done()
                if [list(r.output) for r in reqs] != plain:
                    raise AssertionError("[10] (a): the warm-up streams "
                                         "differ from phase 4's")
            m, counts = paged_run(eng, script, plain, card, label)
            for name, n in counts.items():
                out.setdefault(name, {})[part] = n
            if part == "a":
                print(f"  [10] warm decode {m['decode_us_per_token']:.1f} "
                      f"us/token with 3 swaps out and in, phase 4's warm "
                      f"graph engine {plain_decode_us:.1f} [{card}]")
            del eng
        print(f"  [10] (d) spill: {spill['bytes']} B written in "
              f"{[round(s, 4) for s in spill['write']]} s, read back in "
              f"{[round(s, 4) for s in spill['read']]} s [{card}]")
        if not spill["read"] or len(spill["write"]) != len(spill["read"]):
            raise AssertionError("[10] (d): no spill round trip")
    return out


# ---------------------------------------------------------------- phase 11

def compute_mode() -> str:
    """The card's compute mode; several processes share the card only in
    ``Default``."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def step_launches(engines):
    """Attribute the kernels' launches to the engine whose ``step`` made
    them (a router launches nothing outside its engines' steps).  Returns
    {engine index: launch counts added, keyed as ``launch_counts``}."""
    from repro_torch.runtime.graphs import launch_counts
    got = {i: {} for i in range(len(engines))}

    def wrap(i, fn):
        def step():
            before = launch_counts()
            fn()
            for k, n in launch_counts().items():
                got[i][k] = got[i].get(k, 0) + n - before[k]
        return step

    for i, eng in enumerate(engines):
        eng.step = wrap(i, eng.step)
    return got


def count_chunks(eng):
    """Count the prefill chunks ``eng``'s batched programs run: each scan
    runs ``_MAX_SCAN_CHUNKS`` chunks whatever its rows take, each admit
    one.  Returns a dict holding the running count under "chunks"."""
    from repro_torch.serving.executor import _MAX_SCAN_CHUNKS as M
    ex, got = eng.executor, {"chunks": 0}

    def wrap(fn, n):
        def call(*args, **kw):
            got["chunks"] += n
            return fn(*args, **kw)
        return call

    ex.bstage_chunk_scan = wrap(ex.bstage_chunk_scan, M)
    ex.bstage_admit = wrap(ex.bstage_admit, 1)
    return got


def worker_work(before, after):
    """A worker's work between two ``EngineProxy.launch_counts`` reads, the
    first with ``reset=True``: (its launch counts, the prefill chunks its
    batched programs ran, counted as ``count_chunks`` counts them, its
    decode steps)."""
    from repro_torch.serving.executor import _MAX_SCAN_CHUNKS as M
    calls = {key: n - before["program_calls"].get(key, 0)
             for key, n in after["program_calls"].items()}
    chunks = sum(n * (M if key[0] == "bscan" else 1)
                 for key, n in calls.items() if key[0] in ("bscan", "badmit"))
    steps = sum(n * key[1] for key, n in calls.items() if key[0] == "decode")
    return after["launches"], chunks, steps


def handoff_splits(pre, dec):
    """Per handoff, its swap split in us/MiB: the gather (with its
    harvest) on the prefill engine, the put and the scatter on the decode
    engine, read from the engines' counters around each call.  Returns
    {rid: {"gather": us/MiB, "put": ..., "scatter": ...}}."""
    out = {}
    mib = pre.executor.swap_bytes_per_slot / 2 ** 20

    def wrap(eng, name, parts, rid_of):
        fn = getattr(eng, name)

        def call(*args):
            before = {p: getattr(eng, f"swap_{p}_s") for p in parts}
            res = fn(*args)
            rid = rid_of(args)
            for p in parts:
                out.setdefault(rid, {})[p] = (
                    (getattr(eng, f"swap_{p}_s") - before[p]) * 1e6 / mib)
            return res
        setattr(eng, name, call)

    wrap(pre, "_swap_out_ready", ("gather",), lambda a: a[0].req.rid)
    wrap(dec, "_swap_in", ("put", "scatter"), lambda a: a[0])
    return out


def disagg_run(router, requests, plain, label, card):
    """Serve phase 4's mix through ``router``: every stream bitwise
    ``plain``, every request's TTFT stamped.  Returns (requests, wall
    seconds)."""
    reqs = requests()
    t0 = time.perf_counter()
    for r in reqs:
        router.submit(r)
    router.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = [list(r.output) for r in reqs]
    if streams != plain:
        raise AssertionError(f"[11] {label}: streams differ from phase 4's "
                             f"plain ones, first index per request "
                             f"{first_difference(streams, plain)}")
    if not all(r.done and r.ttft_s is not None and r.ttft_s > 0
               for r in reqs):
        raise AssertionError(f"[11] {label}: a request without a TTFT")
    tokens = sum(len(r.output) for r in reqs)
    print(f"  [11] {label} [{card}]: streams bitwise phase 4's; {tokens} "
          f"tokens in {wall:.3f} s ({tokens / wall:.1f} tok/s), mean TTFT "
          f"{np.mean([r.ttft_s for r in reqs]) * 1e3:.1f} ms")
    return reqs, wall


def disagg_phase(cfg, params, engine_mod, card, plain):
    """The router, engine roles and worker processes on full-width
    qwen3-next-gdn, phase 4's mix and engine settings, through CUDA
    graphs, every stream bitwise phase 4's plain ``plain``: (a)
    ``Router([prefill engine, decode engine])`` in this process, cold
    then warm; (b) migration between two both-role engines: ``drain(1)``
    with engine 1 holding queued requests, then a request paused on
    engine 0, engine 0's slots refilled, the request resumed and moved
    by ``rebalance_swapped`` to engine 1; (c) a prefill and a decode
    worker process (``EngineProxy``, weights from seed 0 drawn in each
    worker), cold then warm; (d) a both-role worker killed before its first tick beside
    (b)'s engine 1, its requests re-homed.  Returns the GDN kernels'
    launches by part: (c)'s are those the two workers report for
    themselves (``EngineProxy.launch_counts``), the others this
    process's."""
    import warnings
    Engine, Request = engine_mod.DecodeEngine, engine_mod.Request
    Router, EngineProxy = engine_mod.Router, engine_mod.EngineProxy
    from repro_torch.kernels import gdn_decode as kdecode
    from repro_torch.kernels import gdn_prefill as kprefill
    from repro_torch.runtime.graphs import add_launches, launch_counts
    from repro_torch.serving import wire
    dkey, pkey = (kdecode.__name__, ""), (kprefill.__name__, "")
    kw = dict(max_slots=4, max_len=1024, prefill_chunk=64, decode_block=8,
              seed=0, device="cuda")
    prompts = _phase4_prompts(cfg.vocab)
    n_gdn = sum(k == "gdn" for k in cfg.layer_kinds)
    out = {"gdn_decode": {}, "gdn_prefill": {}}

    def requests():
        return [Request(rid=i, prompt=p, max_new_tokens=32,
                        temperature=0.8 if i == 2 else 0.0,
                        top_k=40 if i == 2 else 0)
                for i, p in enumerate(prompts)]

    mode = compute_mode()
    print(f"  [11] compute mode: {mode}")
    if mode != "Default":
        raise AssertionError(f"[11] compute mode {mode!r}: parts (c) and "
                             f"(d) need several processes on the card "
                             f"(Default)")

    # (a) disaggregation in this process
    pre = Engine(cfg, params, role="prefill", **kw)
    dec = Engine(cfg, params, role="decode", **kw)
    ptrs = [buffer_ptrs(e.executor) for e in (pre, dec)]
    calls = [watch_swaps(e) for e in (pre, dec)]
    chunks = count_chunks(pre)
    per_engine = step_launches([pre, dec])
    splits = handoff_splits(pre, dec)
    router = Router([pre, dec])
    handed = []                         # one record, for its wire size
    withdraw = pre.withdraw_handoff

    def keep(*args):
        rec = withdraw(*args)
        handed[:] = [rec]
        return rec
    pre.withdraw_handoff = keep
    for run in ("cold", "warm"):
        for e in (pre, dec):
            e.reset_metrics()
        for d in per_engine.values():
            d.clear()
        for c in calls:
            c.update(dict.fromkeys(c, 0))
        splits.clear()
        chunks["chunks"] = 0
        handoffs0 = router.handoffs
        add_launches(launch_counts(), -1)           # zero every count
        reqs, _ = disagg_run(router, requests, plain,
                             f"(a) prefill -> decode, {run}", card)
        counts = launch_counts()
        pm, dm = pre.metrics(), dec.metrics()
        got = {name: (per_engine[0].get(key, 0), per_engine[1].get(key, 0))
               for name, key in (("decode", dkey), ("prefill", pkey))}
        print(f"  [11] (a) {run}: {router.handoffs - handoffs0} handoffs; "
              f"prefill engine {pm['stage_dispatches']} stage dispatches, "
              f"{chunks['chunks']} batched chunks, {pre.decode_steps} decode "
              f"steps, gdn_prefill {got['prefill'][0]}, gdn_decode "
              f"{got['decode'][0]}; decode engine {dm['stage_dispatches']} "
              f"stage dispatches, {dec.decode_steps} decode steps, "
              f"gdn_decode {got['decode'][1]}, gdn_prefill "
              f"{got['prefill'][1]}, {dm['decode_us_per_token']:.1f} "
              f"us/token; swap calls "
              f"{[{k: n for k, n in c.items() if n} for c in calls]}")
        print(f"  [11] (a) {run}: per handoff, us/MiB (gather / put / "
              f"scatter) "
              + "; ".join(f"rid {rid}: {s['gather']:.1f} / {s['put']:.1f} "
                          f"/ {s['scatter']:.1f}"
                          for rid, s in sorted(splits.items())))
        if router.handoffs - handoffs0 != 6 or pm["handoffs_out"] != 6:
            raise AssertionError(f"[11] (a) {run}: "
                                 f"{router.handoffs - handoffs0} handoffs, "
                                 f"not 6")
        if dm["stage_dispatches"] or got["prefill"][1] \
                or pre.decode_steps or got["decode"][0]:
            raise AssertionError(f"[11] (a) {run}: the decode engine "
                                 f"prefilled or the prefill engine decoded")
        if got["prefill"][0] != n_gdn * chunks["chunks"] \
                or got["decode"][1] != n_gdn * dec.decode_steps \
                or got["decode"][1] <= 0 or chunks["chunks"] <= 0:
            raise AssertionError(f"[11] (a) {run}: launches {got}, not "
                                 f"{n_gdn} x {chunks['chunks']} chunks / "
                                 f"{n_gdn} x {dec.decode_steps} steps")
        if (counts[dkey], counts[pkey]) != (sum(got["decode"]),
                                            sum(got["prefill"])):
            raise AssertionError(f"[11] (a) {run}: a launch outside the "
                                 f"engines' steps")
        out["gdn_decode"][f"a_{run}"] = counts[dkey]
        out["gdn_prefill"][f"a_{run}"] = counts[pkey]
    if [buffer_ptrs(e.executor) for e in (pre, dec)] != ptrs:
        raise AssertionError("[11] (a): a slot buffer moved")
    print(f"  [11] (a) warm: mean TTFT "
          f"{np.mean([r.ttft_s for r in reqs]) * 1e3:.1f} ms, decode engine "
          f"{dm['decode_us_per_token']:.1f} us/token [{card}]")
    del pre, dec, router
    gc.collect()
    torch.cuda.empty_cache()

    # (b) migration between two both-role engines
    e0, e1 = Engine(cfg, params, **kw), Engine(cfg, params, **kw)
    ptrs = [buffer_ptrs(e.executor) for e in (e0, e1)]
    calls = [watch_swaps(e) for e in (e0, e1)]
    router = Router([e0, e1], policy="round_robin")
    add_launches(launch_counts(), -1)
    reqs = requests()
    t0 = time.perf_counter()
    for r in reqs:
        router.submit(r)
    if e1.queue_len != 3:
        raise AssertionError(f"[11] (b): engine 1 holds {e1.queue_len} "
                             f"queued requests, not 3")
    moved = router.drain(1)
    if moved < 1 or e1.queue_len:
        raise AssertionError(f"[11] (b): drain(1) moved {moved}")
    for _ in range(200):
        router.step()
        if reqs[0].state == "active" and len(reqs[0].output) >= 3:
            break
    else:
        raise AssertionError("[11] (b): rid 0 never decoded")
    router.pause(0)
    for _ in range(50):                 # engine 0's freed slot refilled
        router.step()
        if not e0.free_slots:
            break
    else:
        raise AssertionError("[11] (b): engine 0's freed slot stayed free")
    router.resume(0)
    router.undrain(1)
    migrated = router.migrated
    router.step()                       # rebalance_swapped moves rid 0
    if router.migrated <= migrated or not any(
            r is reqs[0] for r in e1._all):
        raise AssertionError("[11] (b): rebalance_swapped did not move "
                             "rid 0 to engine 1")
    router.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = [list(r.output) for r in reqs]
    if streams != plain:
        raise AssertionError(f"[11] (b): streams differ from phase 4's, "
                             f"first index per request "
                             f"{first_difference(streams, plain)}")
    if [buffer_ptrs(e.executor) for e in (e0, e1)] != ptrs:
        raise AssertionError("[11] (b): a slot buffer moved")
    counts = launch_counts()
    steps = e0.decode_steps + e1.decode_steps
    m = router.metrics()
    print(f"  [11] (b) migration [{card}]: streams bitwise phase 4's; "
          f"drain(1) moved {moved}, rebalance_swapped moved rid 0 "
          f"(migrated {router.migrated}); {m['swap_outs']} swap-outs / "
          f"{m['swap_ins']} swap-ins, "
          f"{m['swap_s'] * 1e6 / (m['swap_bytes'] / 2 ** 20):.1f} "
          f"us/MiB; {wall:.3f} s; gdn_decode {counts[dkey]} = {n_gdn} x "
          f"{steps} steps, gdn_prefill {counts[pkey]}; swap calls "
          f"{[{k: n for k, n in c.items() if n} for c in calls]}")
    if counts[dkey] != n_gdn * steps or m["swap_ins"] != m["swap_outs"]:
        raise AssertionError(f"[11] (b): launches {counts[dkey]} != "
                             f"{n_gdn} x {steps}, or swaps out "
                             f"{m['swap_outs']} != in {m['swap_ins']}")
    out["gdn_decode"]["b"] = counts[dkey]
    out["gdn_prefill"]["b"] = counts[pkey]
    del e0, router
    gc.collect()
    torch.cuda.empty_cache()

    # (c) and (d): three workers started together
    def spawn(role):
        t0 = time.perf_counter()
        prox = EngineProxy(cfg, params_seed=0, role=role, **kw)
        return prox, time.perf_counter() - t0

    from concurrent.futures import ThreadPoolExecutor
    roles = ("prefill", "decode", "both")
    with ThreadPoolExecutor(len(roles)) as pool:
        futs = [pool.submit(spawn, role) for role in roles]
        started = [f.result() for f in futs]    # raises a failed start-up
    workers = [p for p, _ in started]
    try:
        print(f"  [11] (c) workers started together, spawn to first reply "
              f"[{card}]: "
              + ", ".join(f"{p.role} pid {p.proc.pid} {s!r} s on "
                          f"{p.device}" for p, s in started))
        pre, dec, lone = workers
        pipe, wire_bytes = {}, []

        def timed(eng, name):
            fn = getattr(eng, name)

            def call(*args):
                t0 = time.perf_counter()
                res = fn(*args)
                rec = res if res is not None else args[0]
                if rec is not None:
                    pipe.setdefault(rec.req.rid, {})[name] = (
                        time.perf_counter() - t0)
                return res
            setattr(eng, name, call)

        timed(pre, "withdraw_handoff")
        timed(dec, "readmit_swapped")
        wire_bytes.append(len(wire.encode_swap_record(handed[0])))
        router = Router([pre, dec])
        for run in ("cold", "warm"):    # warm: the workers' graphs replay
            pipe.clear()
            handoffs0 = router.handoffs
            router.reset_metrics()
            snaps = [p.launch_counts(reset=True) for p in (pre, dec)]
            add_launches(launch_counts(), -1)
            disagg_run(router, requests, plain,
                       f"(c) prefill worker -> decode worker, {run}", card)
            mine = launch_counts()
            work = [worker_work(s, p.launch_counts())
                    for s, p in zip(snaps, (pre, dec))]
            m = router.metrics()
            print(f"  [11] (c) {run}: per handoff through the pipes, s "
                  f"(withdraw_handoff + readmit_swapped, each one swap "
                  f"record of ~{wire_bytes[0]} B wire-encoded): "
                  + "; ".join(f"rid {rid}: {t['withdraw_handoff']:.4f} + "
                              f"{t['readmit_swapped']:.4f}"
                              for rid, t in sorted(pipe.items())))
            pm, dm = m["per_engine"]
            print(f"  [11] (c) {run}: {router.handoffs - handoffs0} "
                  f"handoffs; decode worker "
                  f"{dm['decode_us_per_token']:.1f} us/token, prefill "
                  f"worker {pm['decoded_tokens']} decoded tokens, decode "
                  f"worker {dm['stage_dispatches']} stage dispatches")
            (pl, pchunks, psteps), (dl, dchunks, dsteps) = work
            print(f"  [11] (c) {run}: prefill worker {pchunks} batched "
                  f"chunks, {psteps} decode steps, gdn_prefill {pl[pkey]}, "
                  f"gdn_decode {pl[dkey]}; decode worker {dchunks} batched "
                  f"chunks, {dsteps} decode steps, gdn_decode {dl[dkey]}, "
                  f"gdn_prefill {dl[pkey]}; this process gdn_decode "
                  f"{mine[dkey]}, gdn_prefill {mine[pkey]}")
            if router.handoffs - handoffs0 != 6 or pm["handoffs_out"] != 6 \
                    or pm["decoded_tokens"] or dm["stage_dispatches"]:
                raise AssertionError(f"[11] (c) {run}: "
                                     f"{router.handoffs - handoffs0} "
                                     f"handoffs, or a worker outside its "
                                     f"role")
            if pl[pkey] != n_gdn * pchunks or pchunks <= 0 or pl[dkey] \
                    or psteps or dl[dkey] != n_gdn * dsteps or dsteps <= 0 \
                    or dl[pkey] or dchunks or mine[dkey] or mine[pkey]:
                raise AssertionError(f"[11] (c) {run}: worker launches "
                                     f"{pl} / {dl}, not {n_gdn} x "
                                     f"{pchunks} chunks on the prefill "
                                     f"worker and {n_gdn} x {dsteps} "
                                     f"steps on the decode worker, or "
                                     f"{mine} in this process")
            out["gdn_decode"][f"c_{run}"] = dl[dkey]
            out["gdn_prefill"][f"c_{run}"] = pl[pkey]
        for p in (pre, dec):
            p.shutdown()
            if p.proc.returncode != 0:
                raise AssertionError(f"[11] (c): worker {p.role} exited "
                                     f"{p.proc.returncode}")
        print(f"  [11] (c) both workers exited with code 0")

        # (d) the both-role worker killed beside engine 1 of (b)
        router = Router([lone, e1], policy="round_robin")
        add_launches(launch_counts(), -1)
        steps0 = e1.decode_steps
        reqs = requests()
        for r in reqs:
            router.submit(r)
        if router.placed != [3, 3]:
            raise AssertionError(f"[11] (d): placed {router.placed}")
        lone.proc.kill()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            router.run_until_done()
        torch.cuda.synchronize()
        streams = [list(r.output) for r in reqs]
        m = router.metrics()
        counts = launch_counts()
        print(f"  [11] (d) worker killed before its first tick [{card}]: "
              f"dead {m['dead']}, rehomed {m['rehomed']}, warned "
              f"{[str(w.message)[:60] for w in caught]}; gdn_decode "
              f"{counts[dkey]}, gdn_prefill {counts[pkey]}")
        if m["dead"] != [0] or m["rehomed"] != 3 or not any(
                "worker died" in str(w.message) for w in caught):
            raise AssertionError(f"[11] (d): dead {m['dead']}, rehomed "
                                 f"{m['rehomed']}")
        if streams != plain:
            raise AssertionError(f"[11] (d): streams differ from phase "
                                 f"4's, first index per request "
                                 f"{first_difference(streams, plain)}")
        if counts[dkey] != n_gdn * (e1.decode_steps - steps0):
            raise AssertionError(f"[11] (d): gdn_decode {counts[dkey]}")
        out["gdn_decode"]["d"] = counts[dkey]
        out["gdn_prefill"]["d"] = counts[pkey]
        print(f"  [11] (d): every request finished, streams bitwise phase "
              f"4's")
    finally:
        for p in workers:
            p.shutdown()
    del e1
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 13

# phase 4's engine settings and mix
PHASE4_KW = dict(max_slots=4, max_len=1024, prefill_chunk=64, decode_block=8,
                 seed=0, device="cuda")


def phase4_requests(Request, vocab):
    return [Request(rid=i, prompt=p, max_new_tokens=32,
                    temperature=0.8 if i == 2 else 0.0,
                    top_k=40 if i == 2 else 0)
            for i, p in enumerate(_phase4_prompts(vocab))]


def zero_launches():
    from repro_torch.runtime.graphs import add_launches, launch_counts
    add_launches(launch_counts(), -1)


def gdn_counts():
    from repro_torch.runtime.graphs import launch_counts
    c = launch_counts()
    return {"gdn_decode": sum(n for (m, _), n in c.items()
                              if m.endswith("gdn_decode")),
            "gdn_prefill": sum(n for (m, _), n in c.items()
                               if m.endswith("gdn_prefill"))}


def one_step_collectives(eng, cfg):
    """The collectives, their host seconds and the GDN decode launches of
    one decode step of ``eng``'s model on its own shards (the model code
    alone: a tick adds one gather of its tokens over "data")."""
    from repro_torch.models import lm
    from repro_torch.parallel import comm
    ex = eng.executor
    zero_launches()
    comm.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with comm.use(ex._axes):
        lm.decode_step(ex.params, cfg, ex.tokens, ex.caches)
    torch.cuda.synchronize()
    return dict(collectives=comm.stats["calls"],
                collective_s=comm.stats["seconds"],
                collective_bytes=comm.stats["bytes"],
                step_s=time.perf_counter() - t0,
                gdn_decode=gdn_counts()["gdn_decode"])


def mesh_nccl_phase(cfg, params, engine_mod, card, plain, label="[13] (a)",
                    phase="phase 4"):
    """(a) A (1,1) NCCL mesh in this process on the default CUDA-graph
    engine, phase 4's mix cold then warm: streams bitwise ``plain``, the
    graph engine's of ``phase`` on these weights; the warm run's
    collectives run inside replayed graphs (``comm.stats["replayed"]``),
    none from the host unless a program takes its first, eager call in
    it."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.parallel import comm
    mesh_mod.init_ranks(0, 1, mesh_mod.free_port(), "nccl")
    try:
        mesh = mesh_mod.make_serving_mesh(1, 1)
        eng = engine_mod.DecodeEngine(cfg, params, mesh=mesh, **PHASE4_KW)
        if not eng.executor.cuda_graphs:
            raise AssertionError(f"{label}: the NCCL mesh engine replays "
                                 "no CUDA graphs")
        for run in ("cold", "warm"):
            reqs = phase4_requests(engine_mod.Request, cfg.vocab)
            eng.reset_metrics()
            comm.reset_stats()
            shapes = eng.executor.compiled_programs()["total"]
            t0 = time.perf_counter()
            for r in reqs:
                eng.submit(r)
            eng.run_until_done()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            streams = [list(r.output) for r in reqs]
            if streams != plain:
                raise AssertionError(
                    f"{label} {run}: streams differ from {phase}'s graph "
                    f"engine's at {first_difference(streams, plain)}")
            m = eng.metrics()
            st = dict(comm.stats)
            new = eng.executor.compiled_programs()["total"] - shapes
            print(f"  {label} (1,1) NCCL mesh, graphs, {run} [{card}]: "
                  f"streams bitwise {phase}'s; decode "
                  f"{m['decode_us_per_token']:.1f} us/token, mean TTFT "
                  f"{m['mean_ttft_s'] * 1e3:.1f} ms, {m['tokens'] / wall:.1f}"
                  f" tok/s; collectives: {st['calls']} from the host, "
                  f"{st['captured']} captured, {st['replayed']} replayed; "
                  f"{new} program shapes added; mesh "
                  f"{m['mesh_data']}x{m['mesh_model']}; programs "
                  f"{eng.executor.compiled_programs()}")
            if run == "warm" and (not st["replayed"]
                                  or (st["calls"] and not new)):
                raise AssertionError(f"{label} warm: collectives {st}: "
                                     f"not run inside the captured graphs")
        step = one_step_collectives(eng, cfg)
        print(f"  {label} one decode step (eager, the model code): "
              f"{step['collectives']} collectives, each captured in the "
              f"decode graphs (a tick adds 1, the tokens' gather over "
              f"data), {step['gdn_decode']} gdn_decode launches")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return m["decode_us_per_token"]


def _mesh_serve(label, cfg, params, mesh, engine_mod, step3):
    """One eager gloo-mesh engine serving phase 4's mix on this rank (in
    (c) request 0 paused after 2 tokens and resumed, its image kept), then
    one decode step's logits on the mesh against the one-device step from
    phase 3's state and tokens (this rank's rows)."""
    from repro_torch.models import lm
    from repro_torch.parallel import comm
    from repro_torch.parallel import sharding as rules
    eng = engine_mod.DecodeEngine(cfg, params, mesh=mesh, cuda_graphs=False,
                                  **PHASE4_KW)
    reqs = phase4_requests(engine_mod.Request, cfg.vocab)
    zero_launches()
    comm.reset_stats()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    out = {}
    if label == "c":
        while not (reqs[0].state == "active" and len(reqs[0].output) >= 2):
            eng.step()
        eng.pause(0)
        out["image"] = eng.swapped[0].state
        out["n"] = len(reqs[0].output)
        eng.step()
        eng.resume(0)
    eng.run_until_done()
    torch.cuda.synchronize()
    m = eng.metrics()
    out.update(streams=[list(r.output) for r in reqs],
               wall=time.perf_counter() - t0, us_token=m["decode_us_per_token"],
               ttft_ms=m["mean_ttft_s"] * 1e3, decode_steps=eng.decode_steps,
               ticks=m["ticks"], run_collectives=comm.stats["calls"],
               run_collective_s=comm.stats["seconds"],
               run_collective_bytes=comm.stats["bytes"], launches=gdn_counts(),
               swap_bytes_per_slot=eng.executor.swap_bytes_per_slot,
               step=one_step_collectives(eng, cfg))
    if "n" in out:
        out["after"] = out["streams"][0][out["n"]:]
    # phase 3's state (a plain 64-token prefill of 4 rows), cut into this
    # rank's shards of a copy by the slot rules at batch 4
    from repro_torch.tree import tree_map
    B = step3["tok"].shape[0]
    plain = cfg.replace(use_pallas_serving=False)
    caches = lm.init_caches(plain, B, PHASE4_KW["max_len"], device="cuda")
    lm.prefill_chunk(params, plain, caches, tokens=step3["toks"].cuda())
    ex = eng.executor
    parts = rules.slot_specs(cfg, mesh, lm.cache_specs(
        cfg, B, PHASE4_KW["max_len"]).tree, B)
    local = rules.shard_tree(tree_map(torch.clone, caches), parts,
                             ex._axes.coords, ex._axes.sizes)
    tok = step3["tok"].cuda()
    one, _ = lm.decode_step(params, cfg, tok, caches)
    b = B // ex._axes.data.size
    rows = slice(ex._axes.data.index * b, (ex._axes.data.index + 1) * b)
    zero_launches()
    with comm.use(ex._axes):
        got, _ = lm.decode_step(ex.params, cfg, tok[rows], local)
    torch.cuda.synchronize()
    # numpy, not tensors: a tensor would cross the queue as a handle to
    # this process's memory, which ends before the parent reads it
    out["logits"] = dict(mesh=got.float().cpu().numpy(),
                         one=one[rows].float().cpu().numpy(),
                         rows=(rows.start, rows.stop),
                         gdn_decode=gdn_counts()["gdn_decode"])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_rank(rank, port, step3, q):
    """A gloo rank of phase 13 (b) and (c) on card 0: phase 4's weights
    drawn from seed 0 here, then each mesh's engine."""
    import traceback
    import torch.distributed as dist
    out = {}
    try:
        torch.cuda.set_device(0)
        from repro_torch import configs
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.models import lm
        from repro_torch.serving import engine as engine_mod
        mesh_mod.init_ranks(rank, 2, port, "gloo")
        cfg = configs.get_arch("qwen3-next-gdn").replace(
            use_pallas_serving=True)
        params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0),
                            cfg, device="cuda")
        for label, shape in (("b", (2, 1)), ("c", (1, 2))):
            mesh = mesh_mod.make_serving_mesh(*shape)
            out[label] = _mesh_serve(label, cfg, params, mesh, engine_mod,
                                     step3)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        out["error"] = traceback.format_exc()
    if rank:
        out.get("c", {}).pop("image", None)
    q.put((rank, out))


def mesh_phase(cfg, params, engine_mod, card, plain, step3, plain_us,
               meanwhile=None):
    """Phase 13: mesh serving of full-width qwen3-next-gdn on phase 4's
    mix (module docstring).  ``meanwhile()`` runs here while (b) and (c)'s
    ranks serve (phase 17's start).  Returns the GDN kernels' launches per
    rank at the local shapes, keyed by phase 2's rows, (b)'s streams and
    what ``meanwhile`` returned."""
    import torch.multiprocessing as mp
    from repro_torch.launch import mesh as mesh_mod
    us_a = mesh_nccl_phase(cfg, params, engine_mod, card, plain)
    print(f"  [13] (a) warm {us_a:.1f} us/token against phase 4's warm "
          f"{plain_us:.1f} ({us_a / plain_us:.4f}x)")

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = mesh_mod.free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_mesh_rank, args=(r, port, step3, q))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        extra = meanwhile() if meanwhile is not None else None
        res = _rank_results(procs, q, 900)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for r, out in res.items():
        if "error" in out:
            raise AssertionError(f"[13] rank {r}:\n{out['error']}")
    print(f"  [13] two gloo ranks on card 0 (spawn, draw, (b), (c)) took "
          f"{time.perf_counter() - t0:.1f} s")
    launches = {}
    n_gdn = sum(k == "gdn" for k in cfg.layer_kinds)
    for label, shape, row in (("b", "(2,1)", "data2"),
                              ("c", "(1,2)", "model2")):
        outs = [res[r][label] for r in range(2)]
        if outs[1]["streams"] != outs[0]["streams"]:
            raise AssertionError(f"[13] ({label}): the ranks' streams "
                                 f"differ")
        o = outs[0]
        for r, x in enumerate(outs):
            st = x["step"]
            if st["gdn_decode"] != n_gdn:
                raise AssertionError(f"[13] ({label}) rank {r}: "
                                     f"{st['gdn_decode']} gdn_decode "
                                     f"launches per decode step, not "
                                     f"{n_gdn}")
            print(f"  [13] ({label}) {shape} gloo mesh, eager, rank {r} "
                  f"[{card}]: decode {x['us_token']:.1f} us/token, mean "
                  f"TTFT {x['ttft_ms']:.1f} ms, {x['decode_steps']} decode "
                  f"steps in {x['ticks']} ticks; the run's "
                  f"{x['run_collectives']} collectives "
                  f"({x['run_collective_bytes']} B) took "
                  f"{x['run_collective_s']:.3f} s; one decode step: "
                  f"{st['collectives']} collectives "
                  f"({st['collective_bytes']} B), "
                  f"{st['collective_s'] * 1e3:.1f} ms of "
                  f"{st['step_s'] * 1e3:.1f} ms in them, "
                  f"{st['gdn_decode']} gdn_decode launches; the run's "
                  f"GDN launches {x['launches']}")
        diff = first_difference(o["streams"], plain)
        greedy = [d for i, d in enumerate(diff) if i != 2]
        print(f"  [13] ({label}) first token index leaving the 1-device "
              f"streams, per request (request 2 draws): {diff}")
        if label == "b" and any(d is not None for d in diff):
            print(f"  [13] (b): the data axis left the 1-device streams "
                  f"(the GEMVs' row counts halve); see (c)'s logit bound")
        if label == "c":
            print(f"  [13] (c) greedy streams' first differences: {greedy}")
        launches[f"gdn_decode_{row}"] = o["launches"]["gdn_decode"]
        launches[f"gdn_prefill_{row}"] = o["launches"]["gdn_prefill"]

    # each layout's logits: no further from the fp32 step than twice the
    # 1-device bf16 step is (phase 3's rule), the argmax equal wherever
    # the 1-device top-2 gap exceeds its own error
    for label, r in ((label, r) for label in ("b", "c") for r in range(2)):
        lg = res[r][label]["logits"]
        logit_rule(f"[13] ({label}) rank {r}, rows {lg['rows']} "
                   f"({lg['gdn_decode']} gdn_decode launches)",
                   torch.from_numpy(lg["mesh"]), torch.from_numpy(lg["one"]),
                   step3["truth"][slice(*lg["rows"])])
        if lg["gdn_decode"] != n_gdn:
            raise AssertionError(f"[13] ({label}): {lg['gdn_decode']} "
                                 f"gdn_decode launches in the logit step")

    # (d) (c)'s image of request 0 restored into a one-device engine
    c = res[0]["c"]
    sw = c["image"]
    eng = engine_mod.DecodeEngine(cfg, params, cuda_graphs=False,
                                  **PHASE4_KW)
    ex = eng.executor
    if sw.nbytes != ex.swap_bytes_per_slot or \
            c["swap_bytes_per_slot"] != ex.swap_bytes_per_slot:
        raise AssertionError(f"[13] (d): image of {sw.nbytes} B, slots of "
                             f"{ex.swap_bytes_per_slot} B")
    ex.restore_slot(1, sw)
    back = ex.gather_slot(1)
    from repro_torch.tree import leaves
    for a, b in zip(leaves(back.caches) + [back.token],
                    leaves(sw.caches) + [sw.token]):
        if a.tobytes() != b.tobytes():
            raise AssertionError("[13] (d): the restored image does not "
                                 "gather back bitwise")
    ex.restore_slot(1, back)
    got = []
    while True:
        toks, valid = ex.decode(8)
        got += [int(t) for t, v in zip(toks[:, 1], valid[:, 1]) if v]
        if not valid[-1, 1]:
            break
    diff = first_difference([got], [c["after"]])[0]
    diff1 = first_difference([got], [plain[0][c["n"]:]])[0]
    print(f"  [13] (d) (1,2) image of request 0 ({sw.nbytes} B, after "
          f"{c['n']} tokens) restored into a one-device eager engine: "
          f"gathers back bitwise; its {len(got)}-token continuation leaves "
          f"(c)'s at {diff}, phase 4's at {diff1} (None: equal)")
    if len(got) != len(c["after"]):
        raise AssertionError(f"[13] (d): {len(got)} tokens, (c) emitted "
                             f"{len(c['after'])}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches, res[0]["b"]["streams"], extra


# ---------------------------------------------------------------- phase 14

# the model axis of the other kinds at full width on (1,2): mamba2-1.3b
# (ssm heads through both GDN kernels), recurrentgemma-2b (RG-LRU width,
# MQA attention split on head_dim, prompts past its 2048 window) and
# mixtral-8x7b (grouped heads, expert parallelism; 8 of 32 layers, as
# phase 12 (b)).  Per arch: the depth served, the engine settings, the
# two requests' prompts and budgets (phase 4's first two, phase 8's first
# and last), and the fixed decode state's (B, T, prefill chunk, max_len).
MESH14 = {
    "mamba2-1.3b": dict(layers=None, kw=PHASE4_KW, step=(4, 64, 64, 1024)),
    "recurrentgemma-2b": dict(
        layers=None, step=(4, 2112, 1056, 4096),
        kw=dict(PHASE4_KW, max_len=4096, prefill_chunk=256)),
    "mixtral-8x7b": dict(layers=8, kw=PHASE4_KW, step=(4, 64, 64, 128)),
}
MESH14_LOCAL = dict(MAMBA2, Hv=MAMBA2["Hv"] // 2)   # mamba2's heads at (1,2)
# the archs served on a (1,2) gloo mesh: phase 14's and phase 19 (a)'s
# minicpm-2b (its vocabulary on d_model; phase 4's engine settings)
MESH_SERVED = dict(MESH14, **{"minicpm-2b": dict(
    layers=None, kw=PHASE4_KW, step=(4, 64, 64, 1024))})


def mesh14_config(configs, arch):
    cfg = configs.get_arch(arch)
    if arch == "mamba2-1.3b":
        cfg = cfg.replace(use_pallas_serving=True)
    if MESH_SERVED[arch]["layers"]:
        cfg = cfg.replace(n_layers=MESH_SERVED[arch]["layers"])
    return cfg


def mesh14_requests(Request, arch, vocab):
    """Two requests of the arch's phase, greedy, 16 new tokens each (the
    script's time limit): phase 4's first two prompts, or phase 8's first
    and last (2500 tokens, past the window, and 300)."""
    if arch == "recurrentgemma-2b":
        rng = np.random.default_rng(8)
        prompts = [rng.integers(1, vocab, n) for n in GEMMA_PROMPTS]
        prompts = [prompts[0], prompts[3]]
    else:
        prompts = _phase4_prompts(vocab)[:2]
    return [Request(rid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]


def fixed_step(cfg, params, lm, folder):
    """The one-device decode step of phase 14 (b)-(d) on a fixed state: a
    plain prefill of random tokens (seed 14) in chunks, its caches saved
    under ``folder`` for the mesh ranks, then one step through ``cfg``'s
    path (the kernels where it has them) in bf16, and the fp32 step (fp32
    activations, the bf16 weights upcast in each product, no kernel) on
    an fp32 prefill of the same tokens.  Returns {"path", "one",
    "truth"}, the logits on the host."""
    from repro_torch.tree import tree_map
    B, T, chunk, max_len = MESH_SERVED[cfg.name]["step"]
    gen = torch.Generator(device="cuda").manual_seed(14)
    toks = torch.randint(1, cfg.vocab, (B, T), generator=gen, device="cuda")
    tok = torch.randint(1, cfg.vocab, (B,), generator=gen, device="cuda")
    plain = cfg.replace(use_pallas_serving=False)
    out = {"path": os.path.join(folder, f"{cfg.name}.pt")}
    for key, c in (("one", plain), ("truth",
                                    plain.replace(act_dtype="float32"))):
        caches = lm.init_caches(c, B, max_len, device="cuda")
        for i in range(0, T, chunk):
            lm.prefill_chunk(params, c, caches, tokens=toks[:, i:i + chunk])
        if key == "one":
            torch.save({"caches": tree_map(lambda t: t.cpu(), caches),
                        "tok": tok.cpu()}, out["path"])
        logits, _ = lm.decode_step(params, cfg if key == "one" else c, tok,
                                   caches)
        out[key] = logits.float().cpu()
        del caches
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out["one"]).all()):
        raise AssertionError(f"[14] {cfg.name}: non-finite logits")
    return out


def _kernel_shapes(kdecode, kprefill, seen):
    """Wrap the GDN kernels' launchers to record the shapes they are
    called at: (Hk, Hv, d_k, d_v) of gdn_decode, (Hv per q/k head, d_k,
    d_v) of gdn_prefill."""
    real_d, real_p = kdecode.gdn_decode, kprefill.gdn_prefill

    def dec(q, k, v, *a, **kw):
        seen.add(("gdn_decode", q.shape[1], v.shape[1], q.shape[2],
                  v.shape[2]))
        return real_d(q, k, v, *a, **kw)

    def pre(q, k, v, *a, n_rep=1, **kw):
        seen.add(("gdn_prefill", n_rep, q.shape[2], v.shape[2]))
        return real_p(q, k, v, *a, n_rep=n_rep, **kw)
    kdecode.gdn_decode, kprefill.gdn_prefill = dec, pre


def _mesh14_serve(arch, mesh, folder, configs, lm, engine_mod):
    """One arch on this rank of the (1,2) gloo mesh: its shards drawn
    alone from seed 0 (``lm.init_lm(..., mesh=)``), an eager engine
    serving two requests (launch counters and collectives zeroed before,
    read after), one decode step's collectives, then the decode step on
    the fixed state of ``fixed_step`` cut into this rank's shards."""
    from repro_torch.parallel import comm
    from repro_torch.parallel import sharding as rules
    from repro_torch.tree import leaves, tree_map
    cfg = mesh14_config(configs, arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    out = {"draw_s": time.perf_counter() - t0,
           "params_bytes": sum(t.numel() * t.element_size()
                               for t in leaves(params))}
    eng = engine_mod.DecodeEngine(cfg, params, mesh=mesh, cuda_graphs=False,
                                  **MESH_SERVED[arch]["kw"])
    reqs = mesh14_requests(engine_mod.Request, arch, cfg.vocab)
    zero_launches()
    comm.reset_stats()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    torch.cuda.synchronize()
    m = eng.metrics()
    out.update(streams=[list(r.output) for r in reqs],
               wall=time.perf_counter() - t0,
               us_token=m["decode_us_per_token"],
               ttft_ms=m["mean_ttft_s"] * 1e3, decode_steps=eng.decode_steps,
               ticks=m["ticks"], run_collectives=comm.stats["calls"],
               run_collective_s=comm.stats["seconds"],
               run_collective_bytes=comm.stats["bytes"],
               launches=gdn_counts(),
               allocated=torch.cuda.memory_allocated(),
               peak=torch.cuda.max_memory_allocated(),
               step=one_step_collectives(eng, cfg))
    blob = torch.load(os.path.join(folder, f"{arch}.pt"), weights_only=False)
    B, _, _, max_len = MESH_SERVED[arch]["step"]
    ex = eng.executor
    parts = rules.slot_specs(cfg, mesh, lm.cache_specs(cfg, B, max_len).tree,
                             B)
    local = tree_map(lambda t: t.cuda(), rules.shard_tree(
        blob["caches"], parts, ex._axes.coords, ex._axes.sizes))
    zero_launches()
    with comm.use(ex._axes):
        got, _ = lm.decode_step(ex.params, cfg, blob["tok"].cuda(), local)
    torch.cuda.synchronize()
    out["logits"] = dict(mesh=got.float().cpu().numpy(),
                         gdn_decode=gdn_counts()["gdn_decode"])
    return out


def _mesh14_rank(rank, port, folder, archs, q):
    """A gloo rank of phase 14 (b)-(d) on card 0: each of ``archs`` in
    turn."""
    import traceback
    import torch.distributed as dist
    out = {}
    try:
        torch.cuda.set_device(0)
        from repro_torch import configs
        from repro_torch.kernels import gdn_decode as kdecode
        from repro_torch.kernels import gdn_prefill as kprefill
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.models import lm
        from repro_torch.serving import engine as engine_mod
        seen = set()
        _kernel_shapes(kdecode, kprefill, seen)
        mesh_mod.init_ranks(rank, 2, port, "gloo")
        mesh = mesh_mod.make_serving_mesh(1, 2)
        for arch in archs:
            seen.clear()
            out[arch] = _mesh14_serve(arch, mesh, folder, configs, lm,
                                      engine_mod)
            out[arch]["kernel_shapes"] = sorted(seen)
            # the arch's engine and weights (a cycle with its programs)
            # go before the next is drawn
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        out["error"] = traceback.format_exc()
    q.put((rank, out))


def _rank_results(procs, q, timeout, tag=None):
    """{rank: result} from each of ``procs`` through ``q``; raises when a
    rank exits without one or ``timeout`` seconds pass, and (with
    ``tag``) as soon as a rank reports an error (the others would wait
    for it in a collective)."""
    import queue
    res, end = {}, time.monotonic() + timeout
    while len(res) < len(procs):
        try:
            r, out = q.get(timeout=5)
            res[r] = out
            if tag is not None and "error" in out:
                raise AssertionError(f"{tag} rank {r}:\n{out['error']}")
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in res and not p.is_alive()]
            if dead or time.monotonic() > end:
                raise AssertionError(f"ranks {dead or 'all'} gave no "
                                     f"result (exit codes "
                                     f"{[p.exitcode for p in procs]})")
    return res


def logit_rule(label, got, one, truth):
    """Phase 3's rule: ``got`` no further from the fp32 logits ``truth``
    than twice the one-device bf16 step ``one`` is, and its argmax equal
    wherever the one-device top-2 gap exceeds that step's own error."""
    d = max_err(got, one)
    err, err_one = max_err(got, truth), max_err(one, truth)
    top2 = one.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    same = got.argmax(-1) == one.argmax(-1)
    print(f"  {label}: one decode step's logits, max|mesh - 1-device| "
          f"{d:.3e}; from fp32: mesh {err:.3e}, 1-device {err_one:.3e} "
          f"(limit 2x 1-device); argmax equal {same.tolist()}, 1-device "
          f"top-2 gaps {[round(float(x), 4) for x in gap]}")
    if err > 2 * err_one or not bool((same | (gap <= err_one)).all()):
        raise AssertionError(f"{label}: the mesh's logits leave the bound")


def mesh14_phase(card, steps, plain):
    """Phase 14 (b)-(d): two gloo ranks on card 0 serve each arch on the
    (1,2) mesh and step its fixed state (module docstring); ``steps``:
    ``fixed_step``'s result per arch, ``plain``: the one-device graph
    engine's streams of its phase.  Returns mamba2's GDN launches per
    rank, keyed by phase 2's rows."""
    import torch.multiprocessing as mp
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_mod
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = mesh_mod.free_port()
    folder = os.path.dirname(steps["mamba2-1.3b"]["path"])
    t0 = time.perf_counter()
    archs = [a for a in MESH14 if a in steps]
    procs = [ctx.Process(target=_mesh14_rank,
                         args=(r, port, folder, archs, q))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        res = _rank_results(procs, q, 900)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for r, out in res.items():
        if "error" in out:
            raise AssertionError(f"[14] rank {r}:\n{out['error']}")
    print(f"  [14] two gloo ranks on card 0 (spawn, then each arch's draw, "
          f"serve and step) took {time.perf_counter() - t0:.1f} s")
    launches = {}
    for label, arch in zip("bcd", MESH14):
        if arch not in steps:
            continue
        outs = [res[r][arch] for r in range(2)]
        if outs[1]["streams"] != outs[0]["streams"]:
            raise AssertionError(f"[14] ({label}) {arch}: the ranks' "
                                 f"streams differ")
        n_gdn = sum(k == "ssm" for k in
                    mesh14_config(configs, arch).layer_kinds)
        for r, x in enumerate(outs):
            st = x["step"]
            print(f"  [14] ({label}) {arch} (1,2) gloo mesh, eager, rank "
                  f"{r} [{card}]: shards of {x['params_bytes'] / 1e9:.2f} "
                  f"GB drawn in {x['draw_s']:.1f} s; decode "
                  f"{x['us_token']:.1f} us/token, mean TTFT "
                  f"{x['ttft_ms']:.1f} ms, {x['decode_steps']} decode steps "
                  f"in {x['ticks']} ticks, the run's {x['run_collectives']} "
                  f"collectives ({x['run_collective_bytes']} B) took "
                  f"{x['run_collective_s']:.3f} s; one decode step: "
                  f"{st['collectives']} collectives "
                  f"({st['collective_bytes']} B), "
                  f"{st['collective_s'] * 1e3:.1f} ms of "
                  f"{st['step_s'] * 1e3:.1f} ms in them, "
                  f"{st['gdn_decode']} gdn_decode launches; allocated "
                  f"{x['allocated']} B (peak {x['peak']} B); GDN launches "
                  f"{x['launches']} at {x['kernel_shapes']}")
            if st["gdn_decode"] != n_gdn or \
                    x["logits"]["gdn_decode"] != n_gdn:
                raise AssertionError(f"[14] ({label}) rank {r}: "
                                     f"{st['gdn_decode']} and "
                                     f"{x['logits']['gdn_decode']} "
                                     f"gdn_decode launches per step, not "
                                     f"{n_gdn}")
            if n_gdn:
                hk, hv, dk, dv = (MESH14_LOCAL[k]
                                  for k in ("Hk", "Hv", "d_k", "d_v"))
                want = [("gdn_decode", hk, hv, dk, dv),
                        ("gdn_prefill", hv // hk, dk, dv)]
                if x["kernel_shapes"] != sorted(want) or \
                        not x["launches"]["gdn_prefill"]:
                    raise AssertionError(f"[14] ({label}) rank {r}: GDN "
                                         f"kernels at {x['kernel_shapes']}, "
                                         f"not {want}")
            elif any(x["launches"].values()):
                raise AssertionError(f"[14] ({label}) rank {r}: a GDN "
                                     f"kernel launched: {x['launches']}")
        print(f"  [14] ({label}) first token index leaving the 1-device "
              f"streams, per request (greedy): "
              f"{first_difference(outs[0]['streams'], plain[arch])}")
        step = steps[arch]
        for r in range(2):
            logit_rule(f"[14] ({label}) {arch} rank {r}",
                       torch.from_numpy(res[r][arch]["logits"]["mesh"]),
                       step["one"], step["truth"])
        if n_gdn:
            launches["gdn_decode_mamba2_model2"] = \
                outs[0]["launches"]["gdn_decode"]
            launches["gdn_prefill_mamba2_model2"] = \
                outs[0]["launches"]["gdn_prefill"]
    return launches


# ---------------------------------------------------------------- phase 17

# phase 17 (c): the idle lease (no eager gloo tick of the full-width model
# comes near it) and the planted scheduler clocks, per rank: rank 1 at its
# own offset, and jumping past the lease after two requests are touched
IDLE17 = dict(lease_s=120.0, offsets=(0.0, 500.0), jump=(0.0, 1200.0))
# (c)'s ranks: a rank that makes no progress for this many seconds (a
# collective its peer never joins) reports it and exits, so ranks that
# disagree fail instead of waiting on each other for ever
IDLE17_TIMEOUT_S = 120
# (d): the longest a killed rank may take to surface as WorkerDied
DEATH17_BOUND_S = 30.0


def gdn_layers(cfg) -> int:
    """The GDN layers of ``cfg``: each launches one GDN kernel per decode
    step and per prefill chunk."""
    return sum(k == "gdn" for k in cfg.layer_kinds)


class PlantedClock:
    """A rank's planted scheduler clock: the real ``perf_counter`` plus
    ``offset`` seconds (phase 17 (c) patches the port's scheduler module
    with it)."""

    def __init__(self, offset: float):
        self.offset = offset

    def perf_counter(self) -> float:
        return time.perf_counter() + self.offset


class Watchdog:
    """A rank's bound on a stall: ``tick()`` marks progress; after
    ``limit`` seconds without one a thread puts an error result for
    ``rank`` on ``q`` and ends the process."""

    def __init__(self, rank, q, limit):
        import threading
        self.rank, self.q, self.limit = rank, q, limit
        self.what = "start"
        self.last = time.monotonic()
        threading.Thread(target=self._watch, daemon=True).start()

    def tick(self, what):
        self.what, self.last = what, time.monotonic()

    def _watch(self):
        while time.monotonic() - self.last < self.limit:
            time.sleep(1.0)
        self.q.put((self.rank, {"error": f"no progress for {self.limit} s "
                                         f"after {self.what} (a collective "
                                         f"the other rank never joined)"}))
        self.q.close()
        self.q.join_thread()
        os._exit(1)


def _idle_serve(eng, reqs, clock, host, dog):
    """Phase 17 (c)'s script on this rank: fill the slots, let
    ``2 x lease`` pass on every clock, touch two of the four active
    requests, jump this rank's clock by its ``jump``, then reconnect every
    dormant session each tick until all finish.  After every tick the
    ranks compare a digest of their slots and swapped sessions on the
    host group (a rank that disagrees fails the run at once).  Returns
    the evicting sweeps' (tick, rids), this rank's own view of them and
    the untouched rids."""
    import zlib
    lease = eng.idle_swap_ms / 1e3
    log, own = [], []
    shared = eng._idle_slots

    def sweep():
        now = clock.perf_counter()
        mine = sorted(r.rid for r in eng.active.values()
                      if now - r.t_last_activity > lease)
        slots = shared()
        if slots:
            log.append((eng.ticks, sorted(eng.active[s].rid
                                          for s in slots)))
            own.append(mine)
        return slots
    eng._idle_slots = sweep

    def agree():
        mine = zlib.crc32(repr((sorted((s, r.rid) for s, r in
                                       eng.active.items()),
                                sorted(eng.swapped))).encode())
        got = host.gather_ints([mine])
        if len(set(got)) != 1:
            raise AssertionError(f"[17] (c) tick {eng.ticks}: the ranks' "
                                 f"slots and swapped sessions differ "
                                 f"(digests {got})")

    for r in reqs:
        eng.submit(r)
    while len(eng.active) < eng.max_slots:
        eng.step()
        agree()
        dog.tick(f"tick {eng.ticks}")
    live = [r.rid for _, r in sorted(eng.active.items())]
    clock.offset += 2 * lease
    for rid in live[:2]:
        eng.touch(rid)
    clock.offset += IDLE17["jump"][host.index]
    for _ in range(1000):
        if all(r.done for r in reqs):
            break
        for rid in list(eng.swapped):
            if rid not in eng.resume_q:
                eng.resume(rid)
        eng.step()
        agree()
        dog.tick(f"tick {eng.ticks}")
    else:
        raise AssertionError("[17] (c): the run did not finish")
    return {"evicted": log, "own": own, "untouched": sorted(live[2:])}


def _idle_rank(rank, port, baseline, q):
    """A gloo rank of phase 17 (c) on card 0: phase 4's weights drawn from
    seed 0, the (2,1) mesh; with ``baseline`` first phase 13 (b)'s run
    (no policy), then the idle run under this rank's planted clock."""
    import traceback
    out = {}
    dog = Watchdog(rank, q, IDLE17_TIMEOUT_S)
    try:
        torch.cuda.set_device(0)
        from repro_torch import configs
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.models import lm
        from repro_torch.parallel import comm
        from repro_torch.serving import engine as engine_mod
        from repro_torch.serving import scheduler as sched
        mesh_mod.init_ranks(rank, 2, port, "gloo")
        dog.tick("the group")
        cfg = configs.get_arch("qwen3-next-gdn").replace(
            use_pallas_serving=True)
        dev = PHASE4_KW["device"]
        params = lm.init_lm(torch.Generator(device=dev).manual_seed(0),
                            cfg, device=dev)
        mesh = mesh_mod.make_serving_mesh(2, 1)
        Engine, Request = engine_mod.DecodeEngine, engine_mod.Request
        if baseline:
            eng = Engine(cfg, params, mesh=mesh, cuda_graphs=False,
                         **PHASE4_KW)
            reqs = phase4_requests(Request, cfg.vocab)
            for r in reqs:
                eng.submit(r)
            eng.run_until_done()
            out["baseline"] = [list(r.output) for r in reqs]
            del eng
            dog.tick("the baseline run")
        clock = PlantedClock(IDLE17["offsets"][rank])
        sched.time = clock
        eng = Engine(cfg, params, mesh=mesh, cuda_graphs=False,
                     swap_policy="idle",
                     idle_swap_ms=IDLE17["lease_s"] * 1e3, **PHASE4_KW)
        reqs = phase4_requests(Request, cfg.vocab)
        zero_launches()
        t0 = time.perf_counter()
        out.update(_idle_serve(eng, reqs, clock, comm.host_group(mesh),
                               dog))
        torch.cuda.synchronize()
        m = eng.metrics()
        out.update(streams=[list(r.output) for r in reqs],
                   wall=time.perf_counter() - t0,
                   swaps=(m["swap_outs"], m["swap_ins"]),
                   swap_s=m["swap_s"], decode_steps=eng.decode_steps,
                   launches=gdn_counts(), n_gdn=gdn_layers(cfg))
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    except BaseException:
        out["error"] = traceback.format_exc()
    dog.tick("the end")
    q.put((rank, out))
    if "error" in out:
        q.close()
        q.join_thread()     # the result leaves before the process does
        os._exit(1)         # no teardown against a rank that may be gone


def idle_phase_start(baseline):
    """Spawn phase 17 (c)'s two ranks; they run beside (a), (b), (d)."""
    import torch.multiprocessing as mp
    from repro_torch.launch import mesh as mesh_mod
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = mesh_mod.free_port()
    procs = [ctx.Process(target=_idle_rank, args=(r, port, baseline, q))
             for r in range(2)]
    for p in procs:
        p.start()
    return procs, q, time.perf_counter()


def idle_phase_check(started, want, card):
    """Phase 17 (c)'s results: both ranks evicted the same rids at the
    same ticks (the untouched two; rank 1's own clock would take all
    four), and the streams are bitwise ``want``, phase 13 (b)'s (the
    baseline run of the ranks themselves when phase 13 did not run)."""
    procs, q, t0 = started
    try:
        res = _rank_results(procs, q, 600)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for r, out in res.items():
        if "error" in out:
            raise AssertionError(f"[17] (c) rank {r}:\n{out['error']}")
    a, b = res[0], res[1]
    if want is None:
        want = a["baseline"]
    for r, x in enumerate((a, b)):
        print(f"  [17] (c) (2,1) gloo mesh, idle lease "
              f"{IDLE17['lease_s']} s, rank {r} clock offset "
              f"{IDLE17['offsets'][r]} s then +{IDLE17['jump'][r]} s "
              f"[{card}]: evicted (tick, rids) {x['evicted']}, its own "
              f"clock's view {x['own']}; {x['swaps'][0]} swap-outs / "
              f"{x['swaps'][1]} swap-ins in {x['swap_s']:.3f} s; "
              f"{x['decode_steps']} decode steps, GDN launches "
              f"{x['launches']}; the run {x['wall']:.1f} s")
    if not a["evicted"] or a["evicted"] != b["evicted"] \
            or a["evicted"][0][1] != a["untouched"] \
            or a["own"][0] != a["untouched"] or len(b["own"][0]) != 4:
        raise AssertionError("[17] (c): the ranks did not evict the "
                             "untouched requests alike by rank 0's clock")
    if a["streams"] != b["streams"] or a["streams"] != want:
        raise AssertionError(f"[17] (c): streams leave phase 13 (b)'s at "
                             f"{first_difference(a['streams'], want)}")
    for r, x in enumerate((a, b)):
        n_gdn = x["n_gdn"]
        if x["launches"]["gdn_decode"] != n_gdn * x["decode_steps"]:
            raise AssertionError(f"[17] (c) rank {r}: gdn_decode "
                                 f"{x['launches']['gdn_decode']}, not "
                                 f"{n_gdn} x {x['decode_steps']}")
    print(f"  [17] (c): both ranks evicted {a['evicted']}; streams bitwise "
          f"phase 13 (b)'s; spawn to results "
          f"{time.perf_counter() - t0:.1f} s")
    return a["launches"]


def _spawn_workers(engine_mod, cfg, specs, meanwhile):
    """Start one ``EngineProxy`` per (name, kwargs) of ``specs`` together
    and run ``meanwhile()`` here while they start; returns ({name: (proxy,
    spawn-to-first-reply seconds)}, what ``meanwhile`` returned)."""
    from concurrent.futures import ThreadPoolExecutor

    def spawn(name, kw):
        t0 = time.perf_counter()
        p = engine_mod.EngineProxy(cfg, params_seed=0, **kw)
        return name, (p, time.perf_counter() - t0)
    with ThreadPoolExecutor(len(specs)) as pool:
        futs = [pool.submit(spawn, n, kw) for n, kw in specs]
        try:
            done = meanwhile()
        except BaseException:
            for f in futs:      # the workers still go down
                if f.exception() is None:
                    f.result()[1][0].shutdown()
            raise
    out, errors = {}, []
    for f in futs:
        try:
            name, got = f.result()
            out[name] = got
        except Exception as e:          # noqa: BLE001 — raised below
            errors.append(e)
    if errors:
        for p, _ in out.values():
            p.shutdown()
        raise errors[0]
    return out, done


def _prefill_images(Engine, cfg, params, kw, requests):
    """Each request's handoff image (host numpy) from a one-device
    prefill-role engine of ``cfg`` serving ``requests()``, by rid."""
    eng = Engine(cfg, params, role="prefill", **kw)
    reqs = requests()
    for r in reqs:
        eng.submit(r)
    got = {}
    for _ in range(200):
        eng.step()
        while (rec := eng.withdraw_handoff()) is not None:
            got[rec.req.rid] = rec.state
        if len(got) == len(reqs):
            break
    else:
        raise AssertionError("[17] (b): the one-device prefill engine "
                             "handed off too few")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return got


def image_rule(label, mesh, one, truth):
    """Phase 3's rule on a handed-off image, leaf by leaf: every float
    cache leaf of the mesh's image no further from the fp32 engine's than
    twice the one-device bf16 image is; the sampler rows equal.  Returns
    the worst relative distance from the one-device image (max |mesh -
    one| / max |one| over the leaves)."""
    from repro_torch.tree import leaves
    worst, where = 0.0, None
    for i, (m, o, t) in enumerate(zip(leaves(mesh.caches),
                                      leaves(one.caches),
                                      leaves(truth.caches))):
        m, o, t = (torch.from_numpy(_f32(x)) for x in (m, o, t))
        d, err, err_one = max_err(m, o), max_err(m, t), max_err(o, t)
        if err > 2 * err_one:
            raise AssertionError(f"{label}: cache leaf {i} {tuple(m.shape)}"
                                 f" {err:.3e} from fp32, the 1-device image"
                                 f" {err_one:.3e} (limit 2x)")
        rel = d / max(float(o.abs().max()), 1e-30)
        if rel > worst:
            worst, where = rel, f"{i} {tuple(m.shape)}"
    for a, b in zip(leaves(mesh.sampler), leaves(one.sampler)):
        if np.asarray(a).tobytes() != np.asarray(b).tobytes():
            raise AssertionError(f"{label}: the sampler rows differ")
    return worst, where


def _f32(a):
    """A host image leaf as fp32 numpy (bf16 from its raw 2-byte
    words)."""
    a = np.asarray(a)
    if a.dtype == np.dtype("V2"):
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def workers_start(cfg, params, engine_mod, card, baseline):
    """Phase 17's start: (c)'s two ranks spawned (``baseline``: they serve
    phase 13 (b)'s run first), then (a), (b) and (d)'s four workers
    started together while (b)'s one-device and fp32 images are made
    here.  Returns what ``workers_phase`` takes."""
    idle = idle_phase_start(baseline)
    kw = dict(PHASE4_KW)
    dev = kw.pop("device")

    def requests():
        return phase4_requests(engine_mod.Request, cfg.vocab)

    def images():
        """(b)'s yardsticks, made while the workers start: each request's
        handoff image from a one-device bf16 prefill engine through
        graphs and from an fp32-activation one (the plain path)."""
        return (_prefill_images(engine_mod.DecodeEngine, cfg, params,
                                PHASE4_KW, requests),
                _prefill_images(
                    engine_mod.DecodeEngine,
                    cfg.replace(act_dtype="float32",
                                use_pallas_serving=False),
                    params, dict(PHASE4_KW, cuda_graphs=False), requests))

    t0 = time.perf_counter()
    workers, (ones, truth) = _spawn_workers(engine_mod, cfg, [
        ("w0", dict(mesh_shape=(1, 1), device=dev, **kw)),
        ("w1", dict(mesh_shape=(1, 1), device=dev, **kw)),
        ("p12", dict(mesh_shape=(1, 2), backend="gloo", device=dev,
                     role="prefill", **kw)),
        ("d1", dict(device=dev, role="decode", **kw))], images)
    print(f"  [17] workers started together [{card}], spawn to first "
          f"reply: " + ", ".join(
              f"{n} {p.mesh_shape or 'one device'} {p.role} "
              f"pids {p.rank_pids} {s:.2f} s"
              for n, (p, s) in workers.items())
          + f"; all in {time.perf_counter() - t0:.2f} s, (b)'s one-device "
          f"and fp32 images made meanwhile")
    return dict(workers=workers, ones=ones, truth=truth, idle=idle)


def workers_phase(cfg, engine_mod, card, plain, want13, started):
    """Phase 17: mesh engines behind the router and in worker processes,
    full-width qwen3-next-gdn, phase 4's mix and engine settings (module
    docstring).  ``started``: ``workers_start``'s workers, images and (c)'s
    ranks; ``want13``: phase 13 (b)'s streams (None: (c)'s ranks made
    them).  Returns the GDN kernels' launches by part."""
    import signal
    import warnings
    Router, Request = engine_mod.Router, engine_mod.Request
    from repro_torch.kernels import gdn_decode as kdecode
    from repro_torch.kernels import gdn_prefill as kprefill
    dkey, pkey = (kdecode.__name__, ""), (kprefill.__name__, "")
    n_gdn = gdn_layers(cfg)
    out = {"gdn_decode": {}, "gdn_prefill": {}}
    workers, ones, truth = (started[k] for k in ("workers", "ones", "truth"))

    def requests():
        return phase4_requests(Request, cfg.vocab)

    w0, w1, p12, d1 = (workers[n][0] for n in ("w0", "w1", "p12", "d1"))
    try:
        # (a) two (1,1) NCCL mesh workers on card 0, through graphs
        router = Router([w0, w1])
        for run in ("cold", "warm"):
            router.reset_metrics()
            snaps = [w.launch_counts(reset=True) for w in (w0, w1)]
            t1 = time.perf_counter()
            reqs = requests()
            for r in reqs:
                router.submit(r)
            router.run_until_done()
            wall = time.perf_counter() - t1
            streams = [list(r.output) for r in reqs]
            if streams != plain:
                raise AssertionError(
                    f"[17] (a) {run}: streams leave phase 4's at "
                    f"{first_difference(streams, plain)}")
            works = [worker_work(s, w.launch_counts())
                     for s, w in zip(snaps, (w0, w1))]
            m = router.metrics()
            for i, ((got, chunks, steps), pm) in enumerate(
                    zip(works, m["per_engine"])):
                print(f"  [17] (a) {run}: worker {i} ((1,1) NCCL mesh, "
                      f"graphs) placed {router.placed[i]}, {steps} decode "
                      f"steps, gdn_decode {got[dkey]}, {chunks} batched "
                      f"chunks, gdn_prefill {got[pkey]}, "
                      f"{pm['decode_us_per_token']:.1f} us/token")
                if got[dkey] != n_gdn * steps or steps <= 0 \
                        or got[pkey] != n_gdn * chunks:
                    raise AssertionError(f"[17] (a) {run} worker {i}: "
                                         f"launches {got}, not {n_gdn} x "
                                         f"{steps} / {chunks}")
            out["gdn_decode"][f"a_{run}"] = sum(w[0][dkey] for w in works)
            out["gdn_prefill"][f"a_{run}"] = sum(w[0][pkey] for w in works)
            print(f"  [17] (a) {run} [{card}]: streams bitwise phase 4's; "
                  f"{m['tokens']} tokens in {wall:.3f} s, mean TTFT "
                  f"{m['mean_ttft_s'] * 1e3:.1f} ms")
        w1.shutdown()

        # (b) a (1,2) gloo prefill worker hands off to a one-device decode
        # worker (graphs); every image held against one device
        handed, pipe = {}, {}

        def timed(eng, name, keep):
            fn = getattr(eng, name)

            def call(*args):
                t1 = time.perf_counter()
                res = fn(*args)
                rec = res if res is not None else args[0]
                if rec is not None:
                    pipe.setdefault(rec.req.rid, {})[name] = (
                        time.perf_counter() - t1)
                    if keep:
                        handed[rec.req.rid] = rec.state
                return res
            setattr(eng, name, call)
        timed(p12, "withdraw_handoff", True)
        timed(d1, "readmit_swapped", False)
        ticks = {"n": 0}
        begin = p12.step_begin

        def counted():
            if not p12._inflight_step:
                ticks["n"] += 1         # a tick relayed to both ranks
            return begin()
        p12.step_begin = counted
        router = Router([p12, d1])
        snaps = [w.launch_counts(reset=True) for w in (p12, d1)]
        t1 = time.perf_counter()
        reqs = requests()
        for r in reqs:
            router.submit(r)
        router.run_until_done()
        wall = time.perf_counter() - t1
        streams = [list(r.output) for r in reqs]
        after = [w.launch_counts() for w in (p12, d1)]
        m = router.metrics()
        pm, dm = m["per_engine"]
        relay = after[0]["host_collectives"]
        print(f"  [17] (b) (1,2) gloo prefill worker -> one-device decode "
              f"worker [{card}]: {router.handoffs} handoffs, {wall:.3f} s, "
              f"mean TTFT {m['mean_ttft_s'] * 1e3:.1f} ms; per handoff "
              f"(withdraw_handoff + readmit_swapped, s): "
              + "; ".join(f"rid {rid}: {t['withdraw_handoff']:.4f} + "
                          f"{t['readmit_swapped']:.4f}"
                          for rid, t in sorted(pipe.items())))
        print(f"  [17] (b) the prefill worker's host group (the relay and "
              f"the ranks' agreement, every op): {relay['calls']} calls, "
              f"{relay['seconds']:.4f} s, {relay['bytes']} B over "
              f"{ticks['n']} ticks and the other ops "
              f"({relay['seconds'] / max(ticks['n'], 1) * 1e3:.3f} ms per "
              f"tick)")
        print(f"  [17] (b) first token index leaving phase 4's streams, per "
              f"request (request 2 draws): "
              f"{first_difference(streams, plain)}")
        if router.handoffs != 6 or pm["decoded_tokens"] \
                or dm["stage_dispatches"]:
            raise AssertionError(f"[17] (b): {router.handoffs} handoffs, "
                                 f"or a worker outside its role")
        (pl, pchunks, psteps), (dl, dchunks, dsteps) = (
            worker_work(s, a) for s, a in zip(snaps, after))
        for r, counts in enumerate(after[0]["rank_launches"]):
            print(f"  [17] (b) prefill worker rank {r}: gdn_prefill "
                  f"{counts[pkey]} ({pchunks} batched chunks), gdn_decode "
                  f"{counts[dkey]}")
            if counts[pkey] != n_gdn * pchunks or pchunks <= 0 \
                    or counts[dkey]:
                raise AssertionError(f"[17] (b) rank {r}: {counts}")
        if dl[dkey] != n_gdn * dsteps or dsteps <= 0 or dl[pkey]:
            raise AssertionError(f"[17] (b) decode worker: {dl}")
        out["gdn_decode"]["b"] = dl[dkey]
        out["gdn_prefill"]["b"] = pl[pkey]
        worst = []
        for rid in sorted(handed):
            rel, leaf = image_rule(f"[17] (b) rid {rid}", handed[rid],
                                   ones[rid], truth[rid])
            worst.append((rel, rid, leaf))
            tok = (int(np.asarray(handed[rid].token).reshape(-1)[0]),
                   int(np.asarray(ones[rid].token).reshape(-1)[0]))
            print(f"  [17] (b) rid {rid}'s image: within phase 3's rule "
                  f"leaf by leaf; worst relative distance from the "
                  f"one-device image {rel:.3e} (leaf {leaf}); first token "
                  f"{tok[0]} (one device {tok[1]})")
        print(f"  [17] (b) the worst over the images: {max(worst)[0]:.3e} "
              f"(rid {max(worst)[1]}, leaf {max(worst)[2]})")
        d1.shutdown()

        # (d) rank 1 of the (1,2) worker killed mid-run beside (a)'s w0
        died = {}
        die = p12._die

        def stamped(cause):
            died.setdefault("t", time.perf_counter())
            return die(cause)
        p12._die = stamped
        router = Router([p12, w0], policy="round_robin")
        snap = w0.launch_counts(reset=True)
        reqs = requests()
        for r in reqs:
            router.submit(r)
        placed = router.placed[0]
        for w in (p12, w0):             # each worker mid-tick at the kill
            w.step_begin()
        t_kill = time.perf_counter()
        os.kill(p12.rank_pids[1], signal.SIGKILL)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            router.run_until_done()
        took = died.get("t", float("inf")) - t_kill
        m = router.metrics()
        done = [r for r in reqs if r.done]
        failed = [r.rid for r in reqs if r.state == "failed"]
        streams = {r.rid: list(r.output) for r in done}
        print(f"  [17] (d) rank 1 (pid {p12.rank_pids[1]}) of the (1,2) "
              f"worker killed in its first tick, {placed} requests placed "
              f"on it [{card}]: WorkerDied "
              f"{took:.3f} s later (bound {DEATH17_BOUND_S} s); dead "
              f"{m['dead']}, rehomed {m['rehomed']}, failed {failed}, "
              f"warned {[str(w.message)[:60] for w in caught]}; worker "
              f"exit code {p12.proc.wait(timeout=60)}")
        if m["dead"] != [0] or m["rehomed"] < 1 \
                or m["rehomed"] + len(failed) != placed \
                or took > DEATH17_BOUND_S:
            raise AssertionError(f"[17] (d): dead {m['dead']}, rehomed "
                                 f"{m['rehomed']} and failed {failed} of "
                                 f"{placed}, WorkerDied after {took:.3f} s")
        if len(done) + len(failed) != len(reqs) or any(
                streams[rid] != plain[rid] for rid in streams):
            raise AssertionError("[17] (d): a stream leaves phase 4's, or "
                                 "a request neither finished nor failed")
        got, _, steps = worker_work(snap, w0.launch_counts())
        if got[dkey] != n_gdn * steps:
            raise AssertionError(f"[17] (d): gdn_decode {got[dkey]}")
        out["gdn_decode"]["d"] = got[dkey]
        out["gdn_prefill"]["d"] = got[pkey]
        print(f"  [17] (d): {len(done)} finished on the (1,1) worker, "
              f"streams bitwise phase 4's")
    finally:
        for p, _ in workers.values():
            p.shutdown()
    launches = idle_phase_check(started["idle"], want13, card)
    out["gdn_decode"]["c"] = launches["gdn_decode"]
    out["gdn_prefill"]["c"] = launches["gdn_prefill"]
    return out


# ---------------------------------------------------------------- phase 5

TRAIN_STEPS = 5
# phases 5 and 15 (a) train full-width qwen3-next-gdn at this depth (of
# 48 layers), cut for the script's time limit: at 24 layers, with phase
# 19 in, the whole script took 1197.6 s of its 1200 on an H100 host; at
# 12 FSDP's rule still holds at model 1 (0.79 B params x 14 B > 10 GB)
TRAIN_LAYERS = 12


def _loss_and_grad_norm(params, cfg, batch):
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import global_norm
    from repro_torch.tree import leaves
    loss, _ = lm.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves(params), allow_unused=True)
    norm = global_norm([g for g in grads if g is not None])
    return float(loss.detach()), float(norm)


def _zero_counts(kernel_mods):
    for mod in kernel_mods:
        if isinstance(mod.launches, dict):
            for k in mod.launches:
                mod.launches[k] = 0
        else:
            mod.launches = 0


def state_digest(state):
    """Per leaf, the int64 sum of its words (bf16 as int16, fp32 and int32
    as int32), taken on the device and read once."""
    from repro_torch.tree import leaves
    bits = {2: torch.int16, 4: torch.int32}
    return torch.stack([t.detach().view(bits[t.element_size()]).sum(
        dtype=torch.int64) for t in leaves(state)]).tolist()


def _init_check(tr, cfg, tcfg):
    """``loss_fn`` and its gradients at the initial parameters on the
    step-0 batch through the flash kernels against the plain
    ``blockwise_attention`` path: bf16 activations, so the limits are
    relative to bf16 (loss 1e-2, gradient global norm 2e-2).  Returns the
    flash loss."""
    from repro_torch.tree import leaves
    params = tr.state["params"]
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
    return lf


def _train_run(tr, cfg, kflash, kernel_mods, lf, card, label):
    """``tr.run()`` over its ``tc.steps`` steps with every launch counter
    zeroed just before and read just after; checks the history, step 1
    against ``loss_fn`` at init and the flash launches (one forward, run
    again by remat, and one backward per attention layer and step).
    Returns (flash launches, [(loss, aux, grad norm)] per step, median
    step time from step 3 on)."""
    from repro_torch.models.mixers import get_mixer
    steps = tr.tc.steps
    n_attn = sum(get_mixer(k).is_attention for k in cfg.layer_kinds)
    _zero_counts(kernel_mods)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = tr.run()
    wall = time.perf_counter() - t0
    launches = dict(kflash.launches)
    others = {m.__name__: m.launches for m in kernel_mods
              if not isinstance(m.launches, dict)}
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.memory_reserved()
    losses = [l for _, l in hist]
    print(f"  {label}: losses {losses} (ln V = {math.log(cfg.vocab):.4f}); "
          f"grad norms {[r['grad_norm'] for r in tr.logged]}; step-1 loss "
          f"against loss_fn at init: {abs(losses[0] - lf) / lf:.3e}")
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
    how = ("at the wrappers" if label.endswith("eager") else
           "under replay: each replay adds what the capture counted")
    print(f"  {label}: flash launches {launches} over {steps} steps, "
          f"counted {how} (expected {want}: {n_attn} attention layers, "
          f"each forward run again by remat); other kernels {others}")
    if launches != want or any(others.values()):
        raise AssertionError("unexpected kernel launches in training")
    step_s = float(np.median(tr.step_times[2:steps]))
    tokens = tr.tc.global_batch * tr.tc.seq_len
    print(f"  {label} [{card}]: step times "
          f"{[round(t, 4) for t in tr.step_times]} s; median of steps "
          f"3-{steps} {step_s:.4f} s = {tokens / step_s:.1f} tokens/s; "
          f"peak memory {peak / 2**30:.2f} GiB (max_memory_allocated), "
          f"{reserved / 2**30:.2f} GiB reserved; run() {wall:.1f} s")
    return launches, [(r["loss"], r["aux"], r["grad_norm"])
                      for r in tr.logged], step_s


def _replayed_flash_step(tr, replayed):
    """The flash kernels each replay of the step's graph launches, read
    from the captured graph's kernel nodes by name (exact; the profiler
    lost a ``flash_fwd`` record in whole runs of windows): one step's
    share of ``replayed``, the launches the graph run's replays added."""
    from repro_torch.runtime.graphs import kernel_names
    names = kernel_names(tr.program.graph)
    prefix = {"flash_fwd": "flash_fwd_", "flash_bwd_dq": "flash_dq_",
              "flash_bwd_dkv": "flash_dkv_"}
    got = {n: sum(c for key, c in names.items() if p in key)
           for n, p in prefix.items()}
    per_step = {n: c // tr.tc.steps for n, c in replayed.items()}
    print(f"  the step's graph: flash kernel nodes {got} (one step's share "
          f"of the run's {replayed}: {per_step}), {sum(names.values())} "
          f"kernel nodes in all")
    if got != per_step:
        raise AssertionError(f"a replay launches flash kernels {got}, not "
                             f"{per_step}")


def train_phase(cfg, card, kflash, kernel_mods):
    """Full-width training through the port's Trainer with the flash
    kernels, first eagerly (``cuda_graphs=False``, no checkpoint), then
    replaying the step's CUDA graph (the default) with a checkpoint; each
    ``TRAIN_STEPS`` steps from the same seed.  Per-step loss and gradient
    norm and a digest of the final state must be equal bit for bit between
    the two.  The flash launches are exact in both runs; in the graph run
    a replay adds what its capture counted, so the captured graph's kernel
    nodes must hold one step's share of flash kernels.  Returns the eager
    run's launches, counted at the wrappers, and the graph run's per-step
    metrics, final state digest and median replayed step time (phase 15
    (a)'s yardstick)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.lm import param_count
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.runtime.graphs import graph_nodes
    from repro_torch.tree import leaves
    tcfg = cfg.replace(use_flash_kernel=True)
    steps = TRAIN_STEPS
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckdir:
        def trainer(cuda_graphs, ck):
            tc = TrainerConfig(
                steps=steps, seq_len=FLASH["T"], global_batch=FLASH["B"],
                warmup_steps=1, ckpt_dir=ck, ckpt_every=1000, log_every=1)
            t0 = time.perf_counter()
            tr = Trainer(tcfg, tc, device="cuda",
                         cuda_graphs=cuda_graphs).compile(keep_graph=True)
            torch.cuda.synchronize()
            print(f"  state drawn in {time.perf_counter() - t0:.1f} s: "
                  f"{param_count(tr.state['params']) / 1e9:.3f} B "
                  f"{cfg.act_dtype} params, AdamW fp32 moments; "
                  f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                  f"allocated")
            return tr

        tr = trainer(False, None)
        lf = _init_check(tr, cfg, tcfg)
        launches, eager, eager_s = _train_run(tr, cfg, kflash, kernel_mods,
                                              lf, card, "eager")
        eager_digest = state_digest(tr.state)
        del tr                     # two states do not fit the card
        gc.collect()
        torch.cuda.empty_cache()

        tr = trainer(None, ckdir)
        if not tr.cuda_graphs:
            raise AssertionError("the trainer does not default to graphs")
        replayed, graph, graph_s = _train_run(tr, cfg, kflash, kernel_mods,
                                              lf, card, "graphs")
        prog = tr.program
        kernels, nodes = graph_nodes(prog.graph)
        print(f"  graphs [{card}]: one graph of {kernels} kernel nodes "
              f"({nodes} nodes), captured in {prog.capture_s:.2f} s, "
              f"instantiated in {prog.instantiate_s:.2f} s; replayed step "
              f"{graph_s:.4f} s against {eager_s:.4f} s eagerly "
              f"({eager_s / graph_s:.2f}x)")
        same = graph == eager and state_digest(tr.state) == eager_digest
        print(f"  per-step loss, aux and grad norm, final state digest "
              f"({len(eager_digest)} leaves): graphs == eager bitwise: "
              f"{same}")
        if not same:
            raise AssertionError("the replayed step differs from the eager "
                                 "step")
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

        _replayed_flash_step(tr, replayed)
    return launches, dict(graph=graph, digest=eager_digest, graph_s=graph_s)


# ---------------------------------------------------------------- phase 6

DANUBE_PROMPTS = (5000, 4500, 1000, 200)


def _danube_serve(cfg, params, engine_mod, card):
    """(i) Four requests, two with prompts past the 4096-token window,
    through ``DecodeEngine`` to completion, eagerly and through CUDA
    graphs (``serve_twice``)."""
    Engine, Request = engine_mod.DecodeEngine, engine_mod.Request
    kw = dict(max_slots=4, max_len=8192, prefill_chunk=256, decode_block=8,
              seed=0, device="cuda")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab, n) for n in DANUBE_PROMPTS]
    print(f"  prompts {list(DANUBE_PROMPTS)} (window {cfg.window}), 32 new "
          f"tokens each")

    def requests():
        return [Request(rid=i, prompt=p, max_new_tokens=32,
                        temperature=0.8 if i == 2 else 0.0,
                        top_k=40 if i == 2 else 0)
                for i, p in enumerate(prompts)]

    eng, _, _ = serve_twice(Engine, cfg, params, kw, requests, card,
                            "danube serve")
    del eng


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


# ---------------------------------------------------------------- phase 7

def mamba2_phase(card, lm, engine_mod, kdecode, kprefill, configs,
                 kernel_counts):
    """Full-width mamba2-1.3b (48 ssm layers, no FFN; random bf16 weights
    drawn on the card from seed 0) through the GDN kernels with
    ``delta_rule=False``: one decode step against the plain path (phase
    3's check), then phase 4's mix through the eager and the CUDA-graph
    engine (``serve_twice``), the GDN kernels' launches counted at the
    wrappers in the eager warm run (``gdn_launches``: ``gdn_decode`` 48 x
    decode steps, ``gdn_prefill`` 48 x prefill chunks, placeholder chunks
    included) and one replayed batched round under the profiler.  Returns
    the launches keyed by phase 2's rows, the config, the weights, the
    graph engine's warm streams and us/token (phase 14 (a) takes the
    last two)."""
    cfg = configs.get_arch("mamba2-1.3b").replace(use_pallas_serving=True)
    t0 = time.perf_counter()
    params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    torch.cuda.synchronize()
    print(f"[7] full-width {cfg.name}: {lm.param_count(params) / 1e9:.3f} B "
          f"params ({cfg.act_dtype}) drawn in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    model_phase(cfg, params, lm)
    Engine, Request = engine_mod.DecodeEngine, engine_mod.Request
    kw = dict(max_slots=4, max_len=1024, prefill_chunk=64, decode_block=8,
              seed=0, device="cuda")
    prompts = _phase4_prompts(cfg.vocab)
    print(f"  prompts {[len(p) for p in prompts]}, 32 new tokens each")

    def requests():
        return [Request(rid=i, prompt=p, max_new_tokens=32,
                        temperature=0.8 if i == 2 else 0.0,
                        top_k=40 if i == 2 else 0)
                for i, p in enumerate(prompts)]

    eng, runs, streams = serve_twice(
        Engine, cfg, params, kw, requests, card, "mamba2 serve",
        variants=(("per-prompt", dict(prefill_batching=False), True),))
    n_ssm = sum(k == "ssm" for k in cfg.layer_kinds)
    got = gdn_launches(runs, kdecode, kprefill, n_ssm, "mamba2 serve")
    profile_batched_round(eng, kernel_counts, n_ssm, "mamba2 serve")
    warm_us = eng.metrics()["decode_us_per_token"]
    return dict(launches={"gdn_decode_mamba2": got["decode"],
                          "gdn_prefill_mamba2": got["prefill"]},
                cfg=cfg, params=params, warm_us=warm_us,
                plain=streams[("graphs", "warm")])


# ---------------------------------------------------------------- phase 8

GEMMA_PROMPTS = (2500, 1200, 600, 300)


def gemma_phase(card, lm, engine_mod, configs, folder):
    """Full-width recurrentgemma-2b (26 layers: 18 rglru, 8 swa with a
    2048-token window and MQA q heads padded 10 -> 16; random bf16 weights
    drawn on the card from seed 0) serving 4 requests, one prompt past the
    window, 16 new tokens each (one at temperature 0.8 / top-k 40),
    eagerly and through CUDA graphs (``serve_twice``): the RG-LRU programs
    capture and replay, streams bitwise equal.  No hand-written kernel is
    on this path: none may launch.  Then phase 14's fixed step on these
    weights (``fixed_step``, saved under ``folder``); returns it and the
    warm streams of the requests phase 14 (c) serves."""
    cfg = configs.get_arch("recurrentgemma-2b")
    t0 = time.perf_counter()
    params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    torch.cuda.synchronize()
    print(f"[8] full-width {cfg.name}: {lm.param_count(params) / 1e9:.3f} B "
          f"params ({cfg.act_dtype}) drawn in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    Engine, Request = engine_mod.DecodeEngine, engine_mod.Request
    kw = dict(max_slots=4, max_len=4096, prefill_chunk=256, decode_block=8,
              seed=0, device="cuda")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, cfg.vocab, n) for n in GEMMA_PROMPTS]
    print(f"  prompts {list(GEMMA_PROMPTS)} (window {cfg.window}), 16 new "
          f"tokens each")

    def requests():
        return [Request(rid=i, prompt=p, max_new_tokens=16,
                        temperature=0.8 if i == 1 else 0.0,
                        top_k=40 if i == 1 else 0)
                for i, p in enumerate(prompts)]

    _, runs, streams = serve_twice(Engine, cfg, params, kw, requests, card,
                                   "recurrentgemma serve")
    counts = {name: {k: n for k, n in c.items() if n}
              for name, (c, _) in runs.items()}
    if any(counts.values()):
        raise AssertionError(f"a kernel launched on the rglru path: "
                             f"{counts}")
    plain = streams[("graphs", "warm")]
    return fixed_step(cfg, params, lm, folder), [plain[0], plain[3]]


# ---------------------------------------------------------------- phase 12

# full width with the depth cut to fit the card: the whole of either
# model is over its 80 GB in bf16 (46.7 B and 476.9 B parameters)
MOE_SERVE_LAYERS = {"mixtral-8x7b": 8, "arctic-480b": 2}
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_STEPS = 4


def _moe_draw(card, lm, cfg, full_layers, label):
    """Random weights of ``cfg`` drawn on the card from seed 0, each
    expert matrix on its own (``moe.init_moe``); prints the draw's
    seconds and peak memory."""
    from repro_torch.tree import leaves
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
    print(f"  {label}: full-width {cfg.name} at {cfg.n_layers} of "
          f"{full_layers} layers: {lm.param_count(params) / 1e9:.3f} B "
          f"params, {nbytes / 1e9:.2f} GB ({cfg.act_dtype}) drawn in "
          f"{time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    return params


def moe_consistency(card, lm, moe, configs):
    """(a) mixtral-8x7b at full width, 2 layers, fp32 activations,
    dropless capacity (cf = E / k, as the reference's
    ``test_prefill_decode_consistency``): ``prefill(T + 1)``'s last
    logits against ``prefill(T)`` then ``decode_step``, B = 2, T = 16,
    within that test's rtol = atol = 2e-3 — the capacity dispatch and
    the dense all-expert decode compute one function at the real expert
    shapes.  First the sort-based top-k on the card: ties to the lower
    expert index, as ``jax.lax.top_k``."""
    rows = torch.tensor([[.125] * 8, [.1, .2, .2, .1, .1, .2, .05, .05]],
                        device="cuda")
    _, idx = moe.select_top_k(rows, 2)
    _, idx128 = moe.select_top_k(torch.full((4, 128), 1 / 128,
                                            device="cuda"), 2)
    print(f"  ties on the card: {idx.tolist()} and {idx128[0].tolist()} "
          f"(jax.lax.top_k: [[0, 1], [1, 2]] and [0, 1])")
    if idx.tolist() != [[0, 1], [1, 2]] or idx128.tolist() != [[0, 1]] * 4:
        raise AssertionError("the top-k breaks ties unlike jax.lax.top_k")
    full = configs.get_arch("mixtral-8x7b")
    cfg = full.replace(n_layers=2, act_dtype="float32",
                       moe_capacity_factor=full.moe_experts / full.moe_top_k)
    params = _moe_draw(card, lm, cfg, full.n_layers, "(a)")
    B, T = 2, 16
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (B, T + 1), generator=gen,
                         device="cuda")
    la, _ = lm.prefill(params, cfg, lm.init_caches(cfg, B, 64, "cuda"),
                       tokens=toks)
    _, caches = lm.prefill(params, cfg, lm.init_caches(cfg, B, 64, "cuda"),
                           tokens=toks[:, :T])
    lb, _ = lm.decode_step(params, cfg, toks[:, T], caches)
    torch.cuda.synchronize()
    experts = tuple(params["groups"][0][0]["moe"]["wi_gate"].shape[1:])
    check(f"(a) prefill({T + 1}) vs prefill({T}) + decode_step logits, "
          f"experts {experts}", lb, la, 2e-3, 2e-3)


def bmm_f32_check(params, label, max_experts=16, rows=64):
    """``layers.bmm_f32`` on bf16 operands at the drawn first layer's
    full-width expert matrices (the first ``max_experts`` of them; their
    fp32 copies must fit beside the model) against ``torch.bmm`` of the
    same values as fp32 operands: summation order apart, within the card
    test's rtol = 1e-5, atol = 1e-4."""
    from repro_torch.models import layers
    p = params["groups"][0][0]["moe"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name in ("wi_gate", "wo"):
        w = p[name][0, :max_experts]
        x = torch.randn((w.shape[0], rows, w.shape[1]), generator=gen,
                        device="cuda").to(torch.bfloat16)
        got = layers.bmm_f32(x, w)
        want = torch.bmm(x.float(), w.float())
        torch.cuda.synchronize()
        if got.dtype != torch.float32:
            raise AssertionError(f"{label}: bmm_f32 gave {got.dtype}")
        check(f"{label} bmm_f32 bf16 {name} {tuple(x.shape)} @ "
              f"{tuple(w.shape)} vs fp32 operands", got, want, 1e-5, 1e-4)
        del x, got, want


def moe_serve(card, lm, engine_mod, configs, arch, variants, label,
              folder=None):
    """(b), (c) ``arch`` at full width, ``MOE_SERVE_LAYERS`` deep, bf16
    weights from seed 0, serving phase 4's mix and engine settings
    through ``serve_twice`` (eager once, the default CUDA-graph engine
    cold then warm, then ``variants``): streams bitwise equal, the
    default engine's gate staging per prompt, and no hand-written kernel
    launched (every counter zeroed before, all six 0 after).  Prints the
    warm graph engine's TTFT, decode us/token and tok/s beside the floor
    of the dense all-expert decode: every weight but the embedding table
    read once per step.  With ``folder``: then phase 14's fixed step on
    these weights (``fixed_step``); returns it and the warm streams of
    phase 14 (d)'s two requests."""
    from repro_torch.runtime.graphs import add_launches, launch_counts
    from repro_torch.tree import leaves
    full = configs.get_arch(arch)
    cfg = full.replace(n_layers=MOE_SERVE_LAYERS[arch])
    params = _moe_draw(card, lm, cfg, full.n_layers, label)
    bmm_f32_check(params, label)
    Engine, Request = engine_mod.DecodeEngine, engine_mod.Request
    kw = dict(max_slots=4, max_len=1024, prefill_chunk=64, decode_block=8,
              seed=0, device="cuda")
    prompts = _phase4_prompts(cfg.vocab)

    def requests():
        return [Request(rid=i, prompt=p, max_new_tokens=32,
                        temperature=0.8 if i == 2 else 0.0,
                        top_k=40 if i == 2 else 0)
                for i, p in enumerate(prompts)]

    add_launches(launch_counts(), -1)                   # zero every count
    eng, runs, streams = serve_twice(Engine, cfg, params, kw, requests,
                                     card, f"{label} {arch} serve",
                                     variants=variants)
    launched = {k: n for k, n in launch_counts().items() if n}
    print(f"  {label}: kernel launches over every serve run {launched}; "
          f"default engine prefill_batching {eng.prefill_batching}")
    if launched or any(n for c, _ in runs.values() for n in c.values()):
        raise AssertionError(f"{label}: a hand-written kernel launched on "
                             f"the MoE serving path: {launched}")
    if eng.prefill_batching:
        raise AssertionError(f"{label}: the gate let an MoE arch stage "
                             f"prompts in batches")
    m = eng.metrics()                              # its warm run
    table = params["embed"]["table"]
    step_bytes = sum(t.numel() * t.element_size() for t in leaves(params)) \
        - table.numel() * table.element_size()
    floor_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    slots = kw["max_slots"]
    print(f"  {label} [{card}]: graphs warm: decode "
          f"{m['decode_us_per_token']:.1f} us/token, mean TTFT "
          f"{m['mean_ttft_s'] * 1e3:.1f} ms (per-prompt staging), "
          f"{m['mean_tokens_per_s']:.1f} tok/s per request; floor of the "
          f"dense all-expert decode: {step_bytes / 1e9:.2f} GB / "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = {floor_ms:.2f} ms per "
          f"{slots}-slot step, {floor_ms * 1e3 / slots:.1f} us/token")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    out = None
    if folder is not None:
        out = (fixed_step(cfg, params, lm, folder),
               streams[("graphs", "warm")][:2])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_train(card, configs, kflash, kernel_mods):
    """(d) mixtral-8x7b at full width, ``MOE_TRAIN_LAYERS`` deep, bf16,
    ``use_flash_kernel``, global batch 2 x seq_len 2048 (two groups of
    1024 tokens per row: C = 320): ``loss_fn`` at init through the flash
    kernels against the plain path, then ``MOE_TRAIN_STEPS`` steps through
    an eager ``Trainer`` and through the default one (step 1 eager, step
    2 captured, then replayed), no checkpoint.  Loss, aux, grad norm and
    a state digest bitwise equal; the flash launches exact (at the
    wrappers eagerly; under replay the graph's kernel nodes by name).
    Returns the eager run's flash launches."""
    from repro_torch.runtime.graphs import graph_nodes
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.models.lm import param_count
    full = configs.get_arch("mixtral-8x7b")
    cfg = full.replace(n_layers=MOE_TRAIN_LAYERS)
    tcfg = cfg.replace(use_flash_kernel=True)

    def trainer(cuda_graphs):
        tc = TrainerConfig(steps=MOE_TRAIN_STEPS, seq_len=FLASH["T"],
                           global_batch=FLASH["B"], warmup_steps=1,
                           log_every=1)
        t0 = time.perf_counter()
        tr = Trainer(tcfg, tc, device="cuda",
                     cuda_graphs=cuda_graphs).compile(keep_graph=True)
        torch.cuda.synchronize()
        print(f"  (d) {cfg.name} at {cfg.n_layers} of {full.n_layers} "
              f"layers: state drawn in {time.perf_counter() - t0:.1f} s: "
              f"{param_count(tr.state['params']) / 1e9:.3f} B "
              f"{cfg.act_dtype} params, AdamW fp32 moments; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        return tr

    tr = trainer(False)
    lf = _init_check(tr, cfg, tcfg)
    launches, eager, eager_s = _train_run(tr, cfg, kflash, kernel_mods, lf,
                                          card, "(d) eager")
    eager_digest = state_digest(tr.state)
    del tr                         # two states do not fit the card
    gc.collect()
    torch.cuda.empty_cache()

    tr = trainer(None)
    if not tr.cuda_graphs:
        raise AssertionError("the trainer does not default to graphs")
    replayed, graph, graph_s = _train_run(tr, cfg, kflash, kernel_mods, lf,
                                          card, "(d) graphs")
    kernels, nodes = graph_nodes(tr.program.graph)
    print(f"  (d) graphs [{card}]: one graph of {kernels} kernel nodes "
          f"({nodes} nodes), captured in {tr.program.capture_s:.2f} s, "
          f"instantiated in {tr.program.instantiate_s:.2f} s; replayed "
          f"step {graph_s:.4f} s against {eager_s:.4f} s eagerly")
    same = graph == eager and state_digest(tr.state) == eager_digest
    print(f"  (d) per-step loss, aux and grad norm {graph}, final state "
          f"digest: graphs == eager bitwise: {same}")
    if not same:
        raise AssertionError("(d) the replayed MoE step differs from the "
                             "eager step")
    if not all(aux > 0 for _, aux, _ in eager):
        raise AssertionError("(d) the aux loss did not reach the metrics")
    _replayed_flash_step(tr, replayed)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def moe_phase(card, lm, engine_mod, configs, kflash, kernel_mods, folder):
    """Phase 12: the MoE FFN at full width, (a)-(d), each model freed
    before the next.  Returns (d)'s flash launches and phase 14's fixed
    step of (b)'s mixtral with (b)'s streams."""
    from repro_torch.models import moe
    moe_consistency(card, lm, moe, configs)
    gc.collect()
    torch.cuda.empty_cache()
    mixtral = moe_serve(card, lm, engine_mod, configs, "mixtral-8x7b",
                        (("spec self-draft k=4",
                          dict(speculative=True, k_draft=4), True),), "(b)",
                        folder)
    moe_serve(card, lm, engine_mod, configs, "arctic-480b", (), "(c)")
    return (moe_train(card, configs, kflash, kernel_mods),
            mixtral)


# ---------------------------------------------------------------- phase 15

# (b)-(d): full width cut to three (gdn, gdn, gdn, attn) groups, phase 5's
# batch and seed, 3 steps of its schedule (warmup 1: step 1 at lr 0)
MESH15_LAYERS = 12
MESH15_STEPS = 3


def _train15_tc(steps, **kw):
    from repro_torch.runtime.trainer import TrainerConfig
    return TrainerConfig(steps=steps, seq_len=FLASH["T"],
                         global_batch=FLASH["B"], warmup_steps=1,
                         log_every=1, **kw)


def train15_nccl(cfg, card, phase5, kflash, kernel_mods):
    """(a) Phase 5's full-width training on a (1,1) NCCL mesh through the
    step's CUDA graph, FSDP on by the reference's rule: per-step loss,
    aux and grad norm and the final state digest bitwise phase 5's graph
    run; the replayed steps issue no collective from the host."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.parallel import comm
    from repro_torch.parallel import sharding as rules
    from repro_torch.runtime.trainer import Trainer
    tcfg = cfg.replace(use_flash_kernel=True)
    steps = TRAIN_STEPS
    mesh_mod.init_ranks(0, 1, mesh_mod.free_port(), "nccl")
    try:
        mesh = mesh_mod.make_local_mesh(1, 1)
        per_dev = rules.estimate_params(tcfg) * 14 / 1
        tr = Trainer(tcfg, _train15_tc(steps), mesh=mesh,
                     device="cuda").compile()
        print(f"  [15] (a) (1,1) NCCL mesh: needs_fsdp {tr.fsdp} (the "
              f"reference's rule: {rules.estimate_params(tcfg) / 1e9:.3f} B "
              f"params x 14 B / model 1 = {per_dev / 1e9:.1f} GB per device "
              f"against 10 GB); graphs {tr.cuda_graphs}")
        if not (tr.fsdp and tr.cuda_graphs):
            raise AssertionError("[15] (a): FSDP off or no CUDA graph")
        _zero_counts(kernel_mods)
        comm.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        tr.run()
        st = dict(comm.stats)
        got = [(r["loss"], r["aux"], r["grad_norm"]) for r in tr.logged]
        same = got == phase5["graph"] and \
            state_digest(tr.state) == phase5["digest"]
        step_s = float(np.median(tr.step_times[2:steps]))
        print(f"  [15] (a) [{card}]: losses {[g[0] for g in got]}; per-step "
              f"loss, aux, grad norm and the final state digest bitwise "
              f"phase 5's graph run: {same}; collectives: {st['calls']} "
              f"issued from the host (the eager step 1), {st['captured']} "
              f"captured (step 2), {st['replayed']} replayed (steps "
              f"2-{steps}); flash launches {dict(kflash.launches)}; "
              f"replayed step {step_s:.4f} s against phase 5's "
              f"{phase5['graph_s']:.4f} s "
              f"({step_s / phase5['graph_s']:.4f}x); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not same:
            raise AssertionError("[15] (a): the mesh step differs from "
                                 "phase 5's graph step")
        # step 1 runs eagerly; step 2 captures, then replays (a capture
        # runs nothing), as does every later step
        if not st["captured"] or st["calls"] != st["captured"] or \
                st["replayed"] != st["captured"] * (steps - 1):
            raise AssertionError(f"[15] (a): collectives {st}: a replayed "
                                 f"step issued some from the host")
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return step_s


def _mesh15_cfg():
    from repro_torch import configs
    return configs.get_arch("qwen3-next-gdn").replace(
        n_layers=MESH15_LAYERS, use_flash_kernel=True)


def _train15_steps(tr, start, n):
    """``n`` eager steps from ``start``: per step the metrics, seconds,
    collectives and their host seconds (rank's own)."""
    from repro_torch.parallel import comm
    out = []
    for step in range(start, start + n):
        tr.batch(step)
        comm.reset_stats()
        t0 = time.perf_counter()
        m = tr.step()
        out.append(dict({k: float(v) for k, v in m.items()},
                        seconds=time.perf_counter() - t0,
                        collectives=comm.stats["calls"],
                        collective_s=comm.stats["seconds"],
                        collective_bytes=comm.stats["bytes"]))
    return out


def _dump_params(tr, folder, step):
    """The trainer's parameters, whole, as a checkpoint of ``step`` in
    ``folder`` (rank 0 writes; every rank takes part)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    CheckpointManager(folder).save(tr.state["params"], step,
                                   specs=tr.specs["params"], axes=tr.axes)


# planted faults (``--mesh-train-faults``), each a run of 2 steps from
# seed 0 whose parameters the rule must refuse: rank 1's gradients left
# out of the data mean on (2,1), and the all-reduce of the first
# ``copy_to`` the backward reaches (the last layer's) skipped on (1,2)
FAULTS15 = {"data_mean": (2, 1), "copy_to": (1, 2)}


def _plant(fault, tr):
    """Break ``tr``'s step by ``fault`` (``FAULTS15``) in this process."""
    from repro_torch.parallel import comm
    if fault == "data_mean":
        mean_flat = comm.Axis.mean_flat

        def left_out(axis, ts, split=None):
            if axis.name == "data" and axis.index == 1:
                ts = [torch.zeros_like(t) for t in ts]
            return mean_flat(axis, ts, split)
        comm.Axis.mean_flat = left_out
        return
    backward, calls = comm._CopyTo.backward, [0]

    def skipped(ctx, g):
        calls[0] += 1
        return (None, g) if calls[0] == 1 else backward(ctx, g)
    comm._CopyTo.backward = staticmethod(skipped)
    step = tr.step

    def each_step():
        calls[0] = 0
        return step()
    tr.step = each_step


def _train15_rank(rank, port, folder, q, faults, go, c_done):
    """A gloo rank of phase 15 (b)-(d) on card 0: (b) (2,1) and (c) (1,2)
    trainers drawn from seed 0, 2 eager steps each; (b) checkpoints its
    state, (c) dumps its parameters; (d) (b)'s checkpoint restored into
    a (1,2) trainer, step 3, its parameters dumped; with ``faults``, then
    each of ``FAULTS15``'s runs, its parameters dumped.  (b) steps once
    the parent sets ``go``; rank 0 sets ``c_done`` after (c)'s dump."""
    import traceback
    import torch.distributed as dist
    out = {}
    try:
        torch.cuda.set_device(0)
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.kernels import flash_attn as kflash
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.runtime.trainer import Trainer
        from repro_torch.tree import leaves
        mesh_mod.init_ranks(rank, 2, port, "gloo")
        cfg = _mesh15_cfg()
        meshes = {(2, 1): mesh_mod.make_local_mesh(2, 1),
                  (1, 2): mesh_mod.make_local_mesh(1, 2)}
        runs = [("b", (2, 1), 2), ("c", (1, 2), 2), ("d", (1, 2), 1)]
        if faults:
            runs += [(f, shape, 2) for f, shape in FAULTS15.items()]
        for label, shape, n in runs:
            t0 = time.perf_counter()
            tr = Trainer(cfg, _train15_tc(MESH15_STEPS), mesh=meshes[shape],
                         device="cuda").compile()
            start = 0
            if label == "d":
                tr.ckpt = CheckpointManager(f"{folder}/b")
                start = tr._maybe_restore()
            if label in FAULTS15:
                _plant(label, tr)
            torch.cuda.synchronize()
            ready = time.perf_counter() - t0
            if label == "b":        # the one device's yardsticks run alone
                go.wait()
            for key in kflash.launches:
                kflash.launches[key] = 0
            torch.cuda.reset_peak_memory_stats()
            steps = _train15_steps(tr, start, n)
            o = dict(steps=steps, start=start, ready_s=ready,
                     fsdp=tr.fsdp, launches=dict(kflash.launches),
                     allocated=torch.cuda.memory_allocated(),
                     peak=torch.cuda.max_memory_allocated(),
                     state_bytes=sum(t.nbytes for t in leaves(tr.state)))
            t0 = time.perf_counter()
            if label == "b":
                tr.ckpt = CheckpointManager(f"{folder}/b")
                tr.save(start + n)
            else:
                _dump_params(tr, f"{folder}/{label}_params", start + n)
            o["save_s"] = time.perf_counter() - t0
            out[label] = o
            if label == "c" and rank == 0:
                c_done.set()
            del tr
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        out["error"] = traceback.format_exc()
    q.put((rank, out))


def param_distance(got, want, mu, lrs, wd, b1=0.9):
    """Per leaf of a run's parameters ``got`` against the one-device
    run's ``want`` (``mu``: its first moments): (elements past the steps'
    bound 2 sum(lr) (1 + wd |p|) plus one unit in the last place of p,
    the share of the "sharp" elements (|m| / (1 - b1) > 1e-6: a gradient
    well above AdamW's eps) past one ulp + 0.05 sum(lr), max |diff|)."""
    from repro_torch.tree import leaves
    lr = float(sum(lrs))
    out = []
    for a, b, m in zip(leaves(got), leaves(want), leaves(mu)):
        mant = 7 if b.dtype == torch.bfloat16 else 23
        a, b, m = (t.cuda().float() for t in (a, b, m))
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.clamp(b.abs(), min=1e-30))) - mant)
        d = (a - b).abs()
        loose = int((d > 2 * lr * (1 + wd * b.abs()) + ulp).sum())
        sharp = m.abs() / (1 - b1) > 1e-6
        past = int(((d > ulp + 0.05 * lr) & sharp).sum())
        out.append((loose, past / max(1, int(sharp.sum())), float(d.max())))
    return out


# phase 15's rule: the largest share of a leaf's sharp elements that may
# sit past the tight bound, between what sound layouts gave (at most
# 9.06%) and what the planted faults gave (FAULTS15: 76% and 85% in their
# worst leaves); PERF.md section 6 gives its history
SHARP_LIMIT = 0.15


def check_params(label, dist):
    """Phase 15's rule for a run's parameters against the one-device run:
    no element past the steps' bound, and in each leaf at most
    ``SHARP_LIMIT`` of the sharp elements past one ulp + 0.05 sum(lr)
    (bf16 summation orders moved up to 9% of a leaf's sharp elements past
    it, in every layout and in the one-device run with 2 microbatches;
    each planted fault more than 70% of its worst leaf's).  Returns (the
    worst share, its leaf, max |diff|)."""
    for i, (loose, share, _) in enumerate(dist):
        if loose:
            raise AssertionError(f"{label}: leaf {i}: {loose} elements "
                                 f"past the steps' bound")
        if share > SHARP_LIMIT:
            raise AssertionError(f"{label}: leaf {i}: {share:.3e} of its "
                                 f"sharp elements past the tight bound")
    worst = max(range(len(dist)), key=lambda i: dist[i][1])
    return dist[worst][1], worst, max(d[2] for d in dist)


def _snapshot(tr):
    """(params, first moments) of a one-device trainer, on the host."""
    from repro_torch.tree import leaves, tree_map
    mu = leaves(tr.state["opt"]["mu"], is_leaf=lambda t: isinstance(t, dict)
                and "m" in t)
    return (tree_map(lambda t: t.detach().cpu(), tr.state["params"]),
            [s["m"].detach().cpu() for s in mu])


def _yardsticks15(cfg, tc, lrs, card):
    """The one-device eager trainer with 2 microbatches (the rows split
    as the data axis splits them: the floor of what an equally valid
    summation order moves in bf16), 2 steps, then with 1, 3 steps.
    Returns the 1-microbatch run's metrics per step, the host snapshots
    {(microbatches, step): (params, first moments)}, that trainer (kept
    for (d)), its state's bytes and the floor (2 microbatches against 1
    after step 2)."""
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.tree import leaves
    ref, snaps = {}, {}
    for mb, n in ((2, 2), (1, MESH15_STEPS)):
        t0 = time.perf_counter()
        one = Trainer(cfg, _train15_tc(MESH15_STEPS, microbatches=mb),
                      device="cuda", cuda_graphs=False).compile()
        ref[mb] = []
        for step in range(n):
            one.batch(step)
            t1 = time.perf_counter()
            m = one.step()
            ref[mb].append(dict({k: float(v) for k, v in m.items()},
                                seconds=time.perf_counter() - t1))
            if step + 1 >= 2:
                snaps[mb, step + 1] = _snapshot(one)
        one_bytes = sum(t.nbytes for t in leaves(one.state))
        print(f"  [15] one-device eager, {mb} microbatch(es) [{card}]: "
              f"{one_bytes / 1e9:.2f} GB of state; steps "
              f"{[round(r['seconds'], 4) for r in ref[mb]]} s; losses "
              f"{[r['loss'] for r in ref[mb]]}; grad norms "
              f"{[r['grad_norm'] for r in ref[mb]]} "
              f"({time.perf_counter() - t0:.1f} s)")
        if mb == 2:
            del one
            gc.collect()
            torch.cuda.empty_cache()
    floor = param_distance(snaps[2, 2][0], *snaps[1, 2], lrs[:2],
                           tc.adamw.weight_decay)
    w = max(range(len(floor)), key=lambda i: floor[i][1])
    print(f"  [15] floor after step 2: 2 microbatches against 1: worst "
          f"share past one ulp + 0.05 sum(lr) {floor[w][1]:.3e} (leaf {w}), "
          f"max|diff| {max(x[2] for x in floor):.3e}, "
          f"{sum(x[0] for x in floor)} elements past the steps' bound")
    return ref[1], snaps, one, one_bytes, floor


def mesh15_phase(card, kflash, kernel_mods, faults=False):
    """Phase 15 (b)-(d): the 12-layer cut of full-width qwen3-next-gdn.
    Two gloo ranks on card 0 start first and draw (b)'s shards while the
    one-device yardsticks run here (``_yardsticks15``); then the ranks
    run (b), (c) and (d)'s mesh part.  Once (c) is written, the
    parameters of (b) and (c) are read and measured here, and (d)'s
    one-device part restores (b)'s checkpoint into the kept yardstick
    trainer and steps, while the ranks run (d).  ``faults``: the ranks
    then run ``FAULTS15``, and each one's distance from the one-device
    run is printed beside the rule's.  Returns the flash launches per
    rank of (b) and (c), keyed by phase 2's local-shape rows."""
    import torch.multiprocessing as mp
    from repro_torch.checkpoint.manager import CheckpointManager, restore
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.parallel import sharding as rules
    from repro_torch.runtime.trainer import make_schedule
    cfg = _mesh15_cfg()
    tc = _train15_tc(MESH15_STEPS)
    wd = tc.adamw.weight_decay
    lrs = [float(make_schedule(tc)(s)) for s in range(MESH15_STEPS)]
    print(f"  [15] (b)-(d): {cfg.name} cut to {MESH15_LAYERS} layers, "
          f"{rules.estimate_params(cfg) / 1e9:.3f} B params (x 14 B = "
          f"{rules.estimate_params(cfg) * 14 / 1e9:.2f} GB: FSDP at model 1 "
          f"by the rule, not at model 2); lr per step {lrs}")
    folder = tempfile.TemporaryDirectory(dir=ROOT / "build")
    try:
        ctx = mp.get_context("spawn")
        q, go, c_done = ctx.Queue(), ctx.Event(), ctx.Event()
        port = mesh_mod.free_port()
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_train15_rank,
                             args=(r, port, folder.name, q, faults, go,
                                   c_done))
                 for r in range(2)]
        for p in procs:
            p.start()
        try:
            ref, snaps, one, one_bytes, floor = _yardsticks15(cfg, tc, lrs,
                                                              card)
            like = tree_like(one.state["params"])
            go.set()
            end = time.monotonic() + 900
            while not c_done.wait(5):
                if time.monotonic() > end or not all(p.is_alive()
                                                     for p in procs):
                    break
            if c_done.is_set():
                dists, one_d = _early15(folder.name, like, snaps, lrs, wd,
                                        one, ref)
            del one
            gc.collect()
            torch.cuda.empty_cache()
            res = _rank_results(procs, q, 900)
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
        for r, out in res.items():
            if "error" in out:
                raise AssertionError(f"[15] rank {r}:\n{out['error']}")
        print(f"  [15] two gloo ranks on card 0 (spawn, draws, (b), (c), "
              f"(d){', the faults' if faults else ''}) took "
              f"{time.perf_counter() - t0:.1f} s, the one-device "
              f"yardsticks and checks alongside")

        # (b)'s checkpoint: the whole state, written by rank 0
        ck = CheckpointManager(f"{folder.name}/b")
        with open(pathlib.Path(folder.name) / "b" / "step_000000002" /
                  "manifest.json") as f:
            manifest = json.load(f)
        print(f"  [15] (b) checkpoint: step {ck.latest_step()}, "
              f"{manifest['nbytes'] / 1e9:.3f} GB in "
              f"{len(manifest['keys'])} arrays (the one device's state: "
              f"{one_bytes / 1e9:.3f} GB)")
        if ck.latest_step() != 2 or manifest["nbytes"] != one_bytes:
            raise AssertionError("[15] (b): the checkpoint is incomplete")

        launches = {}
        n_attn = sum(k == "attn" for k in cfg.layer_kinds)
        for label, shape, row, fsdp in (("b", "(2,1)", "data2", True),
                                        ("c", "(1,2)", "model2", False),
                                        ("d", "(1,2)", None, False)):
            outs = [res[r][label] for r in range(2)]
            first = outs[0]["steps"]
            if any([dict(s, seconds=0, collective_s=0) for s in o["steps"]]
                   != [dict(s, seconds=0, collective_s=0) for s in first]
                   for o in outs[1:]):
                raise AssertionError(f"[15] ({label}): the ranks' metrics "
                                     f"differ")
            for r, o in enumerate(outs):
                if o["fsdp"] is not fsdp:
                    raise AssertionError(f"[15] ({label}): needs_fsdp "
                                         f"{o['fsdp']}, not {fsdp}")
                _print_rank15(label, shape, r, o, one_bytes, card)
            start = outs[0]["start"]
            for i, s in enumerate(first):
                r1 = ref[start + i]
                dl = abs(s["loss"] - r1["loss"]) / abs(r1["loss"])
                dn = abs(s["grad_norm"] - r1["grad_norm"]) / r1["grad_norm"]
                print(f"  [15] ({label}) step {start + i + 1}: loss "
                      f"{s['loss']:.6f} against {r1['loss']:.6f} ({dl:.3e}, "
                      f"limit 1e-2), grad norm {s['grad_norm']:.6f} against "
                      f"{r1['grad_norm']:.6f} ({dn:.3e}, limit 2e-2), aux "
                      f"{s['aux']}")
                if dl > 1e-2 or dn > 2e-2 or s["aux"] != r1["aux"]:
                    raise AssertionError(f"[15] ({label}): step "
                                         f"{start + i + 1} leaves the "
                                         f"one-device step")
            end = start + len(first)
            if label == "d":
                dist = param_distance(
                    restore(like, f"{folder.name}/d_params", end),
                    *snaps[1, end], lrs[:end], wd)
                two = None
            else:
                dist, two = dists[label]
            share, leaf, dmax = check_params(f"[15] ({label})", dist)
            msg = (f"  [15] ({label}) parameters after step {end} against "
                   f"the one device's: max|diff| {dmax:.3e}; worst share "
                   f"past one ulp + 0.05 sum(lr) {share:.3e} (leaf {leaf}; "
                   f"limit {SHARP_LIMIT})")
            if two is not None:
                msg += (f"; the floor's there {floor[leaf][1]:.3e}; "
                        f"against the 2-microbatch run, worst share "
                        f"{two:.3e}")
                if label == "b" and two > 1e-3:
                    raise AssertionError("[15] (b): the (2,1) step leaves "
                                         "the 2-microbatch step it matches")
            print(msg + ": within the rule")
            if row is not None:
                want_l = {"flash_fwd": 2 * n_attn * len(first),
                          "flash_bwd_dq": n_attn * len(first),
                          "flash_bwd_dkv": n_attn * len(first)}
                for r, o in enumerate(outs):
                    if o["launches"] != want_l:
                        raise AssertionError(f"[15] ({label}) rank {r}: "
                                             f"flash launches "
                                             f"{o['launches']}, not "
                                             f"{want_l}")
                for k, n in want_l.items():
                    launches[f"{k}_{row}"] = n

        start, m, r3, dist = one_d
        dl = abs(m["loss"] - r3["loss"]) / abs(r3["loss"])
        dn = abs(m["grad_norm"] - r3["grad_norm"]) / r3["grad_norm"]
        share, _, dmax = check_params("[15] (d) one device", dist)
        print(f"  [15] (d) (2,1)'s step-{start} checkpoint into one device "
              f"[{card}]: step {start + 1} loss {m['loss']:.6f} against "
              f"{r3['loss']:.6f} ({dl:.3e}), grad norm {m['grad_norm']:.6f}"
              f" against {r3['grad_norm']:.6f} ({dn:.3e}); parameters "
              f"max|diff| {dmax:.3e}, worst share past the tight bound "
              f"{share:.3e}: within the rule")
        if start != 2 or dl > 1e-2 or dn > 2e-2:
            raise AssertionError("[15] (d): the restored one-device step "
                                 "leaves the unbroken run's")
        for fault, shape in FAULTS15.items() if faults else ():
            _print_rank15(fault, shape, 0, res[0][fault], one_bytes, card)
            dist = param_distance(restore(like, f"{folder.name}/{fault}"
                                          f"_params", 2), *snaps[1, 2],
                                  lrs[:2], wd)
            share = sorted((x[1] for x in dist), reverse=True)
            print(f"  [15] fault {fault} on {shape}: {sum(x[0] for x in dist)}"
                  f" elements past the steps' bound; worst shares past the "
                  f"tight bound {[f'{x:.3e}' for x in share[:5]]}; leaves "
                  f"past {SHARP_LIMIT}: "
                  f"{sum(x[1] > SHARP_LIMIT for x in dist)} of {len(dist)}; "
                  f"max|diff| {max(x[2] for x in dist):.3e}")
    finally:
        folder.cleanup()
    return launches


# ---------------------------------------------------------------- phase 16

# the model axis in training for the other kinds: each arch at full width
# with its depth cut, its seq_len and global batch (recurrentgemma-2b and
# h2o-danube-1.8b past their windows), 2 steps of phase 15's schedule
# (warmup 1: step 1 at lr 0); "flash": its FLASH16 row at one device;
# "arch": the arch where the key is not one; "dtype": the activation dtype
# where not the arch's (mamba2 at 12 layers in bf16: its one-device run
# with a forward one bit off leaves itself past the rule, so no layout
# can be held to it there); "witness": that one-bit-off run made beside
# the yardstick, whose distance must read under the rule for the
# arch's check to mean anything (mamba2 in bf16 at 2 layers)
MESH16 = {
    "mamba2-1.3b": dict(layers=12, seq=2048, batch=1, flash=None,
                        dtype="float32"),
    "mamba2-1.3b-bf16": dict(arch="mamba2-1.3b", layers=2, seq=2048,
                             batch=1, flash=None, witness=True),
    "recurrentgemma-2b": dict(layers=3, seq=4096, batch=1, flash="gemma"),
    "h2o-danube-1.8b": dict(layers=2, seq=4608, batch=1, flash="danube"),
    "mixtral-8x7b": dict(layers=1, seq=2048, batch=2, flash=None),
}
MESH16_STEPS = 2
# the local rows of FLASH16 each arch's ranks launch at
MESH16_LOCAL = {"recurrentgemma-2b": "gemma_model2",
                "h2o-danube-1.8b": "danube_model2",
                "mixtral-8x7b": "mixtral_model2"}
# the planted fault of phase 16 (``--mesh-train-faults``): mixtral's run
# with the router's gradient summed over "model" with the aux term inside
# the sum (the router reading the FFN input after ``copy_to``, the combine
# gates' gradient left partial, the router leaf's whole gradient
# all-reduced): the aux term counts twice at model 2
FAULTS16 = {"router_sum": "mixtral-8x7b"}


def _mesh16_cfg(key):
    from repro_torch import configs
    m = MESH16[key]
    cfg = configs.get_arch(m.get("arch", key)).replace(
        n_layers=m["layers"], use_flash_kernel=True)
    return cfg.replace(act_dtype=m["dtype"]) if "dtype" in m else cfg


def _train16_tc(key):
    from repro_torch.runtime.trainer import TrainerConfig
    m = MESH16[key]
    return TrainerConfig(steps=MESH16_STEPS, seq_len=m["seq"],
                         global_batch=m["batch"], warmup_steps=1,
                         log_every=1)


def _plant16(fault):
    """Break the MoE's expert-parallel backward in this process by
    ``fault`` (``FAULTS16``); returns the undo."""
    from repro_torch.models import moe
    from repro_torch.parallel import comm
    real = moe.moe_fwd

    def summed(p, x, route=None, **kw):
        p = dict(p, router=comm.copy_to(comm.model_axis(), p["router"]))
        copy_to = comm.copy_to
        comm.copy_to = lambda axis, t: t      # the gates' sum left out
        try:
            return real(p, x, **kw)           # the router reads x
        finally:
            comm.copy_to = copy_to
    moe.moe_fwd = summed
    return lambda: setattr(moe, "moe_fwd", real)


def _train16_rank(rank, port, folder, q, faults, go):
    """A gloo rank of phase 16 on card 0: each arch of ``MESH16`` trained
    on (1,2), its shards drawn alone from seed 0, 2 eager steps, its
    parameter shards saved (``_save_shards16``); with ``faults`` then
    ``FAULTS16``'s runs.  The first arch (mamba2, ~7 GB per rank) runs
    beside the parent's one-device yardsticks; the second waits for the
    parent's ``go`` (the yardsticks peak at 40 GB)."""
    import traceback
    import torch.distributed as dist
    out = {}
    try:
        torch.cuda.set_device(0)
        from repro_torch.kernels import flash_attn as kflash
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.runtime.trainer import Trainer
        from repro_torch.tree import leaves
        mesh_mod.init_ranks(rank, 2, port, "gloo")
        mesh = mesh_mod.make_local_mesh(1, 2)
        runs = [(arch, arch) for arch in MESH16]
        if faults:
            runs += list(FAULTS16.items())
        for i, (label, arch) in enumerate(runs):
            t0 = time.perf_counter()
            tr = Trainer(_mesh16_cfg(arch), _train16_tc(arch), mesh=mesh,
                         device="cuda").compile()
            undo = _plant16(label) if label in FAULTS16 else None
            torch.cuda.synchronize()
            ready = time.perf_counter() - t0
            if i == 1:
                go.wait()
            for key in kflash.launches:
                kflash.launches[key] = 0
            torch.cuda.reset_peak_memory_stats()
            steps = _train15_steps(tr, 0, MESH16_STEPS)
            o = dict(steps=steps, start=0, ready_s=ready, fsdp=tr.fsdp,
                     launches=dict(kflash.launches),
                     allocated=torch.cuda.memory_allocated(),
                     peak=torch.cuda.max_memory_allocated(),
                     state_bytes=sum(t.nbytes for t in leaves(tr.state)))
            if undo is not None:
                undo()
            t0 = time.perf_counter()
            _save_shards16(tr, f"{folder}/{label}_{rank}.pt")
            o["save_s"] = time.perf_counter() - t0
            out[label] = o
            del tr
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        out["error"] = traceback.format_exc()
    q.put((rank, out))


def _hold_steps(tag, outs, ref):
    """Phase 15's rule for the metrics of a mesh run's ranks ``outs``
    against the one-device steps ``ref``: the ranks' metrics equal, each
    step's loss within 1e-2 and grad norm within 2e-2 relative, aux within
    1e-2 (and 0 where the one device's is)."""
    first = outs[0]["steps"]
    if any([dict(s, seconds=0, collective_s=0) for s in o["steps"]]
           != [dict(s, seconds=0, collective_s=0) for s in first]
           for o in outs[1:]):
        raise AssertionError(f"{tag}: the ranks' metrics differ")
    for i, (s, r1) in enumerate(zip(first, ref)):
        dl = abs(s["loss"] - r1["loss"]) / abs(r1["loss"])
        dn = abs(s["grad_norm"] - r1["grad_norm"]) / r1["grad_norm"]
        da = abs(s["aux"] - r1["aux"]) / max(abs(r1["aux"]), 1e-30)
        print(f"  {tag} step {i + 1}: loss {s['loss']:.6f} against "
              f"{r1['loss']:.6f} ({dl:.3e}, limit 1e-2), grad norm "
              f"{s['grad_norm']:.6f} against {r1['grad_norm']:.6f} "
              f"({dn:.3e}, limit 2e-2), aux {s['aux']} against {r1['aux']}")
        if dl > 1e-2 or dn > 2e-2 or (r1["aux"] and da > 1e-2) or \
                (not r1["aux"] and s["aux"]):
            raise AssertionError(f"{tag}: step {i + 1} leaves the "
                                 f"one-device step")


def _hold_witness(tag, wd):
    """The witness's distance ``wd`` (``param_distance`` of the one-device
    run with a forward one bit off against the one device's) within the
    rule, or the rule cannot hold a mesh at this depth."""
    w = max(range(len(wd)), key=lambda i: wd[i][1])
    print(f"  {tag}: the one-device run with a forward one bit off (the "
          f"witness) against the one device's: worst share {wd[w][1]:.3e} "
          f"(leaf {w}), {sum(x[0] for x in wd)} elements past the steps' "
          f"bound, max|diff| {max(x[2] for x in wd):.3e}")
    if wd[w][1] > SHARP_LIMIT or any(x[0] for x in wd):
        raise AssertionError(f"{tag}: the witness leaves the rule, so the "
                             f"rule cannot hold the mesh at this depth")


def _save_shards16(tr, path):
    """This rank's parameter shards on the host, each with the dim the
    model axis splits (None: replicated), for ``_whole16``."""
    from repro_torch.parallel import sharding as rules
    from repro_torch.tree import leaves
    out = []
    for t, spec in zip(leaves(tr.state["params"]),
                       leaves(tr.specs["params"])):
        names = rules.dim_axes(spec, t.dim())
        dim = next((d for d, ns in enumerate(names) if "model" in ns), None)
        out.append((t.detach().cpu(), dim))
    torch.save(out, path)


def _whole16(folder, label, ranks=2):
    """The whole parameters of a (1, ``ranks``) run from its ranks' saved
    shards: the split leaves concatenated in rank order, the others
    rank 0's."""
    parts = [torch.load(f"{folder}/{label}_{r}.pt") for r in range(ranks)]
    return [xs[0][0] if xs[0][1] is None else
            torch.cat([x for x, _ in xs], xs[0][1]) for xs in zip(*parts)]


def _flip16(tr):
    """The witness's forward one bit off: the lowest mantissa bit of 1 in
    1024 entries of the trainer's embedding table flipped."""
    table = tr.state["params"]["embed"]["table"].detach()
    flip = torch.rand(table.shape, generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda") < 1 / 1024
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[
        table.dtype]
    table.copy_((table.view(bits) ^ flip.to(bits)).view(table.dtype))


def _run16(key, flip=False):
    """A one-device eager trainer of ``key`` (``flip``: ``_flip16`` before
    step 1) after its 2 steps, and the per-step metrics."""
    from repro_torch.runtime.trainer import Trainer
    one = Trainer(_mesh16_cfg(key), _train16_tc(key), device="cuda",
                  cuda_graphs=False).compile()
    if flip:
        _flip16(one)
    ref = []
    for step in range(MESH16_STEPS):
        one.batch(step)
        t1 = time.perf_counter()
        m = one.step()
        ref.append(dict({k: float(v) for k, v in m.items()},
                        seconds=time.perf_counter() - t1))
    return one, ref


def _yardsticks16(card, kflash):
    """Each arch's one-device eager trainer of the same depth, seed and
    batch, 2 steps: {key: (per-step metrics, (params, first moments) on
    the host after the last step, state bytes, flash launches, peak, the
    witness's parameters on the host or None)}."""
    from repro_torch.tree import leaves
    out = {}
    for arch in MESH16:
        t0 = time.perf_counter()
        for key in kflash.launches:
            kflash.launches[key] = 0
        torch.cuda.reset_peak_memory_stats()
        one, ref = _run16(arch)
        nbytes = sum(t.nbytes for t in leaves(one.state))
        peak = torch.cuda.max_memory_allocated()
        snap = _snapshot(one)
        launched = dict(kflash.launches)
        witness = None
        if MESH16[arch].get("witness"):
            del one
            one, _ = _run16(arch, flip=True)
            witness = _snapshot(one)[0]
        out[arch] = (ref, snap, nbytes, launched, peak, witness)
        print(f"  [16] {arch} at {MESH16[arch]['layers']} layers, one "
              f"device, eager [{card}]: {nbytes / 1e9:.3f} GB of state, "
              f"peak {peak / 1e9:.2f} GB; steps "
              f"{[round(r['seconds'], 4) for r in ref]} s; losses "
              f"{[r['loss'] for r in ref]}; grad norms "
              f"{[r['grad_norm'] for r in ref]}; aux "
              f"{[r['aux'] for r in ref]}; flash launches "
              f"{out[arch][3]} ({time.perf_counter() - t0:.1f} s)")
        del one
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _attn_layers(arch):
    from repro_torch.models.mixers import get_mixer
    return sum(get_mixer(k).is_attention
               for k in _mesh16_cfg(arch).layer_kinds)


def mesh16_phase(card, kflash, faults=False):
    """Phase 16: every kind but gdn and attn, and the MoE's experts,
    trained on a (1,2) mesh over two gloo ranks sharing card 0 (``MESH16``,
    ``use_flash_kernel`` on), each held against the one-device eager run
    of the same depth and seed by phase 15's rule: each step's loss
    within 1e-2 and grad norm within 2e-2 relative (aux too), every
    parameter within the steps' bound, at most ``SHARP_LIMIT`` of each
    leaf's sharp elements past the tight bound.  ``faults``: the ranks
    then run ``FAULTS16``, which the rule must refuse.  Returns the flash
    launches of the yardsticks and of a rank, keyed by phase 2's
    ``FLASH16`` rows."""
    import torch.multiprocessing as mp
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.runtime.trainer import make_schedule
    folder = tempfile.TemporaryDirectory(dir=ROOT / "build")
    launches = {}
    try:
        ctx = mp.get_context("spawn")
        q, go = ctx.Queue(), ctx.Event()
        port = mesh_mod.free_port()
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_train16_rank,
                             args=(r, port, folder.name, q, faults, go))
                 for r in range(2)]
        for p in procs:
            p.start()
        try:
            ones = _yardsticks16(card, kflash)
            go.set()
            res = _rank_results(procs, q, 900)
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
        for r, out in res.items():
            if "error" in out:
                raise AssertionError(f"[16] rank {r}:\n{out['error']}")
        print(f"  [16] two gloo ranks on card 0 (spawn, draws, "
              f"{len(res[0])} runs) took {time.perf_counter() - t0:.1f} s, "
              f"the one-device yardsticks beside the first")
        shares = {}
        runs = [(arch, arch) for arch in MESH16]
        runs += list(FAULTS16.items()) if faults else []
        for label, arch in runs:
            ref, (want, mu), one_bytes, one_l, _, witness = ones[arch]
            outs = [res[r][label] for r in range(2)]
            for r, o in enumerate(outs):
                _print_rank15(label, "(1,2)", r, o, one_bytes, card, "16")
            tc = _train16_tc(arch)
            lrs = [float(make_schedule(tc)(s)) for s in range(MESH16_STEPS)]
            dist = param_distance(_whole16(folder.name, label), want, mu,
                                  lrs, tc.adamw.weight_decay)
            if label in FAULTS16:
                share = sorted((x[1] for x in dist), reverse=True)
                shares[label] = share[0]
                print(f"  [16] fault {label} on (1,2) ({arch}): "
                      f"{sum(x[0] for x in dist)} elements past the steps' "
                      f"bound; worst shares past the tight bound "
                      f"{[f'{x:.3e}' for x in share[:5]]}; leaves past "
                      f"{SHARP_LIMIT}: "
                      f"{sum(x[1] > SHARP_LIMIT for x in dist)} of "
                      f"{len(dist)}; max|diff| "
                      f"{max(x[2] for x in dist):.3e}; the sound run's "
                      f"worst share {shares[arch]:.3e}")
                if not any(x[0] for x in dist) and share[0] <= SHARP_LIMIT:
                    raise AssertionError(f"[16] fault {label}: within the "
                                         f"rule")
                continue
            _hold_steps(f"[16] {arch}", outs, ref)
            if witness is not None:
                _hold_witness(f"[16] {arch}", param_distance(
                    witness, want, mu, lrs, tc.adamw.weight_decay))
            share, leaf, dmax = check_params(f"[16] {arch}", dist)
            shares[arch] = share
            print(f"  [16] {arch} parameters after step {MESH16_STEPS} "
                  f"against the one device's: max|diff| {dmax:.3e}; worst "
                  f"share past one ulp + 0.05 sum(lr) {share:.3e} (leaf "
                  f"{leaf}; limit {SHARP_LIMIT}): within the rule")
            n_attn = _attn_layers(arch)
            # remat runs each forward twice
            fwd = 2 if _mesh16_cfg(arch).remat else 1
            want_l = {"flash_fwd": fwd * n_attn * MESH16_STEPS,
                      "flash_bwd_dq": n_attn * MESH16_STEPS,
                      "flash_bwd_dkv": n_attn * MESH16_STEPS}
            for who, got_l in [("one device", one_l)] + [
                    (f"rank {r}", o["launches"]) for r, o in
                    enumerate(outs)]:
                if got_l != want_l:
                    raise AssertionError(f"[16] {arch} {who}: flash "
                                         f"launches {got_l}, not {want_l}")
            for k, n in want_l.items():
                if MESH16[arch]["flash"]:
                    launches[f"{k}_{MESH16[arch]['flash']}"] = n
                if arch in MESH16_LOCAL:
                    launches[f"{k}_{MESH16_LOCAL[arch]}"] = n
    finally:
        folder.cleanup()
    return launches


# ---------------------------------------------------------------- phase 19

# fit_spec's moves of the model axis at full width, on gloo ranks sharing
# card 0 (one world of MOVES19_WORLD ranks, started once):
# (a) minicpm-2b on (1,2), its vocabulary of 122,753 (which no axis
#     divides) on d_model: the table looked up and gathered along it, the
#     tied logits row-parallel (``MESH_SERVED``: phase 4's settings);
# (b) minicpm-2b trained through the flash kernels, 2 steps: at (1,2) at
#     the least depth at which ``needs_fsdp`` turns FSDP on (the table then
#     replicated over "model"), and at (1,4) at 2 layers (the table on
#     d_model, no FSDP; 512 tokens, since the tied logits' fp32 partial
#     sums over the whole vocabulary cross the axis), each beside a
#     one-device witness whose forward is one bit off (``_flip16``),
#     which must itself read within the rule;
# (c) on (1,16): mamba2-1.3b at 2 of 48 layers (the table and ``lm_head``
#     on d_model; its depth cut for the time: at 12 layers a prefill and
#     a decode step took 30.9 s, 75 collectives of 0.4 s each through the
#     host with 16 ranks on 8 cores), mixtral-8x7b at 1 of 32 layers (the experts
#     on d_ff, ``wo`` on d_model) and arctic-480b at 1 of 35 layers (q, k
#     and v on head_dim, ``wo`` on d_model; ~28 GB at one device).
MOVES19_WORLD = 16
MOVES19_B = {
    "minicpm_fsdp_1x2": dict(mesh=(1, 2), layers=None, seq=2048,
                             flash="minicpm_model2", fsdp=True),
    "minicpm_1x4": dict(mesh=(1, 4), layers=2, seq=512,
                        flash="minicpm_model4", fsdp=False, witness=True)}
MOVES19_C = {"mamba2-1.3b": 2, "mixtral-8x7b": 1, "arctic-480b": 1}
MOVES19_C_STEP = (4, 64, 128)        # rows, prompt tokens (one chunk), max_len
# the GDN kernels' local shape of mamba2-1.3b on (1,16): 4 of 64 heads
MAMBA2_MODEL16 = dict(MAMBA2, Hv=MAMBA2["Hv"] // 16)
PREFILL_MAMBA2_MODEL16 = (MAMBA2["Hk"], MAMBA2_MODEL16["Hv"], MAMBA2["d_k"],
                          MAMBA2["d_v"], torch.bfloat16)
PREFILL_MAMBA2_MODEL16_CASES = tuple(
    c[:4] + (PREFILL_MAMBA2_MODEL16,) for c in PREFILL_MAMBA2_CASES)
# (b)'s flash shapes at hd 64: the (1,2) and (1,4) ranks' local heads of
# minicpm-2b's 48 (36 padded to 48, MHA)
FLASH19 = {"minicpm_model2": dict(B=1, T=2048, Hq=24, Hkv=24, hd=64),
           "minicpm_model4": dict(B=1, T=512, Hq=12, Hkv=12, hd=64)}


def moves19_rows(ops, ref, kdecode, kprefill, kflash, time_launches):
    """Phase 2's rows at phase 19's local shapes: both GDN kernels at
    mamba2-1.3b's (1,16) shard (no delta rule), the flash kernels at
    ``FLASH19``."""
    shape = tuple(MAMBA2_MODEL16[k] for k in ("B", "Hk", "Hv", "d_k", "d_v"))
    rows = [decode_phase(ref, kdecode, time_launches,
                         "gdn_decode_mamba2_model16", shape,
                         delta_rules=(False,)),
            prefill_phase(ops, ref, kprefill, time_launches,
                          "gdn_prefill_mamba2_model16",
                          PREFILL_MAMBA2_MODEL16_CASES,
                          PREFILL_MAMBA2_MODEL16 + (False,))]
    gen = torch.Generator(device="cuda").manual_seed(19)
    for suffix, sh in FLASH19.items():
        x = _flash_inputs(sh["B"], sh["T"], sh["Hq"], sh["Hkv"], sh["hd"],
                          torch.bfloat16, gen)
        e = _flash_check(ref, kflash, f"flash {suffix} {sh}", *x)
        rows += _flash_timed(ref, kflash, time_launches, sh, x,
                             f"_{suffix}", [max(v) for v in e])
    return rows


def _moves19_cfg(label):
    """(b)'s minicpm-2b config: its depth, the flash kernels on."""
    from repro_torch import configs
    spec = MOVES19_B[label]
    cfg = configs.get_arch("minicpm-2b").replace(use_flash_kernel=True)
    cfg = cfg.replace(n_layers=spec["layers"] or _least_fsdp_depth(cfg))
    return cfg.replace(act_dtype=spec["dtype"]) if "dtype" in spec else cfg


def _least_fsdp_depth(cfg):
    """The least depth at which ``needs_fsdp`` holds on (1,2)."""
    from types import SimpleNamespace
    from repro_torch.parallel import sharding as rules
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 1, "model": 2})
    return next(n for n in range(1, cfg.n_layers + 1)
                if rules.needs_fsdp(cfg.replace(n_layers=n), mesh))


def _moves19_tc(label):
    from repro_torch.runtime.trainer import TrainerConfig
    return TrainerConfig(steps=2, seq_len=MOVES19_B[label]["seq"],
                         global_batch=1, warmup_steps=1, log_every=1)


def _moves19_wide_cfg(arch):
    from repro_torch import configs
    cfg = configs.get_arch(arch).replace(n_layers=MOVES19_C[arch])
    return cfg.replace(use_pallas_serving=True) if arch == "mamba2-1.3b" \
        else cfg


def _moves19_caches(lm, cfg, mesh=None):
    """Zeroed caches of (c)'s rows and ``max_len``: on ``mesh`` this
    rank's shards (the slot specs)."""
    from repro_torch.parallel import comm
    from repro_torch.parallel import sharding as rules
    B, _, max_len = MOVES19_C_STEP
    spec = lm.cache_specs(cfg, B, max_len)
    if mesh is None:
        return spec.zeros("cuda")
    sizes = comm.MeshAxes(mesh).sizes
    return rules.map_specs(
        lambda s, p: torch.zeros(rules.local_shape(s.shape, p, sizes),
                                 dtype=s.dtype, device="cuda"),
        spec.tree, rules.slot_specs(cfg, mesh, spec.tree, B))


def _moves19_step(lm, params, cfg, caches, toks, tok, axes=None):
    """One prefill of ``toks`` (one chunk) into ``caches``, then one
    decode step of ``tok`` (``axes``: the mesh active): the logits on the
    host."""
    from repro_torch.parallel import comm
    with comm.use(axes):
        lm.prefill_chunk(params, cfg, caches, tokens=toks)
        logits, _ = lm.decode_step(params, cfg, tok, caches)
    return logits.float().cpu()


def _moves19_wide(arch, mesh, folder, lm):
    """(c) on this rank: its shards of ``arch`` drawn alone from seed 0,
    the bytes they and the caches take, one prefill and one decode step
    on the parent's tokens, the collectives and GDN launches of both."""
    from repro_torch.parallel import comm
    cfg = _moves19_wide_cfg(arch)
    toks, tok = (t.cuda() for t in torch.load(f"{folder}/tokens19_{arch}.pt"))
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    out = {"draw_s": time.perf_counter() - t0,
           "params_bytes": torch.cuda.memory_allocated() - a0}
    caches = _moves19_caches(lm, cfg, mesh)
    torch.cuda.synchronize()
    out["allocated"] = torch.cuda.memory_allocated() - a0
    zero_launches()
    comm.reset_stats()
    t0 = time.perf_counter()
    out["logits"] = _moves19_step(lm, params, cfg, caches, toks, tok,
                                  comm.MeshAxes(mesh)).numpy()
    out.update(step_s=time.perf_counter() - t0,
               peak=torch.cuda.max_memory_allocated(),
               collectives=comm.stats["calls"],
               collective_s=comm.stats["seconds"], launches=gdn_counts())
    return out


def _moves19_train(label, mesh, folder, kflash, rank):
    """(b) on this rank: the trainer on ``mesh``, its shards drawn alone,
    2 eager steps, its parameter shards saved for the parent."""
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.tree import leaves
    t0 = time.perf_counter()
    tr = Trainer(_moves19_cfg(label), _moves19_tc(label), mesh=mesh,
                 device="cuda").compile()
    torch.cuda.synchronize()
    ready = time.perf_counter() - t0
    for key in kflash.launches:
        kflash.launches[key] = 0
    torch.cuda.reset_peak_memory_stats()
    steps = _train15_steps(tr, 0, 2)
    o = dict(steps=steps, start=0, ready_s=ready, fsdp=tr.fsdp,
             launches=dict(kflash.launches),
             allocated=torch.cuda.memory_allocated(),
             peak=torch.cuda.max_memory_allocated(),
             state_bytes=sum(t.nbytes for t in leaves(tr.state)),
             embed=tuple(tr.state["params"]["embed"]["table"].shape))
    t0 = time.perf_counter()
    _save_shards16(tr, f"{folder}/{label}_{rank}.pt")
    o["save_s"] = time.perf_counter() - t0
    return o


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def _moves19_rank(rank, port, folder, q, go):
    """A gloo rank of phase 19 on card 0: (a) on ranks 0-1, (b) on 0-1
    then 0-3, (c) on all, a barrier between the parts."""
    import traceback
    import torch.distributed as dist
    out = {}
    try:
        torch.cuda.set_device(0)
        from repro_torch import configs
        from repro_torch.kernels import flash_attn as kflash
        from repro_torch.kernels import gdn_decode as kdecode
        from repro_torch.kernels import gdn_prefill as kprefill
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.models import lm
        from repro_torch.serving import engine as engine_mod
        seen = set()
        _kernel_shapes(kdecode, kprefill, seen)
        mesh_mod.init_ranks(rank, MOVES19_WORLD, port, "gloo")
        # every rank builds every mesh (its groups are collective)
        meshes = {m: mesh_mod.make_serving_mesh(*m)
                  for m in ((1, 2), (1, 4), (1, MOVES19_WORLD))}
        go.wait()
        if meshes[1, 2].get_coordinate() is not None:
            out["a"] = _mesh14_serve("minicpm-2b", meshes[1, 2], folder,
                                     configs, lm, engine_mod)
        _free()
        dist.barrier()
        for label, spec in MOVES19_B.items():
            if meshes[spec["mesh"]].get_coordinate() is not None:
                out[label] = _moves19_train(label, meshes[spec["mesh"]],
                                            folder, kflash, rank)
            _free()
            dist.barrier()
        for arch in MOVES19_C:
            seen.clear()
            out[arch] = _moves19_wide(arch, meshes[1, MOVES19_WORLD], folder,
                                      lm)
            out[arch]["kernel_shapes"] = sorted(seen)
            _free()
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        out["error"] = traceback.format_exc()
    q.put((rank, out))


def _moves19_yardsticks(card, lm, engine_mod, configs, folder, kflash):
    """The one-device runs, made while the ranks start: (c)'s steps (bf16
    through the arch's path, and fp32 activations on the same weights),
    (a)'s streams and fixed state, (b)'s two trainers.  Returns ({arch:
    {"one", "truth"}}, (a)'s streams and fixed step, {label: (per-step
    metrics, (params, first moments), state bytes, flash launches, the
    witness's parameters on the host or None)})."""
    from repro_torch.tree import leaves
    B, T, _ = MOVES19_C_STEP
    gen = torch.Generator().manual_seed(19)
    wide = {}
    for arch in MOVES19_C:
        cfg = _moves19_wide_cfg(arch)
        toks = torch.randint(1, cfg.vocab, (B, T), generator=gen)
        tok = torch.randint(1, cfg.vocab, (B,), generator=gen)
        torch.save((toks, tok), f"{folder}/tokens19_{arch}.pt")
        toks, tok = toks.cuda(), tok.cuda()
        t0 = time.perf_counter()
        params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0),
                            cfg, device="cuda")
        one = _moves19_step(lm, params, cfg, _moves19_caches(lm, cfg), toks,
                            tok)
        f32 = cfg.replace(use_pallas_serving=False, act_dtype="float32")
        truth = _moves19_step(lm, params, f32, _moves19_caches(lm, f32),
                              toks, tok)
        wide[arch] = dict(one=one, truth=truth)
        print(f"  [19] (c) {arch} at {cfg.n_layers} layers, one device: "
              f"{lm.param_count(params) / 1e9:.3f} B params, a "
              f"{T}-token prefill and a decode step in bf16 and with fp32 "
              f"activations, peak {torch.cuda.max_memory_allocated() / 1e9:.2f}"
              f" GB ({time.perf_counter() - t0:.1f} s)")
        del params
        _free()
        torch.cuda.reset_peak_memory_stats()
    cfg = mesh14_config(configs, "minicpm-2b")
    params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    eng = engine_mod.DecodeEngine(cfg, params, cuda_graphs=False,
                                  **MESH_SERVED["minicpm-2b"]["kw"])
    reqs = mesh14_requests(engine_mod.Request, "minicpm-2b", cfg.vocab)
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    plain = [list(r.output) for r in reqs]
    del eng
    step_a = fixed_step(cfg, params, lm, folder)
    del params
    _free()
    train = {}
    for label in MOVES19_B:
        for key in kflash.launches:
            kflash.launches[key] = 0
        t0 = time.perf_counter()
        one, ref = _run19(label)
        nbytes = sum(t.nbytes for t in leaves(one.state))
        snap, launched = _snapshot(one), dict(kflash.launches)
        witness = None
        if MOVES19_B[label].get("witness"):
            del one
            one, _ = _run19(label, flip=True)
            witness = _snapshot(one)[0]
        train[label] = (ref, snap, nbytes, launched, witness)
        print(f"  [19] (b) {label}: minicpm-2b at "
              f"{_moves19_cfg(label).n_layers} layers, one device, eager "
              f"[{card}]: {nbytes / 1e9:.3f} GB of state, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; losses "
              f"{[r['loss'] for r in ref]}; grad norms "
              f"{[r['grad_norm'] for r in ref]}; flash launches "
              f"{train[label][3]} ({time.perf_counter() - t0:.1f} s)")
        del one
        _free()
    return wide, (plain, step_a), train


def _run19(label, flip=False):
    """A one-device eager trainer of (b)'s ``label`` (``flip``: ``_flip16``
    before step 1) after its 2 steps, and the per-step metrics."""
    from repro_torch.runtime.trainer import Trainer
    one = Trainer(_moves19_cfg(label), _moves19_tc(label), device="cuda",
                  cuda_graphs=False).compile()
    if flip:
        _flip16(one)
    ref = []
    for step in range(2):
        one.batch(step)
        ref.append({k: float(v) for k, v in one.step().items()})
    return one, ref


def moves19_phase(card, lm, engine_mod, configs, kflash):
    """Phase 19: ``fit_spec``'s moves of the model axis at full width
    (the section's comment): the one-device yardsticks while the
    sixteen gloo ranks start, then (a), (b) and (c) on the ranks, each
    held against one device.  Returns the launches of a rank keyed by
    phase 2's rows (``gdn_*_mamba2_model16``, ``flash_*_minicpm_model2``
    / ``_model4``)."""
    import torch.multiprocessing as mp
    from types import SimpleNamespace
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps as steps_mod
    from repro_torch.runtime.trainer import make_schedule
    folder = tempfile.TemporaryDirectory(dir=ROOT / "build")
    launches = {}
    try:
        ctx = mp.get_context("spawn")
        q, go = ctx.Queue(), ctx.Event()
        port = mesh_mod.free_port()
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_moves19_rank,
                             args=(r, port, folder.name, q, go))
                 for r in range(MOVES19_WORLD)]
        for p in procs:
            p.start()
        try:
            wide, (plain_a, step_a), train = _moves19_yardsticks(
                card, lm, engine_mod, configs, folder.name, kflash)
            print(f"  [19] the one-device yardsticks took "
                  f"{time.perf_counter() - t0:.1f} s, the ranks starting "
                  f"beside them")
            go.set()
            res = _rank_results(procs, q, 900, "[19]")
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
        print(f"  [19] {MOVES19_WORLD} gloo ranks on card 0 (spawn, then "
              f"(a), (b), (c)) took {time.perf_counter() - t0:.1f} s")
        def model_mesh(m):
            return SimpleNamespace(axis_names=("data", "model"),
                                   shape={"data": 1, "model": m})

        # (a) minicpm-2b on (1,2)
        outs = [res[r]["a"] for r in range(2)]
        if outs[1]["streams"] != outs[0]["streams"]:
            raise AssertionError("[19] (a) minicpm-2b: the ranks' streams "
                                 "differ")
        cfg = mesh14_config(configs, "minicpm-2b")
        _, _, _, max_len = MESH_SERVED["minicpm-2b"]["step"]
        dry = steps_mod.count_cell(cfg, ShapeConfig("d", max_len, 4,
                                                     "decode"), model_mesh(2))
        for r, x in enumerate(outs):
            st = x["step"]
            print(f"  [19] (a) minicpm-2b (1,2) gloo mesh, eager, rank {r} "
                  f"[{card}]: shards of {x['params_bytes'] / 1e9:.2f} GB "
                  f"drawn in {x['draw_s']:.1f} s; decode "
                  f"{x['us_token']:.1f} us/token, mean TTFT "
                  f"{x['ttft_ms']:.1f} ms, {x['decode_steps']} decode steps "
                  f"in {x['ticks']} ticks; one decode step: "
                  f"{st['collectives']} collectives "
                  f"({st['collective_bytes']} B), "
                  f"{st['collective_s'] * 1e3:.1f} ms of "
                  f"{st['step_s'] * 1e3:.1f} ms in them, against "
                  f"launch.steps.count_cell's dry count "
                  f"{dry['collective_calls']} "
                  f"({dict(dry['collectives_by_axis'])} B by axis); "
                  f"allocated {x['allocated']} B (peak {x['peak']} B)")
            if st["collectives"] != dry["collective_calls"]:
                raise AssertionError(f"[19] (a) rank {r}: "
                                     f"{st['collectives']} collectives per "
                                     f"decode step, the dry count "
                                     f"{dry['collective_calls']}")
        print(f"  [19] (a) first token index leaving the 1-device streams, "
              f"per request (greedy): "
              f"{first_difference(outs[0]['streams'], plain_a[:2])}")
        for r in range(2):
            logit_rule(f"[19] (a) minicpm-2b rank {r}",
                       torch.from_numpy(res[r]["a"]["logits"]["mesh"]),
                       step_a["one"], step_a["truth"])

        # (b) minicpm-2b trained
        for label, spec in MOVES19_B.items():
            n = spec["mesh"][1]
            ref, (want, mu), one_bytes, one_l, witness = train[label]
            outs = [res[r][label] for r in range(n)]
            for r, o in enumerate(outs):
                _print_rank15(label, str(spec["mesh"]), r, o, one_bytes,
                              card, "19")
                if o["fsdp"] is not spec["fsdp"]:
                    raise AssertionError(f"[19] ({label}) rank {r}: fsdp "
                                         f"{o['fsdp']}")
            print(f"  [19] ({label}) the table's shard on a rank: "
                  f"{outs[0]['embed']} (fsdp {outs[0]['fsdp']}: "
                  f"{'replicated over model' if spec['fsdp'] else 'on d_model'})")
            tc = _moves19_tc(label)
            lrs = [float(make_schedule(tc)(s)) for s in range(2)]
            dist = param_distance(_whole16(folder.name, label, n), want, mu,
                                  lrs, tc.adamw.weight_decay)
            _hold_steps(f"[19] ({label})", outs, ref)
            if witness is not None:
                _hold_witness(f"[19] ({label})", param_distance(
                    witness, want, mu, lrs, tc.adamw.weight_decay))
            share, leaf, dmax = check_params(f"[19] ({label})", dist)
            print(f"  [19] ({label}) parameters after step 2 against the "
                  f"one device's: max|diff| {dmax:.3e}; worst share past "
                  f"one ulp + 0.05 sum(lr) {share:.3e} (leaf {leaf}; limit "
                  f"{SHARP_LIMIT}): within the rule")
            layers = _moves19_cfg(label).n_layers
            fwd = 2 if _moves19_cfg(label).remat else 1
            want_l = {"flash_fwd": fwd * layers * 2,
                      "flash_bwd_dq": layers * 2,
                      "flash_bwd_dkv": layers * 2}
            for who, got_l in [("one device", one_l)] + [
                    (f"rank {r}", o["launches"]) for r, o in
                    enumerate(outs)]:
                if got_l != want_l:
                    raise AssertionError(f"[19] ({label}) {who}: flash "
                                         f"launches {got_l}, not {want_l}")
            for k, v in want_l.items():
                launches[f"{k}_{spec['flash']}"] = v

        # (c) on (1,16)
        B, _, max_len = MOVES19_C_STEP
        for arch in MOVES19_C:
            cfg = _moves19_wide_cfg(arch)
            dry = steps_mod.count_cell(cfg, ShapeConfig(
                "d", max_len, B, "decode"), model_mesh(MOVES19_WORLD))
            args = dry["argument_bytes"]
            want_b = args["params"] + args["caches"]
            n_ssm = sum(k == "ssm" for k in cfg.layer_kinds)
            for r in range(MOVES19_WORLD):
                x = res[r][arch]
                ratio = x["allocated"] / want_b
                if r in (0, MOVES19_WORLD - 1):
                    print(f"  [19] (c) {arch} (1,{MOVES19_WORLD}) rank {r} "
                          f"[{card}]: params {x['params_bytes']} B drawn in "
                          f"{x['draw_s']:.1f} s, with the caches "
                          f"{x['allocated']} B allocated against the dry "
                          f"run's argument bytes {want_b} ({ratio:.4f}x; "
                          f"peak {x['peak']} B); prefill + decode step "
                          f"{x['step_s']:.2f} s, {x['collectives']} "
                          f"collectives ({x['collective_s']:.2f} s in "
                          f"them); GDN launches {x['launches']} at "
                          f"{x['kernel_shapes']}")
                if not np.array_equal(x["logits"], res[0][arch]["logits"]):
                    raise AssertionError(f"[19] (c) {arch}: rank {r}'s "
                                         f"logits differ from rank 0's")
                if abs(ratio - 1) > 0.01:
                    raise AssertionError(f"[19] (c) {arch} rank {r}: "
                                         f"allocated {ratio:.4f}x the dry "
                                         f"run's argument bytes")
                want_k = [("gdn_decode", 1, MAMBA2_MODEL16["Hv"], 128, 64),
                          ("gdn_prefill", MAMBA2_MODEL16["Hv"], 128, 64)] \
                    if n_ssm else []
                want_n = {"gdn_decode": n_ssm, "gdn_prefill": n_ssm}
                if x["kernel_shapes"] != sorted(want_k) or \
                        x["launches"] != want_n:
                    raise AssertionError(f"[19] (c) {arch} rank {r}: GDN "
                                         f"kernels {x['launches']} at "
                                         f"{x['kernel_shapes']}, not "
                                         f"{want_n} at {want_k}")
            allocs = [res[r][arch]["allocated"] for r in range(MOVES19_WORLD)]
            print(f"  [19] (c) {arch}: every rank's logits bitwise rank 0's; "
                  f"allocated {min(allocs)}-{max(allocs)} B per rank, "
                  f"{sum(allocs) / 1e9:.3f} GB over the {MOVES19_WORLD} "
                  f"ranks")
            logit_rule(f"[19] (c) {arch}",
                       torch.from_numpy(res[0][arch]["logits"]),
                       wide[arch]["one"], wide[arch]["truth"])
            if n_ssm:
                launches["gdn_decode_mamba2_model16"] = n_ssm
                launches["gdn_prefill_mamba2_model16"] = n_ssm
    finally:
        folder.cleanup()
    return launches


def _early15(folder, like, snaps, lrs, wd, one, ref):
    """What needs only the files the ranks wrote by the end of (c): the
    distances of (b)'s and (c)'s parameters after step 2 from the
    1-microbatch run's, and the worst share from the 2-microbatch run's;
    then (d)'s one-device part: (b)'s checkpoint restored into the kept
    yardstick trainer (past step 3), step 3 again.  Returns ({label:
    (distances, worst share against 2 microbatches)}, (restored step,
    its step's metrics, the unbroken run's, the distances))."""
    from repro_torch.checkpoint.manager import CheckpointManager, restore
    dists = {}
    for label in ("b", "c"):
        got = (restore({"params": like}, f"{folder}/b", 2)["params"]
               if label == "b" else restore(like, f"{folder}/c_params", 2))
        dists[label] = (
            param_distance(got, *snaps[1, 2], lrs[:2], wd),
            max(x[1] for x in param_distance(got, *snaps[2, 2], lrs[:2],
                                             wd)))
    one.ckpt = CheckpointManager(f"{folder}/b")
    start = one._maybe_restore()
    one.batch(start)
    m = {k: float(v) for k, v in one.step().items()}
    dist = param_distance(_host(one.state["params"]), *snaps[1, start + 1],
                          lrs[:start + 1], wd)
    return dists, (start, m, ref[start], dist)


def _print_rank15(label, shape, r, o, one_bytes, card, tag="15"):
    print(f"  [{tag}] ({label}) {shape} gloo, eager, rank {r} [{card}]: fsdp "
          f"{o['fsdp']}; steps from {o['start'] + 1}: "
          + "; ".join(f"{s['seconds']:.3f} s, {s['collectives']} "
                      f"collectives, {s['collective_s']:.3f} s and "
                      f"{s['collective_bytes'] / 1e9:.3f} GB in them"
                      for s in o["steps"])
          + f"; state {o['state_bytes'] / 1e9:.3f} GB of the one device's "
          f"{one_bytes / 1e9:.3f}; allocated {o['allocated'] / 1e9:.2f} GB, "
          f"peak {o['peak'] / 1e9:.2f} GB; trainer ready in "
          f"{o['ready_s']:.1f} s, saves {o['save_s']:.1f} s; flash launches "
          f"{o['launches']}")


def _host(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().cpu(), tree)


def tree_like(tree):
    """A tree of meta tensors of ``tree``'s shapes and dtypes (the shape
    ``checkpoint.manager.restore`` reads into)."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def phase4_weights(configs, lm):
    """Phases 3 and 4's full-width qwen3-next-gdn (the GDN kernels on) and
    its weights drawn from seed 0, with the bytes the allocator took for
    them."""
    cfg = configs.get_arch("qwen3-next-gdn").replace(use_pallas_serving=True)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    torch.cuda.synchronize()
    param_alloc = torch.cuda.memory_allocated() - alloc0
    print(f"[3] full-width {cfg.name}: {lm.param_count(params) / 1e9:.3f} B "
          f"params ({cfg.act_dtype}) drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    return cfg, params, param_alloc


def mesh_workers_only(card, configs, lm, engine_mod, t_start):
    """``--mesh-workers``: phase 4's streams from one graph engine's cold
    run, then phase 17 (its (c) ranks serving phase 13 (b)'s run first)."""
    cfg = configs.get_arch("qwen3-next-gdn").replace(use_pallas_serving=True)
    dev = PHASE4_KW["device"]
    params = lm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    eng = engine_mod.DecodeEngine(cfg, params, **PHASE4_KW)
    reqs = phase4_requests(engine_mod.Request, cfg.vocab)
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    plain = [list(r.output) for r in reqs]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[17] mesh engines behind the router and in worker processes "
          f"[{card}]")
    started = workers_start(cfg, params, engine_mod, card, True)
    workers_phase(cfg, engine_mod, card, plain, None, started)
    print(f"  [17] done in {time.perf_counter() - t_start:.1f} s [{card}]")
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels, hold them against their plain "
                         "versions and stop")
    ap.add_argument("--mesh-train-faults", action="store_true",
                    help="build the kernels, run phase 15 (b)-(d) and its "
                         "planted faults (FAULTS15) and stop")
    ap.add_argument("--dryrun", action="store_true",
                    help="build the kernels, draw phase 4's weights, run "
                         "phase 18 and stop")
    ap.add_argument("--mesh-workers", action="store_true",
                    help="build the kernels, serve phase 4's mix once for "
                         "its streams, run phase 17 (its (c) ranks also "
                         "make phase 13 (b)'s streams) and stop")
    ap.add_argument("--model-moves", action="store_true",
                    help="build the kernels, hold phase 2's rows at phase "
                         "19's shapes, run phase 19 and stop")
    args = ap.parse_args()
    t_start = time.perf_counter()

    def mark(phase):
        print(f"  -- phase {phase} done at "
              f"{time.perf_counter() - t_start:.1f} s from the start")
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
                                                       kernel_counts,
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

    if args.mesh_train_faults:
        print(f"[15] (b)-(d) and the planted faults [{card}]")
        mesh15_phase(card, kflash, (kflash, kdecode, kprefill, kattn), True)
        print(f"  [15] done in {time.perf_counter() - t_start:.1f} s")
        print(f"[16] the model axis in training for the other kinds, and "
              f"the planted fault [{card}]")
        mesh16_phase(card, kflash, True)
        print(f"  [16] done in {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.mesh_workers:
        return mesh_workers_only(card, configs, lm, engine_mod, t_start)
    if args.model_moves:
        print(f"[2] kernels vs plain versions at phase 19's shapes [{card}]")
        for r in moves19_rows(ops, ref, kdecode, kprefill, kflash,
                              time_launches):
            print(f"  {r['name']}: {r['ms'] * 1e3:.2f} us (bound "
                  f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}, plain "
                  f"{r['plain_ms'] * 1e3:.2f} us)")
        print(f"[19] fit_spec's moves of the model axis at full width "
              f"[{card}]")
        moves19_phase(card, lm, engine_mod, configs, kflash)
        mark(19)
        return 0
    if args.dryrun:
        cfg, params, param_alloc = phase4_weights(configs, lm)
        print(f"[18] the dry run against the card, and the paper's Table "
              f"II at batch 1 [{card}]")
        dryrun_phase(cfg, params, param_alloc, lm, ref, kdecode,
                     time_launches, None, card)
        mark(18)
        return 0
    print(f"[2] kernels vs plain versions, full-width shapes [{card}]")
    mamba2 = tuple(MAMBA2[k] for k in ("B", "Hk", "Hv", "d_k", "d_v"))
    rows = [decode_phase(ref, kdecode, time_launches),
            prefill_phase(ops, ref, kprefill, time_launches),
            decode_phase(ref, kdecode, time_launches, "gdn_decode_mamba2",
                         mamba2, delta_rules=(False,)),
            prefill_phase(ops, ref, kprefill, time_launches,
                          "gdn_prefill_mamba2", PREFILL_MAMBA2_CASES,
                          PREFILL_MAMBA2 + (False,))]
    mamba2_local = tuple(MESH14_LOCAL[k]
                         for k in ("B", "Hk", "Hv", "d_k", "d_v"))
    rows += [decode_phase(ref, kdecode, time_launches,
                          "gdn_decode_mamba2_model2", mamba2_local,
                          delta_rules=(False,)),
             prefill_phase(ops, ref, kprefill, time_launches,
                           "gdn_prefill_mamba2_model2",
                           PREFILL_MAMBA2_MODEL2_CASES,
                           PREFILL_MAMBA2_MODEL2 + (False,))]
    rows += [decode_phase(ref, kdecode, time_launches, "gdn_decode_model2",
                          MESH_MODEL2, delta_rules=(True,)),
             decode_phase(ref, kdecode, time_launches, "gdn_decode_data2",
                          MESH_DATA2, delta_rules=(True,))]
    rows += [prefill_phase(ops, ref, kprefill, time_launches, name,
                           PREFILL_MESH_CASES[name], cases[0][4] + (True,),
                           B=len(cases[0][2]))
             for name, cases in PREFILL_MESH_CASES.items()]
    prefill_pow2_checks(ops, ref)
    rows += flash_phase(ref, kflash, time_launches)
    rows += moves19_rows(ops, ref, kdecode, kprefill, kflash, time_launches)
    rows.append(attn_decode_phase(ref, kattn, time_launches,
                                  ATTN_DECODE_SHAPES))
    for r in rows:
        lib = "" if r["library_ms"] is None else \
            f", library {r['library_ms'] * 1e3:.2f} us"
        print(f"  {r['name']}: {r['ms'] * 1e3:.2f} us (bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}, plain "
              f"{r['plain_ms'] * 1e3:.2f} us{lib})")
    mark(2)
    if args.kernels_only:
        print(json.dumps({"kernels": rows}))
        return 0
    print(f"[19] fit_spec's moves of the model axis at full width: "
          f"minicpm-2b on (1,2) served and on (1,2) / (1,4) trained; "
          f"{', '.join(MOVES19_C)} on (1,{MOVES19_WORLD}) [{card}]")
    launches = moves19_phase(card, lm, engine_mod, configs, kflash)
    gc.collect()
    torch.cuda.empty_cache()
    mark(19)

    cfg, params, param_alloc = phase4_weights(configs, lm)
    step3 = model_phase(cfg, params, lm)
    mark(3)

    print(f"[4] serving through DecodeEngine [{card}]")
    got, plain, warm_us, step_ms = serve_phase(
        cfg, params, engine_mod, kdecode, kprefill, card, kernel_counts)
    launches.update(got)
    mark(4)
    print(f"[18] the dry run against the card, on phase 4's weights, and "
          f"the paper's Table II at batch 1 [{card}]")
    row18, launches["gdn_decode_b1"] = dryrun_phase(
        cfg, params, param_alloc, lm, ref, kdecode, time_launches, step_ms,
        card)
    rows.append(row18)
    torch.cuda.empty_cache()
    mark(18)
    print(f"[9] speculative decode of full-width {cfg.name} on phase 4's "
          f"mix, through CUDA graphs [{card}]")
    spec_phase(cfg, params, lm, engine_mod, kdecode, card, plain,
               kernel_counts)
    torch.cuda.empty_cache()
    mark(9)
    print(f"[10] state paging of full-width {cfg.name} on phase 4's mix, "
          f"through CUDA graphs [{card}]")
    t0 = time.perf_counter()
    paging = paging_phase(cfg, params, engine_mod, card, plain, warm_us)
    print(f"  [10] phase 10 took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[11] router, engine roles and worker processes on full-width "
          f"{cfg.name}, phase 4's mix, through CUDA graphs [{card}]")
    t0 = time.perf_counter()
    disagg = disagg_phase(cfg, params, engine_mod, card, plain)
    print(f"  [11] phase 11 took {time.perf_counter() - t0:.1f} s [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[13] mesh serving of full-width {cfg.name} on phase 4's mix "
          f"[{card}]")
    t0 = time.perf_counter()
    got, streams13, started17 = mesh_phase(
        cfg, params, engine_mod, card, plain, step3, warm_us,
        meanwhile=lambda: workers_start(cfg, params, engine_mod, card,
                                        False))
    launches.update(got)
    print(f"  [13] phase 13 took {time.perf_counter() - t0:.1f} s, phase "
          f"17's start inside it [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[17] mesh engines behind the router and in worker processes, "
          f"full-width {cfg.name}, phase 4's mix (started during phase 13) "
          f"[{card}]")
    t0 = time.perf_counter()
    workers17 = workers_phase(cfg, engine_mod, card, plain, streams13,
                              started17)
    print(f"  [17] phase 17 took {time.perf_counter() - t0:.1f} s after its "
          f"start [{card}]")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    print(f"[5] training full-width {cfg.name} through Trainer with the "
          f"flash kernels [{card}]")
    cfg5 = cfg.replace(n_layers=TRAIN_LAYERS)
    p5_launches, phase5 = train_phase(cfg5, card, kflash,
                                      (kflash, kdecode, kprefill, kattn))
    launches.update(p5_launches)
    torch.cuda.empty_cache()
    mark(5)

    launches.update(danube_phase(card, lm, attention, engine_mod, kattn,
                                 configs))
    torch.cuda.empty_cache()
    mark(6)
    folder14 = tempfile.TemporaryDirectory(dir=ROOT / "build")
    steps14, plain14 = {}, {}
    m2 = mamba2_phase(card, lm, engine_mod, kdecode, kprefill, configs,
                      kernel_counts)
    launches.update(m2.pop("launches"))
    del m2["params"]
    gc.collect()
    torch.cuda.empty_cache()
    mark(7)
    steps14["recurrentgemma-2b"], plain14["recurrentgemma-2b"] = \
        gemma_phase(card, lm, engine_mod, configs, folder14.name)
    gc.collect()
    torch.cuda.empty_cache()
    mark(8)
    print(f"[12] MoE at full width with the depth cut: mixtral-8x7b and "
          f"arctic-480b served, mixtral trained [{card}]")
    t0 = time.perf_counter()
    moe_launches, mixtral = moe_phase(card, lm, engine_mod, configs, kflash,
                                      (kflash, kdecode, kprefill, kattn),
                                      folder14.name)
    steps14["mixtral-8x7b"], plain14["mixtral-8x7b"] = mixtral
    print(f"  [12] phase 12 took {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[14] the mesh's model axis for the other kinds: (a) "
          f"full-width {m2['cfg'].name} on a (1,1) NCCL mesh, phase 7's "
          f"weights (drawn again from seed 0) and mix [{card}]")
    t0 = time.perf_counter()
    params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0),
                        m2["cfg"], device="cuda")
    us_a = mesh_nccl_phase(m2["cfg"], params, engine_mod, card, m2["plain"],
                           label="[14] (a)", phase="phase 7")
    print(f"  [14] (a) warm {us_a:.1f} us/token against phase 7's warm "
          f"{m2['warm_us']:.1f} ({us_a / m2['warm_us']:.4f}x)")
    steps14["mamba2-1.3b"] = fixed_step(m2["cfg"], params, lm,
                                        folder14.name)
    plain14["mamba2-1.3b"] = m2["plain"][:2]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[14] (b)-(d) the mesh's model axis at full width over two gloo "
          f"ranks on card 0: {', '.join(MESH14)} [{card}]")
    launches.update(mesh14_phase(card, steps14, plain14))
    folder14.cleanup()
    print(f"  [14] phase 14 took {time.perf_counter() - t0:.1f} s [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[15] the trainer's mesh: full-width {cfg.name} [{card}]")
    t0 = time.perf_counter()
    step_a = train15_nccl(cfg5, card, phase5, kflash,
                          (kflash, kdecode, kprefill, kattn))
    print(f"  [15] (a) took {time.perf_counter() - t0:.1f} s; replayed "
          f"step {step_a:.4f} s")
    launches.update(mesh15_phase(card, kflash,
                                 (kflash, kdecode, kprefill, kattn)))
    print(f"  [15] phase 15 took {time.perf_counter() - t0:.1f} s [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[16] the model axis in training for the other kinds: "
          f"{', '.join(MESH16)} at full width, depth cut [{card}]")
    t0 = time.perf_counter()
    launches.update(mesh16_phase(card, kflash))
    print(f"  [16] phase 16 took {time.perf_counter() - t0:.1f} s [{card}]")
    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["name"] in paging:
            r["launches_paging"] = paging[r["name"]]
            r["launches_disagg"] = disagg[r["name"]]
            r["launches_mesh_workers"] = workers17[r["name"]]
        if r["name"] in moe_launches:
            r["launches_moe"] = moe_launches[r["name"]]
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s [{card}]")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
