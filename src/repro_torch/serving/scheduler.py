"""Host scheduler: request lifecycle, slot assignment and tick policy (port
of the base tick of ``repro.serving.scheduler``).

The scheduler never touches a device buffer; it decides *what* the
``DeviceExecutor`` dispatches and *when*:

  1. **submit** validates a request (sampling parameters, token budget,
     prompt length vs ``max_len``) and appends it to a FIFO queue.
  2. **staging admit** (overlapped, the default): queued requests prefill
     chunk by chunk into the executor's staging ring at tick boundaries.
     While free slots exist this is work-conserving; once every slot is
     busy, up to ``staging_depth`` head-of-queue requests still prefill
     ahead of a free slot, one chunk dispatch per staged request per tick,
     emit their first token (drawn on the device by the fused admit) and
     wait staged-ready until a slot frees (FIFO scatter).  With
     ``overlap=False`` the same dispatches run behind a free slot (the
     serialized baseline — streams are bitwise identical).
  3. **tick** (``step``): one fused k-step decode+sample over all slots,
     with k the budget-aware power-of-two bucket capped at
     ``decode_block``; one host sync per tick.
  4. finished slots (device EOS/budget flags) are freed at tick boundaries.

**Batched staging** (``prefill_batching``, on by default wherever the
reference turns it on): the staged prompts share one ``(staging_depth,
...)`` cache tree; each tick an oldest-first packer under a per-tick
token budget (``prefill_budget``) fuses them into at most one batched
scan and one batched admit per input kind, and every finished row enters
its slot through one multi-row scatter (``_admit_batched``).

**Speculative decode** (``speculative``): a draft model proposes
``k_draft`` tokens per slot at the end of a step; the next step's verify
scores them with the target and commits each slot only through the
tokens it emits (``_step_speculative``), streams bitwise those of plain
decode.  ``adaptive_k`` shrinks or grows the draft length with the
acceptance rate.

**State paging** (slot oversubscription): a request's whole device
residency (recurrent state, rolling KV window, sampler row and last token)
is a fixed-size block, so an idle session leaves its slot as one host
``SwappedState`` and comes back bitwise.  ``pause(rid)`` swaps a request
out wherever it is in the lifecycle (SWAPPED), ``resume(rid)`` queues it
for a slot grant (RESUMING), ``preempt()`` evicts the policy victim with
automatic resume, and ``swap_policy`` ("idle", "pressure" or "auto") runs
an idle-lease and/or priority-pressure sweep at the start of each tick.
A swap-in enters its slot through the copies every admit takes.  Freed
slots alternate between the resume queue and staged-ready fresh admits;
``max_live_requests`` caps the sessions an engine holds, swapped ones
included.  ``async_paging`` drains swap-outs through a ring of
``gather_ring`` buffers, harvested at tick boundaries, and prestages the
head resume claim's put a tick ahead of a predictable grant; beyond
``host_swap_bytes`` of held images the coldest dormant one spills to
``swap_spool_dir`` through ``serving.wire``.

**Roles** (disaggregated serving): a ``role="prefill"`` engine pauses every
request at the admit boundary (prompt consumed, first token drawn, sampler
row advanced) and parks the swapped image on its handoff queue; a
``role="decode"`` engine takes no fresh prompt, only images through
``readmit_swapped``; ``"both"`` (the default) does both.  The narrow
surface a ``Router`` reads (``load``, ``queue_len``, ``free_slots``,
``idle_capacity``, ``handoffs``, ``owns``, ...) and the migration verbs
(``withdraw``, ``readmit``, ``withdraw_swapped``, ``withdraw_handoff``,
``readmit_swapped``) are the reference's; an ``rpc.EngineProxy`` mirrors
them from a worker process.  A migrated image is host numpy, so it
restores through the taker's own ``_fill_slot`` wherever the taker runs.

**Meshes** (``mesh=``, a ``("data", "model")`` ``DeviceMesh``): every rank
of the mesh runs this scheduler on the same requests, so its decisions —
admits, plans, ticks, paging — are the same on every rank, and the
executor's programs gather each tick's tokens over "data" at the tick's
one host sync.  No decision may read a rank's own clock or event state:
the idle sweep (``idle``, ``auto``) evicts the slots rank 0's clock finds
past their lease, broadcast once per sweep on the mesh's host group
(``parallel.comm.host_group``), while ``touch`` and the lease stamps stay
per rank; the pressure victim ties break by activation order, not a time
stamp; a swap-out drains at once on a mesh, so async paging's
``ready()`` harvests and prefetches read no event.  Each rank spills into
its own ``rank<N>`` folder of ``swap_spool_dir`` (which image spills is
rank-local: it moves no collective and no stream).
"""
from __future__ import annotations

import os
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.parallel import comm
from repro_torch.serving import wire
from repro_torch.serving.executor import (_MAX_SCAN_CHUNKS, DeviceExecutor,
                                         PendingSwap, PlanStep,
                                         SwappedState)

# request lifecycle: QUEUED, STAGING (chunked prefill into the ring), READY
# (first token drawn, waiting for a slot), ACTIVE (slot-resident) and
# DONE, plus paging's SWAPPED (image on the host, or paused straight out
# of the queue) and RESUMING (waiting for a slot grant)
QUEUED, STAGING, READY, ACTIVE = "queued", "staging", "ready", "active"
SWAPPED, RESUMING, DONE = "swapped", "resuming", "done"
# where a swapped request's image is: DRAINING (gather dispatched, the
# drain in flight), HOSTED (host numpy), PREFETCHED (put back on the
# device ahead of a predicted grant), SPILLED (a wire file in the spool)
DRAINING, HOSTED = "draining", "hosted"
PREFETCHED, SPILLED = "prefetched", "spilled"


@dataclass
class Request:
    rid: int
    prompt: Optional[np.ndarray] = None         # (T,) int token ids
    prompt_embeds: Optional[np.ndarray] = None  # (T, d_model) stub frontends
    max_new_tokens: int = 16
    temperature: float = 0.0            # 0 => greedy
    top_k: int = 0                      # 0 => disabled
    top_p: float = 1.0                  # 1.0 => disabled
    eos_id: Optional[int] = None
    priority: int = 0                   # pressure: a strictly higher
                                        # priority wins a slot from a lower
    output: List[int] = field(default_factory=list)
    done: bool = False
    state: str = "new"
    # wall-clock stamps (perf_counter seconds), set by the scheduler
    t_submit: Optional[float] = None
    t_first: Optional[float] = None     # first token synced to the host
    t_done: Optional[float] = None
    swapped_s: float = 0.0              # total wall time swapped out
    _swapped_pre_first_s: float = 0.0   # swapped time before the first token
    t_last_activity: Optional[float] = None  # idle lease: set at submit and
                                        # activation, renewed by touch
    _t_active: Optional[float] = None   # latest slot activation

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit to first token, less the time swapped out before it."""
        if self.t_first is None or self.t_submit is None:
            return None
        return self.t_first - self.t_submit - self._swapped_pre_first_s

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_done is None or self.t_submit is None:
            return None
        return self.t_done - self.t_submit

    @property
    def active_latency_s(self) -> Optional[float]:
        """Latency less the time swapped out: throughput's denominator."""
        lat = self.latency_s
        return None if lat is None else lat - self.swapped_s

    @property
    def tokens_per_s(self) -> Optional[float]:
        lat = self.active_latency_s
        return len(self.output) / lat if lat else None

    @property
    def prompt_len(self) -> Optional[int]:
        if self.prompt is not None:
            return int(np.asarray(self.prompt).shape[-1])
        if self.prompt_embeds is not None:
            return int(np.asarray(self.prompt_embeds).shape[0])
        return None

    @property
    def _inputs(self):
        return self.prompt if self.prompt is not None else self.prompt_embeds


@dataclass(eq=False)      # identity semantics: entries are removed by `is`
class _Staging:
    """One in-flight staged prefill bound to an executor ring buffer."""
    req: Request
    plan: List[PlanStep]
    buf: int
    plan_pos: int = 0
    prompt_pos: int = 0
    ready: bool = False
    chunks_left: int = 0      # batched path: full C-chunks not yet staged
    tail: int = 0             # batched path: valid tokens in the admit chunk
    admitted: bool = False    # batched path: admit dispatched, token pending
    pause_pending: bool = False  # paused mid-prefill: swap out at the admit
                                 # boundary instead of waiting staged-ready


@dataclass(eq=False)
class _Swapped:
    """One swapped-out request: its host image (None when it was paused
    straight out of the queue) and the time its swap began (the gather's
    dispatch).  ``pending`` holds a drain in flight, ``prefetch`` an image
    already put back on the device, ``spool`` the path of its spilled
    file (see ``phase``)."""
    req: Request
    state: Optional[SwappedState]
    t_swap: float
    pending: Optional[PendingSwap] = None
    prefetch: Optional[tuple] = None
    spool: Optional[str] = None

    @property
    def phase(self) -> str:
        if self.pending is not None:
            return DRAINING
        if self.prefetch is not None:
            return PREFETCHED
        if self.spool is not None:
            return SPILLED
        return HOSTED


class Scheduler:
    """Continuous-batching decode scheduler over a ``DeviceExecutor``."""

    def __init__(self, cfg: ArchConfig, params, *, max_slots: int = 4,
                 max_len: int = 256, seed: int = 0, decode_block: int = 1,
                 overlap: bool = True, prefill_chunk: int = 16,
                 budget_ticks: bool = True, mesh=None,
                 staging_depth: int = 2, plan_mode: str = "masked",
                 prefill_batching: Optional[bool] = None,
                 prefill_budget: Optional[int] = None,
                 swap_policy: str = "manual",
                 idle_swap_ms: Optional[float] = None,
                 max_live_requests: Optional[int] = None,
                 async_paging: bool = False, gather_ring: int = 2,
                 host_swap_bytes: Optional[int] = None,
                 swap_spool_dir: Optional[str] = None,
                 speculative: bool = False, draft_cfg=None,
                 draft_params=None, k_draft: int = 4,
                 adaptive_k: bool = False, role: str = "both",
                 device=None, cuda_graphs: Optional[bool] = None):
        if decode_block < 1:
            raise ValueError(f"decode_block must be >= 1, got {decode_block}")
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError(f"prefill_budget must be >= 1 token, got "
                             f"{prefill_budget}")
        if swap_policy not in ("manual", "idle", "pressure", "auto"):
            raise ValueError(f"swap_policy must be one of manual/idle/"
                             f"pressure/auto, got {swap_policy!r}")
        if swap_policy in ("idle", "auto") and idle_swap_ms is None:
            raise ValueError(f"swap_policy={swap_policy!r} sweeps idle "
                             f"leases — set idle_swap_ms")
        if idle_swap_ms is not None and idle_swap_ms < 0:
            raise ValueError(f"idle_swap_ms must be >= 0, got "
                             f"{idle_swap_ms}")
        if max_live_requests is not None and max_live_requests < 1:
            raise ValueError(f"max_live_requests must be >= 1, got "
                             f"{max_live_requests}")
        if host_swap_bytes is not None and host_swap_bytes < 0:
            raise ValueError(f"host_swap_bytes must be >= 0, got "
                             f"{host_swap_bytes}")
        if host_swap_bytes is not None and swap_spool_dir is None:
            raise ValueError("host_swap_bytes is a spill watermark — set "
                             "swap_spool_dir so cold images have "
                             "somewhere to go")
        if (draft_cfg is not None or draft_params is not None) \
                and not speculative:
            raise ValueError("draft_cfg/draft_params given without "
                             "speculative=True")
        if adaptive_k and not speculative:
            raise ValueError("adaptive_k tunes the speculative draft "
                             "length — set speculative=True")
        if role not in ("prefill", "decode", "both"):
            raise ValueError(f"role must be one of prefill/decode/both, "
                             f"got {role!r}")
        if mesh is not None and swap_spool_dir is not None:
            import torch.distributed as dist
            swap_spool_dir = os.path.join(swap_spool_dir,
                                          f"rank{dist.get_rank()}")
        self.role = role
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.seed = seed
        self.decode_block = decode_block
        self.overlap = overlap
        self.budget_ticks = budget_ticks
        # speculative decode: the default draft is the target itself
        # (self-draft, sharing its weights)
        self.speculative = speculative
        self.k_draft = k_draft
        self.adaptive_k = bool(adaptive_k)
        self._k_eff = k_draft
        self._accept_window: Deque[tuple] = deque(maxlen=4)
        if speculative and draft_cfg is None:
            draft_cfg, draft_params = cfg, params
        self.executor = DeviceExecutor(
            cfg, params, max_slots=max_slots, max_len=max_len,
            decode_block=decode_block, prefill_chunk=prefill_chunk,
            mesh=mesh, staging_depth=staging_depth, plan_mode=plan_mode,
            prefill_batching=prefill_batching,
            draft_cfg=draft_cfg if speculative else None,
            draft_params=draft_params if speculative else None,
            k_draft=k_draft, gather_ring=gather_ring, device=device,
            cuda_graphs=cuda_graphs)
        # per-tick prefill budget of the batched packer, in scan-chunk
        # units (an admit costs one); the default lets every staging row
        # take a full scan + admit per tick
        C = self.executor.prefill_chunk
        self._budget_chunks = (
            max(1, prefill_budget // C) if prefill_budget is not None
            else self.executor.staging_depth * (_MAX_SCAN_CHUNKS + 1))
        self.free: Deque[int] = deque(range(max_slots))
        self.active: Dict[int, Request] = {}
        self.queue: Deque[Request] = deque()
        self._all: List[Request] = []
        self._stagings: List[_Staging] = []
        self._free_bufs: Deque[int] = deque(range(staging_depth))
        # batched rows whose request finished at admit, zeroed by the next
        # multi-row scatter
        self._dirty_rows: set = set()
        # state paging: the swapped-out requests by rid (rids are unique
        # among live requests), the FIFO resume queue, the rids whose
        # drain is in flight (in dispatch order: the force-harvest order
        # when the gather ring runs out) and the spill tier's watermark
        self.swap_policy = swap_policy
        self.idle_swap_ms = idle_swap_ms
        self.max_live_requests = max_live_requests
        # on a mesh, rank 0's clock decides the idle sweep for every rank
        self._host = (comm.host_group(mesh) if mesh is not None
                      and swap_policy in ("idle", "auto") else None)
        self._activations = 0       # the pressure victim's tie order
        self._active_seq: Dict[int, int] = {}     # slot -> activation
        self.swapped: Dict[int, _Swapped] = {}
        self.resume_q: Deque[int] = deque()
        self._grant_resume_next = True
        self.async_paging = bool(async_paging)
        self._draining_q: Deque[int] = deque()
        self.host_swap_bytes = host_swap_bytes
        self.swap_spool_dir = swap_spool_dir
        # disaggregation: a prefill-role engine parks each admit-boundary
        # swap here until the router ships it to a decode engine
        self._handoff_q: Deque[int] = deque()
        self.handoffs_out = 0       # records shipped by withdraw_handoff
        # the speculative tick's draft, pending across the step boundary:
        # (k, device draft tokens, live rids); a pause or preempt of an
        # active request meanwhile waits for the verify (rid, resume)
        self._pending = None
        self._spec_deferred: List[tuple] = []
        self.spec_ticks = 0
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.draft_prefills = 0     # draft-state rebuild dispatches
        self.draft_steps = 0        # draft decode steps (sum of k)
        self.verify_positions = 0   # verify positions (sum of k + 1)
        self.ticks = 0
        self.decode_steps = 0       # decode steps run by ticks (sum of k)
        self.decode_s = 0.0         # wall time inside decode ticks (+ sync)
        self.decoded_tokens = 0     # tokens emitted by ticks (not admit)
        self.stage_dispatches = 0   # prefill-chunk dispatches
        self.scatter_dispatches = 0  # slot scatters
        self._zero_swap_counters()
        self._metrics_seen: set = set()

    def _zero_swap_counters(self):
        self.swap_outs = 0          # slot/staging gathers to the host
        self.swap_ins = 0           # restores into a slot
        self.swap_s = 0.0           # wall time inside swap transfers
        self.swap_bytes = 0         # bytes moved (both directions)
        # swap_s split two ways: dispatch (launches, and harvests of drains
        # already landed) + stall (waits async paging exists to hide), and
        # gather (with harvests) + put + scatter
        self.swap_dispatch_s = 0.0
        self.swap_stall_s = 0.0
        self.swap_gather_s = 0.0
        self.swap_put_s = 0.0
        self.swap_scatter_s = 0.0
        self.swap_prefetches = 0    # puts staged ahead of a grant
        self.swap_prefetch_hits = 0  # grants that took a prefetch
        self.swap_prefetch_drops = 0  # prefetches dropped unused
        self.swap_harvests_overlapped = 0  # drain landed before the harvest
        self.swap_harvests_forced = 0      # the harvest had to wait
        self.spills = 0             # images written to the spool dir
        self.spill_loads = 0        # images read back
        self.spill_bytes = 0        # bytes written to disk

    # ---------------------------------------------------- compat surface
    @property
    def spec(self):
        return self.executor.spec

    @property
    def prefill_chunk(self) -> int:
        return self.executor.prefill_chunk

    @property
    def plan_mode(self) -> str:
        return self.executor.plan_mode

    @property
    def prefill_batching(self) -> bool:
        return self.executor.prefill_batching

    @property
    def staging_depth(self) -> int:
        return self.executor.staging_depth

    @property
    def state_bytes_per_slot(self) -> int:
        return self.executor.state_bytes_per_slot

    @property
    def window_bytes_per_slot(self) -> int:
        return self.executor.window_bytes_per_slot

    @property
    def cache_bytes(self) -> int:
        return self.executor.cache_bytes

    @property
    def mesh(self):
        return self.executor.mesh

    @property
    def caches(self):
        return self.executor.caches

    @property
    def tokens(self):
        return self.executor.tokens

    @property
    def sampler(self):
        return self.executor.sampler

    # ------------------------------------------------------------ submit
    def submit(self, req: Request):
        # a decode-role engine never prefills: it adopts admitted state
        # through readmit_swapped (the prefill->decode handoff)
        if self.role == "decode":
            raise ValueError(f"req {req.rid}: engine role is 'decode' — "
                             f"it accepts handoff images "
                             f"(readmit_swapped), not fresh prompts")
        if not 0.0 < req.top_p <= 1.0:
            raise ValueError(f"req {req.rid}: top_p must be in (0, 1], "
                             f"got {req.top_p}")
        if req.top_k < 0:
            raise ValueError(f"req {req.rid}: top_k must be >= 0, "
                             f"got {req.top_k}")
        if req.temperature <= 0.0 and (req.top_k > 0 or req.top_p < 1.0):
            raise ValueError(f"req {req.rid}: top_k/top_p have no effect "
                             f"at temperature<=0 (greedy); set "
                             f"temperature > 0")
        if req.max_new_tokens < 1:
            raise ValueError(f"req {req.rid}: max_new_tokens must be >= 1 "
                             f"(admit always emits the first token), got "
                             f"{req.max_new_tokens}")
        T = req.prompt_len
        if T is None:
            raise ValueError(f"req {req.rid}: needs a prompt or "
                             f"prompt_embeds")
        if T < 1:
            raise ValueError(f"req {req.rid}: empty prompt")
        if T > self.max_len:
            raise ValueError(
                f"req {req.rid}: prompt length {T} exceeds max_len "
                f"{self.max_len} — the window caches would wrap "
                f"mid-prompt and silently corrupt the context")
        if self.speculative and req.prompt is None:
            raise ValueError(
                f"req {req.rid}: prompt_embeds requests cannot run on a "
                f"speculative engine — the draft-state rebuild at slot "
                f"activation (draft_prefill_slot) replays the consumed "
                f"*token* stream, and embeds have no token ids to "
                f"replay; submit to a non-speculative engine")
        # the swap store and resume queue are keyed by rid, so a rid must
        # be unique among the live requests (a finished rid may recur)
        if self.owns(req.rid):
            raise ValueError(f"req {req.rid}: rid already live on this "
                             f"engine (swap bookkeeping is rid-keyed)")
        if self.max_live_requests is not None:
            live = (len(self.queue) + len(self._stagings)
                    + len(self.active) + len(self.swapped))
            if live >= self.max_live_requests:
                raise RuntimeError(
                    f"max_live_requests={self.max_live_requests} reached "
                    f"({live} live incl. swapped): admission refused — "
                    f"oversubscription caps host memory, not just slots")
        req.t_submit = time.perf_counter()
        req.t_last_activity = req.t_submit
        req.state = QUEUED
        self.queue.append(req)
        self._all.append(req)

    def withdraw(self, *, oldest: bool = False) -> Optional[Request]:
        """Remove and return a queued (not yet staging) request, or None:
        the router moves backlog across engines.  Rebalance takes the
        newest (the queue head keeps its FIFO TTFT), drain the oldest
        first so arrival order survives the move."""
        if not self.queue:
            return None
        req = self.queue.popleft() if oldest else self.queue.pop()
        self._forget(req)
        return req

    def readmit(self, req: Request):
        """Put a withdrawn request back at the queue tail (the router's
        undo when no other engine takes it); ``t_submit`` is kept."""
        self.queue.append(req)
        self._all.append(req)

    def _forget(self, req: Request):
        """Drop ``req`` from the request list by identity (two requests of
        equal fields must not alias)."""
        del self._all[next(i for i, r in enumerate(self._all) if r is req)]

    def _release_record(self, rec: _Swapped) -> _Swapped:
        """Make a record that leaves this engine whole: a draining gather
        is harvested (forced if it has not landed), a spilled image read
        back, a device prestage dropped (it lives on this engine's
        device)."""
        if rec.pending is not None:
            self._harvest(rec, forced=not rec.pending.ready())
        if rec.spool is not None:
            self._load_spill(rec)
        self._drop_prefetch(rec)
        self._forget(rec.req)
        return rec

    def withdraw_swapped(self) -> Optional[_Swapped]:
        """Remove and return the newest resuming request's swap record
        (request + host image), or None: swap-aware rebalance migrates a
        resume claim to any engine of the same config and ``max_len``.
        Newest-first keeps this engine's resume-queue head.  The record
        leaves with a complete host image."""
        if not self.resume_q:
            return None
        return self._release_record(self.swapped.pop(self.resume_q.pop()))

    def withdraw_handoff(self) -> Optional[_Swapped]:
        """Remove and return the oldest completed-prefill swap record
        awaiting dispatch to a decode engine, or None (a prefill-role
        engine parks every admit-boundary swap on its handoff queue).  The
        record leaves with a complete host image; under async paging the
        drain has normally landed during the prefill ticks since."""
        while self._handoff_q:
            rec = self.swapped.pop(self._handoff_q.popleft(), None)
            if rec is None:
                continue            # withdrawn through another path
            self._release_record(rec)
            self.handoffs_out += 1
            return rec
        return None

    def readmit_swapped(self, rec: _Swapped):
        """Adopt a migrated swap record: the request joins this engine's
        resume queue and its image enters a slot at the next grant
        through this engine's own ``_fill_slot`` (every slot buffer keeps
        its address; a speculative engine rebuilds the draft state at
        the swap-in)."""
        if self.owns(rec.req.rid):
            raise ValueError(f"req {rec.req.rid}: rid already live on "
                             f"this engine")
        self._all.append(rec.req)
        self.swapped[rec.req.rid] = rec
        self.resume_q.append(rec.req.rid)
        rec.req.state = RESUMING

    @property
    def load(self) -> int:
        """Requests this engine still owes work to (router placement):
        resuming requests claim a slot grant, dormant swapped ones cost
        only host memory and are left out."""
        return (len(self.active) + len(self.queue) + len(self._stagings)
                + len(self.resume_q))

    # ----------------------------------------------- router-facing surface
    # the narrow read surface the Router uses; an rpc.EngineProxy mirrors
    # exactly these from its worker's status snapshots
    @property
    def handoffs(self) -> int:
        """Completed-prefill swap records awaiting handoff dispatch."""
        return len(self._handoff_q)

    @property
    def queue_len(self) -> int:
        return len(self.queue)

    @property
    def free_slots(self) -> int:
        return len(self.free)

    @property
    def staging_len(self) -> int:
        return len(self._stagings)

    @property
    def resume_len(self) -> int:
        return len(self.resume_q)

    @property
    def idle_capacity(self) -> int:
        """Free slots not already claimed by this engine's own backlog
        (queue, staging ring or resume queue)."""
        return (self.free_slots - self.queue_len - self.staging_len
                - self.resume_len)

    def owns(self, rid: int) -> bool:
        """True when a live (not done) request ``rid`` is here: queued,
        staging, active, resuming or swapped out."""
        return rid in self.swapped or any(
            r.rid == rid and not r.done for r in self._all)

    def done_requests(self) -> List[Request]:
        return [r for r in self._all if r.done]

    def _finished(self, req: Request, tok: int) -> bool:
        return (len(req.output) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id))

    # ------------------------------------------------------ state paging
    def pause(self, rid: int) -> Request:
        """Swap request ``rid`` out of the device (its client went idle),
        wherever it is:

          * active       -> its slot column, sampler row and last token
                            gather to the host; the slot is freed;
          * staged-ready -> its staging row (or ring buffer) is gathered;
          * mid-prefill  -> marked pause-pending: the prefill finishes and
                            the swap happens at the admit boundary;
          * queued       -> leaves the queue with no image;
          * resuming     -> back to dormant (its image stays on the host).

        On a speculative engine an active request paused while a draft is
        pending swaps out at the next verify boundary (until then its
        committed state trails unverified proposals); a ``resume`` before
        that cancels it.  Dormant requests do not hold up
        ``run_until_done``."""
        if rid in self.swapped:
            rec = self.swapped[rid]
            if rid in self.resume_q:
                self.resume_q.remove(rid)
                self._drop_prefetch(rec)
                rec.req.state = SWAPPED
                return rec.req
            raise ValueError(f"req {rid} is already swapped out")
        for slot, req in self.active.items():
            if req.rid == rid:
                if self._pending is not None:
                    return self._defer(req, resume=False)
                return self._swap_out_active(slot)
        for st in self._stagings:
            if st.req.rid == rid:
                if st.ready:
                    self._swap_out_ready(st)
                else:
                    st.pause_pending = True
                return st.req
        for req in self.queue:
            if req.rid == rid:
                self.queue = deque(r for r in self.queue if r is not req)
                self.swapped[rid] = _Swapped(req=req, state=None,
                                             t_swap=time.perf_counter())
                req.state = SWAPPED
                return req
        raise KeyError(f"no live request with rid {rid} to pause")

    def resume(self, rid: int) -> Request:
        """Bring a paused request back: one paused out of the queue (no
        image) rejoins the queue tail and prefills again; one with an
        image joins the resume queue for the next granted slot.  A pause
        still pending (mid-prefill, or deferred to a verify) is
        cancelled."""
        rec = self.swapped.get(rid)
        if rec is None:
            for i, (r, _) in enumerate(self._spec_deferred):
                if r == rid:
                    del self._spec_deferred[i]
                    return next(q for q in self.active.values()
                                if q.rid == rid)
            for st in self._stagings:
                if st.req.rid == rid and st.pause_pending:
                    st.pause_pending = False
                    return st.req
            raise KeyError(f"req {rid} is not swapped out")
        if rid in self.resume_q:
            raise ValueError(f"req {rid} is already resuming")
        req = rec.req
        if rec.state is None and rec.pending is None and rec.spool is None:
            now = time.perf_counter()
            req.swapped_s += now - rec.t_swap
            req._swapped_pre_first_s += now - rec.t_swap
            del self.swapped[rid]
            self.queue.append(req)
            req.state = QUEUED
            req.t_last_activity = now
        else:
            self.resume_q.append(rid)
            req.state = RESUMING
        return req

    def preempt(self, rid: Optional[int] = None) -> Optional[Request]:
        """Evict an active request to the host and queue it for automatic
        resume: ``rid``, or the policy victim (lowest priority, ties to
        the latest activation).  Returns it, or None with no slot
        occupied; deferred to the verify boundary like ``pause``."""
        if rid is not None:
            for slot, req in self.active.items():
                if req.rid == rid:
                    if self._pending is not None:
                        return self._defer(req, resume=True)
                    return self._swap_out_active(slot, resume=True)
            raise KeyError(f"req {rid} is not active")
        if not self.active:
            return None
        slot = self._victim_slot()
        if self._pending is not None:
            return self._defer(self.active[slot], resume=True)
        return self._swap_out_active(slot, resume=True)

    def touch(self, rid: int):
        """Renew request ``rid``'s activity lease (the idle policy swaps
        out active requests whose lease is older than ``idle_swap_ms``)."""
        for r in self._all:
            if r.rid == rid and not r.done:
                r.t_last_activity = time.perf_counter()
                return
        raise KeyError(f"no live request with rid {rid}")

    def _defer(self, req: Request, resume: bool) -> Request:
        if not any(r == req.rid for r, _ in self._spec_deferred):
            self._spec_deferred.append((req.rid, resume))
        return req

    def _victim_slot(self) -> int:
        """The lowest priority, the latest activation among equals (the
        activation count, the same on every rank of a mesh)."""
        return min(self.active,
                   key=lambda s: (self.active[s].priority,
                                  -self._active_seq[s]))

    def _book(self, dt: float, part: str, stall: bool):
        """Add ``dt`` seconds of swap work to ``swap_s``, to its direction
        (gather / put / scatter) and to dispatch or stall."""
        self.swap_s += dt
        setattr(self, f"swap_{part}_s", getattr(self, f"swap_{part}_s") + dt)
        if stall:
            self.swap_stall_s += dt
        else:
            self.swap_dispatch_s += dt

    def _ensure_gather_capacity(self):
        """With every gather-ring buffer draining, force-harvest the oldest
        drain: a draining buffer is never reused before its harvest."""
        while not self.executor._gather_free:
            self._harvest(self.swapped[self._draining_q[0]], forced=True)

    def _harvest(self, rec: _Swapped, *, forced: bool):
        """Materialize a draining record's host image; ``forced`` means the
        tick loop waits on it (a stall), else the drain had landed."""
        t0 = time.perf_counter()
        rec.state = self.executor.harvest(rec.pending)
        rec.pending = None
        self._draining_q.remove(rec.req.rid)
        self._book(time.perf_counter() - t0, "gather", stall=forced)
        if forced:
            self.swap_harvests_forced += 1
        else:
            self.swap_harvests_overlapped += 1

    def _harvest_sweep(self):
        """Tick-boundary harvest of every drain that has landed."""
        for rid in list(self._draining_q):
            rec = self.swapped[rid]
            if rec.pending.ready():
                self._harvest(rec, forced=False)

    def flush_swaps(self):
        """Harvest every draining swap-out now (landed drains count as
        overlapped, the rest as stalls)."""
        while self._draining_q:
            rec = self.swapped[self._draining_q[0]]
            self._harvest(rec, forced=not rec.pending.ready())

    def _swap_out(self, req: Request, pend: PendingSwap, t0: float,
                  resume: bool):
        """Book one dispatched gather and file its record; the synchronous
        path harvests it at once."""
        self._book(time.perf_counter() - t0, "gather", stall=False)
        self.swap_outs += 1
        self.swap_bytes += pend.nbytes
        # t_swap is the dispatch: parked time spans dispatch to restore,
        # however late the drain is harvested
        rec = _Swapped(req=req, state=None, t_swap=t0, pending=pend)
        self.swapped[req.rid] = rec
        self._draining_q.append(req.rid)
        if not self.async_paging:
            self._harvest(rec, forced=True)
        if resume:
            self.resume_q.append(req.rid)
            req.state = RESUMING
        else:
            req.state = SWAPPED
        return req

    def _swap_out_active(self, slot: int, *, resume: bool = False):
        req = self.active.pop(slot)
        t0 = time.perf_counter()
        self._ensure_gather_capacity()
        pend = self.executor.gather_slot_async(slot)
        self.free.append(slot)
        return self._swap_out(req, pend, t0, resume)

    def _swap_out_ready(self, st: _Staging):
        """The admit-boundary swap: the request has its first token and an
        advanced sampler row but no slot, so its staging row (or ring
        buffer) is gathered."""
        t0 = time.perf_counter()
        self._ensure_gather_capacity()
        if self.executor.prefill_batching:
            pend = self.executor.bgather_row_async(st.buf)
            self._dirty_rows.add(st.buf)    # zeroed by the next scatter
        else:
            pend = self.executor.gather_staging_async(st.buf)
            self._free_bufs.append(st.buf)
        self._stagings.remove(st)
        self._swap_out(st.req, pend, t0, resume=False)
        if self.role == "prefill":
            # a finished prefill whose image belongs on a decode engine
            self._handoff_q.append(st.req.rid)

    def _swap_in(self, rid: int, slot: int):
        rec = self.swapped.pop(rid)
        req = rec.req
        if rec.pending is not None:     # the grant beat the drain
            self._harvest(rec, forced=not rec.pending.ready())
        if rec.spool is not None:
            self._load_spill(rec)
        t0 = time.perf_counter()
        if rec.prefetch is not None:
            prestaged, rec.prefetch = rec.prefetch, None
            self.swap_prefetch_hits += 1
        else:
            # the put a prefetched grant avoids
            prestaged = self.executor.prestage_restore(rec.state)
            self._book(time.perf_counter() - t0, "put", stall=True)
        t1 = time.perf_counter()
        self.executor.restore_slot(slot, rec.state, prestaged=prestaged)
        self.scatter_dispatches += 1
        now = time.perf_counter()
        self._book(now - t1, "scatter", stall=False)
        self.swap_ins += 1
        self.swap_bytes += rec.state.nbytes
        req.swapped_s += now - rec.t_swap
        self._activate(slot, req)

    def _prefetch_resume(self):
        """Put the head resume claim's image back on the device a tick
        ahead of a predictable grant (a slot is free, or an active slot is
        within a tick of its budget)."""
        if not self.resume_q:
            return
        rec = self.swapped[self.resume_q[0]]
        if rec.prefetch is not None:
            return
        if not (self.free or any(
                r.max_new_tokens - len(r.output) <= self.decode_block
                for r in self.active.values())):
            return
        if rec.pending is not None:
            if not rec.pending.ready():
                return              # let the drain land first
            self._harvest(rec, forced=False)
        if rec.spool is not None:
            self._load_spill(rec)
        t0 = time.perf_counter()
        rec.prefetch = self.executor.prestage_restore(rec.state)
        self._book(time.perf_counter() - t0, "put", stall=False)
        self.swap_prefetches += 1

    def _drop_prefetch(self, rec: _Swapped):
        if rec.prefetch is not None:
            rec.prefetch = None
            self.swap_prefetch_drops += 1

    # ---------------------------------------------------- spill to disk
    def _spill_path(self, rid: int) -> str:
        return os.path.join(self.swap_spool_dir, f"swap-{rid}.state")

    def _apply_spill(self):
        """Spill the coldest dormant images to the spool dir until the held
        images fit under ``host_swap_bytes``; only images nothing is about
        to touch (not draining, prefetched or resuming) may go."""
        limit = self.host_swap_bytes or 0
        while True:
            held = [r for r in self.swapped.values() if r.state is not None]
            if sum(r.state.nbytes for r in held) <= limit:
                return
            cold = [r for r in held
                    if r.req.rid not in self.resume_q and r.prefetch is None]
            if not cold:
                return
            self._spill(min(cold, key=lambda r: r.t_swap))

    def _spill(self, rec: _Swapped):
        """Write the image as its wire encoding and drop it from memory."""
        os.makedirs(self.swap_spool_dir, exist_ok=True)
        path = self._spill_path(rec.req.rid)
        wire.dump_swapped(path, rec.state)
        rec.spool = path
        self.spills += 1
        self.spill_bytes += rec.state.nbytes
        rec.state = None

    def _load_spill(self, rec: _Swapped):
        """Read a spilled image back (bitwise) and delete its file."""
        rec.state = wire.load_swapped(rec.spool)
        os.remove(rec.spool)
        rec.spool = None
        self.spill_loads += 1

    def _grant_resume(self) -> bool:
        """True when the next freed slot goes to the resume queue rather
        than a staged-ready fresh admit: when both wait, grants
        alternate."""
        if not self.resume_q:
            return False
        if not (self._stagings and self._stagings[0].ready):
            return True
        return self._grant_resume_next

    def _apply_swap_policy(self):
        """Tick-boundary eviction sweep.  idle: an active request whose
        lease is older than ``idle_swap_ms`` is swapped out dormant.
        pressure: while a strictly higher-priority request waits (resume
        queue, staged-ready or queued) without a free slot, the policy
        victim is evicted to the resume queue; equal priorities never
        displace each other."""
        if self.swap_policy in ("idle", "auto") and self.active:
            for slot in self._idle_slots():
                self._swap_out_active(slot)
        if self.swap_policy in ("pressure", "auto"):
            while self.active:
                waiting = sorted(
                    [self.swapped[r].req.priority for r in self.resume_q]
                    + [s.req.priority for s in self._stagings if s.ready]
                    + [r.priority for r in self.queue], reverse=True)
                if len(self.free) >= len(waiting):
                    break
                need = waiting[len(self.free)]
                slot = self._victim_slot()
                if need <= self.active[slot].priority:
                    break
                self._swap_out_active(slot, resume=True)

    def _idle_slots(self) -> List[int]:
        """The active slots whose lease is older than ``idle_swap_ms`` by
        this rank's clock; on a mesh rank 0's list, broadcast to every
        rank (each rank's own clock and stamps would disagree)."""
        now = time.perf_counter()
        cutoff = self.idle_swap_ms / 1e3
        slots = [s for s, r in self.active.items()
                 if now - r.t_last_activity > cutoff]
        if self._host is None:
            return slots
        return self._host.broadcast_ints(
            slots if self._host.index == 0 else None)

    def _tick_start(self):
        """The paging work at the start of every tick: harvest landed
        drains, spill, run the swap policy."""
        if self.async_paging and self._draining_q:
            self._harvest_sweep()
        if self.swap_spool_dir is not None:
            self._apply_spill()
        if self.swap_policy != "manual":
            self._apply_swap_policy()

    # ----------------------------------------------------------- staging
    def _stage_start(self, req: Request):
        buf = self._free_bufs.popleft()
        req.state = STAGING
        # a prefill-role engine swaps out at the admit boundary instead of
        # holding the request staged-ready (the mid-prefill pause's
        # machinery); a request finished at its admit completes in place
        handoff = self.role == "prefill"
        args = dict(seed=self.seed, rid=req.rid, temperature=req.temperature,
                    top_k=req.top_k, top_p=req.top_p, eos_id=req.eos_id,
                    budget=req.max_new_tokens)
        if self.executor.prefill_batching:
            # no fixed plan: the per-tick packer allocates chunks; begin is
            # host-only (rows are zeroed by the multi-row scatter)
            T, C = req.prompt_len, self.executor.prefill_chunk
            tail = (T - 1) % C + 1
            self._stagings.append(_Staging(req=req, plan=[], buf=buf,
                                           chunks_left=(T - tail) // C,
                                           tail=tail, pause_pending=handoff))
            self.executor.bstage_begin(buf, **args)
            return
        self._stagings.append(_Staging(
            req=req, plan=self.executor.plan_prefill(req.prompt_len),
            buf=buf, pause_pending=handoff))
        self.executor.stage_begin(buf, **args)

    def _stage_dispatch_one(self, st: _Staging):
        step = st.plan[st.plan_pos]
        chunk = st.req._inputs[st.prompt_pos:st.prompt_pos + step.tokens]
        if step.kind == "scan":
            self.executor.stage_chunk_scan(st.buf, chunk,
                                           valid_lens=step.valid)
        elif step.kind == "chunk":
            self.executor.stage_chunk(st.buf, chunk)
        else:
            self.executor.stage_admit(st.buf, chunk, valid_len=step.valid)
        st.prompt_pos += step.tokens
        st.plan_pos += 1
        self.stage_dispatches += 1

    def _complete(self, req: Request, now: float):
        req.done = True
        req.state = DONE
        req.t_done = now

    def _stage_finish(self, st: _Staging):
        """Plan complete: sync the fused first token (TTFT is stamped here)
        and either complete the request (EOS / max_new_tokens=1) or hold it
        staged-ready until a slot frees."""
        req = st.req
        tok = int(self.executor.staging_tok[st.buf][0])
        req.t_first = time.perf_counter()
        req.output.append(tok)
        if self._finished(req, tok):
            self._complete(req, req.t_first)
            self._stagings.remove(st)
            self._free_bufs.append(st.buf)
            return
        if st.pause_pending:
            self._swap_out_ready(st)    # the admit-boundary swap
            return
        st.ready = True
        req.state = READY

    def _activate(self, slot: int, req: Request):
        self.active[slot] = req
        req.state = ACTIVE
        req._t_active = req.t_last_activity = time.perf_counter()
        self._activations += 1
        self._active_seq[slot] = self._activations
        self._draft_activate(slot, req)

    def _stage_scatter(self):
        st = self._stagings.pop(0)
        slot = self.free.popleft()
        self.executor.scatter(slot, st.buf)
        self.scatter_dispatches += 1
        self._free_bufs.append(st.buf)
        self._activate(slot, st.req)

    def _draft_activate(self, slot: int, req: Request):
        """Rebuild the draft model's state of ``slot`` at its activation by
        replaying the request's consumed tokens: the prompt and every
        emitted token but the last (the next decode input)."""
        if not self.speculative:
            return
        toks = np.asarray(req.prompt, np.int64).reshape(-1)
        if len(req.output) > 1:
            toks = np.concatenate([toks, np.asarray(req.output[:-1],
                                                    np.int64)])
        self.executor.draft_prefill_slot(slot, toks)
        self.draft_prefills += 1

    def _admit(self):
        """Advance the admit pipeline at a tick boundary: FIFO scatter of
        staged-ready requests into free slots, new stagings while ring
        buffers allow (behind a free slot unless ``overlap``), then one
        chunk dispatch per staging — every chunk while slots are free, one
        per staging per tick once they are all busy.  Batched staging
        replaces this loop with ``_admit_batched``."""
        if self.executor.prefill_batching:
            return self._admit_batched()
        yielded = set()
        while True:
            # resume swap-ins share freed slots with the FIFO scatter of
            # staged-ready requests (alternating when both wait)
            if self.free and self._grant_resume():
                self._swap_in(self.resume_q.popleft(), self.free.popleft())
                self._grant_resume_next = False
                continue
            if self._stagings and self._stagings[0].ready and self.free:
                self._stage_scatter()
                self._grant_resume_next = True
                continue
            if (self.queue and self._free_bufs
                    and (self.free or self.overlap)):
                self._stage_start(self.queue.popleft())
                continue
            st = next((s for s in self._stagings
                       if not s.ready and id(s) not in yielded), None)
            if st is None:
                return
            self._stage_dispatch_one(st)
            if st.plan_pos == len(st.plan):
                self._stage_finish(st)
            elif not self.free and self.active:
                yielded.add(id(st))

    # --------------------------------------------------- batched staging
    def _flush_scatter(self, assigns):
        """One multi-row scatter covering every slot assignment plus the
        dirty (finished-at-admit) rows; released rows return to the free
        pool clean."""
        self.executor.bscatter(assigns, self._dirty_rows)
        self.scatter_dispatches += 1
        self._free_bufs.extend(row for _, row in assigns)
        self._free_bufs.extend(self._dirty_rows)
        self._dirty_rows.clear()

    def _stage_finish_batch(self, sts: List[_Staging]):
        """Every request admitted by one batched dispatch syncs its first
        token from the same host read and stamps the same ``t_first``: a
        batch admit is one device event."""
        toks = self.executor.btoks_host()           # the one host sync
        now = time.perf_counter()
        for st in sts:
            req = st.req
            tok = int(toks[st.buf])
            req.t_first = now
            req.output.append(tok)
            if self._finished(req, tok):
                self._complete(req, now)
                self._stagings.remove(st)
                self._dirty_rows.add(st.buf)    # zeroed at next scatter
            elif st.pause_pending:
                self._swap_out_ready(st)        # the admit-boundary swap
            else:
                st.ready = True
                req.state = READY

    def _dispatch_batched(self, budget: int) -> bool:
        """One packed prefill round: walk the staging FIFO oldest-first,
        allocating each entry up to ``budget`` scan-chunk units (an admit
        costs one), then fuse all allocations into at most one batched
        scan and one batched admit per input kind.  The walk never skips
        past an unfinished older entry once the budget runs out (the
        fairness guard).  Interior chunks are C-quantized, so each
        prompt's chunk decomposition is that of per-prompt dispatch."""
        C = self.executor.prefill_chunk
        scan_e: Dict[bool, list] = {}
        admit_e: Dict[bool, list] = {}
        admitted: List[_Staging] = []
        for st in self._stagings:
            if st.ready or st.admitted:
                continue
            if budget <= 0:
                break               # strict oldest-first: no skip-ahead
            is_embeds = st.req.prompt is None
            if st.chunks_left:
                take = min(st.chunks_left, _MAX_SCAN_CHUNKS, budget)
                chunk = st.req._inputs[st.prompt_pos:
                                       st.prompt_pos + take * C]
                scan_e.setdefault(is_embeds, []).append(
                    (st.buf, chunk, take))
                st.prompt_pos += take * C
                st.chunks_left -= take
                budget -= take
            if st.chunks_left == 0 and budget > 0:
                chunk = st.req._inputs[st.prompt_pos:
                                       st.prompt_pos + st.tail]
                admit_e.setdefault(is_embeds, []).append(
                    (st.buf, chunk, st.tail))
                st.prompt_pos += st.tail
                st.admitted = True
                admitted.append(st)
                budget -= 1
        for entries in scan_e.values():
            self.executor.bstage_chunk_scan(entries)
            self.stage_dispatches += 1
        for entries in admit_e.values():
            self.executor.bstage_admit(entries)
            self.stage_dispatches += 1
        if admitted:
            self._stage_finish_batch(admitted)
        return bool(scan_e or admit_e)

    def _admit_batched(self):
        """Batched admit pipeline: per round at most one multi-row scatter,
        then new stagings (host only), then one packed prefill round.
        While slots are free the loop drains work-conservingly; under
        saturation one round per tick keeps the resident slots decoding
        between prefill programs."""
        while True:
            progressed = False
            # slot grants: resume-queue swap-ins alternate with the
            # multi-row scatter of head-run staged-ready requests
            assigns = []
            while self.free and (self.resume_q or (
                    self._stagings and self._stagings[0].ready)):
                if self._grant_resume():
                    self._swap_in(self.resume_q.popleft(),
                                  self.free.popleft())
                    self._grant_resume_next = False
                    progressed = True
                    continue
                st = self._stagings.pop(0)
                slot = self.free.popleft()
                assigns.append((slot, st.buf))
                self._activate(slot, st.req)
                self._grant_resume_next = True
            if assigns:
                self._flush_scatter(assigns)
                progressed = True
            # start staging while rows allow; a dirty row blocks a start
            # only until a release-only scatter cleans it
            while self.queue and (self.free or self.overlap):
                if not self._free_bufs:
                    if self._dirty_rows:
                        self._flush_scatter([])
                        progressed = True
                        continue
                    break
                self._stage_start(self.queue.popleft())
                progressed = True
            # infinite budget while a slot is free (work-conserving)
            budget = self._budget_chunks if not self.free else 1 << 30
            if self._dispatch_batched(budget):
                progressed = True
            if not self.free and self.active:
                return              # saturated: one round per tick
            if not progressed:
                return

    # -------------------------------------------------------------- tick
    def _bucket(self, cap: int, verify: int = 0) -> int:
        """Budget-aware tick length: the smallest power-of-two bucket
        (capped at ``cap``) covering the largest remaining per-slot budget
        less the ``verify`` tokens a speculative verify emits itself."""
        if not self.budget_ticks:
            return cap
        need = max(r.max_new_tokens - len(r.output)
                   for r in self.active.values()) - verify
        k = 1
        while k < need and k < cap:
            k <<= 1
        return min(k, cap)

    def _tick_k(self) -> int:
        return self._bucket(self.decode_block)

    def _spec_k(self) -> int:
        """Draft length: capped at ``k_draft``, or at the adapted k with
        ``adaptive_k``; 0 (a verify-only tick) when no slot needs more
        than the verify's own token."""
        kmax = self._k_eff if self.adaptive_k else self.k_draft
        if self.budget_ticks and max(r.max_new_tokens - len(r.output)
                                     for r in self.active.values()) <= 1:
            return 0
        return self._bucket(kmax, verify=1)

    def _adapt_k(self, accepted: int, drafted: int):
        """Acceptance-adaptive draft length: over a window of 4 verify
        ticks, a rate below 0.5 halves the effective k (floor 1), above
        0.8 doubles it (cap ``k_draft``); each change clears the window.
        Streams do not depend on k."""
        self._accept_window.append((accepted, drafted))
        if len(self._accept_window) < self._accept_window.maxlen:
            return
        d = sum(x[1] for x in self._accept_window)
        if d == 0:
            return
        rate = sum(x[0] for x in self._accept_window) / d
        if rate < 0.5 and self._k_eff > 1:
            self._k_eff = max(1, self._k_eff // 2)
            self._accept_window.clear()
        elif rate > 0.8 and self._k_eff < self.k_draft:
            self._k_eff = min(self.k_draft, self._k_eff * 2)
            self._accept_window.clear()

    def _emit(self, toks, valid, now: float) -> Dict[int, int]:
        """Append each active slot's valid tokens, free finished slots;
        returns tokens emitted per slot."""
        emitted = {}
        for slot, req in list(self.active.items()):
            n = 0
            for j in range(toks.shape[0]):
                if not valid[j, slot]:
                    break
                tok = int(toks[j, slot])
                req.output.append(tok)
                self.decoded_tokens += 1
                n += 1
                if self._finished(req, tok):
                    self._complete(req, now)
                    del self.active[slot]
                    self.free.append(slot)
                    self.executor.release_slot(slot)
                    break
            emitted[slot] = n
        return emitted

    def _step_speculative(self):
        """One speculative tick, pipelined across the step boundary: verify
        the draft dispatched at the end of the previous step (the tick's
        one host sync), emit, then admit and dispatch the next draft, so
        admits happen only between a verify and the next draft."""
        if self._pending is not None:
            k, dtoks, live = self._pending
            self._pending = None
            t0 = time.perf_counter()
            toks, valid = self.executor.spec_verify(k, dtoks)
            now = time.perf_counter()
            self.decode_s += now - t0
            self.ticks += 1
            self.spec_ticks += 1
            self.verify_positions += k + 1
            self.drafted_tokens += k * len(live)
            # every emission beyond the first rode on an accepted draft
            accepted = sum(max(n - 1, 0)
                           for n in self._emit(toks, valid, now).values())
            self.accepted_tokens += accepted
            if self.adaptive_k and k > 0:
                self._adapt_k(accepted, k * len(live))
            # pauses and preempts deferred to this verify boundary
            deferred_, self._spec_deferred = self._spec_deferred, []
            for rid, resume in deferred_:
                slot = next((s for s, r in self.active.items()
                             if r.rid == rid), None)
                if slot is not None:    # it may have finished in the verify
                    self._swap_out_active(slot, resume=resume)
        self._tick_start()
        self._admit()
        if self.async_paging:
            self._prefetch_resume()
        if not self.active:
            return
        k = self._spec_k()
        t0 = time.perf_counter()
        dtoks = self.executor.spec_draft(k)     # no host sync
        self.decode_s += time.perf_counter() - t0
        self.draft_steps += k
        self._pending = (k, dtoks, [r.rid for r in self.active.values()])

    def step(self):
        """One engine tick: advance the admit pipeline, then one fused
        decode+sample tick, then emit and free — one host sync per tick.
        Speculative engines run the draft-verify tick instead."""
        if self.speculative:
            return self._step_speculative()
        self._tick_start()
        self._admit()
        if self.async_paging:
            self._prefetch_resume()
        if not self.active:
            return
        k = self._tick_k()
        t0 = time.perf_counter()
        toks, valid = self.executor.decode(k)
        now = time.perf_counter()
        self.decode_s += now - t0
        self.ticks += 1
        self.decode_steps += k
        self._emit(toks, valid, now)

    def run_until_done(self, max_ticks: int = 10_000, *,
                       strict: bool = True) -> List[Request]:
        """Tick until the queue, the staging ring, the slots and the resume
        queue drain.  Dormant swapped-out requests (paused, not resumed)
        are no pending work: the loop returns with them on the host."""
        for _ in range(max_ticks):
            if not self.load:
                break
            self.step()
        if self.load:
            msg = (f"run_until_done: max_ticks={max_ticks} exhausted with "
                   f"{len(self.queue)} queued, {len(self.active)} active, "
                   f"{len(self._stagings)} staging, {len(self.resume_q)} "
                   f"resuming request(s) unfinished")
            if strict:
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning)
        return [r for r in self._all if r.done]

    # ----------------------------------------------------------- metrics
    def reset_metrics(self):
        """Zero the aggregate counters; requests completed so far leave the
        per-request window."""
        self.ticks = 0
        self.decode_steps = 0
        self.decode_s = 0.0
        self.decoded_tokens = 0
        self.stage_dispatches = 0
        self.scatter_dispatches = 0
        self._zero_swap_counters()
        self.spec_ticks = 0
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.draft_prefills = 0
        self.draft_steps = 0
        self.verify_positions = 0
        self.handoffs_out = 0
        self._metrics_seen = {id(r) for r in self._all if r.done}

    def metrics(self) -> Dict[str, float]:
        """Aggregate serving metrics over requests completed since the last
        ``reset_metrics`` (the reference's keys)."""
        done = [r for r in self._all
                if r.done and id(r) not in self._metrics_seen]
        ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
        lats = [r.latency_s for r in done if r.latency_s is not None]
        tps = [r.tokens_per_s for r in done if r.tokens_per_s is not None]
        progs = self.executor.compiled_programs()
        mesh = self.executor.mesh
        return {
            "requests": len(done),
            "tokens": sum(len(r.output) for r in done),
            "ticks": self.ticks,
            "decode_block": self.decode_block,
            "decoded_tokens": self.decoded_tokens,
            "decode_s": self.decode_s,
            "decode_us_per_token":
                self.decode_s / max(1, self.decoded_tokens) * 1e6,
            "stage_dispatches": self.stage_dispatches,
            "scatter_dispatches": self.scatter_dispatches,
            "overlap": int(self.overlap),
            "prefill_chunk": self.executor.prefill_chunk,
            "plan_mode": self.executor.plan_mode,
            "prefill_batching": int(self.executor.prefill_batching),
            "compiled_programs": progs["total"],
            "prefill_programs": progs["prefill"],
            "staging_depth": self.staging_depth,
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "swapped": len(self.swapped),
            "resuming": len(self.resume_q),
            "swap_s": self.swap_s,
            "swap_bytes": self.swap_bytes,
            "swap_us_per_mb": (self.swap_s * 1e6
                               / (self.swap_bytes / 2 ** 20)
                               if self.swap_bytes else 0.0),
            "swap_bytes_per_slot": self.executor.swap_bytes_per_slot,
            "async_paging": int(self.async_paging),
            "gather_ring": self.executor.gather_ring,
            "swap_dispatch_s": self.swap_dispatch_s,
            "swap_stall_s": self.swap_stall_s,
            "swap_gather_s": self.swap_gather_s,
            "swap_put_s": self.swap_put_s,
            "swap_scatter_s": self.swap_scatter_s,
            "swap_prefetches": self.swap_prefetches,
            "swap_prefetch_hits": self.swap_prefetch_hits,
            "swap_prefetch_drops": self.swap_prefetch_drops,
            "swap_harvests_overlapped": self.swap_harvests_overlapped,
            "swap_harvests_forced": self.swap_harvests_forced,
            "swap_overlap_ratio": (
                self.swap_harvests_overlapped
                / max(1, self.swap_harvests_overlapped
                      + self.swap_harvests_forced)),
            "draining_swaps": len(self._draining_q),
            "spills": self.spills,
            "spill_loads": self.spill_loads,
            "spill_bytes": self.spill_bytes,
            "host_swap_bytes_held": sum(
                r.state.nbytes for r in self.swapped.values()
                if r.state is not None),
            "role": self.role,
            "handoffs": len(self._handoff_q),
            "handoffs_out": self.handoffs_out,
            "speculative": int(self.speculative),
            "k_draft": self.k_draft if self.speculative else 0,
            "mesh_data": (int(mesh.size(mesh.mesh_dim_names.index("data")))
                          if mesh is not None else 1),
            "mesh_model": (int(mesh.size(
                mesh.mesh_dim_names.index("model"))) if mesh is not None
                else 1),
            "adaptive_k": int(self.adaptive_k),
            "k_draft_effective":
                (self._k_eff if self.speculative and self.adaptive_k
                 else (self.k_draft if self.speculative else 0)),
            "spec_ticks": self.spec_ticks,
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "acceptance_rate":
                self.accepted_tokens / max(1, self.drafted_tokens),
            "syncs_per_token": self.ticks / max(1, self.decoded_tokens),
            "draft_prefills": self.draft_prefills,
            "checkpoint_bytes_per_slot":
                (self.executor.checkpoint_bytes_per_slot
                 if self.speculative else 0),
            "draft_bytes_per_slot":
                (self.executor.draft_bytes_per_slot
                 if self.speculative else 0),
            "speculative_bytes":
                (self.executor.speculative_bytes
                 if self.speculative else 0),
            "mean_ttft_s": float(np.mean(ttfts)) if ttfts else 0.0,
            "mean_latency_s": float(np.mean(lats)) if lats else 0.0,
            "mean_tokens_per_s": float(np.mean(tps)) if tps else 0.0,
        }
