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

Staging is per prompt: the reference's batched staging emits bitwise the
same streams as its per-prompt path, so this port is held against the
reference's default engine.  Settings of later slices raise
``NotImplementedError`` naming the reference module that holds them.
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.serving.executor import DeviceExecutor, PlanStep, deferred

QUEUED, STAGING, READY, ACTIVE, DONE = ("queued", "staging", "ready",
                                        "active", "done")


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
    output: List[int] = field(default_factory=list)
    done: bool = False
    state: str = "new"
    # wall-clock stamps (perf_counter seconds), set by the scheduler
    t_submit: Optional[float] = None
    t_first: Optional[float] = None     # first token synced to the host
    t_done: Optional[float] = None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first is None or self.t_submit is None:
            return None
        return self.t_first - self.t_submit

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_done is None or self.t_submit is None:
            return None
        return self.t_done - self.t_submit

    @property
    def tokens_per_s(self) -> Optional[float]:
        lat = self.latency_s
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
                 async_paging: bool = False,
                 host_swap_bytes: Optional[int] = None,
                 swap_spool_dir: Optional[str] = None,
                 speculative: bool = False, draft_cfg=None,
                 draft_params=None,
                 adaptive_k: bool = False, role: str = "both",
                 device=None):
        if decode_block < 1:
            raise ValueError(f"decode_block must be >= 1, got {decode_block}")
        if prefill_budget is not None:
            raise deferred("prefill_budget (batched staging)",
                           "serving/scheduler.py")
        if (swap_policy != "manual" or idle_swap_ms is not None
                or max_live_requests is not None
                or host_swap_bytes is not None or swap_spool_dir is not None):
            raise deferred("state paging (swap policies, admission caps, "
                           "spill)", "serving/scheduler.py")
        if speculative or adaptive_k:
            raise deferred("speculative decode", "serving/scheduler.py")
        if role != "both":
            raise deferred(f"role={role!r} (disaggregated serving)",
                           "serving/router.py and serving/rpc.py")
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.seed = seed
        self.decode_block = decode_block
        self.overlap = overlap
        self.budget_ticks = budget_ticks
        self.executor = DeviceExecutor(
            cfg, params, max_slots=max_slots, max_len=max_len,
            decode_block=decode_block, prefill_chunk=prefill_chunk,
            mesh=mesh, staging_depth=staging_depth, plan_mode=plan_mode,
            prefill_batching=prefill_batching, draft_cfg=draft_cfg,
            draft_params=draft_params, async_paging=async_paging,
            device=device)
        self.free: Deque[int] = deque(range(max_slots))
        self.active: Dict[int, Request] = {}
        self.queue: Deque[Request] = deque()
        self._all: List[Request] = []
        self._stagings: List[_Staging] = []
        self._free_bufs: Deque[int] = deque(range(staging_depth))
        self.ticks = 0
        self.decode_steps = 0       # decode steps run by ticks (sum of k)
        self.decode_s = 0.0         # wall time inside decode ticks (+ sync)
        self.decoded_tokens = 0     # tokens emitted by ticks (not admit)
        self.stage_dispatches = 0   # prefill-chunk dispatches
        self.scatter_dispatches = 0  # slot scatters
        self._metrics_seen: set = set()

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
        if any(r.rid == req.rid and not r.done for r in self._all):
            raise ValueError(f"req {req.rid}: rid already live on this "
                             f"engine")
        req.t_submit = time.perf_counter()
        req.state = QUEUED
        self.queue.append(req)
        self._all.append(req)

    def pause(self, rid: int):
        raise deferred("pause (state paging)", "serving/scheduler.py")

    def resume(self, rid: int):
        raise deferred("resume (state paging)", "serving/scheduler.py")

    def preempt(self, rid: Optional[int] = None):
        raise deferred("preempt (state paging)", "serving/scheduler.py")

    @property
    def queue_len(self) -> int:
        return len(self.queue)

    @property
    def free_slots(self) -> int:
        return len(self.free)

    def done_requests(self) -> List[Request]:
        return [r for r in self._all if r.done]

    def _finished(self, req: Request, tok: int) -> bool:
        return (len(req.output) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id))

    # ----------------------------------------------------------- staging
    def _stage_start(self, req: Request):
        buf = self._free_bufs.popleft()
        req.state = STAGING
        self._stagings.append(_Staging(
            req=req, plan=self.executor.plan_prefill(req.prompt_len),
            buf=buf))
        self.executor.stage_begin(
            buf, seed=self.seed, rid=req.rid, temperature=req.temperature,
            top_k=req.top_k, top_p=req.top_p, eos_id=req.eos_id,
            budget=req.max_new_tokens)

    def _stage_dispatch_one(self, st: _Staging):
        step = st.plan[st.plan_pos]
        chunk = st.req._inputs[st.prompt_pos:st.prompt_pos + step.tokens]
        if step.kind == "scan":
            self.executor.stage_chunk_scan(st.buf, chunk, step.valid)
        else:
            self.executor.stage_admit(st.buf, chunk, step.valid)
        st.prompt_pos += step.tokens
        st.plan_pos += 1
        self.stage_dispatches += 1

    def _stage_finish(self, st: _Staging):
        """Plan complete: sync the fused first token (TTFT is stamped here)
        and either complete the request (EOS / max_new_tokens=1) or hold it
        staged-ready until a slot frees."""
        req = st.req
        tok = int(self.executor.staging_tok[st.buf][0])
        req.t_first = time.perf_counter()
        req.output.append(tok)
        if self._finished(req, tok):
            req.done = True
            req.state = DONE
            req.t_done = req.t_first
            self._stagings.remove(st)
            self._free_bufs.append(st.buf)
            return
        st.ready = True
        req.state = READY

    def _stage_scatter(self):
        st = self._stagings.pop(0)
        slot = self.free.popleft()
        self.executor.scatter(slot, st.buf)
        self.scatter_dispatches += 1
        self._free_bufs.append(st.buf)
        self.active[slot] = st.req
        st.req.state = ACTIVE

    def _admit(self):
        """Advance the admit pipeline at a tick boundary: FIFO scatter of
        staged-ready requests into free slots, new stagings while ring
        buffers allow (behind a free slot unless ``overlap``), then one
        chunk dispatch per staging — every chunk while slots are free, one
        per staging per tick once they are all busy."""
        yielded = set()
        while True:
            if self._stagings and self._stagings[0].ready and self.free:
                self._stage_scatter()
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

    # -------------------------------------------------------------- tick
    def _tick_k(self) -> int:
        """Budget-aware tick length: the smallest power-of-two bucket
        (capped at ``decode_block``) covering the largest remaining
        per-slot budget."""
        if not self.budget_ticks:
            return self.decode_block
        need = max(r.max_new_tokens - len(r.output)
                   for r in self.active.values())
        k = 1
        while k < need and k < self.decode_block:
            k <<= 1
        return min(k, self.decode_block)

    def step(self):
        """One engine tick: advance the admit pipeline, then one fused
        decode+sample tick, then emit and free — one host sync per tick."""
        self._admit()
        if not self.active:
            return
        k = self._tick_k()
        t0 = time.perf_counter()
        toks, valid = self.executor.decode(k)
        now = time.perf_counter()
        self.decode_s += now - t0
        self.ticks += 1
        self.decode_steps += k
        for slot, req in list(self.active.items()):
            for j in range(toks.shape[0]):
                if not valid[j, slot]:
                    break
                tok = int(toks[j, slot])
                req.output.append(tok)
                self.decoded_tokens += 1
                if self._finished(req, tok):
                    req.done = True
                    req.state = DONE
                    req.t_done = now
                    del self.active[slot]
                    self.free.append(slot)
                    self.executor.release_slot(slot)
                    break

    def run_until_done(self, max_ticks: int = 10_000, *,
                       strict: bool = True) -> List[Request]:
        """Tick until the queue, the staging ring and the slots drain."""
        for _ in range(max_ticks):
            if not self.queue and not self.active and not self._stagings:
                break
            self.step()
        if self.queue or self.active or self._stagings:
            msg = (f"run_until_done: max_ticks={max_ticks} exhausted with "
                   f"{len(self.queue)} queued, {len(self.active)} active, "
                   f"{len(self._stagings)} staging request(s) unfinished")
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
        self._metrics_seen = {id(r) for r in self._all if r.done}

    def metrics(self) -> Dict[str, float]:
        """Aggregate serving metrics over requests completed since the last
        ``reset_metrics`` (the base-tick subset of the reference's keys)."""
        done = [r for r in self._all
                if r.done and id(r) not in self._metrics_seen]
        ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
        lats = [r.latency_s for r in done if r.latency_s is not None]
        tps = [r.tokens_per_s for r in done if r.tokens_per_s is not None]
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
            "staging_depth": self.staging_depth,
            "syncs_per_token": self.ticks / max(1, self.decoded_tokens),
            "mean_ttft_s": float(np.mean(ttfts)) if ttfts else 0.0,
            "mean_latency_s": float(np.mean(lats)) if lats else 0.0,
            "mean_tokens_per_s": float(np.mean(tps)) if tps else 0.0,
        }
