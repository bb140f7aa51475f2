"""Host-side router: one front door over one or more serving engines (port
of ``repro.serving.router``).

A ``Scheduler`` owns one device's slot buffers and programs; serving past
one engine is a routing problem.  The ``Router`` fronts N engines, places
each submitted request on one of them, ticks them all and aggregates
their metrics.  It never touches a device buffer: engines sit behind a
narrow surface (``submit`` / ``step`` / ``withdraw`` / ``load`` / the
count properties), which an in-process ``Scheduler`` and a worker
process's ``EngineProxy`` (``repro_torch.serving.rpc``) implement alike.

Placement policies:
  * ``round_robin``  — cycle over the live engines (uniform traffic);
  * ``least_loaded`` — the engine owing the fewest requests (active +
    queued + staging + resuming), ties to the lowest index (default).

Backlog control:
  * ``rebalance()`` — while one engine is shard-full (every slot busy and
    requests queued) and another has idle capacity (free slots its own
    backlog has not claimed), queued requests migrate from the fullest
    engine's queue tail to the idlest.  Runs at every ``step``; staged and
    active requests never move.
  * ``drain(i)`` — stop placing on engine ``i`` and move its queued
    requests to the others; active and staged requests finish in place.
    ``undrain(i)`` takes it back.

State paging is routed too: ``pause`` / ``resume`` / ``touch`` find the
owning engine, and ``rebalance_swapped`` moves a resume claim off a
slot-full engine: a swapped image is host numpy in the staging caches'
layout, so it restores on any engine of the same config and ``max_len``
(whatever its device) through that engine's own ``_fill_slot``.

**Disaggregated prefill/decode** (engine ``role``): fresh prompts place
only on prefill-capable engines (``prefill`` or ``both``).  A
``role="prefill"`` engine pauses every request at the admit boundary and
parks its image on the handoff queue; each step's handoff sweep ships it
to the least-loaded compatible decode-capable engine, which readmits it
through its resume queue.  Decode ticks never share an engine with
prefill work, and the streams are bitwise the colocated ones.
``pending`` counts undelivered handoffs, so ``run_until_done`` never
abandons one.

**Process-boundary engines**: an ``EngineProxy`` ticks in its own worker
process.  ``step`` issues each proxy's tick without waiting
(``step_begin``) and drains the replies that have arrived, blocking only
when no engine that owes work made progress.  A worker that dies (EOF or
a broken pipe on its channel) is marked dead: its still-queued requests
re-home to live compatible engines, requests past the queue (their state
lived in the dead process) are marked ``"failed"``, and the router keeps
serving on the survivors.

Requests keep their original ``t_submit`` across migrations, so TTFT
measures the client's wait, not the router's shuffling.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Sequence

from repro_torch.serving.rpc import WorkerDied
from repro_torch.serving.scheduler import Request, Scheduler


class Router:
    """Round-robin / least-loaded front door over serving engines."""

    def __init__(self, engines: Sequence[Scheduler], *,
                 policy: str = "least_loaded"):
        if not engines:
            raise ValueError("Router needs at least one engine")
        if policy not in ("round_robin", "least_loaded"):
            raise ValueError(f"unknown placement policy {policy!r}; have "
                             f"'round_robin', 'least_loaded'")
        self.engines: List[Scheduler] = list(engines)
        self.policy = policy
        self._rr = 0                               # round-robin cursor
        self._draining = set()                     # engine indices
        self._dead = set()                         # dead worker indices
        self.placed = [0] * len(self.engines)      # submits per engine
        self.migrated = 0                          # rebalance moves
        self.handoffs = 0                          # prefill→decode ships
        self.rehomed = 0                           # dead-worker recoveries
        roles = [self._role(e) for e in self.engines]
        if any(r != "both" for r in roles):
            if all(r == "decode" for r in roles):
                raise ValueError("every engine is decode-role: nothing "
                                 "can prefill a fresh prompt")
            if ("prefill" in roles
                    and not any(r in ("decode", "both") for r in roles)):
                raise ValueError("prefill-role engines need at least one "
                                 "decode-capable engine to hand off to")

    # --------------------------------------------------------- placement
    @staticmethod
    def _role(e) -> str:
        return getattr(e, "role", "both")

    def _live(self) -> List[int]:
        live = [i for i in range(len(self.engines))
                if i not in self._draining and i not in self._dead]
        if not live:
            raise RuntimeError("all engines are draining or dead; "
                               "undrain one before submitting")
        return live

    def _prefill_capable(self) -> List[int]:
        return [i for i in self._live()
                if self._role(self.engines[i]) != "decode"]

    def _decode_capable(self) -> List[int]:
        return [i for i in self._live()
                if self._role(self.engines[i]) != "prefill"]

    def _place(self) -> int:
        live = self._prefill_capable()
        if not live:
            raise RuntimeError("no live prefill-capable engine to place "
                               "a fresh prompt on")
        if self.policy == "round_robin":
            idx = live[self._rr % len(live)]
            self._rr += 1
            return idx
        return min(live, key=lambda i: (self.engines[i].load, i))

    def submit(self, req: Request) -> int:
        """Validate + enqueue ``req`` on an engine; returns its index."""
        idx = self._place()
        self.engines[idx].submit(req)
        self.placed[idx] += 1
        return idx

    # ------------------------------------------------------ state paging
    def _owner(self, rid: int) -> int:
        for i, e in enumerate(self.engines):
            if i not in self._dead and e.owns(rid):
                return i
        raise KeyError(f"no engine owns a live request with rid {rid}")

    def pause(self, rid: int) -> Request:
        """Swap request ``rid`` out wherever it lives (see
        ``Scheduler.pause``)."""
        return self.engines[self._owner(rid)].pause(rid)

    def resume(self, rid: int) -> Request:
        """Resume a paused request on its owning engine; rebalance may
        later migrate the claim if that engine is slot-full."""
        return self.engines[self._owner(rid)].resume(rid)

    def touch(self, rid: int):
        self.engines[self._owner(rid)].touch(rid)

    # --------------------------------------------------------- rebalance
    def _compatible(self, a: int, b: int) -> bool:
        """A swapped image restores bitwise only onto an engine with the
        same arch config and context length (the cache leaves are sized
        by both); the device may differ — the image is host numpy."""
        ea, eb = self.engines[a], self.engines[b]
        return ea.cfg == eb.cfg and ea.max_len == eb.max_len

    def _move(self, req: Request, donor: int, taker: int) -> bool:
        """Re-home a withdrawn request, preserving ``t_submit`` (TTFT
        measures the client's wait, not the router's shuffling).  If the
        taker rejects it (heterogeneous engines — e.g. a smaller
        ``max_len``), the request goes back on the donor's queue and the
        migration is abandoned rather than the request dropped."""
        t_submit = req.t_submit
        try:
            self.engines[taker].submit(req)
        except ValueError as e:
            self.engines[donor].readmit(req)
            req.t_submit = t_submit
            warnings.warn(f"router: engine {taker} rejected migrated "
                          f"req {req.rid} ({e}); kept on engine {donor}",
                          RuntimeWarning)
            return False
        req.t_submit = t_submit
        self.placed[taker] += 1
        self.placed[donor] -= 1
        return True

    def rebalance(self) -> int:
        """Move queued requests off shard-full engines onto idle ones
        (prefill-capable only — a queued request still needs its prompt
        run).  Returns the number of migrations."""
        moved = 0
        while True:
            capable = self._prefill_capable()
            donors = [i for i in capable
                      if self.engines[i].queue_len
                      and not self.engines[i].free_slots]
            takers = [i for i in capable
                      if self.engines[i].idle_capacity > 0]
            if not donors or not takers:
                return moved
            donor = max(donors, key=lambda i: self.engines[i].queue_len)
            taker = min(takers,
                        key=lambda i: (-self.engines[i].idle_capacity, i))
            req = self.engines[donor].withdraw()
            if req is None:             # raced empty — nothing left to move
                return moved
            if not self._move(req, donor, taker):
                return moved            # taker rejected; req is back home
            moved += 1
            self.migrated += 1

    def rebalance_swapped(self) -> int:
        """Move resume-queue claims off slot-full engines onto
        compatible decode-capable engines with idle capacity.  Returns
        the number of migrations.  Runs after ``rebalance`` at every
        multi-engine step: without it a resumed session is pinned to the
        engine that swapped it out even while a neighbor idles."""
        moved = 0
        while True:
            donors = [i for i in self._live()
                      if self.engines[i].resume_len
                      and not self.engines[i].free_slots]
            if not donors:
                return moved
            donor = max(donors,
                        key=lambda i: self.engines[i].resume_len)
            takers = [i for i in self._decode_capable()
                      if self.engines[i].idle_capacity > 0
                      and self._compatible(donor, i)]
            if not takers:
                return moved
            taker = min(takers,
                        key=lambda i: (-self.engines[i].idle_capacity, i))
            rec = self.engines[donor].withdraw_swapped()
            if rec is None:             # raced empty
                return moved
            try:
                self.engines[taker].readmit_swapped(rec)
            except ValueError as e:
                self.engines[donor].readmit_swapped(rec)
                warnings.warn(f"router: engine {taker} rejected migrated "
                              f"swapped req {rec.req.rid} ({e})",
                              RuntimeWarning)
                return moved
            self.placed[taker] += 1
            self.placed[donor] -= 1
            moved += 1
            self.migrated += 1

    # ---------------------------------------------------------- handoffs
    def dispatch_handoffs(self) -> int:
        """Ship completed-prefill swap records from prefill-role engines
        to the least-loaded compatible decode-capable engine, which
        readmits each through its own restore scatter (resume queue →
        slot grant).  Runs at every step; returns records shipped."""
        moved = 0
        for i in list(self._live()):
            eng = self.engines[i]
            if self._role(eng) != "prefill":
                continue
            while getattr(eng, "handoffs", 0) > 0:
                takers = [j for j in self._decode_capable()
                          if j != i and self._compatible(i, j)]
                if not takers:
                    warnings.warn(
                        f"router: engine {i} holds handoffs but no "
                        f"compatible decode-capable engine is live; "
                        f"leaving them parked", RuntimeWarning)
                    break
                try:
                    rec = eng.withdraw_handoff()
                except WorkerDied:
                    self._on_worker_death(i)
                    break
                if rec is None:
                    break
                taker = min(takers,
                            key=lambda j: (self.engines[j].load, j))
                try:
                    self.engines[taker].readmit_swapped(rec)
                except ValueError as e:
                    eng.readmit_swapped(rec)    # degraded: decode at home
                    warnings.warn(f"router: engine {taker} rejected "
                                  f"handoff req {rec.req.rid} ({e})",
                                  RuntimeWarning)
                    break
                self.placed[taker] += 1
                self.handoffs += 1
                moved += 1
        return moved

    def drain(self, idx: int) -> int:
        """Stop placing on engine ``idx`` and migrate its queued requests
        to the remaining engines.  Active/staged requests finish in place.
        Returns the number of requests moved."""
        if not 0 <= idx < len(self.engines):
            raise IndexError(f"no engine {idx}")
        self._draining.add(idx)
        self._live()                    # raises if nothing is left to serve
        moved = 0
        while True:
            # oldest-first: the full queue migrates in arrival order
            req = self.engines[idx].withdraw(oldest=True)
            if req is None:
                break
            if not self._move(req, idx, self._place()):
                break                   # rejected: left on the drained
                                        # engine (it still serves actives)
            moved += 1
        return moved

    def undrain(self, idx: int):
        self._draining.discard(idx)

    # ------------------------------------------------------- worker death
    def _on_worker_death(self, idx: int):
        """A worker process died (EOF/broken pipe on its RPC channel):
        mark the engine dead, re-home its still-queued requests to live
        compatible prefill-capable engines, and mark requests whose
        state lived in the dead process (staging/active/swapped) as
        ``"failed"`` — their device/host images are gone with it."""
        if idx in self._dead:
            return
        self._dead.add(idx)
        eng = self.engines[idx]
        recover = getattr(eng, "recover_queued", None)
        queued, lost = recover() if recover is not None else ([], [])
        warnings.warn(
            f"router: engine {idx} worker died — re-homing "
            f"{len(queued)} queued request(s), {len(lost)} past-queue "
            f"request(s) failed", RuntimeWarning)
        for req in queued:
            t_submit = req.t_submit
            try:
                takers = [j for j in self._prefill_capable()
                          if self._compatible(idx, j)]
            except RuntimeError:
                takers = []
            placed = False
            for j in sorted(takers,
                            key=lambda j: (self.engines[j].load, j)):
                try:
                    self.engines[j].submit(req)
                except ValueError:
                    continue
                req.t_submit = t_submit
                self.placed[j] += 1
                self.rehomed += 1
                placed = True
                break
            if not placed:
                req.state = "failed"

    def _busy(self, idx: int) -> bool:
        e = self.engines[idx]
        return e.load + getattr(e, "handoffs", 0) > 0

    def _guard(self, idx: int, fn):
        """Run ``fn(engine)``, converting a dead worker into a marked
        engine instead of an exception."""
        try:
            return fn(self.engines[idx])
        except WorkerDied:
            self._on_worker_death(idx)
            return None

    # -------------------------------------------------------------- tick
    @property
    def pending(self) -> int:
        """Requests the router still owes work to, including
        completed-prefill handoffs not yet delivered to a decode engine
        (dormant user-paused sessions are excluded, as on the engine)."""
        return sum(self.engines[i].load
                   + getattr(self.engines[i], "handoffs", 0)
                   for i in range(len(self.engines))
                   if i not in self._dead)

    def step(self):
        """One router tick: rebalance backlog (queued, then resume
        claims), tick every engine, then sweep handoffs.

        Process-remote engines tick **pipelined**: every proxy's step is
        issued up front without waiting (``step_begin``), local engines
        tick while the workers chew, and whatever replies have arrived
        are drained non-blocking — blocking only when nothing local ran
        and no reply was ready (the loop must make progress).  A proxy
        whose previous step is still in flight is simply skipped this
        round: each worker ticks at its own pace instead of the fleet
        marching in lockstep behind the slowest prefill."""
        if len(self.engines) > 1:
            self.rebalance()
            self.rebalance_swapped()
        alive = [i for i in range(len(self.engines))
                 if i not in self._dead]
        proxies = [i for i in alive
                   if hasattr(self.engines[i], "step_begin")]
        locals_ = [i for i in alive if i not in proxies]
        for i in proxies:
            self._guard(i, lambda e: e.step_begin())
        for i in locals_:
            self.engines[i].step()
        # progress = an engine that OWES work ticked; an idle worker's
        # instant replies must not let run_until_done spin through its
        # tick budget while a loaded worker is still chewing (e.g. the
        # decode worker capturing its first CUDA graphs)
        progressed = any(self._busy(i) for i in locals_)
        for i in proxies:
            if i in self._dead:
                continue
            busy = self._busy(i)
            if self._guard(i, lambda e: e.step_drain(block=False)) \
                    and busy:
                progressed = True
        if not progressed:
            # block for one reply from a worker that owes work so the
            # loop paces itself to the workers, not a spin
            for i in proxies:
                if i in self._dead or not self._busy(i):
                    continue
                if self._guard(i, lambda e: e.step_drain(block=True)):
                    break
        if any(self._role(self.engines[i]) == "prefill"
               for i in range(len(self.engines)) if i not in self._dead):
            self.dispatch_handoffs()

    def run_until_done(self, max_ticks: int = 10_000, *,
                       strict: bool = True) -> List[Request]:
        for _ in range(max_ticks):
            if self.pending == 0:
                break
            self.step()
        for i in range(len(self.engines)):      # settle in-flight ticks
            if i not in self._dead and hasattr(self.engines[i],
                                               "step_drain"):
                self._guard(i, lambda e: e.step_drain(block=True))
        if self.pending:
            msg = (f"Router.run_until_done: max_ticks={max_ticks} "
                   f"exhausted with {self.pending} request(s) unfinished "
                   f"across {len(self.engines)} engines")
            if strict:
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning)
        return [r for e in self.engines for r in e.done_requests()]

    # ----------------------------------------------------------- metrics
    def reset_metrics(self):
        for i, eng in enumerate(self.engines):
            if i not in self._dead:
                self._guard(i, lambda e: e.reset_metrics())

    def metrics(self) -> Dict[str, object]:
        """Aggregate metrics over all live engines: counters summed,
        per-request means weighted by each engine's completed-request
        count, plus the per-engine dicts and the router's own placement
        counters."""
        per = []
        for i, eng in enumerate(self.engines):
            if i in self._dead:
                continue
            m = self._guard(i, lambda e: e.metrics())
            if m is not None:
                per.append(m)
        n = [m["requests"] for m in per]

        def wmean(key):
            tot = sum(n)
            if not tot:
                return 0.0
            return float(sum(m[key] * c for m, c in zip(per, n)) / tot)

        decode_s = sum(m["decode_s"] for m in per)
        decoded = sum(m["decoded_tokens"] for m in per)
        return {
            "engines": len(self.engines),
            "policy": self.policy,
            "roles": [self._role(e) for e in self.engines],
            "requests": sum(n),
            "tokens": sum(m["tokens"] for m in per),
            "ticks": sum(m["ticks"] for m in per),
            "decoded_tokens": decoded,
            "decode_s": decode_s,
            "decode_us_per_token": decode_s / max(1, decoded) * 1e6,
            "stage_dispatches": sum(m["stage_dispatches"] for m in per),
            "scatter_dispatches": sum(m["scatter_dispatches"]
                                      for m in per),
            "prefill_batching": int(all(m["prefill_batching"]
                                        for m in per)),
            "compiled_programs": sum(m["compiled_programs"] for m in per),
            "swap_outs": sum(m["swap_outs"] for m in per),
            "swap_ins": sum(m["swap_ins"] for m in per),
            "swapped": sum(m["swapped"] for m in per),
            "resuming": sum(m["resuming"] for m in per),
            "swap_s": sum(m["swap_s"] for m in per),
            "swap_bytes": sum(m["swap_bytes"] for m in per),
            "swap_dispatch_s": sum(m["swap_dispatch_s"] for m in per),
            "swap_stall_s": sum(m["swap_stall_s"] for m in per),
            "swap_prefetches": sum(m["swap_prefetches"] for m in per),
            "swap_prefetch_hits": sum(m["swap_prefetch_hits"]
                                      for m in per),
            "swap_harvests_overlapped": sum(m["swap_harvests_overlapped"]
                                            for m in per),
            "swap_harvests_forced": sum(m["swap_harvests_forced"]
                                        for m in per),
            "draining_swaps": sum(m["draining_swaps"] for m in per),
            "spills": sum(m["spills"] for m in per),
            "spill_loads": sum(m["spill_loads"] for m in per),
            "spill_bytes": sum(m["spill_bytes"] for m in per),
            "handoffs_out": sum(m["handoffs_out"] for m in per),
            "handoffs_pending": sum(m["handoffs"] for m in per),
            "speculative": int(all(m["speculative"] for m in per)),
            "spec_ticks": sum(m["spec_ticks"] for m in per),
            "drafted_tokens": sum(m["drafted_tokens"] for m in per),
            "accepted_tokens": sum(m["accepted_tokens"] for m in per),
            "acceptance_rate": (sum(m["accepted_tokens"] for m in per)
                                / max(1, sum(m["drafted_tokens"]
                                             for m in per))),
            "syncs_per_token": (sum(m["ticks"] for m in per)
                                / max(1, decoded)),
            "draft_prefills": sum(m["draft_prefills"] for m in per),
            "mean_ttft_s": wmean("mean_ttft_s"),
            "mean_latency_s": wmean("mean_latency_s"),
            "mean_tokens_per_s": wmean("mean_tokens_per_s"),
            "placed": list(self.placed),
            "migrated": self.migrated,
            "handoffs": self.handoffs,
            "rehomed": self.rehomed,
            "draining": sorted(self._draining),
            "dead": sorted(self._dead),
            "per_engine": per,
        }
