"""The port's state paging against the JAX reference's, on the CPU (every
program eager), on reduced fp32 configs with parameters from the
reference's ``init_lm`` through the bridge.

Each case of the reference's ``tests/test_state_paging.py`` but its two
router tests runs as one script on a reference engine and on a port
engine: the port's streams must equal the reference engine's (paged)
streams and the port's own uninterrupted ones, its paging counters
(``COUNTERS``, and the count of harvests) the reference's, and its
``metrics()`` must hold every paging key of the reference's.  The
cases:

  * pause mid-decode + resume for all six mixer kinds, greedy and
    stochastic, synchronous and async (``async_paging``);
  * the swapped image against the spec budget (the port's
    ``swap_bytes_per_slot`` is the reference's + 8: the port holds the
    sampler's two threefry key words as int64);
  * the admit-boundary swap (batched and per prompt, sync and async), the
    mid-prefill deferral and its cancellation, the swap inside a rolling
    window's wrap;
  * preempt, the pressure and idle policies, grant alternation, dormant
    requests under ``run_until_done``;
  * swap-aware TTFT and tokens/s, the metrics window across a reset;
  * lifecycle and policy validation, ``max_live_requests``;
  * the gather ring under pressure, prefetch hits and drops, the timing
    split;
  * the spill lifecycle and its validation;
  * one image gathered from a reference engine mid-decode, bridged and
    restored into a port engine's slot: its stream continues as the
    reference's does.

The reference engines are built once per executor configuration at
module scope and serve several scripts (each starts and ends idle; a
request's stream depends on its seed, rid, prompt and sampling only).
The reference's paging modes (``MODES``: async paging, the swap policy,
the admission cap, the spill tier) are attributes its scheduler reads at
each use, its executor's gathers and restores are the same programs in
every mode, so each script sets them on the shared engine.
"""
import os
import tempfile
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                    # noqa: E402
from repro.models import lm as jlm                        # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest      # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch.bridge import to_numpy, to_torch         # noqa: E402
from repro_torch.models import lm as tlm                  # noqa: E402
from repro_torch.serving import scheduler as sched        # noqa: E402
from repro_torch.serving import wire                      # noqa: E402
from repro_torch.serving.engine import DecodeEngine, Request  # noqa: E402
from repro_torch.serving.executor import SwappedState     # noqa: E402
from repro_torch.tree import leaves                       # noqa: E402

ARCHS = {
    "gdn": "qwen3-next-gdn",
    "ssm": "mamba2-1.3b",
    "rglru": "recurrentgemma-2b",
    "attn": "yi-9b",
    "swa": "h2o-danube-1.8b",
}
KINDS = list(ARCHS) + ["gdn_naive"]
ENGINE = dict(max_slots=2, max_len=64, decode_block=2, prefill_chunk=8)
# the reference's paging keys of metrics()
PAGING_KEYS = (
    "swap_outs", "swap_ins", "swapped", "resuming", "swap_s", "swap_bytes",
    "swap_us_per_mb", "swap_bytes_per_slot", "async_paging", "gather_ring",
    "swap_dispatch_s", "swap_stall_s", "swap_gather_s", "swap_put_s",
    "swap_scatter_s", "swap_prefetches", "swap_prefetch_hits",
    "swap_prefetch_drops", "swap_harvests_overlapped",
    "swap_harvests_forced", "swap_overlap_ratio", "draining_swaps",
    "spills", "spill_loads", "spill_bytes", "host_swap_bytes_held")
# the counters held equal to the reference's; how its harvests split into
# overlapped and forced, and whether a prefetch is made, depend on when
# its (asynchronously dispatched) gather lands, so there only the
# harvests' sum is held equal
COUNTERS = (
    "swap_outs", "swap_ins", "swapped", "resuming", "async_paging",
    "gather_ring", "draining_swaps", "spills", "spill_loads", "requests",
    "tokens")
# the reference scheduler's paging modes and their defaults
MODES = dict(async_paging=False, swap_policy="manual", idle_swap_ms=None,
             max_live_requests=None, host_swap_bytes=None,
             swap_spool_dir=None)
# the port's sampler row holds the (2,) threefry key as int64, the
# reference's as uint32: 8 bytes more per image
KEY_BYTES = 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's reduced-size tensors: their
    ops are too small to split, and on a host shared with other test
    workers the extra threads only contend.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _model(kind):
    if kind not in _MODELS:
        name = ARCHS.get(kind, ARCHS["gdn"])
        jcfg = jconfigs.get_arch(name).reduced()
        tcfg = tconfigs.get_arch(name).reduced()
        if kind == "gdn_naive":
            def naive(c):
                return c.replace(pattern=tuple(
                    "gdn_naive" if k == "gdn" else k for k in c.pattern))
            jcfg, tcfg = naive(jcfg), naive(tcfg)
        jp = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
        _MODELS[kind] = dict(jcfg=jcfg, jp=jp, tcfg=tcfg,
                             tp=to_torch(jax.tree.map(np.asarray, jp)))
    return _MODELS[kind]


_JENGINES = {}


def _idle(eng):
    return not (eng.queue or eng.active or eng._stagings or eng.resume_q
                or eng.swapped)


def _jengine(kind, **kw):
    """The reference engine of this executor configuration, built once,
    idle, in the paging modes of ``kw``, its metrics window reset."""
    modes = {k: kw.pop(k, v) for k, v in MODES.items()}
    key = (kind, tuple(sorted(kw.items())))
    eng = _JENGINES.get(key)
    if eng is None:
        m = _model(kind)
        eng = _JENGINES[key] = JEngine(m["jcfg"], m["jp"], **{**ENGINE, **kw})
    assert _idle(eng)
    for k, v in modes.items():
        setattr(eng, k, v)
    eng.reset_metrics()
    return eng


def _tengine(kind, **kw):
    m = _model(kind)
    return DecodeEngine(m["tcfg"], m["tp"], device="cpu",
                        **{**ENGINE, **kw})


def _streams(reqs):
    return [list(r.output) for r in reqs]


def _plain(kind, make, **kw):
    """The port's uninterrupted streams of ``make(Request)``."""
    eng = _tengine(kind, **kw)
    reqs = make(Request)
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    return _streams(reqs)


def _both(kind, script, make=None, plain_kw=None, **kw):
    """``script(eng, R)`` (returns its requests) on the reference engine
    and on a port engine of the same settings: the streams equal each
    other and, with ``make``, the port's uninterrupted streams of
    ``make(Request)``; the paging counters equal; the port's metrics hold
    every paging key and its bytes moved are whole images.  Returns (port
    engine, port requests, reference metrics)."""
    jeng = _jengine(kind, **dict(kw))
    jreqs = script(jeng, JRequest)
    teng = _tengine(kind, **kw)
    treqs = script(teng, Request)
    assert _streams(treqs) == _streams(jreqs)
    if make is not None:
        assert _streams(treqs) == _plain(kind, make, **(plain_kw or {}))
    jm, tm = jeng.metrics(), teng.metrics()
    assert set(PAGING_KEYS) <= set(tm)
    assert {k: tm[k] for k in COUNTERS} == {k: jm[k] for k in COUNTERS}
    assert (tm["swap_harvests_overlapped"] + tm["swap_harvests_forced"]
            == jm["swap_harvests_overlapped"] + jm["swap_harvests_forced"]
            == tm["swap_outs"])
    assert tm["swap_bytes_per_slot"] == jm["swap_bytes_per_slot"] + KEY_BYTES
    assert tm["swap_bytes"] == ((tm["swap_outs"] + tm["swap_ins"])
                                * tm["swap_bytes_per_slot"])
    return teng, treqs, jm


def _reqs(n, stochastic, max_new=8):
    def make(R):
        # rid 0, the request the scripts pause, draws when asked: the PRNG
        # key's round trip is the fragile part of a swap
        return [R(rid=i, prompt=np.arange(1, 7 + 3 * i, dtype=np.int32),
                  max_new_tokens=max_new + i,
                  temperature=0.8 if stochastic and i % 2 == 0 else 0.0,
                  top_k=10 if stochastic and i % 2 == 0 else 0,
                  top_p=0.9 if stochastic and i % 2 == 0 else 1.0)
                for i in range(n)]
    return make


def _step_until(eng, pred, max_ticks=100):
    for _ in range(max_ticks):
        eng.step()
        if pred():
            return
    raise AssertionError("condition not reached")


def _drain(eng, reqs, max_ticks=500):
    """Run to completion, resuming every parked session."""
    for _ in range(max_ticks):
        if all(r.done for r in reqs):
            return
        for rid in list(eng.swapped):
            if rid not in eng.resume_q:
                eng.resume(rid)
        eng.step()
    raise AssertionError("drain did not converge")


def _ring_ledger_ok(eng):
    """Free and draining tickets partition the gather ring."""
    ex = eng.executor
    free, pend = set(ex._gather_free), set(ex._gather_pending)
    assert not (free & pend)
    assert free | pend == set(range(ex.gather_ring))
    assert set(eng._draining_q) == {
        rid for rid, rec in eng.swapped.items() if rec.pending is not None}
    return True


def _mid_decode(make, async_paging=False):
    def script(eng, R):
        reqs = make(R)
        for r in reqs:
            eng.submit(r)
        _step_until(eng, lambda: (reqs[0].state == sched.ACTIVE
                                  and len(reqs[0].output) >= 2))
        eng.pause(0)
        assert reqs[0].state == sched.SWAPPED and 0 in eng.swapped
        if async_paging:
            assert eng.swapped[0].phase == sched.DRAINING
            assert _ring_ledger_ok(eng)
        else:
            assert eng.swapped[0].state is not None
        eng.step()                  # neighbors decode over the freed slot
        eng.step()
        eng.resume(0)
        assert reqs[0].state == sched.RESUMING and 0 in eng.resume_q
        eng.run_until_done()
        assert all(r.done for r in reqs)
        return reqs
    return script


# ----------------------------------------------- mid-decode swap parity

@pytest.mark.parametrize("async_paging", [False, True],
                         ids=["sync", "async"])
@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["greedy", "stochastic"])
@pytest.mark.parametrize("kind", KINDS)
def test_pause_resume_mid_decode_matches_reference(kind, stochastic,
                                                   async_paging):
    """A stream swapped out mid-decode and resumed is the reference
    engine's and the uninterrupted one, and so are its neighbors'."""
    make = _reqs(3, stochastic)
    teng, _, _ = _both(kind, _mid_decode(make, async_paging), make=make,
                       async_paging=async_paging)
    m = teng.metrics()
    assert m["swap_outs"] == m["swap_ins"] == 1
    if async_paging:
        assert m["swap_harvests_overlapped"] + m["swap_harvests_forced"] \
            == m["swap_outs"]
        assert _ring_ledger_ok(teng)


def test_swapped_image_matches_spec_budget():
    """The image is numpy in the staging caches' nesting, one row, and
    ``nbytes`` is the spec's per-slot budget: the reference's + 8."""
    def script(eng, R):
        req = _reqs(1, False)(R)[0]
        eng.submit(req)
        _step_until(eng, lambda: req.state == sched.ACTIVE)
        eng.pause(0)
        sw = eng.swapped[0].state
        script.images.append((eng, sw))
        eng.resume(0)
        eng.run_until_done()
        assert req.done
        return [req]

    script.images = []
    teng, _, jm = _both("gdn", script, make=_reqs(1, False))
    (jeng, jsw), (_, sw) = script.images
    assert isinstance(sw, SwappedState)
    flat = leaves(sw.caches)
    assert flat and all(isinstance(x, np.ndarray) for x in flat)
    assert all(x.shape[1] == 1 for x in flat)
    assert wire.structure(sw.caches) == wire.structure(tlm.init_caches(
        _model("gdn")["tcfg"], 1, ENGINE["max_len"], "cpu"))
    assert isinstance(sw.token, np.ndarray) and sw.token.shape == (1,)
    assert set(sw.sampler) == set(teng.executor.sampler) == set(jsw.sampler)
    assert sw.nbytes == teng.executor.swap_bytes_per_slot
    assert jsw.nbytes == jeng.executor.swap_bytes_per_slot
    assert sw.nbytes == jsw.nbytes + KEY_BYTES
    # the caches, token and sampler row are the reference's bits
    for a, b in zip(leaves(sw.caches), jax.tree.leaves(jsw.caches)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(sw.token, jsw.token)
    for k, v in jsw.sampler.items():
        want = np.asarray(v).astype(sw.sampler[k].dtype)
        np.testing.assert_array_equal(sw.sampler[k], want)


# ------------------------------------------------- admit-boundary swaps

def _boundary_reqs(R):
    return [R(rid=0, prompt=np.arange(1, 9, dtype=np.int32),
              max_new_tokens=24),
            R(rid=1, prompt=np.arange(1, 14, dtype=np.int32),
              max_new_tokens=6, temperature=0.8, top_k=10, top_p=0.9)]


@pytest.mark.parametrize("async_paging", [False, True],
                         ids=["sync", "async"])
@pytest.mark.parametrize("batching", [None, False],
                         ids=["batched", "per_prompt"])
def test_swap_at_admit_boundary(batching, async_paging):
    """A staged-ready request (first token drawn, no slot) swaps out of
    its staging row or ring buffer and resumes bitwise."""
    def script(eng, R):
        rr = _boundary_reqs(R)
        eng.submit(rr[0])
        eng.step()                              # the only slot is busy
        eng.submit(rr[1])
        _step_until(eng, lambda: rr[1].state == sched.READY)
        assert len(rr[1].output) == 1 and not eng.free
        eng.pause(1)
        assert rr[1].state == sched.SWAPPED and 1 in eng.swapped
        eng.step()
        eng.resume(1)
        eng.run_until_done()
        assert all(r.done for r in rr)
        assert eng.metrics()["swap_outs"] == 1
        return rr

    _both("gdn", script, make=_boundary_reqs,
          plain_kw=dict(max_slots=1, prefill_batching=batching),
          max_slots=1, prefill_batching=batching, async_paging=async_paging)


@pytest.mark.parametrize("batching", [None, False],
                         ids=["batched", "per_prompt"])
@pytest.mark.parametrize("cancel", [False, True], ids=["swap", "cancel"])
def test_pause_mid_prefill_defers_to_admit(batching, cancel):
    """A pause mid-prefill is pending until the admit boundary, where the
    swap happens; a resume before it cancels the pause."""
    def pair(R):
        return [R(rid=0, prompt=np.arange(1, 9, dtype=np.int32),
                  max_new_tokens=30),
                R(rid=1, prompt=np.arange(1, 61, dtype=np.int32),
                  max_new_tokens=5, temperature=0.8, top_k=10, top_p=0.9)]

    def script(eng, R):
        rr = pair(R)
        eng.submit(rr[0])
        eng.step()                              # slot busy before staging
        eng.submit(rr[1])
        _step_until(eng, lambda: rr[1].state == sched.STAGING)
        assert eng.pause(1) is rr[1]
        assert 1 not in eng.swapped and rr[1].state == sched.STAGING
        if cancel:
            assert eng.resume(1) is rr[1]
        else:
            _step_until(eng, lambda: rr[1].state == sched.SWAPPED)
            assert not rr[1].done and len(rr[1].output) == 1
            eng.resume(1)
        eng.run_until_done()
        assert all(r.done for r in rr)
        assert eng.metrics()["swap_outs"] == (0 if cancel else 1)
        return rr

    kw = dict(max_slots=1, prefill_batching=batching)
    _both("gdn", script, make=pair, plain_kw=kw, **kw)


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["greedy", "stochastic"])
def test_swap_inside_window_wrap(stochastic):
    """The image of a request whose rolling window has wrapped carries
    the wrapped ring and its position meta."""
    W = _model("swa")["tcfg"].window
    assert W and W < 64
    prompt = np.arange(1, W + 9, dtype=np.int32)        # wraps in prefill

    def pair(R):
        return [R(rid=i, prompt=prompt, max_new_tokens=10 + 4 * i,
                  temperature=0.8 if stochastic and i == 0 else 0.0,
                  top_k=10 if stochastic and i == 0 else 0,
                  top_p=0.9 if stochastic and i == 0 else 1.0)
                for i in range(2)]

    def script(eng, R):
        rr = pair(R)
        for r in rr:
            eng.submit(r)
        _step_until(eng, lambda: (rr[0].state == sched.ACTIVE
                                  and len(rr[0].output) >= 4))
        eng.pause(0)
        eng.step()
        eng.resume(0)
        eng.run_until_done()
        assert all(r.done for r in rr)
        return rr

    _both("swa", script, make=pair)


# --------------------------------------------- preemption and policies

def test_preempt_explicit_and_policy_victim():
    """``preempt()`` evicts the lowest priority (ties: the latest
    activation) with automatic resume; ``preempt(rid)`` that one."""
    def victim(R):
        reqs = _reqs(3, False)(R)
        reqs[0].priority = 1                    # rid 1 is the policy victim
        return reqs

    def script(eng, R):
        reqs = victim(R)
        for r in reqs:
            eng.submit(r)
        _step_until(eng, lambda: len(eng.active) == 2)
        v = eng.preempt()
        assert v is reqs[1]
        assert v.state == sched.RESUMING and 1 in eng.resume_q
        eng.run_until_done()
        assert all(r.done for r in reqs)
        return reqs

    _both("gdn", script, make=victim)

    def explicit(eng, R):
        assert eng.preempt() is None            # nothing resident
        reqs = _reqs(2, False)(R)
        for r in reqs:
            eng.submit(r)
        _step_until(eng, lambda: len(eng.active) == 2)
        assert eng.preempt(rid=1) is reqs[1]
        with pytest.raises(KeyError):
            eng.preempt(rid=1)                  # no longer active
        eng.run_until_done()
        assert all(r.done for r in reqs)
        return reqs

    _both("gdn", explicit, make=_reqs(2, False))


def test_pressure_policy_evicts_strictly_lower_priority():
    """A strictly higher-priority waiter evicts the lowest-priority active
    request; equal priorities never displace each other."""
    def pair(R):
        return [R(rid=0, prompt=np.arange(1, 9, dtype=np.int32),
                  max_new_tokens=20),
                R(rid=1, prompt=np.arange(1, 9, dtype=np.int32),
                  max_new_tokens=4, priority=5)]

    def script(eng, R):
        rr = pair(R)
        eng.submit(rr[0])
        eng.step()
        assert rr[0].state == sched.ACTIVE
        eng.submit(rr[1])                       # strictly outranks rid 0
        _step_until(eng, lambda: rr[1].state == sched.ACTIVE)
        assert rr[0].state in (sched.RESUMING, sched.ACTIVE)
        eng.run_until_done()
        assert all(r.done for r in rr)
        assert rr[1].t_done <= rr[0].t_done     # priority jumped the line
        assert eng.metrics()["swap_outs"] >= 1
        return rr

    kw = dict(max_slots=1, swap_policy="pressure")
    _both("gdn", script, make=pair, plain_kw=dict(max_slots=1), **kw)

    def equal(eng, R):
        rr = _reqs(2, False, max_new=4)(R)
        for r in rr:
            eng.submit(r)
        eng.run_until_done()
        assert all(r.done for r in rr)
        assert eng.metrics()["swap_outs"] == 0  # never displaced
        return rr

    _both("gdn", equal, make=_reqs(2, False, max_new=4),
          plain_kw=dict(max_slots=1), **kw)


def test_idle_policy_lease_and_touch():
    """An active request whose lease expires is swapped out dormant;
    ``touch`` renews a lease; parked sessions reconnect bitwise."""
    def script(eng, R):
        # a long lease while the first ticks run, then a real one
        warm = _reqs(2, False, max_new=4)(R)
        for r in warm:
            eng.submit(r)
        _step_until(eng, lambda: warm[0].state == sched.ACTIVE)
        eng.pause(warm[0].rid)
        eng.resume(warm[0].rid)
        eng.run_until_done()
        reqs = [R(rid=10 + r.rid, prompt=r.prompt,
                  max_new_tokens=r.max_new_tokens)
                for r in _reqs(3, False)(R)]
        for r in reqs:
            eng.submit(r)
        _step_until(eng, lambda: len(eng.active) == 2)
        # the lease turns real only now, so no tick before it (however
        # slow on a loaded host) parks anything
        eng.idle_swap_ms = 50.0
        live = sorted(r.rid for r in eng.active.values())
        time.sleep(0.07)                        # both leases go stale
        eng.touch(live[0])                      # ... one is renewed
        eng.step()
        assert live[0] in {r.rid for r in eng.active.values()}
        parked = [r for r in reqs if r.rid == live[1]][0]
        assert parked.state == sched.SWAPPED and live[1] in eng.swapped
        assert live[1] not in eng.resume_q      # dormant, not resuming
        eng.idle_swap_ms = 1e7      # the drain's ticks park nothing more
        _drain(eng, reqs)
        return warm + reqs

    def plain(R):
        return _reqs(2, False, max_new=4)(R) + [
            R(rid=10 + r.rid, prompt=r.prompt,
              max_new_tokens=r.max_new_tokens)
            for r in _reqs(3, False)(R)]

    _both("gdn", script, make=plain, swap_policy="idle", idle_swap_ms=1e7)


def test_grant_alternation_no_starvation():
    """With resumed sessions and staged-ready fresh admits both waiting,
    grants alternate; every stream is its dedicated-slot one."""
    def mk(R):
        return [R(rid=i, prompt=np.arange(1, 9, dtype=np.int32),
                  max_new_tokens=6) for i in range(6)]

    def script(eng, R):
        rr = mk(R)
        for r in rr[:2]:
            eng.submit(r)
        _step_until(eng, lambda: len(eng.active) == 2)
        eng.preempt()
        eng.preempt()
        assert len(eng.resume_q) == 2 and not eng.active
        for r in rr[2:]:
            eng.submit(r)                       # fresh admits contend
        eng.run_until_done()
        assert all(r.done for r in rr)
        m = eng.metrics()
        assert m["swap_outs"] == 2 and m["swap_ins"] == 2
        return rr

    _both("gdn", script, make=mk, plain_kw=dict(max_slots=6))


def test_run_until_done_ignores_dormant():
    """Dormant sessions are no pending work: the loop returns with them
    parked, and a later resume finishes them."""
    def script(eng, R):
        reqs = _reqs(2, False, max_new=4)(R)
        for r in reqs:
            eng.submit(r)
        _step_until(eng, lambda: reqs[0].state == sched.ACTIVE)
        eng.pause(0)
        eng.run_until_done()
        assert reqs[1].done and not reqs[0].done
        assert reqs[0].state == sched.SWAPPED
        assert not (eng.queue or eng.active or eng._stagings
                    or eng.resume_q)
        eng.resume(0)
        assert list(eng.resume_q) == [0]
        eng.run_until_done()
        assert reqs[0].done
        return reqs

    _both("gdn", script, make=_reqs(2, False, max_new=4))


# ------------------------------------------------- swap-aware metrics

def test_ttft_excludes_pre_first_swapped_time():
    """A request paused out of the queue books no parked time as TTFT."""
    def script(eng, R):
        req = _reqs(1, False, max_new=4)(R)[0]
        eng.submit(req)
        eng.pause(0)                            # straight from the queue
        assert eng.swapped[0].state is None
        time.sleep(0.05)
        eng.resume(0)
        assert req.state == sched.QUEUED        # re-queued, re-prefills
        eng.run_until_done()
        assert req.done and req.swapped_s >= 0.05
        wall_ttft = req.t_first - req.t_submit
        assert wall_ttft >= 0.05
        assert req.ttft_s < wall_ttft - 0.04
        return [req]

    _both("gdn", script, make=_reqs(1, False, max_new=4))


def test_throughput_excludes_mid_decode_swapped_time():
    """tokens/s divides by the active latency; TTFT is untouched by a
    swap after the first token."""
    def script(eng, R):
        req = _reqs(1, False, max_new=8)(R)[0]
        eng.submit(req)
        _step_until(eng, lambda: (req.state == sched.ACTIVE
                                  and len(req.output) >= 2))
        ttft = req.ttft_s
        eng.pause(0)
        time.sleep(0.05)
        eng.resume(0)
        eng.run_until_done()
        assert req.done and req.ttft_s == ttft
        assert req.swapped_s >= 0.05
        assert req.active_latency_s <= req.latency_s - 0.04
        assert req.tokens_per_s == pytest.approx(
            len(req.output) / req.active_latency_s)
        assert eng.metrics()["mean_tokens_per_s"] == pytest.approx(
            req.tokens_per_s)
        return [req]

    _both("gdn", script, make=_reqs(1, False, max_new=8))


def test_reset_metrics_completion_marked_window():
    """A request parked across ``reset_metrics`` that finishes after it
    still counts."""
    def script(eng, R):
        a, b = _reqs(2, False, max_new=3)(R)
        eng.submit(a)
        eng.run_until_done()
        eng.submit(b)
        eng.pause(1)                            # parked across the reset
        eng.reset_metrics()
        assert eng.metrics()["requests"] == 0
        eng.resume(1)
        eng.run_until_done()
        m = eng.metrics()
        assert m["requests"] == 1 and m["tokens"] == len(b.output)
        assert m["swap_ins"] == 0               # a queue pause: no image
        return [a, b]

    _both("gdn", script, make=_reqs(2, False, max_new=3))


# --------------------------------------------------- lifecycle errors

def _lifecycle(eng, R):
    with pytest.raises(KeyError):
        eng.pause(7)
    with pytest.raises(KeyError):
        eng.resume(7)
    with pytest.raises(KeyError):
        eng.touch(7)
    with pytest.raises(KeyError):
        eng.preempt(rid=7)
    req = _reqs(1, False)(R)[0]
    eng.submit(req)
    with pytest.raises(ValueError, match="already live"):
        eng.submit(R(rid=0, prompt=np.arange(1, 5, dtype=np.int32)))
    eng.pause(0)
    with pytest.raises(ValueError, match="already live"):
        eng.submit(R(rid=0, prompt=np.arange(1, 5, dtype=np.int32)))
    with pytest.raises(ValueError, match="already swapped"):
        eng.pause(0)
    eng.resume(0)
    eng.run_until_done()
    assert req.done
    again = R(rid=0, prompt=np.arange(1, 5, dtype=np.int32),
              max_new_tokens=2)                 # a finished rid may recur
    eng.submit(again)
    eng.run_until_done()
    req2 = R(rid=1, prompt=np.arange(1, 10, dtype=np.int32),
             max_new_tokens=8)
    eng.submit(req2)
    _step_until(eng, lambda: req2.state == sched.ACTIVE)
    eng.preempt()
    with pytest.raises(ValueError, match="already resuming"):
        eng.resume(1)
    assert eng.pause(1) is req2                 # resuming -> dormant
    assert req2.state == sched.SWAPPED and not eng.resume_q
    eng.resume(1)
    eng.run_until_done()
    assert req2.done
    return [req, again, req2]


def test_lifecycle_validation_errors():
    _both("gdn", _lifecycle)


def _validation(Engine, cfg, params, tmp, **kw):
    bad = (dict(swap_policy="lru"), "swap_policy"), \
        (dict(swap_policy="idle"), "idle_swap_ms"), \
        (dict(swap_policy="auto", idle_swap_ms=-1.0), "idle_swap_ms"), \
        (dict(max_live_requests=0), "max_live_requests"), \
        (dict(host_swap_bytes=-1, swap_spool_dir=tmp), "host_swap_bytes"), \
        (dict(host_swap_bytes=1 << 20), "swap_spool_dir"), \
        (dict(gather_ring=0), "gather_ring")
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            Engine(cfg, params, max_slots=1, max_len=32, **args, **kw)


def test_policy_cap_spill_and_ring_validation(tmp_path):
    m = _model("gdn")
    _validation(JEngine, m["jcfg"], m["jp"], str(tmp_path))
    _validation(DecodeEngine, m["tcfg"], m["tp"], str(tmp_path),
                device="cpu")


def test_max_live_requests_counts_swapped():
    """Swapped sessions count against the admission cap; a finished one
    frees its seat."""
    def script(eng, R):
        reqs = _reqs(2, False, max_new=2)(R)
        for r in reqs:
            eng.submit(r)
        eng.pause(0)                            # swapped still counts
        with pytest.raises(RuntimeError, match="max_live_requests"):
            eng.submit(R(rid=9, prompt=np.arange(1, 5, dtype=np.int32)))
        eng.resume(0)
        eng.run_until_done()
        late = R(rid=9, prompt=np.arange(1, 5, dtype=np.int32),
                 max_new_tokens=2)
        eng.submit(late)
        eng.run_until_done()
        return reqs + [late]

    _both("gdn", script, max_live_requests=2)


# --------------------------------------------------------- async paging

def test_async_ring_pressure_forces_harvest():
    """More drains than gather buffers: the gather that would overflow
    the ring force-harvests the oldest drain first; ``flush_swaps``
    harvests the rest."""
    def script(eng, R):
        reqs = _reqs(3, False)(R)
        for r in reqs:
            eng.submit(r)
        _step_until(eng, lambda: len(eng.active) == 2)
        first = sorted(r.rid for r in eng.active.values())
        eng.pause(first[0])                     # fills the 1-deep ring
        assert eng.swapped[first[0]].phase == sched.DRAINING
        assert _ring_ledger_ok(eng)
        eng.pause(first[1])                     # forces the first harvest
        assert eng.swapped[first[0]].phase == sched.HOSTED
        assert eng.swapped[first[1]].phase == sched.DRAINING
        assert _ring_ledger_ok(eng)
        assert eng.swap_harvests_forced >= 1
        eng.flush_swaps()                       # harvests every drain
        assert not eng._draining_q and _ring_ledger_ok(eng)
        assert {eng.swapped[r].phase for r in first} == {sched.HOSTED}
        for rid in first:
            eng.resume(rid)
        eng.run_until_done()
        assert all(r.done for r in reqs)
        return reqs

    _both("gdn", script, make=_reqs(3, False), async_paging=True,
          gather_ring=1)


def test_async_prefetch_consumed_and_cancelled():
    """A predictable grant takes an image put back a tick ahead; pausing
    the resuming request drops the prefetch."""
    def script(eng, R):
        reqs = _reqs(3, True)(R)
        for r in reqs:
            eng.submit(r)
        _step_until(eng, lambda: (reqs[0].state == sched.ACTIVE
                                  and len(reqs[0].output) >= 2))
        eng.pause(0)
        eng.step()
        eng.resume(0)
        _step_until(eng, lambda: (0 not in eng.swapped
                                  or eng.swapped[0].prefetch is not None))
        if 0 in eng.swapped:
            assert eng.swapped[0].phase == sched.PREFETCHED
            eng.pause(0)
            assert eng.swapped[0].prefetch is None
            assert eng.swapped[0].phase == sched.HOSTED
            assert eng.swap_prefetch_drops == 1
            eng.resume(0)
        eng.run_until_done()
        assert all(r.done for r in reqs)
        assert eng.metrics()["swap_prefetches"] >= 1
        return reqs

    _both("gdn", script, make=_reqs(3, True), async_paging=True)


@pytest.mark.parametrize("async_paging", [False, True],
                         ids=["sync", "async"])
def test_swap_timing_split_and_parked_from_dispatch(async_paging):
    """swap_s splits into dispatch + stall and into gather + put +
    scatter; the sync path books every harvest as a stall; parked time
    runs from the gather's dispatch."""
    def script(eng, R):
        reqs = _reqs(2, False)(R)
        for r in reqs:
            eng.submit(r)
        _step_until(eng, lambda: (reqs[0].state == sched.ACTIVE
                                  and len(reqs[0].output) >= 2))
        eng.pause(0)
        time.sleep(0.05)
        eng.resume(0)
        eng.run_until_done()
        assert all(r.done for r in reqs)
        m = eng.metrics()
        assert m["swap_s"] == pytest.approx(m["swap_dispatch_s"]
                                            + m["swap_stall_s"])
        assert m["swap_s"] == pytest.approx(
            m["swap_gather_s"] + m["swap_put_s"] + m["swap_scatter_s"])
        assert reqs[0].swapped_s >= 0.05
        if async_paging:
            assert m["swap_harvests_overlapped"] >= 1
            assert m["swap_overlap_ratio"] > 0
        else:
            assert m["swap_harvests_overlapped"] == 0
            assert m["swap_overlap_ratio"] == 0
            assert m["swap_stall_s"] > 0
        return reqs

    _both("gdn", script, make=_reqs(2, False), async_paging=async_paging)


# -------------------------------------------------------- spill to disk

def test_spill_lifecycle():
    """Beyond the watermark the dormant image spills to
    ``swap-<rid>.state`` in the spool dir (out of memory), and resume
    reads it back bitwise and deletes the file."""
    def script(eng, R):
        spool = eng.swap_spool_dir
        reqs = _reqs(3, True)(R)
        for r in reqs:
            eng.submit(r)
        _step_until(eng, lambda: (reqs[0].state == sched.ACTIVE
                                  and len(reqs[0].output) >= 2))
        eng.pause(0)
        _step_until(eng, lambda: eng.swapped[0].phase == sched.SPILLED)
        rec = eng.swapped[0]
        assert rec.state is None and rec.pending is None
        assert os.path.exists(rec.spool) and rec.spool.startswith(spool)
        m = eng.metrics()
        assert m["spills"] == 1 and m["spill_bytes"] > 0
        assert m["host_swap_bytes_held"] == 0
        eng.resume(0)
        eng.run_until_done()
        assert all(r.done for r in reqs)
        assert eng.metrics()["spill_loads"] == 1
        assert not os.listdir(spool)
        return reqs

    with tempfile.TemporaryDirectory() as tmp:
        teng, _, jm = _both(
            "gdn", script, make=_reqs(3, True), async_paging=True,
            swap_spool_dir=os.path.join(tmp, "spool"), host_swap_bytes=0)
        assert teng.metrics()["spill_bytes"] == \
            teng.executor.swap_bytes_per_slot
        assert jm["spill_bytes"] + KEY_BYTES == \
            teng.executor.swap_bytes_per_slot


# ------------------------------------------------------- cross-backend

def test_reference_image_restores_into_a_port_slot():
    """An image gathered from a reference engine mid-decode, bridged
    (``bridge.to_torch`` / ``to_numpy``), restored into a port engine's
    slot (and gathered back bitwise): the port's decode continues the
    stream as the reference's resume does."""
    jeng = _jengine("gdn")
    reqs = _reqs(3, True)(JRequest)
    for r in reqs:
        jeng.submit(r)
    _step_until(jeng, lambda: (reqs[0].state == sched.ACTIVE
                               and len(reqs[0].output) >= 2))
    jeng.pause(0)
    jsw = jeng.swapped[0].state
    n = len(reqs[0].output)
    jeng.resume(0)
    jeng.run_until_done()
    want = reqs[0].output[n:]

    sw = SwappedState(caches=to_numpy(to_torch(jsw.caches)),
                      sampler=to_numpy(to_torch(dict(jsw.sampler))),
                      token=np.asarray(jsw.token))
    teng = _tengine("gdn")
    ex = teng.executor
    ex.restore_slot(1, sw)
    # the port gathers back the image it restored, bit for bit, and the
    # gather froze the slot: restore its own image to go on
    back = ex.gather_slot(1)
    assert bool(ex.sampler["done"][1]) and not ex._stochastic()
    assert wire.structure(back.caches) == wire.structure(sw.caches)
    for a, b in zip(leaves(back.caches) + [back.sampler[k] for k in
                                           sorted(sw.sampler)] + [back.token],
                    leaves(sw.caches) + [sw.sampler[k] for k in
                                         sorted(sw.sampler)] + [sw.token]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    ex.restore_slot(1, back)
    assert ex._stochastic()
    got = []
    while not bool(ex.sampler["done"][1]):
        toks, valid = ex.decode(2)
        got += [int(t) for t, v in zip(toks[:, 1], valid[:, 1]) if v]
        assert not valid[:, 0].any()            # slot 0 stays inert
    assert got == want and len(got) > 0


# ------------------------------------------------------------- serve CLI

def test_serve_cli_paging_flags(capsys, tmp_path):
    """The serve CLI's paging flags reach the engine (the paging line
    names them) and leave the plain run's streams."""
    from repro_torch.launch import serve

    def run(flags):
        serve.main(["--arch", "qwen3-next-gdn", "--requests", "4",
                    "--max-new", "6", "--slots", "2", "--max-len", "48",
                    "--device", "cpu"] + flags)
        out = capsys.readouterr().out
        assert "served 4 requests, 24 tokens" in out
        return out, [line.rsplit("toks:", 1)[1] for line in out.splitlines()
                     if "toks:" in line]

    _, plain = run([])
    out, got = run(["--swap-policy", "auto", "--idle-swap-ms", "1e7",
                    "--max-live-requests", "8", "--async-paging",
                    "--gather-ring", "1", "--host-swap-bytes", "0",
                    "--swap-spool-dir", str(tmp_path / "spool")])
    assert got == plain and len(plain) == 4
    assert "paging: swap_policy=auto, idle lease 10000000 ms, max 8 live " \
        "sessions, async (gather ring 1), spool" in out
