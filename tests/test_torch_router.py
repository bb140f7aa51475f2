"""The port's router and engine roles against the JAX reference, on the CPU
(every program eager), on reduced fp32 configs with parameters from the
reference's ``init_lm`` through the bridge.

  * **Disaggregation, live reference (gdn).** One colocated reference
    engine serves the reference streams of a mix of greedy and stochastic
    requests plus one that finishes at its admit; the port's
    ``Router([prefill, decode])`` must give them bitwise: batched and
    per-prompt staging, async paging on the prefill side, a speculative
    decode engine (which rebuilds the draft state at the swap-in).
  * **The other five kinds** (``ssm``, ``rglru``, ``attn``, ``swa``,
    ``gdn_naive``): the router's streams equal the port's own colocated
    ones, which ``tests/test_torch_paging.py`` and
    ``tests/test_torch_spec_kinds.py`` hold against the reference.
  * **The reference's assertions**, transcribed: the one-device router
    tests of ``tests/test_serving_mesh.py`` (placement, rebalance, drain,
    aggregate metrics, a rejected migration, the withdraw watermark,
    validation), the role tests of ``tests/test_disagg.py`` and the two
    router tests of ``tests/test_state_paging.py``, whose migrated streams
    equal the live reference engine's.
  * **Ring reuse**: a migrated image is a copy out of the donor's gather
    ring; the donor reusing its ring leaves the image's bytes alone.

The reference engine is built once at module scope and serves every
reference stream (a request's stream depends on its seed, rid, prompt and
sampling only, not on the engine's other requests).  The worker-process
engines are in ``tests/test_torch_rpc.py``.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                    # noqa: E402
from repro.models import lm as jlm                        # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest      # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch.bridge import to_torch                   # noqa: E402
from repro_torch.serving import scheduler as sched        # noqa: E402
from repro_torch.serving.engine import (DecodeEngine, Request,  # noqa: E402
                                        Router)
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


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's reduced-size tensors (too
    small to split; on a shared host extra threads only contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _model(kind="gdn"):
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


def _engine(kind="gdn", **kw):
    m = _model(kind)
    return DecodeEngine(m["tcfg"], m["tp"], device="cpu", **{**ENGINE, **kw})


def _reqs(n, R=Request, max_new=8):
    """Mixed greedy / stochastic sessions plus one admit-boundary finisher
    (max_new_tokens=1 completes on the prefill engine, never handed
    off)."""
    out = [R(rid=i, prompt=np.arange(1, 7 + 3 * i, dtype=np.int32),
             max_new_tokens=max_new + i,
             temperature=0.8 if i % 2 == 0 else 0.0,
             top_k=10 if i % 2 == 0 else 0,
             top_p=0.9 if i % 2 == 0 else 1.0)
           for i in range(n)]
    out.append(R(rid=n, prompt=np.arange(1, 9, dtype=np.int32),
                 max_new_tokens=1))
    return out


def _migrant(R=Request, max_new=8):
    """The stochastic request the paging router tests migrate."""
    return R(rid=0, prompt=np.arange(1, 9, dtype=np.int32),
             max_new_tokens=max_new, temperature=0.8, top_k=10, top_p=0.9)


def _streams(reqs):
    return [list(r.output) for r in reqs]


_JENGINE = []
_REF = {}


def _ref(what):
    """The live reference engine's streams: ``"mix"`` for ``_reqs(3)``,
    ``("migrant", n)`` for ``_migrant(max_new=n)``."""
    if what not in _REF:
        if not _JENGINE:
            m = _model()
            _JENGINE.append(JEngine(m["jcfg"], m["jp"], **ENGINE))
        eng = _JENGINE[0]
        reqs = (_reqs(3, JRequest) if what == "mix"
                else [_migrant(JRequest, what[1])])
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        assert all(r.done for r in reqs)
        _REF[what] = _streams(reqs)
    return _REF[what]


_COLOCATED = {}


def _colocated(kind):
    """The port's single-engine streams of ``_reqs(3)``."""
    if kind not in _COLOCATED:
        eng = _engine(kind)
        reqs = _reqs(3)
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        assert all(r.done for r in reqs)
        _COLOCATED[kind] = _streams(reqs)
    return _COLOCATED[kind]


def _step_until(eng, pred, max_ticks=100):
    for _ in range(max_ticks):
        eng.step()
        if pred():
            return
    raise AssertionError("condition not reached")


def _disagg(kind, pre_kw=None, dec_kw=None):
    """``_reqs(3)`` through ``Router([prefill, decode])``; the reference's
    assertions on the handoffs and on which engine did what."""
    pre = _engine(kind, role="prefill", **(pre_kw or {}))
    dec = _engine(kind, role="decode", **(dec_kw or {}))
    router = Router([pre, dec])
    reqs = _reqs(3)
    for r in reqs:
        router.submit(r)
    done = router.run_until_done()
    assert all(r.done for r in reqs)
    assert len(done) == len(reqs)
    m = router.metrics()
    assert m["handoffs"] == 3           # the 1-token request never ships
    assert m["handoffs_out"] == 3
    assert m["roles"] == ["prefill", "decode"]
    pm, dm = m["per_engine"]
    assert pm["decoded_tokens"] == 0 and pm["ticks"] == 0
    assert dm["decoded_tokens"] > 0
    assert dm["stage_dispatches"] == 0          # the decode engine never
    assert pm["stage_dispatches"] > 0           # prefills
    assert pm["handoffs_out"] == 3 and dm["swap_ins"] == 3
    # parked time at the handoff stays out of TTFT and throughput
    for r in reqs:
        assert r.ttft_s is not None and r.ttft_s >= 0
        assert r.tokens_per_s is not None and r.tokens_per_s > 0
    return _streams(reqs)


# ---------------------------------------------------------- disaggregation

@pytest.mark.parametrize("case", ["batched", "per_prompt", "async_prefill",
                                  "speculative_decode"])
def test_gdn_disagg_streams_equal_the_live_reference(case):
    """Prefill engine -> admit-boundary pause -> handoff -> decode engine:
    bitwise the reference engine's colocated streams, greedy and
    stochastic, on every staging path and with a speculative taker."""
    pre_kw, dec_kw = {
        "batched": ({}, {}),
        "per_prompt": (dict(prefill_batching=False),
                       dict(prefill_batching=False)),
        "async_prefill": (dict(async_paging=True, gather_ring=1), {}),
        "speculative_decode": ({}, dict(speculative=True, k_draft=2)),
    }[case]
    assert _disagg("gdn", pre_kw, dec_kw) == _ref("mix")


@pytest.mark.parametrize("kind", [k for k in KINDS if k != "gdn"])
def test_disagg_streams_equal_colocated(kind):
    """The other five mixer kinds: the router's disaggregated streams are
    the port's colocated ones."""
    assert _disagg(kind) == _colocated(kind)


def test_colocated_gdn_is_the_reference():
    assert _colocated("gdn") == _ref("mix")


# ------------------------------------- tests/test_disagg.py, role cases

def test_decode_role_rejects_fresh_prompts():
    eng = _engine(role="decode")
    with pytest.raises(ValueError, match="decode"):
        eng.submit(Request(rid=0, prompt=np.arange(4, dtype=np.int32)))


def test_bad_role_topologies_rejected():
    with pytest.raises(ValueError, match="role must be"):
        _engine(role="verifier")
    dec = _engine(role="decode")
    with pytest.raises(ValueError, match="decode-role"):
        Router([dec])
    pre = _engine(role="prefill")
    with pytest.raises(ValueError, match="decode-capable"):
        Router([pre])
    with pytest.raises(ValueError, match="speculative"):
        _engine(adaptive_k=True)


def test_disagg_prefill_keeps_slots_free():
    """A prefill-role engine pauses at admit: it never takes a slot, and
    its handoff queue drains through withdraw_handoff in swap order."""
    pre = _engine(role="prefill")
    reqs = _reqs(2)
    for r in reqs:
        pre.submit(r)
    for _ in range(200):
        pre.step()
        if pre.handoffs == 2 and reqs[2].done:
            break
    assert pre.handoffs == 2
    assert pre.free_slots == pre.max_slots
    assert reqs[2].done                 # admit-boundary finisher
    rids = [pre.withdraw_handoff().req.rid for _ in range(2)]
    assert rids == [0, 1]
    assert pre.withdraw_handoff() is None
    assert pre.handoffs_out == 2
    assert pre.metrics()["handoffs_out"] == 2
    pre.reset_metrics()
    assert pre.metrics()["handoffs_out"] == 0


# --------------------------- tests/test_serving_mesh.py, one-device router

def _mesh_reqs(n, stochastic=False):
    return [Request(rid=i, prompt=np.arange(1, 7 + 3 * i, dtype=np.int32),
                    max_new_tokens=4 + i,
                    temperature=0.8 if stochastic and i % 2 else 0.0,
                    top_k=10 if stochastic and i % 2 else 0)
            for i in range(n)]


def test_router_round_robin_placement():
    r = Router([_engine() for _ in range(3)], policy="round_robin")
    idxs = [r.submit(q) for q in _mesh_reqs(6)]
    assert idxs == [0, 1, 2, 0, 1, 2]
    assert r.placed == [2, 2, 2]


def test_router_least_loaded_placement():
    r = Router([_engine() for _ in range(2)])   # least_loaded by default
    # preload engine 0 with two requests -> the next three go 1, 1, 0
    for rid in (90, 91):
        r.engines[0].submit(Request(rid=rid,
                                    prompt=np.arange(1, 9, dtype=np.int32)))
    idxs = [r.submit(q) for q in _mesh_reqs(3)]
    assert idxs == [1, 1, 0]


def test_router_rebalance_on_shard_full():
    """Queued requests migrate from a shard-full engine to an idle one;
    t_submit survives the move."""
    engs = [_engine(max_slots=1) for _ in range(2)]
    r = Router(engs, policy="round_robin")
    busy = Request(rid=50, prompt=np.arange(1, 9, dtype=np.int32),
                   max_new_tokens=30)
    engs[0].submit(busy)
    engs[0].step()
    q1 = Request(rid=51, prompt=np.arange(1, 9, dtype=np.int32),
                 max_new_tokens=4)
    q2 = Request(rid=52, prompt=np.arange(1, 9, dtype=np.int32),
                 max_new_tokens=4)
    engs[0].submit(q1)
    engs[0].submit(q2)
    t_orig = q2.t_submit
    moved = r.rebalance()
    assert moved >= 1
    assert r.migrated == moved
    # the tail request moved to the idle engine, the head kept its place
    assert q2 in engs[1].queue or q2 in engs[1]._all
    assert q2.t_submit == t_orig
    assert engs[0].queue and engs[0].queue[0] is q1
    done = r.run_until_done()
    assert {q.rid for q in done} == {50, 51, 52}


def test_router_drain():
    engs = [_engine() for _ in range(2)]
    r = Router(engs, policy="round_robin")
    for q in _mesh_reqs(4):
        r.submit(q)                 # 2 queued on each engine
    moved = r.drain(0)
    assert moved == 2
    assert not engs[0].queue
    assert len(engs[1].queue) == 4
    assert [q.rid for q in engs[1].queue] == [1, 3, 0, 2]   # oldest first
    extra = Request(rid=99, prompt=np.arange(1, 9, dtype=np.int32),
                    max_new_tokens=2)
    assert r.submit(extra) == 1     # new submissions skip the drained one
    r.undrain(0)
    with pytest.raises(RuntimeError, match="draining"):
        rr = Router([_engine()])
        rr.drain(0)


def test_router_metrics_aggregate():
    engs = [_engine() for _ in range(2)]
    r = Router(engs, policy="round_robin")
    reqs = _mesh_reqs(4)
    for q in reqs:
        r.submit(q)
    done = r.run_until_done()
    assert len(done) == 4 and all(q.done for q in reqs)
    m = r.metrics()
    per = m["per_engine"]
    assert m["engines"] == 2 and len(per) == 2
    assert m["requests"] == per[0]["requests"] + per[1]["requests"] == 4
    assert m["tokens"] == sum(p["tokens"] for p in per)
    assert m["ticks"] == sum(p["ticks"] for p in per)
    assert m["decoded_tokens"] == sum(p["decoded_tokens"] for p in per)
    assert m["placed"] == [2, 2]
    assert m["mean_ttft_s"] > 0.0
    # every key of the reference router's metrics
    assert set(m) == set(JROUTER_KEYS)
    # a single-engine router is the engine itself (same streams)
    rs = Router([_engine()])
    reqs2 = _mesh_reqs(4)
    for q in reqs2:
        rs.submit(q)
    rs.run_until_done()
    by_rid = {q.rid: q.output for q in reqs}
    assert all(by_rid[q.rid] == q.output for q in reqs2)


# the keys of repro.serving.router.Router.metrics()
JROUTER_KEYS = (
    "engines", "policy", "roles", "requests", "tokens", "ticks",
    "decoded_tokens", "decode_s", "decode_us_per_token", "stage_dispatches",
    "scatter_dispatches", "prefill_batching", "compiled_programs",
    "swap_outs", "swap_ins", "swapped", "resuming", "swap_s", "swap_bytes",
    "swap_dispatch_s", "swap_stall_s", "swap_prefetches",
    "swap_prefetch_hits", "swap_harvests_overlapped",
    "swap_harvests_forced", "draining_swaps", "spills", "spill_loads",
    "spill_bytes", "handoffs_out", "handoffs_pending", "speculative",
    "spec_ticks", "drafted_tokens", "accepted_tokens", "acceptance_rate",
    "syncs_per_token", "draft_prefills", "mean_ttft_s", "mean_latency_s",
    "mean_tokens_per_s", "placed", "migrated", "handoffs", "rehomed",
    "draining", "dead", "per_engine")


def test_router_metrics_keys_are_the_reference_routers():
    """The reference router's metrics over reference engines have the
    keys the port's router reports (the list above is not stale)."""
    m = _model()
    jr = __import__("repro.serving.router", fromlist=["Router"]).Router
    assert set(jr([JEngine(m["jcfg"], m["jp"], **ENGINE)]).metrics()) == \
        set(JROUTER_KEYS)


def test_router_migration_rejection_keeps_request():
    """A taker of a smaller max_len rejecting a migrated request must not
    drop it: it goes back on the donor's queue."""
    donor = _engine(max_slots=1)
    small = _engine(max_len=8)
    r = Router([donor, small], policy="round_robin")
    busy = Request(rid=1, prompt=np.arange(1, 9, dtype=np.int32),
                   max_new_tokens=20)
    donor.submit(busy)
    donor.step()                            # slot busy
    long = Request(rid=2, prompt=np.arange(1, 15, dtype=np.int32),
                   max_new_tokens=2)        # 14 tokens > small's max_len
    donor.submit(long)
    with pytest.warns(RuntimeWarning, match="rejected migrated"):
        moved = r.rebalance()
    assert moved == 0
    assert long in donor.queue and long in donor._all
    done = r.run_until_done()
    assert {q.rid for q in done} == {1, 2}


def test_withdraw_keeps_metrics_watermark():
    """Withdrawing a pre-reset request must not shift post-reset requests
    out of the metrics window."""
    eng = _engine()
    a = Request(rid=1, prompt=np.arange(1, 9, dtype=np.int32),
                max_new_tokens=2)
    eng.submit(a)
    eng.reset_metrics()                     # watermark past the queued a
    b = Request(rid=2, prompt=np.arange(1, 9, dtype=np.int32),
                max_new_tokens=2)
    eng.submit(b)
    assert eng.withdraw(oldest=True) is a   # a leaves; the window follows
    eng.run_until_done()
    m = eng.metrics()
    assert m["requests"] == 1 and b.done


def test_router_validation():
    with pytest.raises(ValueError, match="at least one"):
        Router([])
    with pytest.raises(ValueError, match="policy"):
        Router([_engine()], policy="random")


# --------------------------------- tests/test_state_paging.py, router cases

def test_router_pause_resume_and_swap_migration():
    """The router finds a rid's owning engine for pause / resume / touch,
    and swap-aware rebalance migrates a resume claim from a slot-full
    engine to a compatible idle one, restored there bitwise (the live
    reference engine's stream)."""
    engs = [_engine(max_slots=1) for _ in range(2)]
    router = Router(engs, policy="round_robin")
    a = _migrant()
    assert router.submit(a) == 0
    engs[0].step()
    assert a.state == sched.ACTIVE
    router.pause(0)                             # through the router
    assert a.state == sched.SWAPPED and 0 in engs[0].swapped
    hog = Request(rid=10, prompt=np.arange(1, 9, dtype=np.int32),
                  max_new_tokens=24, temperature=0.8, top_k=10, top_p=0.9)
    engs[0].submit(hog)
    engs[0].step()                              # hog takes e0's only slot
    router.resume(0)                            # e0 slot-full: a donor
    assert list(engs[0].resume_q) == [0]
    router.step()                               # rebalance_swapped moves it
    assert 0 in engs[1].swapped or any(
        r.rid == 0 and r.state == sched.ACTIVE for r in engs[1]._all)
    router.touch(0)                             # owner lookup after the move
    done = router.run_until_done()
    assert {r.rid for r in done} == {0, 10}
    assert any(r is a for r in engs[1]._all)    # finished on the taker
    assert [list(a.output)] == _ref(("migrant", 8))
    m = router.metrics()
    assert m["swap_outs"] >= 1 and m["swap_ins"] >= 1
    assert m["migrated"] >= 1


def test_router_sums_swap_split_and_migration_waits_for_harvest():
    """Router metrics sum the dispatch / stall split, and a swapped-state
    migration harvests a still-draining gather itself, so the record
    moves with a complete host image, restored bitwise on the taker."""
    engs = [_engine(max_slots=1, async_paging=True) for _ in range(2)]
    router = Router(engs, policy="round_robin")
    a = _migrant(max_new=12)
    router.submit(a)
    engs[0].step()
    assert a.state == sched.ACTIVE
    router.pause(0)
    assert engs[0].swapped[0].phase == sched.DRAINING
    router.resume(0)
    # withdraw while the gather is still draining (no tick swept it)
    assert engs[0].swapped[0].phase == sched.DRAINING
    rec = engs[0].withdraw_swapped()
    assert rec is not None
    assert rec.pending is None and rec.prefetch is None     # harvested
    assert isinstance(rec.state, SwappedState)
    hog = Request(rid=10, prompt=np.arange(1, 9, dtype=np.int32),
                  max_new_tokens=24)
    engs[0].submit(hog)
    engs[1].readmit_swapped(rec)
    done = router.run_until_done()
    assert {r.rid for r in done} == {0, 10}
    assert [list(a.output)] == _ref(("migrant", 12))
    m = router.metrics()
    assert m["swap_dispatch_s"] > 0
    assert m["swap_s"] == pytest.approx(m["swap_dispatch_s"]
                                        + m["swap_stall_s"])
    assert (m["swap_harvests_overlapped"] + m["swap_harvests_forced"]
            == m["swap_outs"])


def test_migration_surface_refusals():
    """``readmit_swapped`` refuses a rid already live on the taker; the
    withdraw verbs return None with nothing to give; ``owns`` and the
    count properties follow the lifecycle."""
    eng = _engine()
    assert eng.withdraw() is None and eng.withdraw_swapped() is None
    assert eng.withdraw_handoff() is None
    a = _migrant()
    eng.submit(a)
    assert eng.owns(0) and eng.load == 1 and eng.queue_len == 1
    assert eng.idle_capacity == eng.max_slots - 1
    _step_until(eng, lambda: a.state == sched.ACTIVE)
    assert eng.load == 1 and eng.free_slots == 1 and eng.staging_len == 0
    eng.pause(0)
    eng.resume(0)
    assert eng.resume_len == 1 and eng.load == 1
    rec = eng.withdraw_swapped()
    assert not eng.owns(0) and eng.load == 0
    eng.submit(Request(rid=0, prompt=np.arange(1, 5, dtype=np.int32),
                       max_new_tokens=2))
    with pytest.raises(ValueError, match="already live"):
        eng.readmit_swapped(rec)
    eng.run_until_done()
    eng.readmit_swapped(rec)            # the live rid finished: taken
    eng.run_until_done()
    assert [list(a.output)] == _ref(("migrant", 8))


# ---------------------------------------------------------------- ring reuse

def test_migrated_image_survives_donor_ring_reuse():
    """A migrated image is a copy out of the donor's gather ring: after the
    donor gathers another request through its only ring buffer, the
    image's bytes are unchanged, and the taker resumes its stream as the
    reference's."""
    donor = _engine(async_paging=True, gather_ring=1)
    taker = _engine()
    a = _migrant(max_new=12)
    b = Request(rid=1, prompt=np.arange(1, 12, dtype=np.int32),
                max_new_tokens=20)
    donor.submit(a)
    donor.submit(b)
    _step_until(donor, lambda: a.state == b.state == sched.ACTIVE
                and len(a.output) >= 3)
    donor.pause(0)
    donor.resume(0)
    rec = donor.withdraw_swapped()
    image = [np.array(x, copy=True) for x in
             leaves(rec.state.caches) + list(rec.state.sampler.values())
             + [rec.state.token]]
    donor.pause(1)                      # the ring's one buffer again
    donor.flush_swaps()
    assert len(donor.executor._gather_bufs) == 1
    after = (leaves(rec.state.caches) + list(rec.state.sampler.values())
             + [rec.state.token])
    assert all(x.dtype == y.dtype and x.tobytes() == y.tobytes()
               for x, y in zip(image, after))
    ring = leaves(donor.executor._gather_bufs[0][1][0])
    assert any(np.asarray(t).tobytes() != x.tobytes()
               for t, x in zip(ring, image))    # the ring moved on
    taker.readmit_swapped(rec)
    taker.run_until_done()
    assert [list(a.output)] == _ref(("migrant", 12))
