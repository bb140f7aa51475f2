"""The port's speculative decode against the JAX reference's for every
mixer kind, on the CPU (every program eager), on reduced fp32 configs with
parameters from the reference's ``init_lm`` through the bridge.

  * for ``gdn``, ``ssm``, ``rglru``, ``attn``, ``swa`` and ``gdn_naive``
    (the reference's ``tests/test_spec_decode.py`` kinds), a self-draft
    with budget-aware draft lengths and a draft of other weights
    (``PRNGKey(99)``: its proposals are mostly rejected, so the rollback
    runs; ``budget_ticks=False``, full 4-token drafts every tick): the
    port's streams of a mixed greedy and stochastic batch equal the
    reference speculative engine's and the port's plain decode's, and
    ``spec_ticks``, ``drafted_tokens`` and ``accepted_tokens`` equal the
    reference's;
  * state paging on a speculative engine (qwen3-next-gdn, self-draft
    k_draft 4): a pause while a draft is pending swaps out at the verify
    boundary, a resume before it cancels the pause, and a preempt defers
    the same way with automatic resume; streams and ``swap_outs`` /
    ``swap_ins`` / ``draft_prefills`` equal the reference's.

The reference engines are built once per configuration at module scope.
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
from repro_torch.serving.engine import DecodeEngine, Request  # noqa: E402

ARCHS = {
    "gdn": "qwen3-next-gdn",
    "ssm": "mamba2-1.3b",
    "rglru": "recurrentgemma-2b",
    "attn": "yi-9b",
    "swa": "h2o-danube-1.8b",
}
KINDS = list(ARCHS) + ["gdn_naive"]
ENGINE = dict(max_slots=2, max_len=64, decode_block=2, prefill_chunk=8)
SPEC_KEYS = ("spec_ticks", "drafted_tokens", "accepted_tokens",
             "k_draft_effective")
PAGING_KEYS = ("swap_outs", "swap_ins", "swapped", "resuming",
               "draft_prefills", "requests", "tokens")


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
    """Reference and port configs, target weights (PRNGKey(0)) and draft
    weights (PRNGKey(99)) of ``kind``."""
    if kind not in _MODELS:
        name = ARCHS.get(kind, ARCHS["gdn"])
        jcfg = jconfigs.get_arch(name).reduced()
        tcfg = tconfigs.get_arch(name).reduced()
        if kind == "gdn_naive":
            def naive(c):
                return c.replace(pattern=tuple(
                    "gdn_naive" if k == "gdn" else k for k in c.pattern))
            jcfg, tcfg = naive(jcfg), naive(tcfg)
        init = jax.jit(jlm.init_lm, static_argnums=1)
        jp, jd = (init(jax.random.PRNGKey(s), jcfg) for s in (0, 99))
        _MODELS[kind] = dict(
            jcfg=jcfg, tcfg=tcfg, jp=jp, jd=jd,
            tp=to_torch(jax.tree.map(np.asarray, jp)),
            td=to_torch(jax.tree.map(np.asarray, jd)))
    return _MODELS[kind]


def _kw(kind, draft, torch_side):
    m = _model(kind)
    kw = dict(ENGINE, speculative=True, k_draft=4)
    if draft == "draft99":
        kw.update(draft_cfg=m["tcfg"] if torch_side else m["jcfg"],
                  draft_params=m["td"] if torch_side else m["jd"],
                  budget_ticks=False)
    return kw


_JENGINES = {}


def _jengine(kind, draft):
    """The reference's speculative engine, built once, idle, its metrics
    window reset."""
    eng = _JENGINES.get((kind, draft))
    if eng is None:
        m = _model(kind)
        eng = _JENGINES[(kind, draft)] = JEngine(
            m["jcfg"], m["jp"], **_kw(kind, draft, False))
    assert not (eng.queue or eng.active or eng._stagings or eng.swapped
                or eng._pending)
    eng.reset_metrics()
    return eng


def _tengine(kind, draft=None):
    m = _model(kind)
    kw = _kw(kind, draft, True) if draft else dict(ENGINE)
    return DecodeEngine(m["tcfg"], m["tp"], device="cpu", **kw)


def _reqs(R, n=3, stochastic=True, max_new=8):
    return [R(rid=i, prompt=np.arange(1, 7 + 3 * i, dtype=np.int32),
              max_new_tokens=max_new + i,
              temperature=0.8 if stochastic and i % 2 == 0 else 0.0,
              top_k=10 if stochastic and i % 2 == 0 else 0,
              top_p=0.9 if stochastic and i % 2 == 0 else 1.0)
            for i in range(n)]


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    return [list(r.output) for r in reqs]


def _step_until(eng, pred, max_ticks=100):
    for _ in range(max_ticks):
        eng.step()
        if pred():
            return
    raise AssertionError("condition not reached")


@pytest.mark.parametrize("draft", ["self", "draft99"])
@pytest.mark.parametrize("kind", KINDS)
def test_spec_streams_and_acceptance_match_reference(kind, draft):
    jeng = _jengine(kind, draft)
    want = _run(jeng, _reqs(JRequest))
    teng = _tengine(kind, draft)
    assert _run(teng, _reqs(Request)) == want
    assert _run(_tengine(kind), _reqs(Request)) == want
    jm, tm = jeng.metrics(), teng.metrics()
    assert {k: tm[k] for k in SPEC_KEYS} == {k: jm[k] for k in SPEC_KEYS}
    assert tm["spec_ticks"] > 0
    if draft == "self":
        assert tm["accepted_tokens"] > 0
    else:
        assert tm["acceptance_rate"] < 0.5      # the rollback ran


def _pause(eng, R):
    reqs = _reqs(R, n=2, max_new=10)
    for r in reqs:
        eng.submit(r)
    _step_until(eng, lambda: len(eng.active) == 2 and eng._pending)
    assert eng.pause(0) is reqs[0]
    assert reqs[0].state == sched.ACTIVE and 0 not in eng.swapped
    eng.step()                                  # verify, then swap out
    assert reqs[0].state in (sched.SWAPPED, sched.DONE)
    if reqs[0].state == sched.SWAPPED:
        eng.step()                              # the neighbor decodes
        eng.resume(0)
    eng.run_until_done()
    return reqs


def _cancel(eng, R):
    reqs = _reqs(R, n=2, max_new=10)
    for r in reqs:
        eng.submit(r)
    _step_until(eng, lambda: len(eng.active) == 2 and eng._pending)
    eng.pause(0)
    assert eng.resume(0) is reqs[0]             # cancelled before the verify
    assert reqs[0].state == sched.ACTIVE
    eng.run_until_done()
    assert eng.metrics()["swap_outs"] == 0
    return reqs


def _preempt(eng, R):
    reqs = _reqs(R, n=2, max_new=10)
    reqs[0].priority = 1
    for r in reqs:
        eng.submit(r)
    _step_until(eng, lambda: len(eng.active) == 2 and eng._pending)
    assert eng.preempt() is reqs[1]             # the lowest priority
    assert reqs[1].state == sched.ACTIVE        # deferred
    eng.run_until_done()                        # swaps, resumes
    assert eng.metrics()["swap_outs"] >= 1
    return reqs


@pytest.mark.parametrize("script", [_pause, _cancel, _preempt],
                         ids=["pause", "cancel", "preempt"])
def test_paging_deferred_to_the_verify_boundary(script):
    jeng = _jengine("gdn", "self")
    jreqs = script(jeng, JRequest)
    teng = _tengine("gdn", "self")
    treqs = script(teng, Request)
    plain = _run(_tengine("gdn"), _reqs(Request, n=2, max_new=10))
    assert all(r.done for r in treqs)
    assert [list(r.output) for r in treqs] == \
        [list(r.output) for r in jreqs] == plain
    jm, tm = jeng.metrics(), teng.metrics()
    assert {k: tm[k] for k in PAGING_KEYS} == {k: jm[k] for k in PAGING_KEYS}
    assert tm["swap_ins"] == tm["swap_outs"]
