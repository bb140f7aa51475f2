"""The port's batched staging, pow2 plans and prefill budget against the JAX
reference, on the CPU (every program eager; the GDN kernels' plain
versions where a config asks for them).

  * ``sampling.admit_rows`` and ``sampling.sample_where`` are the
    reference's bit for bit;
  * ``plan_prefill`` equals the reference's, masked and pow2, for every
    prompt length 1..3C;
  * streams and the dispatch and program counts (``stage_dispatches``,
    ``scatter_dispatches``, ``prefill_batching``, ``compiled_programs()``)
    equal the reference engine's on reduced qwen3-next-gdn (gdn + attn),
    mamba2-1.3b (ssm), recurrentgemma-2b (rglru + swa) and
    h2o-danube-1.8b (swa), each request mix holding greedy and stochastic
    requests, under three settings: the default (batched, overlap on,
    three staging rows, no budget), serialized with one staging row and a
    16-token budget, and pow2 plans (per-prompt staging);
  * batch admits share one ``t_first``, one multi-row scatter admits every
    finished row, the packer is strictly oldest-first, the gates fall back
    to per-prompt staging, and no batched or pow2 program makes a host
    tensor or syncs after its first call (``tests/torch_host_guard.py``).

Parameters come from the reference's ``init_lm`` through the bridge;
token streams and counts must be equal, no tolerance.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                    # noqa: E402
from repro.models import lm as jlm                        # noqa: E402
from repro.serving import sampling as jsampling           # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest      # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch.bridge import to_torch                   # noqa: E402
from repro_torch.models.mixers import gdn as tgdn         # noqa: E402
from repro_torch.serving import sampling as ts            # noqa: E402
from repro_torch.serving.engine import DecodeEngine, Request  # noqa: E402
from torch_host_guard import guard_programs               # noqa: E402

ARCHS = {"gdn": "qwen3-next-gdn", "ssm": "mamba2-1.3b",
         "rglru": "recurrentgemma-2b", "swa": "h2o-danube-1.8b"}
PROGRAM_KEYS = ("decode", "prefill_scan", "prefill_chunk", "prefill_admit",
                "prefill", "speculative", "total")
COUNT_KEYS = ("stage_dispatches", "scatter_dispatches", "prefill_batching",
              "compiled_programs", "prefill_programs")
# engine settings per case: the default; serialized with one staging row
# and a 16-token packer budget; pow2 plans (per-prompt staging)
CASES = {
    "default": dict(staging_depth=3),
    "serial_depth1_budget16": dict(overlap=False, staging_depth=1,
                                   prefill_budget=16),
    "pow2": dict(plan_mode="pow2", staging_depth=3),
}
ENGINE = dict(max_slots=2, max_len=64, decode_block=4, prefill_chunk=8,
              seed=7)
# mixed ragged lengths with prefill_chunk=8: tail only (6), scan + tail
# (17), exactly a chunk (8), multi-scan (26), one token (1), mid (13)
LENS = (6, 17, 8, 26, 1, 13)

_MODELS = {}
_REFERENCE = {}


def _model(kind):
    if kind not in _MODELS:
        jcfg = jconfigs.get_arch(ARCHS[kind]).reduced()
        jp = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
        _MODELS[kind] = (jcfg, jp,
                         tconfigs.get_arch(ARCHS[kind]).reduced(),
                         to_torch(jax.tree.map(np.asarray, jp)))
    return _MODELS[kind]


def _requests(cls):
    """Greedy and stochastic requests (temperature / top-k / top-p)."""
    return [cls(rid=i, prompt=np.arange(1, L + 1, dtype=np.int32),
                max_new_tokens=3 + i,
                temperature=0.8 if i % 2 else 0.0,
                top_k=10 if i % 2 else 0,
                top_p=0.9 if i % 2 else 1.0)
            for i, L in enumerate(LENS)]


def _serve(cls, req_cls, cfg, params, **kw):
    eng = cls(cfg, params, **ENGINE, **kw)
    reqs = _requests(req_cls)
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    return eng, [list(r.output) for r in reqs]


def _reference(kind, case):
    if (kind, case) not in _REFERENCE:
        jcfg, jp, _, _ = _model(kind)
        eng, streams = _serve(JEngine, JRequest, jcfg, jp, **CASES[case])
        _REFERENCE[(kind, case)] = (streams, eng.metrics(),
                                    eng.executor.compiled_programs())
    return _REFERENCE[(kind, case)]


# ------------------------------------------------------------ sampling

def test_admit_rows_are_admit_row_bits():
    """``admit_rows`` builds the reference's D rows bit for bit (keys
    folded from (seed, rid)), and each row equals the port's one-row
    ``admit_row`` for that request."""
    rids = np.array([3, 0, 41, 7], np.int32)
    temp = np.array([0.0, 0.8, 1.1, 0.0], np.float32)
    top_k = np.array([0, 10, 0, 0], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 1.0], np.float32)
    eos = np.array([-1, 5, -1, 2], np.int32)
    budget = np.array([4, 9, 1, 30], np.int32)
    want = jsampling.admit_rows(11, rids, temp, top_k, top_p, eos, budget)
    got = ts.admit_rows(11, rids, temp, top_k, top_p, eos, budget)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(v).astype(
                                          got[k].numpy().dtype), err_msg=k)
    for d in range(len(rids)):
        row = ts.admit_row(11, int(rids[d]), float(temp[d]), int(top_k[d]),
                           float(top_p[d]), int(eos[d]), int(budget[d]))
        for k in row:
            assert torch.equal(row[k][0], got[k][d]), (k, d)


@pytest.mark.parametrize("stochastic", [False, True])
def test_sample_where_is_the_reference_bits(stochastic):
    """Tokens and the masked state advance of ``sample_where`` equal the
    reference's: active rows advance as ``sample`` does, inactive rows keep
    their state; a done row stays done."""
    rng = np.random.default_rng(5)
    S, V = 5, 97
    logits = (rng.normal(size=(S, V)) * 3).astype(np.float32)
    rows = jsampling.admit_rows(
        2, np.arange(S, dtype=np.int32),
        np.array([0.0, 0.9, 0.0, 1.3, 0.7] if stochastic else [0.0] * S,
                 np.float32),
        np.array([0, 10, 0, 0, 5] if stochastic else [0] * S, np.int32),
        np.array([1.0, 0.8, 1.0, 1.0, 1.0], np.float32),
        np.array([-1, -1, 3, -1, -1], np.int32),
        np.array([5, 2, 5, 1, 5], np.int32))
    rows = {**rows, "done": rows["done"].at[4].set(True)}
    active = np.array([True, True, False, True, False])
    jtok, jst = jsampling.sample_where(rows, jax.numpy.asarray(logits),
                                       jax.numpy.asarray(active))
    trows = to_torch(jax.tree.map(np.asarray, rows))
    ttok, tst = ts.sample_where(trows, torch.from_numpy(logits),
                                torch.from_numpy(active),
                                stochastic=stochastic)
    np.testing.assert_array_equal(ttok.numpy()[active],
                                  np.asarray(jtok)[active])
    for k, v in jst.items():
        np.testing.assert_array_equal(
            tst[k].numpy(), np.asarray(v).astype(tst[k].numpy().dtype),
            err_msg=k)


# -------------------------------------------------------------- plans

@pytest.mark.parametrize("plan_mode", ["masked", "pow2"])
def test_plan_prefill_matches_reference(plan_mode):
    jcfg, jp, tcfg, tp = _model("gdn")
    kw = dict(max_slots=1, max_len=64, decode_block=1, prefill_chunk=8,
              plan_mode=plan_mode)
    jx = JEngine(jcfg, jp, **kw).executor
    tx = DecodeEngine(tcfg, tp, device="cpu", **kw).executor
    C = tx.prefill_chunk
    for n in range(1, 3 * C + 1):
        want = [(s.kind, s.size, s.tokens,
                 None if s.valid is None else tuple(np.ravel(s.valid)))
                for s in jx.plan_prefill(n)]
        got = [(s.kind, s.size, s.tokens,
                None if s.valid is None else tuple(np.ravel(s.valid)))
               for s in tx.plan_prefill(n)]
        assert got == want, n


# ------------------------------------------------------------ engines

@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_streams_and_counts_match_reference(kind, case):
    """Streams, dispatch counts and program shapes equal the reference
    engine's for the same settings and requests."""
    streams, jm, jprogs = _reference(kind, case)
    _, _, tcfg, tp = _model(kind)
    eng, got = _serve(DecodeEngine, Request, tcfg, tp, device="cpu",
                      **CASES[case])
    assert got == streams
    m = eng.metrics()
    assert {k: m[k] for k in COUNT_KEYS} == {k: jm[k] for k in COUNT_KEYS}
    progs = eng.executor.compiled_programs()
    assert {k: progs[k] for k in PROGRAM_KEYS} == \
        {k: jprogs[k] for k in PROGRAM_KEYS}
    assert m["prefill_batching"] == (case != "pow2")


def test_default_engine_stages_in_batches():
    """The default engine batches, as the reference's does; pow2 plans and
    ``prefill_batching=False`` stage per prompt."""
    _, _, tcfg, tp = _model("gdn")
    kw = dict(max_slots=1, max_len=32, decode_block=1, device="cpu")
    assert DecodeEngine(tcfg, tp, **kw).prefill_batching
    assert not DecodeEngine(tcfg, tp, prefill_batching=False,
                            **kw).prefill_batching
    assert not DecodeEngine(tcfg, tp, plan_mode="pow2",
                            **kw).prefill_batching


def test_batched_programs_across_lengths_match_reference():
    """One engine serving every awkward length: the reference's program
    counts, at most one batched scan and one batched admit."""
    jcfg, jp, tcfg, tp = _model("gdn")
    kw = dict(max_slots=1, max_len=64, decode_block=1, prefill_chunk=8)
    out = []
    for cls, req, cfg, p, extra in ((JEngine, JRequest, jcfg, jp, {}),
                                    (DecodeEngine, Request, tcfg, tp,
                                     dict(device="cpu"))):
        eng = cls(cfg, p, **kw, **extra)
        for rid, T in enumerate((1, 7, 8, 9, 23, 40, 41, 57)):
            eng.submit(req(rid=rid, prompt=np.arange(1, T + 1,
                                                     dtype=np.int32),
                           max_new_tokens=2))
        eng.run_until_done()
        progs = eng.executor.compiled_programs()
        out.append({k: progs[k] for k in PROGRAM_KEYS})
    assert out[1] == out[0]
    assert out[1]["prefill"] <= 2


# ------------------------------------------------- batch-admit semantics

def test_batch_admit_shares_t_first():
    _, _, tcfg, tp = _model("gdn")
    eng = DecodeEngine(tcfg, tp, max_slots=2, max_len=64, decode_block=4,
                       prefill_chunk=8, device="cpu")
    reqs = [Request(rid=i, prompt=np.arange(1, 18, dtype=np.int32),
                    max_new_tokens=4) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert all(r.t_first is not None for r in reqs)
    assert reqs[0].t_first == reqs[1].t_first


def test_multirow_scatter_single_dispatch():
    """Two requests admitted together cost one scatter and one scan + one
    admit dispatch; per prompt they cost two and four.  Same streams."""
    _, _, tcfg, tp = _model("gdn")
    kw = dict(max_slots=2, max_len=64, decode_block=4, prefill_chunk=8,
              device="cpu")
    outs = []
    for batching, scatters, stages in ((None, 1, 2), (False, 2, 4)):
        eng = DecodeEngine(tcfg, tp, prefill_batching=batching, **kw)
        reqs = [Request(rid=i, prompt=np.arange(1, 18, dtype=np.int32),
                        max_new_tokens=6) for i in range(2)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        assert (eng.scatter_dispatches, eng.stage_dispatches) == \
            (scatters, stages)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def test_fairness_long_prompt_drains_oldest_first():
    """Saturated, with a one-chunk budget and short prompts arriving every
    tick behind it, a long staged prompt still drains a chunk per tick and
    takes its first token before any younger prompt."""
    _, _, tcfg, tp = _model("gdn")
    eng = DecodeEngine(tcfg, tp, max_slots=1, max_len=64, decode_block=4,
                       prefill_chunk=8, staging_depth=2, prefill_budget=8,
                       device="cpu")
    busy = Request(rid=99, prompt=np.arange(1, 9, dtype=np.int32),
                   max_new_tokens=50)
    eng.submit(busy)
    eng.step()
    long = Request(rid=0, prompt=np.arange(1, 58, dtype=np.int32),
                   max_new_tokens=4)
    eng.submit(long)
    shorts, ticks = [], 0
    while long.t_first is None and ticks < 12:
        s = Request(rid=1 + ticks, prompt=np.arange(1, 7, dtype=np.int32),
                    max_new_tokens=2)
        eng.submit(s)
        shorts.append(s)
        eng.step()
        ticks += 1
    assert long.t_first is not None and ticks <= 9
    assert all(s.t_first is None for s in shorts)
    eng.run_until_done(max_ticks=50_000)
    assert long.done and busy.done and all(s.done for s in shorts)


# --------------------------------------------------------------- gates

def test_capability_flag_gates_batching(monkeypatch):
    _, _, tcfg, tp = _model("gdn")
    monkeypatch.setattr(tgdn.GatedDeltaNet,
                        "supports_batched_ragged_prefill", False)
    kw = dict(max_slots=1, max_len=64, decode_block=1, prefill_chunk=8,
              device="cpu")
    assert not DecodeEngine(tcfg, tp, **kw).prefill_batching
    with pytest.warns(RuntimeWarning, match="prefill_batching disabled"):
        eng = DecodeEngine(tcfg, tp, prefill_batching=True, **kw)
    assert not eng.prefill_batching
    eng.submit(Request(rid=0, prompt=np.arange(1, 12, dtype=np.int32),
                       max_new_tokens=2))
    assert all(r.done for r in eng.run_until_done())
    with pytest.warns(RuntimeWarning, match="plan_mode is 'pow2'"):
        DecodeEngine(tcfg, tp, prefill_batching=True, plan_mode="pow2",
                     **kw)


def test_prefill_budget_validation():
    _, _, tcfg, tp = _model("gdn")
    with pytest.raises(ValueError, match="prefill_budget"):
        DecodeEngine(tcfg, tp, max_slots=1, max_len=32, prefill_budget=0,
                     device="cpu")


@pytest.mark.parametrize("case", ["default", "pow2"])
def test_programs_stay_on_the_device_after_their_first_call(case,
                                                            monkeypatch):
    """The batched scan and admit (and the pow2 chunk programs) make no
    tensor from host data and read none on the host after their first
    call: what a CUDA graph capture needs."""
    streams, _, _ = _reference("gdn", case)
    _, _, tcfg, tp = _model("gdn")
    calls = guard_programs(monkeypatch)
    eng, got = _serve(DecodeEngine, Request, tcfg, tp, device="cpu",
                      **CASES[case])
    reqs = _requests(Request)           # again: every program called twice
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert calls["guarded"] > 0 and got == streams
    assert [list(r.output) for r in reqs] == streams
    families = {key[0] for key, p in eng.executor._programs.items()
                if p.calls > 1}
    assert ({"bscan", "badmit"} if case == "default"
            else {"scan", "chunk", "admit"}) <= families
