"""The port's speculative decode against the JAX reference, on the CPU
(every program eager), on reduced qwen3-next-gdn with parameters from the
reference's ``init_lm`` through the bridge.

  * ``lm.checkpoint_specs`` / ``checkpoint_spec`` give the reference's
    rollback images (the full cache spec for every built-in kind);
  * ``lm.verify_steps`` against the reference's on the same caches,
    drafts and sampler rows, with a self-draft and with a draft of other
    weights (``PRNGKey(99)``: its proposals are rejected): tokens,
    validity, last tokens and sampler state equal; the committed and
    run-ahead caches within rtol = atol = 1e-5 (fp32; the two packages
    sum in different orders);
  * at the executor: a verify whose drafts are all rejected leaves every
    slot bitwise as one plain decode step does, and a slot done at entry
    bitwise unchanged;
  * engine streams and the counts ``spec_ticks``, ``drafted_tokens``,
    ``accepted_tokens``, ``draft_prefills``, ``k_draft_effective`` and
    ``compiled_programs()`` equal the reference's speculative engine's for
    ``k_draft`` 1, 2 and 4 (self-draft) and ``adaptive_k`` with the
    ``PRNGKey(99)`` draft, and the streams equal plain decode's;
  * validation, paging's errors and the refusals of what stays unported
    (meshes, engine roles), and the host guard
    (``tests/torch_host_guard.py``) over the draft, verify and draft
    rebuild programs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                    # noqa: E402
from repro.models import lm as jlm                        # noqa: E402
from repro.models.mixers import get_mixer as jget_mixer   # noqa: E402
from repro.serving import sampling as jsampling           # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest      # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch.bridge import to_numpy, to_torch         # noqa: E402
from repro_torch.models import lm as tlm                  # noqa: E402
from repro_torch.models.mixers import get_mixer           # noqa: E402
from repro_torch.serving import sampling as ts            # noqa: E402
from repro_torch.serving.engine import DecodeEngine, Request  # noqa: E402
from repro_torch.tree import leaves                       # noqa: E402
from torch_host_guard import guard_programs               # noqa: E402

ENGINE = dict(max_slots=2, max_len=64, decode_block=2, prefill_chunk=8)
CACHES = dict(rtol=1e-5, atol=1e-5)
SPEC_KEYS = ("spec_ticks", "drafted_tokens", "accepted_tokens",
             "draft_prefills", "k_draft_effective", "speculative",
             "k_draft", "adaptive_k")
PROGRAM_KEYS = ("decode", "prefill", "speculative", "total")
# engine settings per case (the target's own weights draft unless
# "draft99": a draft of other weights, whose proposals are rejected)
CASES = {"k1": dict(k_draft=1), "k2": dict(k_draft=2),
         "k4": dict(k_draft=4),
         "adaptive_k4_draft99": dict(k_draft=4, adaptive_k=True)}

_STATE = {}


def _model():
    if not _STATE:
        jcfg = jconfigs.get_arch("qwen3-next-gdn").reduced()
        init = jax.jit(jlm.init_lm, static_argnums=1)
        jp, jd = init(jax.random.PRNGKey(0), jcfg), init(
            jax.random.PRNGKey(99), jcfg)
        _STATE.update(
            jcfg=jcfg, jp=jp, jd=jd,
            tcfg=tconfigs.get_arch("qwen3-next-gdn").reduced(),
            tp=to_torch(jax.tree.map(np.asarray, jp)),
            td=to_torch(jax.tree.map(np.asarray, jd)))
    return _STATE


def _requests(cls, n=3, max_new=8):
    """Greedy requests and stochastic ones (even rids)."""
    return [cls(rid=i, prompt=np.arange(1, 7 + 3 * i, dtype=np.int32),
                max_new_tokens=max_new + i,
                temperature=0.8 if i % 2 == 0 else 0.0,
                top_k=10 if i % 2 == 0 else 0,
                top_p=0.9 if i % 2 == 0 else 1.0)
            for i in range(n)]


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    return [list(r.output) for r in reqs]


def _engine_kw(case, torch_side):
    m = _model()
    kw = dict(CASES[case])
    if case.endswith("draft99"):
        kw.update(draft_cfg=m["tcfg"] if torch_side else m["jcfg"],
                  draft_params=m["td"] if torch_side else m["jd"])
    return kw


_REFERENCE = {}


def _reference(case):
    if case not in _REFERENCE:
        m = _model()
        if case == "plain":
            eng = JEngine(m["jcfg"], m["jp"], **ENGINE)
        else:
            eng = JEngine(m["jcfg"], m["jp"], speculative=True, **ENGINE,
                          **_engine_kw(case, False))
        streams = _run(eng, _requests(JRequest))
        _REFERENCE[case] = (streams, eng.metrics(),
                            eng.executor.compiled_programs())
    return _REFERENCE[case]


# ------------------------------------------------------------- specs

def test_checkpoint_specs_match_reference():
    m = _model()
    for kind in dict.fromkeys(m["tcfg"].layer_kinds):
        ck = get_mixer(kind).checkpoint_spec(m["tcfg"], 1, 64)
        assert ck.nbytes == get_mixer(kind).cache_spec(m["tcfg"], 1,
                                                       64).nbytes
        assert ck.nbytes == jget_mixer(kind).checkpoint_spec(
            m["jcfg"], 1, 64).nbytes
    for batch in (1, 3):
        assert tlm.checkpoint_specs(m["tcfg"], batch, 64).nbytes == \
            jlm.checkpoint_specs(m["jcfg"], batch, 64).nbytes


# ------------------------------------------------------------- verify

def _primed(params, cfg, prompt):
    """Caches after a prompt and the last prompt token's greedy next."""
    caches = jlm.init_caches(cfg, prompt.shape[0], 64)
    logits, caches = jlm.prefill(params, cfg, caches, tokens=prompt)
    return caches, jnp.argmax(logits, -1).astype(jnp.int32)


@pytest.mark.parametrize("draft", ["self", "draft99"])
def test_verify_steps_match_reference(draft):
    m = _model()
    jcfg, jp = m["jcfg"], m["jp"]
    jd, td = (jp, m["tp"]) if draft == "self" else (m["jd"], m["td"])
    prompt = jnp.asarray(np.random.default_rng(3).integers(
        1, jcfg.vocab, size=(2, 10)), jnp.int32)
    caches, tokens = _primed(jp, jcfg, prompt)
    dcaches, _ = _primed(jd, jcfg, prompt)
    k = 4
    drafts, *_ = jlm.decode_steps(jd, jcfg, tokens, dcaches, k)
    sampler = jsampling.admit_rows(
        5, np.array([0, 1], np.int32), np.array([0.0, 0.8], np.float32),
        np.array([0, 10], np.int32), np.array([1.0, 0.9], np.float32),
        np.array([-1, -1], np.int32), np.array([20, 20], np.int32))
    want = jlm.verify_steps(jp, jcfg, jd, jcfg, tokens, drafts, caches,
                            dcaches, sampler, jsampling.sample_where)

    def bridge(tree):
        return to_torch(jax.tree.map(np.asarray, tree))

    tcaches, tdcaches = bridge(caches), bridge(dcaches)
    run = tlm.init_caches(m["tcfg"], 2, 64, "cpu")
    drun = tlm.init_caches(m["tcfg"], 2, 64, "cpu")
    got = tlm.verify_steps(
        m["tp"], m["tcfg"], td, m["tcfg"], bridge(tokens), bridge(drafts),
        tcaches, tdcaches, run, drun, bridge(sampler),
        lambda st, lg, a: ts.sample_where(st, lg, a, stochastic=True))
    j_toks, j_valid, j_last, j_com, j_dcom, j_run, j_drun, j_st = want
    g_toks, g_valid, g_last, g_com, g_dcom, g_run, g_drun, g_st = got
    np.testing.assert_array_equal(g_toks.numpy(), np.asarray(j_toks))
    np.testing.assert_array_equal(g_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(g_last.numpy(), np.asarray(j_last))
    for key, v in j_st.items():
        np.testing.assert_array_equal(
            g_st[key].numpy(), np.asarray(v).astype(g_st[key].numpy().dtype),
            err_msg=key)
    assert g_com is tcaches and g_dcom is tdcaches
    for jt, gt in ((j_com, g_com), (j_dcom, g_dcom), (j_run, g_run),
                   (j_drun, g_drun)):
        for a, b in zip(jax.tree.leaves(jt), leaves(to_numpy(gt))):
            np.testing.assert_allclose(np.asarray(b, np.float64),
                                       np.asarray(a, np.float64), **CACHES)
    accepted = int(np.asarray(j_valid).sum()) - 2
    assert (accepted > 0) if draft == "self" else (accepted == 0)


def _primed_engines():
    """Two identical speculative engines with both slots active."""
    m = _model()
    engs = []
    for _ in range(2):
        eng = DecodeEngine(m["tcfg"], m["tp"], speculative=True, k_draft=4,
                           device="cpu", **ENGINE)
        for r in _requests(Request, n=2, max_new=20):
            eng.submit(r)
        while len(eng.active) < 2:
            eng.step()
        eng.step()
        engs.append(eng)
    return engs


def _slot(ex, slot):
    return ([t[:, slot].clone() for t in leaves(ex.caches)]
            + [v[slot].clone() for _, v in sorted(ex.sampler.items())]
            + [ex.tokens[slot].clone()])


def test_fully_rejected_tick_equals_one_decode_step():
    """Drafts of -1 never match: only the verify's own sample survives, and
    every slot ends bitwise as one plain decode step leaves it."""
    a, b = _primed_engines()
    xa, xb = a.executor, b.executor
    toks_a, _ = xa.decode(1)
    bad = torch.full((4, xb.max_slots), -1, dtype=torch.int32)
    toks_b, valid_b = xb.spec_verify(4, bad)
    assert valid_b[0].all() and not valid_b[1:].any()
    np.testing.assert_array_equal(toks_b[0], toks_a[0])
    for slot in range(xa.max_slots):
        for x, y in zip(_slot(xa, slot), _slot(xb, slot)):
            assert torch.equal(x, y)


def test_done_slot_is_bitwise_unchanged_by_verify():
    _, b = _primed_engines()
    xb = b.executor
    xb.sampler["done"][1] = True
    before = _slot(xb, 1)
    bad = torch.full((4, xb.max_slots), -1, dtype=torch.int32)
    _, valid = xb.spec_verify(4, bad)
    assert not valid[:, 1].any()
    for x, y in zip(before, _slot(xb, 1)):
        assert torch.equal(x, y)


# ------------------------------------------------------------ engines

@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_streams_and_counts_match_reference(case):
    """The reference speculative engine's streams (which are plain
    decode's) and its acceptance counts and program shapes."""
    plain, _, _ = _reference("plain")
    streams, jm, jprogs = _reference(case)
    assert streams == plain
    m = _model()
    eng = DecodeEngine(m["tcfg"], m["tp"], speculative=True, device="cpu",
                       **ENGINE, **_engine_kw(case, True))
    assert _run(eng, _requests(Request)) == streams
    tm = eng.metrics()
    assert {k: tm[k] for k in SPEC_KEYS} == {k: jm[k] for k in SPEC_KEYS}
    progs = eng.executor.compiled_programs()
    assert {k: progs[k] for k in PROGRAM_KEYS} == \
        {k: jprogs[k] for k in PROGRAM_KEYS}
    for key in ("checkpoint_bytes_per_slot", "draft_bytes_per_slot",
                "speculative_bytes"):
        assert tm[key] == jm[key] > 0, key


def test_self_draft_metrics_and_plain_engine_zeros():
    m = _model()
    eng = DecodeEngine(m["tcfg"], m["tp"], speculative=True, k_draft=4,
                       device="cpu", **ENGINE)
    _run(eng, _requests(Request, max_new=12))
    sm = eng.metrics()
    assert sm["spec_ticks"] == sm["ticks"] > 0
    assert sm["acceptance_rate"] > 0.6 and sm["syncs_per_token"] < 0.5
    assert sm["draft_prefills"] == 3
    assert eng.executor.compiled_programs()["speculative"] >= 3
    plain = DecodeEngine(m["tcfg"], m["tp"], device="cpu", **ENGINE)
    _run(plain, _requests(Request, n=1, max_new=4))
    pm = plain.metrics()
    assert pm["speculative"] == pm["k_draft"] == pm["spec_ticks"] == 0
    assert pm["speculative_bytes"] == 0
    assert plain.executor.compiled_programs()["speculative"] == 0


def test_spec_validation_and_refusals():
    m = _model()
    tcfg, tp = m["tcfg"], m["tp"]
    kw = dict(max_slots=1, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        DecodeEngine(tcfg, tp, draft_cfg=tcfg, draft_params=tp, **kw)
    with pytest.raises(ValueError, match="adaptive_k"):
        DecodeEngine(tcfg, tp, adaptive_k=True, **kw)
    with pytest.raises(ValueError, match="k_draft"):
        DecodeEngine(tcfg, tp, speculative=True, k_draft=0, **kw)
    other = tcfg.replace(vocab=tcfg.vocab + 1)
    with pytest.raises(ValueError, match="vocab"):
        DecodeEngine(tcfg, tp, speculative=True, draft_cfg=other,
                     draft_params=tp, **kw)
    eng = DecodeEngine(tcfg, tp, speculative=True, k_draft=2, **kw)
    emb = np.zeros((4, tcfg.d_model), np.float32)
    with pytest.raises(ValueError, match="prompt_embeds"):
        eng.submit(Request(rid=0, prompt_embeds=emb, max_new_tokens=2))
    # paging runs on a speculative engine: with nothing live, each verb
    # raises its own KeyError; a mesh must be a DeviceMesh, an unknown
    # engine role is the reference's ValueError
    for call in (eng.pause, eng.resume, eng.preempt):
        with pytest.raises(KeyError):
            call(0)
    with pytest.raises(TypeError, match="DeviceMesh"):
        DecodeEngine(tcfg, tp, speculative=True, **kw, mesh=object())
    with pytest.raises(ValueError, match="role must be"):
        DecodeEngine(tcfg, tp, speculative=True, **kw, role="verifier")


def test_spec_programs_stay_on_the_device_after_their_first_call(
        monkeypatch):
    """The draft, verify and draft-rebuild programs make no tensor from
    host data and read none on the host after their first call."""
    streams, _, _ = _reference("adaptive_k4_draft99")
    m = _model()
    calls = guard_programs(monkeypatch)
    eng = DecodeEngine(m["tcfg"], m["tp"], speculative=True, device="cpu",
                       **ENGINE, **_engine_kw("adaptive_k4_draft99", True))
    assert _run(eng, _requests(Request)) == streams
    assert _run(eng, _requests(Request)) == streams
    assert calls["guarded"] > 0
    families = {key[0] for key, p in eng.executor._programs.items()
                if p.calls > 1}
    assert {"draft", "verify", "dprefill"} <= families
