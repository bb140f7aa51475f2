"""The port's MoE FFN (``repro_torch.models.moe``) and its two archs,
mixtral-8x7b and arctic-480b, against the JAX reference on the CPU, in
fp32, with inputs made with numpy from a seed and parameters from the
reference's ``init_lm`` through the numpy bridge.

  * ``moe_fwd`` (y and the aux loss) over experts, top-k, capacity factor,
    group size and token count: a case that drops slots (cf 0.5), one
    with fewer tokens than a group, one with several groups; its
    gradients against ``jax.grad``; ``moe_decode``;
  * ties: the experts picked are ``jax.lax.top_k``'s (a zero router, and
    two rows of probabilities with equal entries);
  * reduced mixtral-8x7b (swa + MoE) and arctic-480b (attn + MoE beside a
    dense MLP): the logits of ``prefill``, of ``prefill_chunk`` with a
    ragged per-row ``valid_len`` and of ``decode_step``; the reference's
    prefill/decode consistency with dropless capacity; ``loss_fn`` (aux
    included) and its gradients; one ``build_train_step`` step against
    the jitted reference step;
  * serving reduced mixtral against a live reference ``DecodeEngine``:
    the default engine (its gate stages per prompt; asking for batched
    staging warns "expert-capacity"), pow2 plans and a self-draft
    speculative engine, each with a stochastic request: streams, stage
    and scatter dispatches equal, every port program under the host guard
    (``tests/torch_host_guard.py``); reduced arctic through the default
    engine;
  * full width on the ``meta`` device: every leaf shape and dtype of
    both configs equals the reference's ``jax.eval_shape(init_lm)``.

Tolerances: one MoE layer in fp32 differs only in summation order
(rtol 1e-5, atol 1e-6); the reduced LMs' logits agree to 1e-4, their
losses to 1e-5 relative and gradients to 1e-4 relative (absolute floor
1e-6), as ``tests/test_torch_model.py`` and ``tests/test_torch_train.py``
hold the dense archs; streams and counts are equal, no tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                    # noqa: E402
from repro.models import lm as jlm                        # noqa: E402
from repro.models import moe as jmoe                      # noqa: E402
from repro.runtime import trainer as jtrainer             # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest      # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch.bridge import to_numpy, to_torch         # noqa: E402
from repro_torch.models import lm as tlm                  # noqa: E402
from repro_torch.models import moe as tmoe                # noqa: E402
from repro_torch.runtime import trainer as ttrainer       # noqa: E402
from repro_torch.serving.engine import DecodeEngine, Request  # noqa: E402
from repro_torch.tree import leaves                       # noqa: E402
from torch_host_guard import guard_programs               # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-6)
LOGITS = dict(rtol=1e-4, atol=1e-4)
LOSS = dict(rtol=1e-5, atol=0)
GRAD = dict(rtol=1e-4, atol=1e-6)
ARCHS = ("mixtral-8x7b", "arctic-480b")
# the reference's layer runs jitted (one compile per shape, not one
# dispatch per eager op)
_j_moe_fwd = jax.jit(jmoe.moe_fwd, static_argnames=(
    "top_k", "capacity_factor", "group_size"))
_j_moe_decode = jax.jit(jmoe.moe_decode, static_argnames=("top_k",))
ENGINE = dict(max_slots=2, max_len=64, decode_block=2, prefill_chunk=8,
              seed=3)
# ragged prompts with prefill_chunk=8: tail only, scan + tail, exactly a
# chunk, two chunks and a tail
LENS = (6, 17, 8, 21)
# serving cases: engine arguments (the default stages per prompt: MoE)
CASES = {"default": {}, "pow2": dict(plan_mode="pow2"),
         "spec": dict(speculative=True, k_draft=2)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for reduced-size tensors (too small to split;
    on a host shared with other test workers extra threads contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------ one layer

def _layer_params(rng, d, f, E):
    return {"router": rng.normal(size=(d, E)).astype(np.float32) * 0.5,
            "wi_gate": rng.normal(size=(E, d, f)).astype(np.float32) * 0.25,
            "wi_up": rng.normal(size=(E, d, f)).astype(np.float32) * 0.25,
            "wo": rng.normal(size=(E, f, d)).astype(np.float32) * 0.2}


def _both(p):
    return (jax.tree.map(jnp.asarray, p),
            {k: torch.from_numpy(v.copy()) for k, v in p.items()})


# (E, k, capacity factor, group size, B, T): one group; slots dropped at
# cf 0.5; N = 34 tokens under a group of 128; four groups of 16; top-1
MOE_CASES = [(4, 2, 1.25, 64, 2, 32), (4, 2, 0.5, 64, 2, 32),
             (8, 2, 1.25, 128, 2, 17), (4, 2, 1.25, 16, 2, 32),
             (8, 1, 1.0, 32, 1, 32)]


@pytest.mark.parametrize("E,k,cf,gs,B,T", MOE_CASES)
def test_moe_fwd_matches_reference(E, k, cf, gs, B, T):
    rng = np.random.default_rng(E * 100 + T)
    jp, tp = _both(_layer_params(rng, 16, 32, E))
    x = rng.normal(size=(B, T, 16)).astype(np.float32)
    kw = dict(top_k=k, capacity_factor=cf, group_size=gs)
    jy, ja = _j_moe_fwd(jp, jnp.asarray(x), **kw)
    ty, ta = tmoe.moe_fwd(tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    np.testing.assert_allclose(float(ta), float(ja), **F32)
    if cf < 1:           # the capacity dropped slots
        dropless, _ = tmoe.moe_fwd(tp, torch.from_numpy(x), top_k=k,
                                   capacity_factor=E / k, group_size=gs)
        assert not torch.allclose(ty, dropless)


def test_moe_fwd_gradients_match_reference():
    """d(sum(y * r) + aux) by the parameters and x, with slots dropped."""
    rng = np.random.default_rng(5)
    p = _layer_params(rng, 16, 32, 4)
    x = rng.normal(size=(2, 32, 16)).astype(np.float32)
    r = rng.normal(size=(2, 32, 16)).astype(np.float32)
    kw = dict(top_k=2, capacity_factor=0.75, group_size=32)

    def jf(p, x):
        y, aux = jmoe.moe_fwd(p, x, **kw)
        return jnp.sum(y * r) + aux

    jp, tp = _both(p)
    jg = jax.jit(jax.grad(jf, argnums=(0, 1)))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    for t in tp.values():
        t.requires_grad_(True)
    y, aux = tmoe.moe_fwd(tp, tx, **kw)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    for name in tp:
        np.testing.assert_allclose(_np(tp[name].grad), _np(jg[0][name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(_np(tx.grad), _np(jg[1]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("E,k", [(4, 2), (8, 1)])
def test_moe_decode_matches_reference(E, k):
    rng = np.random.default_rng(E + k)
    jp, tp = _both(_layer_params(rng, 16, 32, E))
    x = rng.normal(size=(3, 16)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tmoe.moe_decode(tp, torch.from_numpy(x), top_k=k)),
        _np(_j_moe_decode(jp, jnp.asarray(x), top_k=k)), **F32)


def test_ties_pick_the_reference_experts():
    """Equal probabilities go to the lower expert index, as with
    ``jax.lax.top_k`` (``torch.topk`` picks [6, 5] and [2, 5] here); a
    zero router makes every softmax row equal, at decode and through the
    capacity dispatch."""
    rows = np.array([[.125] * 8, [.1, .2, .2, .1, .1, .2, .05, .05]],
                    np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(rows), 2)
    tv, ti = tmoe.select_top_k(torch.from_numpy(rows), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), [[0, 1], [1, 2]])
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    rng = np.random.default_rng(9)
    p = _layer_params(rng, 16, 32, 8)
    p["router"][:] = 0.0
    jp, tp = _both(p)
    x = rng.normal(size=(2, 16, 16)).astype(np.float32)
    kw = dict(top_k=2, capacity_factor=1.0, group_size=32)
    jy, ja = _j_moe_fwd(jp, jnp.asarray(x), **kw)
    ty, ta = tmoe.moe_fwd(tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    np.testing.assert_allclose(float(ta), float(ja), **F32)
    np.testing.assert_allclose(
        _np(tmoe.moe_decode(tp, torch.from_numpy(x[:, 0]))),
        _np(_j_moe_decode(jp, jnp.asarray(x[:, 0]))), **F32)


# ------------------------------------------------------------ reduced LMs

_MODELS = {}


def _model(arch):
    """(jcfg, jparams, tcfg, tparams) of the reduced arch, from
    PRNGKey(0)."""
    if arch not in _MODELS:
        jcfg = jconfigs.get_arch(arch).reduced()
        jp = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
        _MODELS[arch] = (jcfg, jp, tconfigs.get_arch(arch).reduced(),
                         to_torch(jax.tree.map(np.asarray, jp)))
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_logits_match_reference(arch):
    """prefill's last logits, a ragged prefill_chunk (per-row valid_len)
    continued by decode_step: hidden rows, caches and logits."""
    jcfg, jp, tcfg, tp = _model(arch)
    rng = np.random.default_rng(1)
    B, T = 2, 16
    toks = rng.integers(0, jcfg.vocab, (B, T)).astype(np.int32)
    jl, _ = jlm.prefill(jp, jcfg, jlm.init_caches(jcfg, B, 64),
                        tokens=jnp.asarray(toks))
    tl, _ = tlm.prefill(tp, tcfg, tlm.init_caches(tcfg, B, 64, "cpu"),
                        tokens=torch.from_numpy(toks).long())
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGITS)

    vl = np.array([5, 8], np.int32)
    jh, jc = jlm.prefill_chunk(jp, jcfg, jlm.init_caches(jcfg, B, 64),
                               tokens=jnp.asarray(toks[:, :8]),
                               valid_len=jnp.asarray(vl))
    tc = tlm.init_caches(tcfg, B, 64, "cpu")
    th, tc = tlm.prefill_chunk(tp, tcfg, tc,
                               tokens=torch.from_numpy(toks[:, :8]).long(),
                               valid_len=torch.from_numpy(vl))
    for b, n in enumerate(vl):
        np.testing.assert_allclose(_np(th[b, :n]), _np(jh[b, :n]),
                                   **LOGITS)
    for a, b in zip(leaves(to_numpy(tc)), jax.tree.leaves(jc)):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), **LOGITS)
    tok = toks[:, 8]
    jd, _ = jlm.decode_step(jp, jcfg, jnp.asarray(tok), jc)
    td, _ = tlm.decode_step(tp, tcfg, torch.from_numpy(tok).long(), tc)
    np.testing.assert_allclose(_np(td), _np(jd), **LOGITS)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency_dropless(arch):
    """The reference's test_prefill_decode_consistency on the port:
    decode_step(t) after prefill(0..t-1) == prefill(0..t)'s last logits,
    with dropless capacity (cf = E / k) so that the capacity dispatch and
    the dense decode compute one function."""
    _, _, tcfg, tp = _model(arch)
    tcfg = tcfg.replace(moe_capacity_factor=float(tcfg.moe_experts)
                        / tcfg.moe_top_k)
    B, T = 2, 16
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab, (B, T + 1)))
    la, _ = tlm.prefill(tp, tcfg, tlm.init_caches(tcfg, B, 64, "cpu"),
                        tokens=toks)
    _, cb = tlm.prefill(tp, tcfg, tlm.init_caches(tcfg, B, 64, "cpu"),
                        tokens=toks[:, :T])
    lb, _ = tlm.decode_step(tp, tcfg, toks[:, T], cb)
    np.testing.assert_allclose(_np(la), _np(lb), rtol=2e-3, atol=2e-3)


def _batch(vocab, B=2, T=32, seed=0):
    rows = np.random.default_rng(seed).integers(
        1, vocab, size=(B, T + 1)).astype(np.int32)
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def _tb(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_reference(arch):
    """Cross entropy + 0.01 x the summed aux, and every gradient."""
    jcfg, jp, tcfg, tp = _model(arch)
    batch = _batch(jcfg.vocab)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, jax.tree.map(jnp.asarray, batch)),
        has_aux=True))(jp)
    tp = to_torch(jax.tree.map(np.asarray, jp))
    plist = leaves(tp)
    for p in plist:
        p.requires_grad_(True)
    tl, tm = tlm.loss_fn(tp, tcfg, _tb(batch))
    tg = torch.autograd.grad(tl, plist, allow_unused=True)
    tl, tm = tl.detach(), {k: v.detach() for k, v in tm.items()}
    np.testing.assert_allclose(float(tl), float(jl), **LOSS)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), **LOSS)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), **LOSS)
    assert float(tm["aux"]) > 0.5             # about 1 per MoE layer
    jgl = jax.tree.leaves(jg)
    assert len(tg) == len(jgl)
    for a, b in zip(tg, jgl):
        np.testing.assert_allclose(0.0 if a is None else _np(a), _np(b),
                                   **GRAD)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One ``build_train_step`` step against the jitted reference step:
    loss, aux, grad norm, moments, and the parameters wherever the
    gradient is well above AdamW's eps (elsewhere bounded by the lr)."""
    jcfg, _, tcfg, _ = _model(arch)
    tc = jtrainer.TrainerConfig(peak_lr=1e-3, warmup_steps=0)
    jstate = jax.jit(lambda key: jtrainer.init_state(key, jcfg, tc))(
        jax.random.PRNGKey(0))
    tstate = to_torch(jax.tree.map(np.asarray, jstate))
    batch = _batch(jcfg.vocab, seed=1)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    with mesh:
        jnew, jm = jax.jit(jtrainer.build_train_step(jcfg, tc))(
            jstate, jax.tree.map(jnp.asarray, batch))
    tnew, tm = ttrainer.build_train_step(tcfg, ttrainer.TrainerConfig(
        peak_lr=1e-3, warmup_steps=0))(tstate, _tb(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), **LOSS)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    for a, b in zip(leaves(to_numpy(tnew["opt"]["mu"])),
                    jax.tree.leaves(jnew["opt"]["mu"])):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD)
    jmu = [np.asarray(s["m"]) for s in jax.tree.leaves(
        jnew["opt"]["mu"], is_leaf=lambda x: isinstance(x, dict)
        and "m" in x)]
    tps = leaves(to_numpy(tnew["params"]))
    jps = jax.tree.leaves(jnew["params"])
    assert len(tps) == len(jps) == len(jmu)
    for a, b, m in zip(tps, jps, jmu):
        sharp = np.abs(m) / (1 - tc.adamw.b1) > 1e-6
        np.testing.assert_allclose(a[sharp], np.asarray(b)[sharp],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-3)


# ------------------------------------------------------------ serving

def _requests(cls):
    """Greedy requests and one stochastic (rid 1)."""
    return [cls(rid=i, prompt=np.arange(1, L + 1, dtype=np.int32) % 200 + 1,
                max_new_tokens=4 + i,
                temperature=0.8 if i == 1 else 0.0,
                top_k=10 if i == 1 else 0, top_p=0.9 if i == 1 else 1.0)
            for i, L in enumerate(LENS)]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    return [list(r.output) for r in reqs]


_REFERENCE = {}
COUNT_KEYS = ("stage_dispatches", "scatter_dispatches", "prefill_batching",
              "tokens")


def _reference(arch, case):
    if (arch, case) not in _REFERENCE:
        jcfg, jp, _, _ = _model(arch)
        eng = JEngine(jcfg, jp, **ENGINE, **CASES[case])
        streams = _serve(eng, _requests(JRequest))
        _REFERENCE[(arch, case)] = (streams, eng.metrics())
    return _REFERENCE[(arch, case)]


@pytest.mark.parametrize("arch,case", [("mixtral-8x7b", c) for c in CASES]
                         + [("arctic-480b", "default")])
def test_moe_serving_matches_reference(arch, case, monkeypatch):
    """Streams and dispatch counts of the port's engine == the live
    reference engine's; every port program after its first call under the
    host guard (what a CUDA graph capture needs on the card)."""
    streams, jm = _reference(arch, case)
    _, _, tcfg, tp = _model(arch)
    calls = guard_programs(monkeypatch)
    eng = DecodeEngine(tcfg, tp, device="cpu", **ENGINE, **CASES[case])
    assert not eng.prefill_batching
    assert _serve(eng, _requests(Request)) == streams
    tm = eng.metrics()
    assert {k: tm[k] for k in COUNT_KEYS} == {k: jm[k] for k in COUNT_KEYS}
    assert calls["guarded"] > 0
    if case == "spec":
        assert tm["spec_ticks"] == jm["spec_ticks"] > 0
        assert tm["accepted_tokens"] == jm["accepted_tokens"]


def test_moe_gate_disables_batching():
    """tests/test_batched_prefill.py::test_moe_gate_disables_batching on
    the port: MoE expert-capacity dispatch couples the rows of a batch, so
    the gate keeps MoE archs on per-prompt staging."""
    _, _, tcfg, tp = _model("mixtral-8x7b")
    kw = dict(max_slots=1, max_len=64, decode_block=1, prefill_chunk=8,
              device="cpu")
    assert not DecodeEngine(tcfg, tp, **kw).prefill_batching
    with pytest.warns(RuntimeWarning, match="expert-capacity"):
        eng = DecodeEngine(tcfg, tp, prefill_batching=True, **kw)
    assert not eng.prefill_batching


# ------------------------------------------------------------ full width

@pytest.mark.parametrize("arch,billions", [("mixtral-8x7b", 46.703),
                                           ("arctic-480b", 476.850)])
def test_init_lm_full_width_shapes_dtypes_match_reference(arch, billions):
    """The port's own init at full width (on the meta device: no memory)
    has the reference's tree, shapes and dtypes (bf16 experts, fp32
    router)."""
    jcfg, tcfg = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    jshape = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0),
                                                jcfg))
    tp = tlm.init_lm(None, tcfg, device="meta")
    jl, tl = jax.tree.leaves(jshape), leaves(tp)
    assert [tuple(a.shape) for a in tl] == [a.shape for a in jl]
    assert [str(a.dtype).replace("torch.", "") for a in tl] == \
        [str(a.dtype) for a in jl]
    n = tlm.param_count(tp)
    assert sum(a.size for a in jl) == n
    assert round(n / 1e9, 3) == billions
