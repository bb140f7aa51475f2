"""The port's recurrentgemma slice against the JAX reference on the
reduced fp32 config (3 layers: rglru, rglru, swa; d_model 64, RG-LRU width
64, MQA 4:1, window 32): the doubling scan against
``jax.lax.associative_scan``, the RG-LRU layer's ragged prefill and decode,
the ``rglru`` mixer's cache spec, and the reduced LM (decode-step logits
and caches, ``decode_steps`` streams, ``loss_fn``).  Parameters come from
the reference's ``lm.init_lm`` through the numpy bridge; inputs are made
with numpy from a seed; every comparison is with a live JAX run.

Tolerances: 1e-5 for one layer (fp32, summation order only — the two
scans associate the same products in another order); 1e-4 for LM logits;
greedy streams equal.  No kernel is on this path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                    # noqa: E402
from repro.models import lm as jlm                        # noqa: E402
from repro.models import rglru as jrglru                  # noqa: E402
from repro.models.mixers import get_mixer as jget_mixer   # noqa: E402
from repro.serving import sampling as jsampling           # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch.bridge import to_numpy, to_torch         # noqa: E402
from repro_torch.models import lm as tlm                  # noqa: E402
from repro_torch.models import rglru as trglru            # noqa: E402
from repro_torch.models.mixers import get_mixer           # noqa: E402
from repro_torch.serving import sampling as tsampling     # noqa: E402
from repro_torch.tree import leaves, tree_map             # noqa: E402

ARCH = "recurrentgemma-2b"
F32 = dict(rtol=1e-5, atol=1e-5)
LM = dict(rtol=1e-4, atol=1e-4)

_j_prefill = jax.jit(jrglru.rglru_prefill)
_j_decode = jax.jit(jrglru.rglru_decode)
_j_scan = jax.jit(jlm.prefill_chunk_scan, static_argnums=1)
_j_admit = jax.jit(jlm.prefill_sample, static_argnums=(1, 4))
_j_decode_step = jax.jit(jlm.decode_step, static_argnums=1)
_j_decode_steps = jax.jit(jlm.decode_steps, static_argnums=(1, 4, 6))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs():
    return (jconfigs.get_arch(ARCH).reduced(),
            tconfigs.get_arch(ARCH).reduced())


@pytest.fixture(scope="module")
def model():
    jcfg, _ = _cfgs()
    jp = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jp, to_torch(jax.tree.map(np.asarray, jp))


def _mixer_params(model):
    """The first rglru layer's mixer params on both sides (repeat 0)."""
    jp, tp = model
    return (jax.tree.map(lambda a: a[0], jp["groups"][0][0]["mixer"]),
            tree_map(lambda a: a[0], tp["groups"][0][0]["mixer"]))


def _assert_tree_close(t_tree, j_tree, **tol):
    tl = leaves(to_numpy(t_tree))
    jl = jax.tree.leaves(jax.tree.map(np.asarray, j_tree))
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        if np.asarray(b).dtype.kind in "iub":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **tol)


# --------------------------------------------------------------- scan

@pytest.mark.parametrize("T", [1, 2, 5, 16, 37])
def test_doubling_scan_matches_associative_scan(T):
    rng = np.random.default_rng(T)
    log_a = -np.abs(rng.normal(size=(3, T, 24))).astype(np.float32)
    gated = rng.normal(size=(3, T, 24)).astype(np.float32)
    h0 = rng.normal(size=(3, 24)).astype(np.float32)
    got = trglru._scan_rglru(*map(torch.from_numpy, (log_a, gated, h0)))
    want = jrglru._scan_rglru(*map(jnp.asarray, (log_a, gated, h0)))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


# ----------------------------------------------------------- RG-LRU layer

@pytest.mark.parametrize("form", ["none", "int", "0-d", "rows"])
def test_rglru_prefill_ragged_and_decode(model, form):
    """A chunk from a nonzero state — whole, or ragged with an int, a 0-d
    tensor or per-row valid_len holding 0 and T — then two decode steps:
    outputs at valid rows, h and the conv carry."""
    jp, tp = _mixer_params(model)
    rng = np.random.default_rng(3)
    B, T = 3, 8
    x = rng.normal(size=(B, T, 64)).astype(np.float32)
    h0 = rng.normal(size=(B, 64)).astype(np.float32)
    c0 = rng.normal(size=(B, 3, 64)).astype(np.float32)
    valid = {"none": None, "int": 5, "0-d": np.int32(3),
             "rows": np.array([T, 0, 3], np.int32)}[form]
    t_vl = valid if form in ("none", "int") else \
        torch.from_numpy(np.asarray(valid))
    jo, jst = _j_prefill(jp, jnp.asarray(x), jrglru.RGLRUState(
        jnp.asarray(h0), jnp.asarray(c0)),
        valid_len=None if valid is None else jnp.asarray(valid))
    to, tst = trglru.rglru_prefill(
        tp, torch.from_numpy(x),
        trglru.RGLRUState(torch.from_numpy(h0.copy()),
                          torch.from_numpy(c0.copy())), valid_len=t_vl)
    _assert_tree_close(tst, jst, **F32)
    n_valid = np.broadcast_to(T if valid is None else valid, (B,))
    for b in range(B):
        np.testing.assert_allclose(_np(to)[b, :n_valid[b]],
                                   _np(jo)[b, :n_valid[b]], **F32)
    for _ in range(2):
        xt = rng.normal(size=(B, 64)).astype(np.float32)
        jo, jst = _j_decode(jp, jnp.asarray(xt), jst)
        to, tst = trglru.rglru_decode(tp, torch.from_numpy(xt), tst)
        np.testing.assert_allclose(_np(to), _np(jo), **F32)
        _assert_tree_close(tst, jst, **F32)


@pytest.mark.parametrize("reduced", [False, True])
def test_rglru_cache_spec_matches_reference(reduced):
    """Leaf for leaf (h fp32 whatever state_dtype says)."""
    for act, state in (("bfloat16", "float32"), ("float32", "bfloat16")):
        j, t = (c.get_arch(ARCH) for c in (jconfigs, tconfigs))
        if reduced:
            j, t = j.reduced(), t.reduced()
        j = j.replace(act_dtype=act, state_dtype=state)
        t = t.replace(act_dtype=act, state_dtype=state)
        js = jget_mixer("rglru").cache_spec(j, 4, 1024)
        ts = get_mixer("rglru").cache_spec(t, 4, 1024)
        assert type(ts.tree).__name__ == type(js.tree).__name__ == \
            "RGLRUState"
        assert [(tuple(l.shape), str(l.dtype).replace("torch.", ""),
                 l.role, l.nbytes) for l in ts.leaves()] == \
            [(tuple(l.shape), str(np.dtype(l.dtype)), l.role, l.nbytes)
             for l in js.leaves()]


# -------------------------------------------------------------------- LM

def _prefilled(model):
    """Both sides after a 2-chunk scan (per-row ragged) + the fused admit
    (one greedy row, one stochastic)."""
    jcfg, tcfg = _cfgs()
    jp, tp = model
    B, C = 2, 8
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 256, size=(B, 2, C)).astype(np.int32)
    vls = np.array([[8, 8], [8, 5]], np.int32)             # (n, B)
    tail = rng.integers(1, 256, size=(B, C)).astype(np.int32)
    tail_vl = np.array([6, 2], np.int32)
    jc = _j_scan(jp, jcfg, jlm.init_caches(jcfg, B, 64),
                 tokens=jnp.asarray(toks), valid_lens=jnp.asarray(vls))
    tc = tlm.prefill_chunk_scan(tp, tcfg,
                                tlm.init_caches(tcfg, B, 64, device="cpu"),
                                tokens=torch.from_numpy(toks),
                                valid_lens=torch.from_numpy(vls))
    js = jsampling.init_state(B)
    for i in range(B):
        js = jsampling.admit_slot(js, i, seed=1, rid=i, temperature=0.9 * i,
                                  top_k=0, top_p=1.0, eos_id=None, budget=40)
    ts = to_torch(jax.tree.map(np.asarray, js))
    jtok, js, jc = _j_admit(jp, jcfg, jc, js, jsampling.sample,
                            tokens=jnp.asarray(tail),
                            valid_len=jnp.asarray(tail_vl))
    ttok, ts, tc = tlm.prefill_sample(tp, tcfg, tc, ts, tsampling.sample,
                                      tokens=torch.from_numpy(tail),
                                      valid_len=torch.from_numpy(tail_vl))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    return jcfg, tcfg, jp, tp, jc, tc, js, ts, jtok, ttok


def test_lm_decode_step_logits_and_caches(model):
    jcfg, tcfg, jp, tp, jc, tc, _, _, jtok, ttok = _prefilled(model)
    _assert_tree_close(tc, jc, **LM)
    jl, jc = _j_decode_step(jp, jcfg, jtok, jc)
    tl, tc = tlm.decode_step(tp, tcfg, ttok, tc)
    assert tl.dtype == torch.float32 and tl.shape == (2, 256)
    np.testing.assert_allclose(_np(tl), _np(jl), **LM)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
    _assert_tree_close(tc, jc, **LM)


@pytest.mark.parametrize("k", [1, 4])
def test_lm_decode_steps_streams(model, k):
    """Fused k-step decode+sample over 32 steps, past the 32-slot window
    of the swa layer: identical token streams (greedy and stochastic)."""
    jcfg, tcfg, jp, tp, jc, tc, js, ts, jtok, ttok = _prefilled(model)
    j_out, t_out = [], []
    for _ in range(32 // k):
        jt, jv, jtok, jc, js = _j_decode_steps(jp, jcfg, jtok, jc, k, js,
                                               jsampling.sample)
        tt, tv, ttok, tc, ts = tlm.decode_steps(tp, tcfg, ttok, tc, k, ts,
                                                tsampling.sample)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        j_out.append(np.asarray(jt))
        t_out.append(tt.numpy())
    np.testing.assert_array_equal(np.concatenate(t_out),
                                  np.concatenate(j_out))
    _assert_tree_close(tc, jc, **LM)


def test_loss_matches_reference(model):
    """``loss_fn`` through ``rglru_train`` (the doubling scan from h = 0)
    and the swa layer's training path."""
    jcfg, tcfg = _cfgs()
    jp, tp = model
    rng = np.random.default_rng(5)
    toks = rng.integers(1, 256, size=(2, 24)).astype(np.int32)
    labels = rng.integers(1, 256, size=(2, 24)).astype(np.int32)
    jloss, _ = jax.jit(jlm.loss_fn, static_argnums=1)(
        jp, jcfg, {"tokens": jnp.asarray(toks),
                   "labels": jnp.asarray(labels)})
    with torch.no_grad():
        tloss, _ = tlm.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                          "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(tloss), float(jloss), **LM)


def test_init_lm_full_width_shapes_dtypes_match_reference():
    """The port's own init at full width (on the meta device: no memory)
    has the reference's tree, shapes and dtypes — q heads padded to 16."""
    jcfg, tcfg = (c.get_arch(ARCH) for c in (jconfigs, tconfigs))
    jshape = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0),
                                                jcfg))
    tp = tlm.init_lm(None, tcfg, device="meta")
    jl, tl = jax.tree.leaves(jshape), leaves(tp)
    assert [tuple(a.shape) for a in tl] == [a.shape for a in jl]
    assert [str(a.dtype).replace("torch.", "") for a in tl] == \
        [str(a.dtype) for a in jl]
    assert sum(a.size for a in jl) == tlm.param_count(tp)
