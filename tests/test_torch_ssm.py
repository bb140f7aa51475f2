"""The port's mamba2 slice against the JAX reference on the reduced fp32
config (d_model 64, d_inner 128, headdim 16 -> 8 value heads, d_state 32,
one q/k head): the causal conv1d helpers, the conv carries at the valid
boundary, the SSD layer's prefill and decode on both paths, the ``ssm``
mixer's cache spec, and the reduced LM (decode-step logits and caches,
``decode_steps`` streams, ``loss_fn`` and its gradients).  Parameters come
from the reference's ``lm.init_lm`` through the numpy bridge; inputs are
made with numpy from a seed; every comparison is with a live JAX run.

Tolerances (as ``tests/test_torch_model.py``): 1e-5 for one layer on the
plain path; 1e-4 for LM logits on the plain path; 5e-4 where the reference
runs its Pallas kernels in interpret mode (``use_pallas_serving=True``)
while the port's CPU tensors take the kernels' plain versions (two
factorizations of one recurrence); greedy streams equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                    # noqa: E402
from repro.models import layers as jlayers                # noqa: E402
from repro.models import lm as jlm                        # noqa: E402
from repro.models import ssm as jssm                      # noqa: E402
from repro.models.mixers import get_mixer as jget_mixer   # noqa: E402
from repro.serving import sampling as jsampling           # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch.bridge import to_numpy, to_torch         # noqa: E402
from repro_torch.models import layers as tlayers          # noqa: E402
from repro_torch.models import lm as tlm                  # noqa: E402
from repro_torch.models import ssm as tssm                # noqa: E402
from repro_torch.models.mixers import get_mixer           # noqa: E402
from repro_torch.serving import sampling as tsampling     # noqa: E402
from repro_torch.tree import leaves, tree_map             # noqa: E402

ARCH = "mamba2-1.3b"
F32 = dict(rtol=1e-5, atol=1e-5)
LM = dict(rtol=1e-4, atol=1e-4)
KERNEL = dict(rtol=5e-4, atol=5e-4)

_j_prefill = jax.jit(jssm.ssm_prefill,
                     static_argnames=("d_inner", "headdim", "d_state",
                                      "chunk", "use_pallas"))
_j_decode = jax.jit(jssm.ssm_decode,
                    static_argnames=("d_inner", "headdim", "d_state",
                                     "use_pallas"))
_j_scan = jax.jit(jlm.prefill_chunk_scan, static_argnums=1)
_j_admit = jax.jit(jlm.prefill_sample, static_argnums=(1, 4))
_j_decode_step = jax.jit(jlm.decode_step, static_argnums=1)
_j_decode_steps = jax.jit(jlm.decode_steps, static_argnums=(1, 4, 6))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(pallas=False):
    return (jconfigs.get_arch(ARCH).reduced().replace(
                use_pallas_serving=pallas),
            tconfigs.get_arch(ARCH).reduced().replace(
                use_pallas_serving=pallas))


@pytest.fixture(scope="module")
def model():
    jcfg, _ = _cfgs()
    jp = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jp, to_torch(jax.tree.map(np.asarray, jp))


def _mixer_params(model):
    """The first layer's mixer params on both sides (repeat 0)."""
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


# ------------------------------------------------------------- conv1d

def test_conv1d_fwd_and_decode_match_reference(model):
    jp, tp = _mixer_params(model)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tlayers.conv1d_fwd(tp["conv_B"], torch.from_numpy(x))),
        _np(jlayers.conv1d_fwd(jp["conv_B"], jnp.asarray(x))), **F32)
    cache = rng.normal(size=(2, 3, 32)).astype(np.float32)
    xt = rng.normal(size=(2, 32)).astype(np.float32)
    ty, tc = tlayers.conv1d_decode(tp["conv_B"], torch.from_numpy(xt),
                                   torch.from_numpy(cache))
    jy, jc = jlayers.conv1d_decode(jp["conv_B"], jnp.asarray(xt),
                                   jnp.asarray(cache))
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    np.testing.assert_array_equal(_np(tc), _np(jc))


@pytest.mark.parametrize("form", ["int", "0-d", "rows"])
def test_conv_prefill_carries_at_valid_len(model, form):
    """The carry is gathered at the valid boundary for an int, a 0-d
    tensor and a per-row (B,) tensor holding 0 and T among its rows."""
    jp, tp = _mixer_params(model)
    rng = np.random.default_rng(1)
    B, T, C = 3, 6, 32
    u = rng.normal(size=(B, T, C)).astype(np.float32)
    cache = rng.normal(size=(B, 3, C)).astype(np.float32)
    valid = {"int": 4, "0-d": np.int32(2),
             "rows": np.array([0, T, 3], np.int32)}[form]
    t_vl = valid if form == "int" else torch.from_numpy(np.asarray(valid))
    to, tc = tssm._conv_prefill(tp["conv_B"], torch.from_numpy(u),
                                torch.from_numpy(cache), t_vl)
    jo, jc = jssm._conv_prefill(jp["conv_B"], jnp.asarray(u),
                                jnp.asarray(cache), jnp.asarray(valid))
    np.testing.assert_allclose(_np(to), _np(jo), **F32)
    np.testing.assert_array_equal(_np(tc), _np(jc))
    full = np.concatenate([cache, u], axis=1)
    for b, v in enumerate(np.broadcast_to(valid, (B,))):
        np.testing.assert_array_equal(_np(tc)[b], full[b, v:v + 3])


# ---------------------------------------------------------- SSD layer

@pytest.mark.parametrize("pallas", [False, True])
def test_ssm_prefill_and_decode(model, pallas):
    """A ragged chunk (per-row valid_len 8, 3 and 0) from a nonzero state,
    then two decode steps — outputs, S and conv carries."""
    jp, tp = _mixer_params(model)
    dims = dict(d_inner=128, headdim=16, d_state=32)
    rng = np.random.default_rng(2)
    B, T = 3, 8
    x = rng.normal(size=(B, T, 64)).astype(np.float32)
    st = [(rng.normal(size=s) * 0.1).astype(np.float32)
          for s in ((B, 8, 32, 16), (B, 3, 128), (B, 3, 32), (B, 3, 32))]
    valid = np.array([8, 3, 0], np.int32)
    jo, jst = _j_prefill(jp, jnp.asarray(x),
                         jssm.SSMState(*map(jnp.asarray, st)), **dims,
                         use_pallas=pallas, valid_len=jnp.asarray(valid))
    tst = tssm.SSMState(*(torch.from_numpy(a.copy()) for a in st))
    to, tst = tssm.ssm_prefill(tp, torch.from_numpy(x), tst, **dims,
                               use_pallas=pallas,
                               valid_len=torch.from_numpy(valid))
    tol = KERNEL if pallas else F32
    _assert_tree_close(tst, jst, **tol)
    for b in range(B):
        np.testing.assert_allclose(_np(to)[b, :valid[b]],
                                   _np(jo)[b, :valid[b]], **tol)
    for _ in range(2):
        xt = rng.normal(size=(B, 64)).astype(np.float32)
        jo, jst = _j_decode(jp, jnp.asarray(xt), jst, **dims,
                            use_pallas=pallas)
        to, tst = tssm.ssm_decode(tp, torch.from_numpy(xt), tst, **dims,
                                  use_pallas=pallas)
        np.testing.assert_allclose(_np(to), _np(jo), **tol)
        _assert_tree_close(tst, jst, **tol)


@pytest.mark.parametrize("reduced", [False, True])
def test_ssd_cache_spec_matches_reference(reduced):
    """Leaf for leaf: shapes, dtypes, roles and bytes (fp32 and bf16
    activations, fp32 and bf16 state)."""
    for act, state in (("bfloat16", "float32"), ("float32", "bfloat16")):
        j, t = (c.get_arch(ARCH) for c in (jconfigs, tconfigs))
        if reduced:
            j, t = j.reduced(), t.reduced()
        j = j.replace(act_dtype=act, state_dtype=state)
        t = t.replace(act_dtype=act, state_dtype=state)
        js = jget_mixer("ssm").cache_spec(j, 4, 1024)
        ts = get_mixer("ssm").cache_spec(t, 4, 1024)
        assert type(ts.tree).__name__ == type(js.tree).__name__ == \
            "SSMState"
        assert [(tuple(l.shape), str(l.dtype).replace("torch.", ""),
                 l.role, l.nbytes) for l in ts.leaves()] == \
            [(tuple(l.shape), str(np.dtype(l.dtype)), l.role, l.nbytes)
             for l in js.leaves()]
        assert (ts.state_bytes, ts.window_bytes) == \
            (js.state_bytes, js.window_bytes)


# -------------------------------------------------------------------- LM

def _prefilled(model, pallas):
    """Both sides after a 2-chunk scan (per-row ragged) + the fused admit
    (one greedy row, one stochastic)."""
    jcfg, tcfg = _cfgs(pallas)
    jp, tp = model
    B, C = 2, 8
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 256, size=(B, 2, C)).astype(np.int32)
    vls = np.array([[8, 8], [8, 5]], np.int32)             # (n, B)
    tail = rng.integers(1, 256, size=(B, C)).astype(np.int32)
    tail_vl = np.array([6, 2], np.int32)
    jc = _j_scan(jp, jcfg, jlm.init_caches(jcfg, B, 32),
                 tokens=jnp.asarray(toks), valid_lens=jnp.asarray(vls))
    tc = tlm.prefill_chunk_scan(tp, tcfg,
                                tlm.init_caches(tcfg, B, 32, device="cpu"),
                                tokens=torch.from_numpy(toks),
                                valid_lens=torch.from_numpy(vls))
    js = jsampling.init_state(B)
    for i in range(B):
        js = jsampling.admit_slot(js, i, seed=1, rid=i, temperature=0.9 * i,
                                  top_k=0, top_p=1.0, eos_id=None, budget=9)
    ts = to_torch(jax.tree.map(np.asarray, js))
    jtok, js, jc = _j_admit(jp, jcfg, jc, js, jsampling.sample,
                            tokens=jnp.asarray(tail),
                            valid_len=jnp.asarray(tail_vl))
    ttok, ts, tc = tlm.prefill_sample(tp, tcfg, tc, ts, tsampling.sample,
                                      tokens=torch.from_numpy(tail),
                                      valid_len=torch.from_numpy(tail_vl))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    return jcfg, tcfg, jp, tp, jc, tc, js, ts, jtok, ttok


@pytest.mark.parametrize("pallas", [False, True])
def test_lm_decode_step_logits_and_caches(model, pallas):
    jcfg, tcfg, jp, tp, jc, tc, _, _, jtok, ttok = _prefilled(model, pallas)
    tol = KERNEL if pallas else LM
    _assert_tree_close(tc, jc, **tol)
    jl, jc = _j_decode_step(jp, jcfg, jtok, jc)
    tl, tc = tlm.decode_step(tp, tcfg, ttok, tc)
    assert tl.dtype == torch.float32 and tl.shape == (2, 256)
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
    _assert_tree_close(tc, jc, **tol)


@pytest.mark.parametrize("k", [1, 4])
def test_lm_decode_steps_streams(model, k):
    """Fused k-step decode+sample with the kernels' switch on: identical
    token streams over 8 steps (one greedy, one stochastic row)."""
    jcfg, tcfg, jp, tp, jc, tc, js, ts, jtok, ttok = _prefilled(model, True)
    j_out, t_out = [], []
    for _ in range(8 // k):
        jt, jv, jtok, jc, js = _j_decode_steps(jp, jcfg, jtok, jc, k, js,
                                               jsampling.sample)
        tt, tv, ttok, tc, ts = tlm.decode_steps(tp, tcfg, ttok, tc, k, ts,
                                                tsampling.sample)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        j_out.append(np.asarray(jt))
        t_out.append(tt.numpy())
    np.testing.assert_array_equal(np.concatenate(t_out),
                                  np.concatenate(j_out))
    _assert_tree_close(tc, jc, **KERNEL)


def test_loss_and_grads_match_reference(model):
    """``loss_fn`` (ssm_train: the chunkwise SSD path under autograd, no
    FFN) and every parameter's gradient."""
    jcfg, tcfg = _cfgs()
    jp, _ = model
    rng = np.random.default_rng(5)
    toks = rng.integers(1, 256, size=(2, 16)).astype(np.int32)
    labels = rng.integers(1, 256, size=(2, 16)).astype(np.int32)
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)}),
        has_aux=True)(jp)
    tp = to_torch(jax.tree.map(np.asarray, jp))
    for t in leaves(tp):
        t.requires_grad_(True)
    tloss, _ = tlm.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                      "labels": torch.from_numpy(labels)})
    # loss_fn applies no final norm (as the reference): its gradient is 0
    tg = torch.autograd.grad(tloss, leaves(tp), allow_unused=True)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **LM)
    jl = jax.tree.leaves(jg)
    assert len(jl) == len(tg)
    for a, b in zip(tg, jl):
        np.testing.assert_allclose(0.0 if a is None else _np(a), _np(b),
                                   **LM)


def test_init_lm_full_width_shapes_dtypes_match_reference():
    """The port's own init at full width (on the meta device: no memory)
    has the reference's tree, shapes and dtypes (bf16 activations)."""
    jcfg, tcfg = (c.get_arch(ARCH) for c in (jconfigs, tconfigs))
    jshape = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0),
                                                jcfg))
    tp = tlm.init_lm(None, tcfg, device="meta")
    jl, tl = jax.tree.leaves(jshape), leaves(tp)
    assert [tuple(a.shape) for a in tl] == [a.shape for a in jl]
    assert [str(a.dtype).replace("torch.", "") for a in tl] == \
        [str(a.dtype) for a in jl]
    assert sum(a.size for a in jl) == tlm.param_count(tp)
