"""The port's model stack against the JAX reference on reduced fp32
configs: layers, the GDN layer, the attention layer (rolling KV wrap
included) and the hybrid LM on reduced qwen3-next-gdn.  Parameters always
come from the reference's ``lm.init_lm`` through the numpy bridge; inputs
are made with numpy from a seed.

Tolerances: one layer in fp32 differs only in summation order (1e-5).
Through the whole reduced LM the logits agree to 1e-4 on the plain path;
with ``use_pallas_serving`` the reference prefills with the chunkwise
Pallas kernel while the port's CPU path is the sequential plain version —
two factorizations of one recurrence — so states and logits get the
reference's kernel tolerance, 5e-4.  Greedy token streams must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                    # noqa: E402
from repro.models import attention as jattn               # noqa: E402
from repro.models import gdn_layer as jgdn_layer          # noqa: E402
from repro.models import layers as jlayers                # noqa: E402
from repro.models import lm as jlm                        # noqa: E402
from repro.serving import sampling as jsampling           # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch.bridge import to_numpy, to_torch         # noqa: E402
from repro_torch.models import attention as tattn         # noqa: E402
from repro_torch.models import gdn_layer as tgdn_layer    # noqa: E402
from repro_torch.models import layers as tlayers          # noqa: E402
from repro_torch.models import lm as tlm                  # noqa: E402
from repro_torch.serving import sampling as tsampling     # noqa: E402
from repro_torch.tree import leaves                       # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)

# the reference's functions run jitted (one compile per shape, not one per
# eager op); cfg and the sample function are static
_j_chunk = jax.jit(jattn.attn_prefill_chunk)
_j_attn_decode = jax.jit(jattn.attn_decode_xla)
_j_scan = jax.jit(jlm.prefill_chunk_scan, static_argnums=1)
_j_admit = jax.jit(jlm.prefill_sample, static_argnums=(1, 4))
_j_decode_step = jax.jit(jlm.decode_step, static_argnums=1)
_j_decode_steps = jax.jit(jlm.decode_steps, static_argnums=(1, 4, 6))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(pallas=False):
    j = jconfigs.get_arch("qwen3-next-gdn").reduced()
    t = tconfigs.get_arch("qwen3-next-gdn").reduced()
    return (j.replace(use_pallas_serving=pallas),
            t.replace(use_pallas_serving=pallas))


@pytest.fixture(scope="module")
def model():
    jcfg, _ = _cfgs()
    jp = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jp, to_torch(jax.tree.map(np.asarray, jp))


def _assert_tree_close(t_tree, j_tree, **tol):
    tl = leaves(to_numpy(t_tree))
    jl = jax.tree.leaves(jax.tree.map(np.asarray, j_tree))
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        if np.asarray(b).dtype.kind in "iub":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **tol)


# ----------------------------------------------------------------- layers

def test_layers_match_reference(model):
    jp, tp = model
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    lp_j = jax.tree.map(lambda a: a[0], jp["groups"][0][0])
    lp_t = {k: {n: a[0] for n, a in v.items()}
            for k, v in tp["groups"][0][0].items() if k != "mixer"}
    np.testing.assert_allclose(
        _np(tlayers.rmsnorm_fwd(lp_t["norm1"], torch.from_numpy(x))),
        _np(jlayers.rmsnorm_fwd(lp_j["norm1"], jnp.asarray(x))), **F32)
    np.testing.assert_allclose(
        _np(tlayers.mlp_fwd(lp_t["mlp"], torch.from_numpy(x))),
        _np(jlayers.mlp_fwd(lp_j["mlp"], jnp.asarray(x))), **F32)
    xh = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(5)[None].repeat(2, 0) + np.array([[0], [40]])
    np.testing.assert_allclose(
        _np(tlayers.apply_rope(torch.from_numpy(xh), torch.from_numpy(pos))),
        _np(jlayers.apply_rope(jnp.asarray(xh), jnp.asarray(pos))), **F32)
    toks = np.array([1, 7, 255])
    np.testing.assert_array_equal(
        _np(tlayers.embed_fwd(tp["embed"], torch.from_numpy(toks))),
        _np(jlayers.embed_fwd(jp["embed"], jnp.asarray(toks))))


# -------------------------------------------------------------- GDN layer

@pytest.mark.parametrize("pallas", [False, True])
def test_gdn_layer_prefill_and_decode(model, pallas):
    jp, tp = model
    lp_j = jax.tree.map(lambda a: a[0], jp["groups"][0][1]["mixer"])
    lp_t = {k: v[0] for k, v in tp["groups"][0][1]["mixer"].items()}
    rng = np.random.default_rng(1)
    B, C, H, d = 3, 8, 4, 16
    x = rng.normal(size=(B, C, 64)).astype(np.float32)
    S0 = (rng.normal(size=(B, H, d, d)) * 0.1).astype(np.float32)
    valid = np.array([8, 3, 0], np.int32)
    jo, jst = jgdn_layer.gdn_prefill(lp_j, jnp.asarray(x),
                                     jgdn_layer.GDNState(jnp.asarray(S0)),
                                     use_pallas=pallas,
                                     valid_len=jnp.asarray(valid))
    tst = tgdn_layer.GDNState(torch.from_numpy(S0.copy()))
    to, tst = tgdn_layer.gdn_prefill(lp_t, torch.from_numpy(x), tst,
                                     use_pallas=pallas,
                                     valid_len=torch.from_numpy(valid))
    tol = dict(rtol=5e-4, atol=5e-4) if pallas else F32
    np.testing.assert_allclose(_np(tst.S), _np(jst.S), **tol)
    for b in range(B):
        np.testing.assert_allclose(_np(to)[b, :valid[b]],
                                   _np(jo)[b, :valid[b]], **tol)
    # a decode step from the prefilled states (Alg. 2; Alg. 1 off-kernel)
    xt = rng.normal(size=(B, 64)).astype(np.float32)
    for fused in ((True, False) if not pallas else (True,)):
        jo, jS = jgdn_layer.gdn_decode(lp_j, jnp.asarray(xt), jst,
                                       use_pallas=pallas, fused=fused)
        t_in = tgdn_layer.GDNState(tst.S.clone())
        to, tS = tgdn_layer.gdn_decode(lp_t, torch.from_numpy(xt), t_in,
                                       use_pallas=pallas, fused=fused)
        np.testing.assert_allclose(_np(to), _np(jo), **tol)
        np.testing.assert_allclose(_np(tS.S), _np(jS.S), **tol)


@pytest.mark.parametrize("pallas", [False, True])
def test_gdn_naive_mixer_matches_reference(model, pallas):
    """The ``gdn_naive`` kind (Alg. 1 decode) through the mixer registry
    on both settings of ``use_pallas_serving``: a ragged prefill chunk
    (the prefill kernel's path when set) then two Alg. 1 decode steps
    (plain in both packages whatever the setting)."""
    from repro.models.mixers import get_mixer as jget_mixer
    from repro_torch.models.mixers import get_mixer
    jp, tp = model
    jcfg, tcfg = _cfgs(pallas)
    jm, tm = jget_mixer("gdn_naive"), get_mixer("gdn_naive")
    assert (tm.state_passes, tm.fused) == (jm.state_passes, jm.fused) == \
        (4, False)
    lp_j = jax.tree.map(lambda a: a[0], jp["groups"][0][0]["mixer"])
    lp_t = {k: v[0] for k, v in tp["groups"][0][0]["mixer"].items()}
    rng = np.random.default_rng(6)
    B, C, H, d = 2, 8, 4, 16
    x = rng.normal(size=(B, C, 64)).astype(np.float32)
    S0 = (rng.normal(size=(B, H, d, d)) * 0.1).astype(np.float32)
    valid = np.array([8, 5], np.int32)
    jo, jst = jm.prefill_chunk(lp_j, jcfg, jnp.asarray(x),
                               jgdn_layer.GDNState(jnp.asarray(S0)),
                               valid_len=jnp.asarray(valid))
    to, tst = tm.prefill_chunk(lp_t, tcfg, torch.from_numpy(x),
                               tgdn_layer.GDNState(torch.from_numpy(S0)),
                               valid_len=torch.from_numpy(valid))
    tol = dict(rtol=5e-4, atol=5e-4) if pallas else F32
    np.testing.assert_allclose(_np(tst.S), _np(jst.S), **tol)
    for _ in range(2):
        xt = rng.normal(size=(B, 64)).astype(np.float32)
        jo, jst = jm.decode(lp_j, jcfg, jnp.asarray(xt), jst)
        to, tst = tm.decode(lp_t, tcfg, torch.from_numpy(xt), tst)
        np.testing.assert_allclose(_np(to), _np(jo), **tol)
        np.testing.assert_allclose(_np(tst.S), _np(jst.S), **tol)


# --------------------------------------------------------- attention layer

def test_attention_chunk_and_decode_through_rolling_wrap(model):
    """A rolling KV buffer of 8 slots already past its wrap (length 13):
    a ragged chunk (per-row valid_len 3 and 0), a full chunk, then decode
    steps — outputs, keys/values and lengths against the reference."""
    jp, tp = model
    lp_j = jax.tree.map(lambda a: a[0], jp["groups"][0][3]["mixer"])
    lp_t = {k: v[0] for k, v in tp["groups"][0][3]["mixer"].items()}
    rng = np.random.default_rng(2)
    B, Hkv, size, hd = 2, 2, 8, 16
    k0 = rng.normal(size=(B, Hkv, size, hd)).astype(np.float32)
    v0 = rng.normal(size=(B, Hkv, size, hd)).astype(np.float32)
    length = np.array([13, 5], np.int32)
    jc = jattn.KVCache(jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(length))
    tc = tattn.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()),
                       torch.from_numpy(length.copy()))
    steps = [("chunk", np.array([3, 0], np.int32)), ("chunk", None),
             ("decode", None), ("decode", None)]
    for kind, valid in steps:
        if kind == "chunk":
            x = rng.normal(size=(B, 4, 64)).astype(np.float32)
            jo, jc = _j_chunk(
                lp_j, jnp.asarray(x), jc,
                valid_len=None if valid is None else jnp.asarray(valid))
            to, tc = tattn.attn_prefill_chunk(
                lp_t, torch.from_numpy(x), tc,
                valid_len=None if valid is None else torch.from_numpy(valid))
            n = [4, 4] if valid is None else valid
            for b in range(B):
                np.testing.assert_allclose(_np(to)[b, :n[b]],
                                           _np(jo)[b, :n[b]], **F32)
        else:
            x = rng.normal(size=(B, 64)).astype(np.float32)
            jo, jc = _j_attn_decode(lp_j, jnp.asarray(x), jc)
            to, tc = tattn.attn_decode_xla(lp_t, torch.from_numpy(x), tc)
            np.testing.assert_allclose(_np(to), _np(jo), **F32)
        np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
        np.testing.assert_allclose(_np(tc.k), _np(jc.k), **F32)
        np.testing.assert_allclose(_np(tc.v), _np(jc.v), **F32)


def test_attention_prefill_fills_rolling_cache(model):
    jp, tp = model
    lp_j = jax.tree.map(lambda a: a[0], jp["groups"][0][3]["mixer"])
    lp_t = {k: v[0] for k, v in tp["groups"][0][3]["mixer"].items()}
    x = np.random.default_rng(3).normal(size=(1, 11, 64)).astype(np.float32)
    for size in (16, 8):                         # linear, then wrapped
        z = np.zeros((1, 2, size, 16), np.float32)
        jo, jc = jattn.attn_prefill(lp_j, jnp.asarray(x), jattn.KVCache(
            jnp.asarray(z), jnp.asarray(z), jnp.zeros((1,), jnp.int32)))
        to, tc = tattn.attn_prefill(lp_t, torch.from_numpy(x), tattn.KVCache(
            torch.zeros(z.shape), torch.zeros(z.shape),
            torch.zeros(1, dtype=torch.int32)))
        np.testing.assert_allclose(_np(to), _np(jo), **F32)
        np.testing.assert_allclose(_np(tc.k), _np(jc.k), **F32)
        assert int(tc.length[0]) == int(jc.length[0]) == 11


# -------------------------------------------------------------------- LM

def _prefilled(model, pallas):
    """Both sides after a 2-chunk scan (per-row ragged) + the fused admit."""
    jcfg, tcfg = _cfgs(pallas)
    jp, tp = model
    B, C = 2, 8
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 256, size=(B, 2, C)).astype(np.int32)
    vls = np.array([[8, 8], [8, 5]], np.int32)             # (n, B)
    tail = rng.integers(1, 256, size=(B, C)).astype(np.int32)
    tail_vl = np.array([6, 2], np.int32)
    jc = jlm.init_caches(jcfg, B, 32)
    jc = _j_scan(jp, jcfg, jc, tokens=jnp.asarray(toks),
                valid_lens=jnp.asarray(vls))
    tc = tlm.init_caches(tcfg, B, 32, device="cpu")
    tc = tlm.prefill_chunk_scan(tp, tcfg, tc, tokens=torch.from_numpy(toks),
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
    return (jcfg, tcfg, jp, tp, jc, tc, js, ts, jtok, ttok)


@pytest.mark.parametrize("pallas", [False, True])
def test_lm_decode_step_logits_and_caches(model, pallas):
    jcfg, tcfg, jp, tp, jc, tc, _, _, jtok, ttok = _prefilled(model, pallas)
    tol = dict(rtol=5e-4, atol=5e-4) if pallas else dict(rtol=1e-4,
                                                          atol=1e-4)
    _assert_tree_close(tc, jc, **tol)
    jl, jc = _j_decode_step(jp, jcfg, jtok, jc)
    tl, tc = tlm.decode_step(tp, tcfg, ttok, tc)
    assert tl.dtype == torch.float32 and tl.shape == (2, 256)
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
    _assert_tree_close(tc, jc, **tol)


def test_lm_full_prompt_prefill(model):
    """``lm.prefill`` (whole prompt, fresh caches, last-token logits)."""
    jcfg, tcfg = _cfgs()
    jp, tp = model
    toks = np.random.default_rng(5).integers(1, 256, size=(2, 12))
    jl, jc = jax.jit(jlm.prefill, static_argnums=1)(
        jp, jcfg, jlm.init_caches(jcfg, 2, 16), tokens=jnp.asarray(toks))
    tl, tc = tlm.prefill(tp, tcfg, tlm.init_caches(tcfg, 2, 16, device="cpu"),
                         tokens=torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    _assert_tree_close(tc, jc, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k", [1, 4])
def test_lm_decode_steps_streams(model, k):
    """Fused k-step decode+sample (one greedy, one stochastic row) with
    the kernels' switch on: identical token streams over 8 steps."""
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
    _assert_tree_close(tc, jc, rtol=5e-4, atol=5e-4)


def test_init_lm_shapes_dtypes_match_reference():
    """The port's own init (drawn from a torch.Generator) has the
    reference's tree, shapes and dtypes — bf16 act dtype included."""
    jcfg, tcfg = _cfgs()
    jcfg, tcfg = (c.replace(act_dtype="bfloat16") for c in (jcfg, tcfg))
    jshape = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0),
                                                jcfg))
    tp = tlm.init_lm(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jl = jax.tree.leaves(jshape)
    tl = leaves(tp)
    assert [tuple(a.shape) for a in tl] == [a.shape for a in jl]
    assert [str(a.dtype).replace("torch.", "") for a in tl] == \
        [str(a.dtype) for a in jl]
