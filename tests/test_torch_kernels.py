"""The port's GDN math and its kernels' plain versions against the JAX
reference: ``repro_torch.core.gdn`` vs ``repro.core.gdn``, and
``repro_torch.kernels.ops`` on CPU tensors (the plain versions) vs the
Pallas kernels in interpret mode and ``repro.kernels.ref``, over the cases
of ``tests/test_kernels.py``.  Inputs are made with numpy from a seed and
handed to both.  The CUDA kernels themselves are held against the plain
versions only on the card (``tests/test_torch_cuda.py``).

Tolerances: fp32 comparisons of the same factorization differ only in
summation order (dot products of <= 128 terms): rtol = atol = 1e-5.  The
chunkwise Pallas kernel (UT transform, nilpotent inverse) against the
port's sequential plain version is two factorizations of one recurrence:
5e-4, the reference's own kernel-vs-oracle tolerance.  bf16 inputs are
upcast identically on both sides, so bf16 cases keep the fp32 tolerance
on the fp32 state and allow one bf16 rounding step (2e-2) on the output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gdn as jgdn                       # noqa: E402
from repro.kernels import ops as jops, ref as jref       # noqa: E402
from repro.kernels.gdn_decode import gdn_decode_pallas   # noqa: E402
from repro_torch.core import gdn as tgdn                 # noqa: E402
from repro_torch.kernels import gdn_decode as tdecode    # noqa: E402
from repro_torch.kernels import gdn_prefill as tprefill  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
CHUNKWISE = dict(rtol=5e-4, atol=5e-4)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _t(a):
    """numpy -> CPU torch (bf16 arrays go through their fp32 values)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _j(a, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a, dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def decode_inputs(seed, B, Hk, Hv, dk, dv):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hk, dk)).astype(np.float32)
    k = rng.normal(size=(B, Hk, dk)).astype(np.float32)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = rng.normal(size=(B, Hv, dv)).astype(np.float32)
    S = (rng.normal(size=(B, Hv, dk, dv)) * 0.2).astype(np.float32)
    g = _sigmoid(rng.normal(size=(B, Hv))).astype(np.float32)
    beta = _sigmoid(rng.normal(size=(B, Hv))).astype(np.float32)
    return q, k, v, S, g, beta


def prefill_inputs(seed, B, T, Hk, Hv, dk, dv):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, Hk, dk)).astype(np.float32)
    k = rng.normal(size=(B, T, Hk, dk)).astype(np.float32)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = rng.normal(size=(B, T, Hv, dv)).astype(np.float32)
    log_g = -np.log1p(np.exp(rng.normal(size=(B, T, Hv)))).astype(np.float32)
    beta = _sigmoid(rng.normal(size=(B, T, Hv))).astype(np.float32)
    S0 = (rng.normal(size=(B, Hv, dk, dv)) * 0.1).astype(np.float32)
    return q, k, v, log_g, beta, S0


# ------------------------------------------------------------- core.gdn

@pytest.mark.parametrize("fn", ["naive", "fused", "ssd"])
def test_core_decode_steps_match_reference(fn):
    q, k, v, S, g, beta = decode_inputs(0, 1, 1, 1, 32, 48)
    args = (q[0, 0], k[0, 0], v[0, 0], S[0, 0], g[0, 0], beta[0, 0])
    if fn == "ssd":
        jo, jS = jgdn.ssd_decode_step(*map(_j, args[:5]))
        to, tS = tgdn.ssd_decode_step(*map(_t, args[:5]))
    else:
        jfn = getattr(jgdn, f"decode_step_{fn}")
        tfn = getattr(tgdn, f"decode_step_{fn}")
        jo, jS = jfn(*map(_j, args))
        to, tS = tfn(*map(_t, args))
    np.testing.assert_allclose(_np(to), _np(jo), **F32)
    np.testing.assert_allclose(_np(tS), _np(jS), **F32)


def test_core_gates_match_reference():
    rng = np.random.default_rng(1)
    alpha, b = rng.normal(size=(2, 8)).astype(np.float32)
    A_log, dt_bias = rng.normal(size=(2, 8)).astype(np.float32)
    jg, jb = jgdn.gates(*map(_j, (alpha, b, A_log, dt_bias)))
    tg, tb = tgdn.gates(*map(_t, (alpha, b, A_log, dt_bias)))
    np.testing.assert_allclose(_np(tg), _np(jg), **F32)
    np.testing.assert_allclose(_np(tb), _np(jb), **F32)


@pytest.mark.parametrize("delta_rule", [True, False])
def test_core_prefill_sequential_and_chunkwise(delta_rule):
    q, k, v, lg, beta, S0 = prefill_inputs(2, 1, 32, 1, 1, 16, 16)
    a = (q[0, :, 0], k[0, :, 0], v[0, :, 0], lg[0, :, 0], beta[0, :, 0],
         S0[0, 0])
    jO, jS = jgdn.prefill_sequential(*map(_j, a), delta_rule=delta_rule)
    tO, tS = tgdn.prefill_sequential(*map(_t, a), delta_rule=delta_rule)
    np.testing.assert_allclose(_np(tO), _np(jO), **F32)
    np.testing.assert_allclose(_np(tS), _np(jS), **F32)
    jO, jS = jgdn.prefill_chunkwise(*map(_j, a), chunk=8,
                                    delta_rule=delta_rule)
    tO, tS = tgdn.prefill_chunkwise(*map(_t, a), chunk=8,
                                    delta_rule=delta_rule)
    np.testing.assert_allclose(_np(tO), _np(jO), **F32)
    np.testing.assert_allclose(_np(tS), _np(jS), **F32)


@pytest.mark.parametrize("fused", [True, False])
def test_core_batched_gva_wrappers(fused):
    q, k, v, S, g, beta = decode_inputs(3, 2, 2, 4, 16, 16)
    jo, jS = jgdn.gdn_decode(*map(_j, (q, k, v, S, g, beta)), fused=fused)
    to, tS = tgdn.gdn_decode(*map(_t, (q, k, v, S, g, beta)), fused=fused)
    np.testing.assert_allclose(_np(to), _np(jo), **F32)
    np.testing.assert_allclose(_np(tS), _np(jS), **F32)
    a = prefill_inputs(4, 2, 16, 2, 4, 16, 16)
    jO, jS = jgdn.gdn_prefill(*map(_j, a), chunk=8)
    tO, tS = tgdn.gdn_prefill(*map(_t, a), chunk=8)
    np.testing.assert_allclose(_np(tO), _np(jO), **F32)
    np.testing.assert_allclose(_np(tS), _np(jS), **F32)


# ----------------------------------------------------- gdn_decode plain

@pytest.mark.parametrize("B,Hk,Hv,dk,dv,dtype,delta_rule", [
    (1, 1, 1, 128, 128, "float32", True),
    (4, 2, 4, 64, 64, "float32", True),       # GVA R = 2
    (2, 4, 4, 128, 64, "float32", True),      # R = 1, rectangular
    (2, 4, 8, 128, 128, "bfloat16", True),
    (2, 4, 4, 128, 64, "float32", False),     # SSD step
])
def test_gdn_decode_plain_vs_pallas(B, Hk, Hv, dk, dv, dtype, delta_rule):
    q, k, v, S, g, beta = decode_inputs(5, B, Hk, Hv, dk, dv)
    jd = jnp.dtype(dtype)
    jq, jk, jv = (_j(x, jd) for x in (q, k, v))
    jo, jS = gdn_decode_pallas(jq, jk, jv, _j(S), _j(g), _j(beta),
                               head_block=min(4, Hv), delta_rule=delta_rule,
                               interpret=True)
    ro, rS = jref.gdn_decode_ref(jq, jk, jv, _j(S), _j(g), _j(beta),
                                 delta_rule=delta_rule)
    tq, tk, tv = (_t(np.asarray(x)) for x in (jq, jk, jv))
    tS = _t(S)
    to, tS_out = tops.gdn_decode(tq, tk, tv, tS, _t(g), _t(beta),
                                 delta_rule=delta_rule)
    assert tS_out is tS                      # the state is updated in place
    assert to.dtype == tq.dtype and tS.dtype == torch.float32
    o_tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for ref_o, ref_S in ((jo, jS), (ro, rS)):
        np.testing.assert_allclose(_np(to), _np(ref_o), **o_tol)
        np.testing.assert_allclose(_np(tS), _np(ref_S), **F32)


def test_gdn_decode_plain_multi_token_trajectory():
    """T steps through ops.gdn_decode (state in place) == T Pallas steps."""
    B, Hk, Hv, d, T = 1, 2, 4, 64, 8
    steps = [decode_inputs(10 + t, B, Hk, Hv, d, d) for t in range(T)]
    jS = jnp.zeros((B, Hv, d, d))
    tS = torch.zeros(B, Hv, d, d)
    for q, k, v, _, g, beta in steps:
        jo, jS = gdn_decode_pallas(_j(q), _j(k), _j(v), jS, _j(g), _j(beta),
                                   head_block=4, interpret=True)
        to, _ = tops.gdn_decode(_t(q), _t(k), _t(v), tS, _t(g), _t(beta))
        np.testing.assert_allclose(_np(to), _np(jo), **F32)
    np.testing.assert_allclose(_np(tS), _np(jS), **F32)


# ---------------------------------------------------- gdn_prefill plain

@pytest.mark.parametrize("T,chunk,Hk,Hv,delta_rule,ragged", [
    (32, 8, 2, 4, True, False),
    (64, 16, 2, 4, False, False),
    (32, 16, 2, 2, True, True),               # R = 1, ragged rows
    (32, 8, 2, 4, True, True),                # R = 2, ragged rows
    (16, 16, 1, 2, False, True),
])
def test_gdn_prefill_plain_vs_pallas(T, chunk, Hk, Hv, delta_rule, ragged):
    B, d = 3, 32
    q, k, v, lg, beta, S0 = prefill_inputs(7, B, T, Hk, Hv, d, d)
    valid = np.array([T, 0, T // 2 + 3], np.int32) if ragged else None
    jO, jS = jops.gdn_prefill(*map(_j, (q, k, v, lg, beta, S0)), chunk=chunk,
                              delta_rule=delta_rule,
                              valid_len=None if valid is None else _j(valid))
    tS = _t(S0)
    tO, tS_out = tops.gdn_prefill(
        *map(_t, (q, k, v, lg, beta)), tS, chunk=chunk, delta_rule=delta_rule,
        valid_len=None if valid is None else _t(valid))
    assert tS_out is tS
    np.testing.assert_allclose(_np(tS), _np(jS), **CHUNKWISE)
    O_t, O_j = _np(tO), _np(jO)
    for b in range(B):
        n = T if valid is None else int(valid[b])    # rows past are garbage
        np.testing.assert_allclose(O_t[b, :n], O_j[b, :n], **CHUNKWISE)
    if ragged:
        # a valid_len = 0 row leaves its state exactly unchanged
        np.testing.assert_array_equal(_np(tS)[1], S0[1])


def test_gdn_prefill_plain_vs_sequential_oracle():
    """The plain version on the (BH, T, d) rows == ``ref.gdn_prefill_ref``
    (the same sequential factorization) with the GVA rows repeated."""
    B, T, Hk, Hv, d = 2, 16, 2, 4, 16
    q, k, v, lg, beta, S0 = prefill_inputs(8, B, T, Hk, Hv, d, d)
    R = Hv // Hk
    qh = np.repeat(q.transpose(0, 2, 1, 3), R, 1).reshape(B * Hv, T, d)
    kh = np.repeat(k.transpose(0, 2, 1, 3), R, 1).reshape(B * Hv, T, d)
    vh = v.transpose(0, 2, 1, 3).reshape(B * Hv, T, d)
    lgh = lg.transpose(0, 2, 1).reshape(B * Hv, T)
    bh = beta.transpose(0, 2, 1).reshape(B * Hv, T)
    S0h = S0.reshape(B * Hv, d, d)
    jO, jS = jref.gdn_prefill_ref(*map(_j, (qh, kh, vh, lgh, bh, S0h)))
    tO, tS = tref.gdn_prefill_ref(*map(_t, (qh, kh, vh, lgh, bh, S0h)))
    np.testing.assert_allclose(_np(tO), _np(jO), **F32)
    np.testing.assert_allclose(_np(tS), _np(jS), **F32)
    # the same rows through the (BHk) q/k layout with n_rep = R
    qk = q.transpose(0, 2, 1, 3).reshape(B * Hk, T, d)
    kk = k.transpose(0, 2, 1, 3).reshape(B * Hk, T, d)
    tO2, tS2 = tref.gdn_prefill_ref(*map(_t, (qk, kk, vh, lgh, bh, S0h)),
                                    n_rep=R)
    np.testing.assert_array_equal(tO2.numpy(), tO.numpy())
    np.testing.assert_array_equal(tS2.numpy(), tS.numpy())


# ------------------------------------------------------------- dispatch

def test_cpu_dispatch_never_counts_a_launch():
    before = (tdecode.launches, tprefill.launches)
    q, k, v, S, g, beta = decode_inputs(9, 1, 1, 2, 16, 16)
    tops.gdn_decode(*map(_t, (q, k, v, S, g, beta)))
    a = prefill_inputs(9, 1, 8, 1, 2, 16, 16)
    tops.gdn_prefill(*map(_t, a), chunk=8)
    assert (tdecode.launches, tprefill.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch the CUDA kernel or raise — no plain fallback."""
    q, k, v, S, g, beta = decode_inputs(9, 1, 1, 2, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tdecode.gdn_decode(*map(_t, (q, k, v, S, g, beta)))
    q, k, v, lg, beta, S0 = prefill_inputs(9, 1, 8, 1, 2, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tprefill.gdn_prefill(
            *(_t(x.transpose(0, 2, 1, 3).reshape(-1, 8, 16))
              for x in (q, k, v)),
            _t(lg.transpose(0, 2, 1).reshape(-1, 8)),
            _t(beta.transpose(0, 2, 1).reshape(-1, 8)),
            _t(S0.reshape(-1, 16, 16)), chunk=8, n_rep=2)
    with pytest.raises(ValueError, match="device"):
        tops.gdn_decode(*(_t(x).to("meta") for x in
                          decode_inputs(9, 1, 1, 2, 16, 16)))
