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
from repro.kernels.gdn_prefill import gdn_prefill_pallas  # noqa: E402
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


@pytest.mark.parametrize("delta_rule", [True, False])
def test_core_chunkwise_gradients_where_the_decay_passes_exp_range(
        delta_rule):
    """A chunk of 64 steps of log decay -3 each (a cumulative -192, past
    fp32's exp range, as mamba2's full-width SSD layers reach): the
    chunkwise forward is the reference's, and its gradients are finite
    and those of the sequential recurrence (the masked entries above the
    diagonal leave no 0 x inf behind; in fp64 to hold the two forms to
    summation order: the chunkwise form in fp32, where the overflow
    happens, against the sequential one in fp64)."""
    q, k, v, _, beta, S0 = prefill_inputs(5, 1, 64, 1, 1, 16, 16)
    lg = np.full((64,), -3.0, np.float32)
    a = (q[0, :, 0], k[0, :, 0], v[0, :, 0], lg, beta[0, :, 0], S0[0, 0])
    jO, _ = jgdn.prefill_chunkwise(*map(_j, a), chunk=64,
                                   delta_rule=delta_rule)
    tO, _ = tgdn.prefill_chunkwise(*map(_t, a), chunk=64,
                                   delta_rule=delta_rule)
    np.testing.assert_allclose(_np(tO), _np(jO), **F32)
    grads = []
    for fn, dtype in ((tgdn.prefill_chunkwise, torch.float32),
                      (tgdn.prefill_sequential, torch.float64)):
        xs = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in a]
        O, S = fn(*xs, delta_rule=delta_rule)
        (O.sum() + S.sum()).backward()
        grads.append([x.grad for x in xs[:4]])
    for got, want in zip(*grads):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)


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


# ------------------------------------------- the prefill kernel's design

def _blocked_inverse(A):
    """(I + A)^{-1} for a strictly lower (C, C) A, C a power of two >= 16,
    in the CUDA kernel's order: the 16 x 16 diagonal blocks by forward
    substitution (all columns at once), then blocks of doubling size n:
    the lower-left block of each 2n x 2n diagonal block,
    X_hl = -X_hh (A_hl X_ll)."""
    C = A.shape[0]
    X = torch.zeros_like(A)
    for b in range(0, C, 16):
        blk = A[b:b + 16, b:b + 16]
        x = torch.zeros(16, 16)
        for r in range(16):
            x[r] = torch.eye(16)[r] - blk[r, :r] @ x[:r]
        X[b:b + 16, b:b + 16] = x
    n = 16
    while n < C:
        for lo in range(0, C, 2 * n):
            lo_, hi_ = slice(lo, lo + n), slice(lo + n, lo + 2 * n)
            X[hi_, lo_] = -(X[hi_, hi_] @ (A[hi_, lo_] @ X[lo_, lo_]))
        n *= 2
    return X


def _split_product(a, b):
    """a @ b as the kernel's tensor cores take it for bf16-valued a: a
    times the three bf16 parts of the fp32 b, summed."""
    p0 = b.to(torch.bfloat16).float()
    r = b - p0
    p1 = r.to(torch.bfloat16).float()
    p2 = (r - p1).to(torch.bfloat16).float()
    return a @ p0 + a @ p1 + a @ p2


def _prefill_kernel_emulation(q, k, v, lg, beta, S0, valid_len, chunk,
                              scale, delta_rule, product):
    """The CUDA prefill kernels' arithmetic in plain fp32 torch on rows
    q, k, v (BH, T, d): per chunk the masked inputs, L = cumsum(log g), M
    and A from Q K^T and K K^T with their decays, Q S and K S, the
    right-hand side, the blocked inverse applied as one product, O = scale
    (exp(L) Q S + M U) and S' = exp(L_C) S + K^T (W U).  ``product`` takes
    the products with the state and with W U: ``_split_product`` for the
    tensor-core kernel (bf16 q, k), ``torch.matmul`` for the CUDA-core
    one."""
    BH, T, _ = q.shape
    O = torch.zeros_like(v)
    S = S0.clone()
    for r in range(BH):
        for t0 in range(0, T, chunk):
            pos = t0 + torch.arange(chunk)
            ok = pos < int(valid_len[r])
            Q = q[r, t0:t0 + chunk]
            K = torch.where(ok[:, None], k[r, t0:t0 + chunk], 0.0)
            V = torch.where(ok[:, None], v[r, t0:t0 + chunk], 0.0)
            g = torch.where(ok, lg[r, t0:t0 + chunk], 0.0)
            b = torch.where(ok, beta[r, t0:t0 + chunk], 0.0)
            L = torch.cumsum(g, 0)
            Lp = L - g
            low = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
            M = torch.where(low, torch.exp(L[:, None] - L[None, :])
                            * (Q @ K.T), 0.0)
            QS = product(Q, S[r])
            if delta_rule:
                A = torch.where(low & ~torch.eye(chunk, dtype=torch.bool),
                                b[:, None] * torch.exp(Lp[:, None]
                                                       - L[None, :])
                                * (K @ K.T), 0.0)
                rhs = b[:, None] * (V - torch.exp(Lp)[:, None]
                                    * product(K, S[r]))
                U = _blocked_inverse(A) @ rhs
            else:
                U = V
            O[r, t0:t0 + chunk] = scale * (torch.exp(L)[:, None] * QS
                                           + M @ U)
            W = torch.exp(L[-1] - L)
            S[r] = torch.exp(L[-1]) * S[r] + product(K.T, W[:, None] * U)
    return O, S


def _check_prefill_design(delta_rule, d, bf16_qk, product):
    """The emulated kernel at C=64 over two chunks with ragged rows (one
    fully padded, one ending inside the second chunk), against
    ``gdn_prefill_pallas`` in interpret mode (nilpotent doubling) and the
    port's plain sequential scan: the state within 1e-4; O within the
    chunkwise tolerance; the padded row's state bitwise unchanged."""
    BH, T, C = 3, 128, 64
    q, k, v, lg, beta, S0 = prefill_inputs(21, 1, T, BH, BH, d, d)
    q, k, v = (x[0].transpose(1, 0, 2).copy() for x in (q, k, v))
    lg, beta = (x[0].T.copy() for x in (lg, beta))
    S0 = S0[0]
    if bf16_qk:
        q, k = (np.asarray(_t(x).to(torch.bfloat16).float()) for x in (q, k))
    valid = np.array([T, 0, 70], np.int32)
    scale = d ** -0.5 if delta_rule else 1.0
    jO, jS = gdn_prefill_pallas(*map(_j, (q, k, v, lg, beta, S0)),
                                _j(valid), chunk=C, scale=scale,
                                delta_rule=delta_rule, interpret=True)
    eO, eS = _prefill_kernel_emulation(*map(_t, (q, k, v, lg, beta, S0)),
                                       _t(valid), C, scale, delta_rule,
                                       product)
    pO, pS = tref.gdn_prefill_ref(*map(_t, (q, k, v, lg, beta, S0)),
                                  _t(valid), scale=scale,
                                  delta_rule=delta_rule)
    state = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(eS), _np(jS), **state)
    np.testing.assert_allclose(_np(eS), _np(pS), **state)
    np.testing.assert_array_equal(_np(eS)[1], S0[1])
    for r in range(BH):
        n = int(valid[r])
        np.testing.assert_allclose(_np(eO)[r, :n], _np(jO)[r, :n],
                                   **CHUNKWISE)
        np.testing.assert_allclose(_np(eO)[r, :n], _np(pO)[r, :n],
                                   **CHUNKWISE)


@pytest.mark.parametrize("delta_rule", [True, False])
def test_prefill_kernel_design_vs_pallas(delta_rule):
    """The tensor-core prefill kernel's numeric design on the CPU before
    any card run: its blocked inverse, its order of products and its
    products with the three bf16 parts of an fp32 operand, at d=128 with q
    and k holding bf16 values, as served."""
    _check_prefill_design(delta_rule, 128, True, _split_product)


@pytest.mark.parametrize("delta_rule", [True, False])
def test_prefill_cuda_core_design_vs_pallas(delta_rule):
    """The CUDA-core prefill kernel's design, which serves the reduced
    configurations: the same blocked inverse and order of products, the
    products with the state in plain fp32, at their width d=16 in fp32."""
    _check_prefill_design(delta_rule, 16, False, torch.matmul)


def test_prefill_bound_at_main_shape():
    """chip_smoke.py's gdn_prefill bound at the main path's shape (one
    64-token chunk, Hk=16, Hv=32, d=128, bf16), against the figures worked
    by hand: 5,783,680 bytes at 3.35 TB/s = 1.7265 us; Q K^T and K K^T
    (32 x 2 x 64^2 x 128) plus three split products for K S, Q S and the
    state update (32 x 3 x 6 x 64 x 128^2) at 989 TFLOP/s = 0.6446 us;
    the inverse applied and M U (32 x 2 x 64^2 x 128) at 67 TFLOP/s =
    0.5008 us: bound by bytes."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    w = smoke.prefill_work(Hk=16, Hv=32, T=64, d_k=128, d_v=128, bf16=True)
    assert w == dict(nbytes=5_783_680, tc_flops=637_534_208,
                     fp32_flops=33_554_432)
    ms, by, (t_bytes, t_fp32, t_tc) = smoke.bound_ms(
        w["nbytes"], w["fp32_flops"], w["tc_flops"])
    assert (round(ms, 7), by) == (0.0017265, "bytes")
    assert (round(t_fp32, 7), round(t_tc, 7)) == (0.0005008, 0.0006446)


def test_gdn_bounds_at_mamba2_shape():
    """chip_smoke.py's GDN bounds at mamba2-1.3b's shape (Hk=1, Hv=64,
    d_k=128, d_v=64, bf16, delta_rule=False), against the figures worked
    by hand.  Prefill, one 64-token chunk: bytes (2 x 64 x 128 + 2 x 64 x
    64 x 64) x 2 + 2 x 64 x 64 x 4 + 2 x 64 x 128 x 64 x 4 + 64 x 4 =
    5,308,672 at 3.35 TB/s = 1.5847 us; Q K^T (64 x 64^2 x 128) and three
    split products for Q S and the update (64 x 3 x 4 x 64 x 128 x 64) at
    989 TFLOP/s = 0.4411 us; M V (64 x 64^2 x 64) at 67 TFLOP/s = 0.2504
    us: bound by bytes.  Decode at B=4: the state read and written (2 x 4
    x 64 x 128 x 64 x 4) + q, k, v, o in bf16 + g, beta = 16,846,848 bytes
    = 5.0289 us against 4 x 64 x (5 x 128 x 64 + 8 x 64) fp32 FLOP."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    w = smoke.prefill_work(Hk=1, Hv=64, T=64, bf16=True, d_k=128, d_v=64,
                           delta_rule=False)
    assert w == dict(nbytes=5_308_672, tc_flops=436_207_616,
                     fp32_flops=16_777_216)
    ms, by, (t_bytes, t_fp32, t_tc) = smoke.bound_ms(
        w["nbytes"], w["fp32_flops"], w["tc_flops"])
    assert (round(ms, 7), by) == (0.0015847, "bytes")
    assert (round(t_fp32, 7), round(t_tc, 7)) == (0.0002504, 0.0004411)
    w = smoke.decode_work(4, 1, 64, 128, 64, delta_rule=False)
    assert w == dict(nbytes=16_846_848, fp32_flops=10_616_832, tc_flops=0)
    ms, by, _ = smoke.bound_ms(w["nbytes"], w["fp32_flops"])
    assert (round(ms, 7), by) == (0.0050289, "bytes")


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
