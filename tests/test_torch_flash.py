"""The port's flash attention against the JAX reference's Pallas kernels
(run in interpret mode on the CPU): the plain versions ``flash_fwd_ref``
(o, m, l) and ``flash_bwd_ref`` (dq, dk, dv) on the kernels' own layout,
and the ``FlashAttention`` autograd wiring against torch autograd through
a dense float64 softmax attention.  Inputs are made with numpy from a
seed.

Tolerances: fp32 differs only in summation order and in the reference's
block-by-block online softmax against the dense plain version, 1e-5
(2e-5 on gradients, which sum over T rows).  bf16 inputs are widened
exactly on both sides, and o, dq, dk, dv are rounded to bf16 once each:
one bf16 step, 1e-2.  With ``valid_len``, output and dq rows at padded
query positions are garbage in the reference, so only valid rows are
compared, with the cotangent zeroed on padded rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import flash_attn as jflash          # noqa: E402
from repro_torch.kernels import flash_attn as tflash    # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
F32_GRAD = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)

# name: (BH, G, T, hd, window, valid_len, block)
CASES = {
    "mha": (2, 1, 64, 16, None, None, 16),
    "gqa4": (2, 4, 32, 16, None, None, 16),
    "mqa": (1, 8, 32, 16, None, None, 16),
    "window": (2, 2, 64, 16, 24, None, 16),
    "valid_len": (3, 2, 64, 16, None, (64, 37, 5), 16),
    "bf16": (2, 2, 64, 32, None, None, 32),
}


def _inputs(name):
    BH, G, T, hd, window, valid, block = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q = rng.normal(size=(BH, G, T, hd)).astype(np.float32)
    k = rng.normal(size=(BH, T, hd)).astype(np.float32)
    v = rng.normal(size=(BH, T, hd)).astype(np.float32)
    do = rng.normal(size=(BH, G, T, hd)).astype(np.float32)
    vl = None if valid is None else np.asarray(valid, np.int32)
    rows = np.ones((BH, T), bool) if vl is None else \
        np.arange(T)[None, :] < vl[:, None]
    do = do * rows[:, None, :, None]          # no cotangent on padded rows
    return (q, k, v, do, vl, rows), window, block, name == "bf16"


def _j(x, bf16):
    x = jnp.asarray(x)
    return x.astype(jnp.bfloat16) if bf16 else x


def _t(x, bf16):
    x = torch.from_numpy(x)
    return x.to(torch.bfloat16) if bf16 else x


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x, jnp.float32))


def _close_rows(got, want, rows, tol):
    """Compare (BH, G, T, ...) arrays on the rows (BH, T) marked valid."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got[np.broadcast_to(
        rows[:, None], got.shape[:3])], want[np.broadcast_to(
            rows[:, None], want.shape[:3])], **tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_plain_versions_match_reference(name):
    (q, k, v, do, vl, rows), window, block, bf16 = _inputs(name)
    jq, jk, jv, jdo = (_j(x, bf16) for x in (q, k, v, do))
    jvl = None if vl is None else jnp.asarray(vl)
    jo, jm, jl = jflash.flash_fwd(jq, jk, jv, jvl, block_q=block,
                                  block_kv=block, window=window,
                                  interpret=True)
    tq, tk, tv, tdo = (_t(x, bf16) for x in (q, k, v, do))
    tvl = None if vl is None else torch.from_numpy(vl)
    to, tm, tl = tflash.flash_fwd(tq, tk, tv, tvl, window=window)
    assert to.dtype == tq.dtype and tm.dtype == tl.dtype == torch.float32
    tol = BF16 if bf16 else F32
    _close_rows(to, jo, rows, tol)
    _close_rows(tm, jm, rows, F32)
    _close_rows(tl, jl, rows, F32)

    jdq, jdk, jdv = jflash.flash_bwd(jq, jk, jv, jo, jm, jl, jdo, jvl,
                                     block_q=block, block_kv=block,
                                     window=window, interpret=True)
    tdq, tdk, tdv = tflash.flash_bwd(tq, tk, tv, to, tm, tl, tdo, tvl,
                                     window=window)
    assert (tdq.dtype, tdk.dtype, tdv.dtype) == (tq.dtype,) * 3
    gtol = BF16 if bf16 else F32_GRAD
    _close_rows(tdq, jdq, rows, gtol)
    np.testing.assert_allclose(_np(tdk), _np(jdk), **gtol)
    np.testing.assert_allclose(_np(tdv), _np(jdv), **gtol)


def _dense64(q, k, v, window, valid_len):
    """Softmax attention in float64 on (B, T, H, hd), autograd's own
    backward; query head h reads kv head h // G."""
    B, T, Hq, hd = q.shape
    G = Hq // k.shape[2]
    kk = torch.repeat_interleave(k, G, dim=2)
    vv = torch.repeat_interleave(v, G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * hd ** -0.5
    pos = torch.arange(T)
    keep = pos[:, None] >= pos[None, :]
    if window is not None:
        keep = keep & ((pos[:, None] - pos[None, :]) < window)
    keep = keep[None, None] & (pos[None, None, None, :]
                               < valid_len[:, None, None, None])
    s = s.masked_fill(~keep, -1e30)     # padded rows may see no key
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)


@pytest.mark.parametrize("window,valid", [(None, (32, 32)), (12, (32, 9))])
def test_flash_attention_autograd_matches_dense_float64(window, valid):
    rng = np.random.default_rng(5)
    B, T, Hq, Hkv, hd = 2, 32, 4, 2, 16
    shapes = [(B, T, Hq, hd), (B, T, Hkv, hd), (B, T, Hkv, hd)]
    xs = [rng.normal(size=s) for s in shapes]
    vl = torch.tensor(valid, dtype=torch.int32)
    rows = (torch.arange(T)[None, :] < vl[:, None]).double()
    w = torch.from_numpy(rng.normal(size=(B, T, Hq, hd))) \
        * rows[:, :, None, None]
    ours = [torch.tensor(x, dtype=torch.float32, requires_grad=True)
            for x in xs]
    want = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
            for x in xs]
    o = tflash.flash_attention(*ours, window=window, valid_len=vl)
    (o.double() * w).sum().backward()
    o64 = _dense64(*want, window, vl)
    (o64 * w).sum().backward()
    valid_rows = rows.bool()
    np.testing.assert_allclose(o.detach()[valid_rows].numpy(),
                               o64.detach()[valid_rows].numpy(), **F32)
    np.testing.assert_allclose(ours[0].grad[valid_rows].numpy(),
                               want[0].grad[valid_rows].numpy(), **F32_GRAD)
    for a, b in zip(ours[1:], want[1:]):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   **F32_GRAD)
