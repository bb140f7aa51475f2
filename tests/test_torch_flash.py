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
    # h2o-danube-1.8b's head dim and recurrentgemma-2b's
    "hd80": (2, 2, 32, 80, None, None, 16),
    "hd80_window": (1, 4, 48, 80, 20, None, 16),
    "hd256": (1, 2, 32, 256, None, None, 16),
    "hd256_window": (2, 2, 32, 256, 12, (32, 19), 16),
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


@pytest.mark.parametrize("form", ["list", "tuple", "numpy", "numpy_int64"])
def test_flash_attention_takes_host_valid_len_sequences(form):
    """A (B,) host sequence of lengths gives the bits a tensor gives."""
    rng = np.random.default_rng(6)
    B, T, Hq, Hkv, hd = 2, 32, 4, 2, 16
    q, k, v = (torch.tensor(rng.normal(size=(B, T, h, hd)),
                            dtype=torch.float32) for h in (Hq, Hkv, Hkv))
    valid = (32, 9)
    host = {"list": list(valid), "tuple": valid,
            "numpy": np.asarray(valid, dtype=np.int32),
            "numpy_int64": np.asarray(valid, dtype=np.int64)}[form]
    want = tflash.flash_attention(
        q, k, v, valid_len=torch.tensor(valid, dtype=torch.int32))
    got = tflash.flash_attention(q, k, v, valid_len=host)
    assert torch.equal(got, want)


# --------------------------------------- the bf16 tensor-core kernels' design

def _tc_emulation(q, k, v, do, vl, window, scale):
    """Dense emulation of the rounding of the bf16 tensor-core forward, dq
    and dk/dv kernels on (BH, G, T, hd) bf16 q, do and (BH, T, hd) bf16 k,
    v: fp32 scores of the bf16 inputs, fp32 softmax statistics, P rounded
    to bf16 for P V and P^T dO, dS rounded to bf16 for dS K and dS^T Q,
    every sum in fp32; o, dq, dk, dv rounded to bf16 once.  Returns (o, m,
    l, dq, dk, dv)."""
    f = torch.float32
    T = q.shape[2]
    pos = torch.arange(T)
    keep = pos[:, None] >= pos[None, :]
    if window is not None:
        keep = keep & (pos[:, None] - pos[None, :] < window)
    keep = keep[None, None] & (pos < (T if vl is None else
                                      torch.from_numpy(vl)[:, None, None,
                                                           None]))
    s = scale * torch.matmul(q.to(f), k.to(f).unsqueeze(1).transpose(-1, -2))
    s = torch.where(keep, s, torch.full((), -1e30))
    m = s.amax(-1)
    e = torch.where(keep, torch.exp(s - m[..., None]), torch.zeros(()))
    l = e.sum(-1)
    rnd = lambda x: x.to(torch.bfloat16).to(f)              # noqa: E731
    o = torch.matmul(rnd(e), v.to(f).unsqueeze(1)) / torch.clamp(
        l, min=1e-30)[..., None]
    o = o.to(torch.bfloat16)
    p = e / torch.clamp(l, min=1e-30)[..., None]
    dof = do.to(f)
    delta = (dof * o.to(f)).sum(-1)
    dp = torch.matmul(dof, v.to(f).unsqueeze(1).transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dv = torch.matmul(rnd(p).transpose(-1, -2), dof).sum(1)
    dq = scale * torch.matmul(rnd(ds), k.to(f).unsqueeze(1))
    dk = scale * torch.matmul(rnd(ds).transpose(-1, -2), q.to(f)).sum(1)
    return o, m, l, dq.to(torch.bfloat16), dk.to(torch.bfloat16), \
        dv.to(torch.bfloat16)


@pytest.mark.parametrize("window,valid", [(None, None), (40, None),
                                          (None, (256, 150))])
def test_tensor_core_rounding_matches_reference(window, valid):
    """The bf16 kernels' numeric design, on the CPU before any card run:
    rounding P and dS to bf16 for their products keeps o, dq, dk and dv
    within the card's bf16 tolerance (2e-2) of the JAX kernels (interpret
    mode, fp32 products) at hd=128, G=8, T=256, and m, l within 1e-4."""
    BH, G, T, hd = 2, 8, 256, 128
    rng = np.random.default_rng(17)
    q = rng.normal(size=(BH, G, T, hd)).astype(np.float32)
    k, v = (rng.normal(size=(BH, T, hd)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(BH, G, T, hd)).astype(np.float32)
    vl = None if valid is None else np.asarray(valid, np.int32)
    rows = np.ones((BH, T), bool) if vl is None else \
        np.arange(T)[None, :] < vl[:, None]
    do = do * rows[:, None, :, None]
    jq, jk, jv, jdo = (_j(x, True) for x in (q, k, v, do))
    jvl = None if vl is None else jnp.asarray(vl)
    jo, jm, jl = jflash.flash_fwd(jq, jk, jv, jvl, window=window,
                                  interpret=True)
    jdq, jdk, jdv = jflash.flash_bwd(jq, jk, jv, jo, jm, jl, jdo, jvl,
                                     window=window, interpret=True)
    o, m, l, dq, dk, dv = _tc_emulation(
        *(_t(x, True) for x in (q, k, v, do)), vl, window, hd ** -0.5)
    card = dict(rtol=2e-2, atol=2e-2)
    _close_rows(o, jo, rows, card)
    _close_rows(m, jm, rows, dict(rtol=1e-4, atol=1e-4))
    _close_rows(l, jl, rows, dict(rtol=1e-4, atol=1e-4))
    _close_rows(dq, jdq, rows, card)
    np.testing.assert_allclose(_np(dk), _np(jdk), **card)
    np.testing.assert_allclose(_np(dv), _np(jdv), **card)


@pytest.mark.parametrize("G,expected", [(1, 1), (4, 4), (6, 3), (7, 7),
                                        (8, 4), (16, 4)])
def test_dkv_cluster_size(G, expected):
    """The bf16 dk/dv kernel's cluster over a key tile's G query heads:
    the largest divisor of G up to 4 (the registry's G = 8: four CTAs of
    two heads each; G = 4: one head each), or G itself where no divisor
    but 1 is that small and G fits a cluster (G = 7, llava-next-34b)."""
    C = tflash.cluster_size(G)
    assert C == expected and G % C == 0 and C <= tflash.MAX_CLUSTER


def _dkv_cluster_emulation(q, k, v, do, vl, window, scale, C):
    """Dense emulation of the bf16 dk/dv kernel's reduction on (BH, G, T,
    hd) bf16 q, do and (BH, T, hd) bf16 k, v: per query head the fp32
    partials dK_g = scale rnd(dS_g)^T Q_g and dV_g = rnd(P_g)^T dO_g (P and
    dS rounded to bf16 as the kernel's products take them); cluster rank
    r sums heads r G/C .. (r+1) G/C - 1 in order, the ranks' partials are
    summed in rank order 0..C-1, then one bf16 rounding."""
    f = torch.float32
    BH, G, T, hd = q.shape
    pos = torch.arange(T)
    keep = pos[:, None] >= pos[None, :]
    if window is not None:
        keep = keep & (pos[:, None] - pos[None, :] < window)
    keep = keep[None, None] & (pos < (T if vl is None else
                                      torch.from_numpy(vl)[:, None, None,
                                                           None]))
    s = scale * torch.matmul(q.to(f), k.to(f).unsqueeze(1).transpose(-1, -2))
    s = torch.where(keep, s, torch.full((), -1e30))
    m = s.amax(-1)
    e = torch.where(keep, torch.exp(s - m[..., None]), torch.zeros(()))
    p = e / torch.clamp(e.sum(-1), min=1e-30)[..., None]
    rnd = lambda x: x.to(torch.bfloat16).to(f)              # noqa: E731
    o = torch.matmul(rnd(p), v.to(f).unsqueeze(1)).to(torch.bfloat16)
    dof = do.to(f)
    delta = (dof * o.to(f)).sum(-1)
    dp = torch.matmul(dof, v.to(f).unsqueeze(1).transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dk_g = scale * torch.matmul(rnd(ds).transpose(-1, -2), q.to(f))
    dv_g = torch.matmul(rnd(p).transpose(-1, -2), dof)
    H = G // C
    out = []
    for parts in (dk_g, dv_g):
        ranks = []
        for r in range(C):
            acc = parts[:, r * H]
            for j in range(1, H):
                acc = acc + parts[:, r * H + j]
            ranks.append(acc)
        total = ranks[0]
        for r in range(1, C):
            total = total + ranks[r]
        out.append(total.to(torch.bfloat16))
    return o, out[0], out[1]


@pytest.mark.parametrize("G,window,valid", [(8, None, None),
                                            (8, 40, (256, 150)),
                                            (7, None, None),
                                            (16, None, (256, 100))])
def test_dkv_cluster_reduction_matches_reference(G, window, valid):
    """The deterministic dk/dv design on the CPU: per-head fp32 partials
    summed in the cluster's fixed order and rounded to bf16 once stay
    within the card's bf16 tolerance (2e-2, as the rounding emulation
    above) of the JAX ``_dkv_kernel`` (interpret mode) at hd = 128, for
    clusters of two heads per CTA (G = 8), one (G = 7) and four (G =
    16)."""
    BH, T, hd = 2, 256, 128
    rng = np.random.default_rng(21)
    q = rng.normal(size=(BH, G, T, hd)).astype(np.float32)
    k, v = (rng.normal(size=(BH, T, hd)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(BH, G, T, hd)).astype(np.float32)
    vl = None if valid is None else np.asarray(valid, np.int32)
    rows = np.ones((BH, T), bool) if vl is None else \
        np.arange(T)[None, :] < vl[:, None]
    do = do * rows[:, None, :, None]
    jq, jk, jv, jdo = (_j(x, True) for x in (q, k, v, do))
    jvl = None if vl is None else jnp.asarray(vl)
    jo, jm, jl = jflash.flash_fwd(jq, jk, jv, jvl, window=window,
                                  interpret=True)
    _, jdk, jdv = jflash.flash_bwd(jq, jk, jv, jo, jm, jl, jdo, jvl,
                                   window=window, interpret=True)
    _, dk, dv = _dkv_cluster_emulation(
        *(_t(x, True) for x in (q, k, v, do)), vl, window, hd ** -0.5,
        tflash.cluster_size(G))
    assert dk.dtype == dv.dtype == torch.bfloat16
    card = dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(dk), _np(jdk), **card)
    np.testing.assert_allclose(_np(dv), _np(jdv), **card)
    if vl is not None:       # key rows at or past valid_len: exactly zero
        for b, n in enumerate(valid):
            assert not _np(dk)[b, n:].any() and not _np(dv)[b, n:].any()


def test_every_attention_head_dim_has_its_kernels():
    """Every registered arch with an attention layer has its head dim
    among the kernels' instantiations (h2o-danube-1.8b's 80 and
    recurrentgemma-2b's 256 among them), and a head dim outside them is
    refused, never run on the plain version instead: the check comes
    before any look at the device."""
    from repro_torch import configs as tconfigs
    from repro_torch.models.mixers import get_mixer
    dims = {arch: cfg.head_dim for arch, cfg in tconfigs.ARCHS.items()
            if any(get_mixer(k).is_attention for k in cfg.layer_kinds)}
    assert dims["h2o-danube-1.8b"] == 80
    assert dims["recurrentgemma-2b"] == 256
    assert set(dims.values()) <= set(tflash.HEAD_DIMS), dims
    q = torch.zeros(1, 2, 8, 96)
    k = torch.zeros(1, 8, 96)
    with pytest.raises(ValueError, match="head dim 96"):
        tflash._check(q, k, k, None)


def test_flash_bounds_at_trained_shape():
    """chip_smoke.py's bound arithmetic at the trained shape (B=2,
    T=2048, Hq=16, Hkv=2, hd=128), against the figures worked by hand:
    every product of the three kernels at the bf16 tensor-core rate (dq
    rounds dS to bf16 for dS K: 3 x 1.7188e10 FLOP at 989 TFLOP/s)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    work = smoke.flash_work(B=2, T=2048, Hq=16, Hkv=2, hd=128)
    got = {name: smoke.bound_ms(w["nbytes"], w["fp32_flops"],
                                w["tc_flops"])[:2]
           for name, w in work.items()}
    assert {n: (round(ms, 6), by) for n, (ms, by) in got.items()} == {
        "flash_fwd": (0.034759, "operations"),
        "flash_bwd_dq": (0.052138, "operations"),
        "flash_bwd_dkv": (0.069518, "operations")}
