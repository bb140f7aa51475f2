"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card (``-m cuda``; skipped without one).  This file imports no JAX, so
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the fp32 state differs only in summation order (decode,
1e-5) or between two factorizations of one recurrence (prefill, 5e-4);
a bf16 output allows one bf16 rounding step (2e-2).  Inputs are made with
numpy from a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import gdn_decode as tdecode    # noqa: E402
from repro_torch.kernels import gdn_prefill as tprefill  # noqa: E402
from repro_torch.kernels import ops, ref                 # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
CHUNKWISE = dict(rtol=5e-4, atol=5e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normal(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(
        np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("delta_rule", [True, False])
def test_decode_kernel_vs_plain(cuda, dtype, delta_rule):
    rng = np.random.default_rng(11)
    B, Hk, Hv, d = 2, 4, 8, 128
    q = _normal(rng, B, Hk, d)
    k = torch.nn.functional.normalize(_normal(rng, B, Hk, d), dim=-1)
    v = _normal(rng, B, Hv, d)
    qkv = [x.to(cuda, dtype) for x in (q, k, v)]
    S = _normal(rng, B, Hv, d, d, scale=0.2).to(cuda)
    g, beta = (torch.sigmoid(_normal(rng, B, Hv)).to(cuda) for _ in range(2))
    S_k = S.clone()
    n = tdecode.launches
    o_k, S_out = ops.gdn_decode(*qkv, S_k, g, beta, delta_rule=delta_rule)
    o_p, S_p = ref.gdn_decode_ref(*qkv, S, g, beta, delta_rule=delta_rule)
    torch.cuda.synchronize()
    assert tdecode.launches == n + 1 and S_out is S_k
    _close(o_k, o_p, F32 if dtype == torch.float32 else BF16)
    _close(S_k, S_p, F32)


# (B, T, Hk, Hv, d, chunk, valid_len, dtype): a small fp32 case in chunks
# of 16; the reduced configurations' width (d=16, fp32) and bf16 at d=64,
# both on the CUDA-core kernel, over two chunks of 64; the full-width head
# dim in chunks of 64 over three chunks, bf16 as served (the tensor-core
# kernel).  valid_len crosses chunk edges, one row fully padded.
PREFILL_CASES = {
    "small": (2, 32, 2, 4, 64, 16, (32, 5), torch.float32),
    "reduced": (3, 128, 2, 4, 16, 64, (128, 0, 70), torch.float32),
    "bf16_d64": (3, 128, 2, 4, 64, 64, (128, 0, 70), torch.bfloat16),
    "full_width_multichunk": (4, 192, 2, 4, 128, 64, (192, 0, 100, 64),
                              torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
@pytest.mark.parametrize("delta_rule", [True, False])
def test_prefill_kernel_vs_plain(cuda, delta_rule, case):
    B, T, Hk, Hv, d, chunk, valid, dtype = PREFILL_CASES[case]
    rng = np.random.default_rng(12)
    q = _normal(rng, B, T, Hk, d).to(cuda, dtype)
    k = torch.nn.functional.normalize(_normal(rng, B, T, Hk, d),
                                      dim=-1).to(cuda, dtype)
    v = _normal(rng, B, T, Hv, d).to(cuda, dtype)
    lg = -torch.nn.functional.softplus(_normal(rng, B, T, Hv)).to(cuda)
    beta = torch.sigmoid(_normal(rng, B, T, Hv)).to(cuda)
    S0 = _normal(rng, B, Hv, d, d, scale=0.1).to(cuda)
    valid = torch.tensor(valid, dtype=torch.int32, device=cuda)
    S_k = S0.clone()
    n = tprefill.launches
    O_k, _ = ops.gdn_prefill(q, k, v, lg, beta, S_k, chunk=chunk,
                             delta_rule=delta_rule, valid_len=valid)
    rows = [x.transpose(1, 2).reshape(B * x.shape[2], T, *x.shape[3:])
            .contiguous() for x in (q, k, v, lg, beta)]
    vl = torch.repeat_interleave(valid, Hv)
    O_p, S_p = ref.gdn_prefill_ref(*rows, S0.reshape(B * Hv, d, d), vl,
                                   delta_rule=delta_rule, n_rep=Hv // Hk)
    torch.cuda.synchronize()
    assert tprefill.launches == n + 1
    _close(S_k.reshape(B * Hv, d, d), S_p, CHUNKWISE)
    for b, n_valid in enumerate(valid.tolist()):
        if n_valid == 0:            # a fully padded row keeps its state
            assert torch.equal(S_k[b], S0[b])
    O_k = O_k.transpose(1, 2).reshape(B * Hv, T, d)
    o_tol = CHUNKWISE if dtype == torch.float32 else BF16
    for r, n_valid in enumerate(vl.tolist()):
        _close(O_k[r, :n_valid], O_p[r, :n_valid], o_tol)


# mamba2's shapes: one q/k head (B, C) for every value head, d_k != d_v.
# Decode (B, Hk, Hv, d_k, d_v, dtype): full width (bf16, the served
# shape) and the reduced config (fp32, d_v 16 below the kernel's
# 32-column tile).
SSM_DECODE_CASES = {
    "mamba2": (4, 1, 64, 128, 64, torch.bfloat16),
    "mamba2_reduced": (3, 1, 8, 32, 16, torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SSM_DECODE_CASES))
@pytest.mark.parametrize("delta_rule", [True, False])
def test_decode_kernel_ssm_shapes_vs_plain(cuda, delta_rule, case):
    B, Hk, Hv, dk, dv, dtype = SSM_DECODE_CASES[case]
    rng = np.random.default_rng(13)
    q = _normal(rng, B, Hk, dk)
    k = torch.nn.functional.normalize(_normal(rng, B, Hk, dk), dim=-1)
    v = _normal(rng, B, Hv, dv)
    qkv = [x.to(cuda, dtype) for x in (q, k, v)]
    S = _normal(rng, B, Hv, dk, dv, scale=0.2).to(cuda)
    g, beta = (torch.sigmoid(_normal(rng, B, Hv)).to(cuda) for _ in range(2))
    S_k = S.clone()
    n = tdecode.launches
    o_k, _ = ops.gdn_decode(*qkv, S_k, g, beta, delta_rule=delta_rule)
    o_p, S_p = ref.gdn_decode_ref(*qkv, S, g, beta, delta_rule=delta_rule)
    torch.cuda.synchronize()
    assert tdecode.launches == n + 1
    _close(o_k, o_p, F32 if dtype == torch.float32 else BF16)
    _close(S_k, S_p, F32)


# Prefill (B, T, Hk, Hv, d_k, d_v, chunk, valid_len, dtype): full width
# on the tensor-core kernel over three chunks, the reduced config on the
# CUDA-core kernel over two; valid_len crosses chunk edges, one row fully
# padded.
SSM_PREFILL_CASES = {
    "mamba2": (4, 192, 1, 64, 128, 64, 64, (192, 0, 100, 64),
               torch.bfloat16),
    "mamba2_reduced": (3, 128, 1, 8, 32, 16, 64, (128, 0, 70),
                       torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SSM_PREFILL_CASES))
@pytest.mark.parametrize("delta_rule", [True, False])
def test_prefill_kernel_ssm_shapes_vs_plain(cuda, delta_rule, case):
    B, T, Hk, Hv, dk, dv, chunk, valid, dtype = SSM_PREFILL_CASES[case]
    rng = np.random.default_rng(14)
    q = _normal(rng, B, T, Hk, dk).to(cuda, dtype)
    k = torch.nn.functional.normalize(_normal(rng, B, T, Hk, dk),
                                      dim=-1).to(cuda, dtype)
    v = _normal(rng, B, T, Hv, dv).to(cuda, dtype)
    lg = -torch.nn.functional.softplus(_normal(rng, B, T, Hv)).to(cuda)
    beta = torch.sigmoid(_normal(rng, B, T, Hv)).to(cuda)
    S0 = _normal(rng, B, Hv, dk, dv, scale=0.1).to(cuda)
    valid = torch.tensor(valid, dtype=torch.int32, device=cuda)
    S_k = S0.clone()
    n = tprefill.launches
    O_k, _ = ops.gdn_prefill(q, k, v, lg, beta, S_k, chunk=chunk,
                             delta_rule=delta_rule, valid_len=valid)
    rows = [x.transpose(1, 2).reshape(B * x.shape[2], T, *x.shape[3:])
            .contiguous() for x in (q, k, v, lg, beta)]
    vl = torch.repeat_interleave(valid, Hv)
    O_p, S_p = ref.gdn_prefill_ref(*rows, S0.reshape(B * Hv, dk, dv), vl,
                                   delta_rule=delta_rule, n_rep=Hv // Hk)
    torch.cuda.synchronize()
    assert tprefill.launches == n + 1
    _close(S_k.reshape(B * Hv, dk, dv), S_p, CHUNKWISE)
    for b, n_valid in enumerate(valid.tolist()):
        if n_valid == 0:
            assert torch.equal(S_k[b], S0[b])
    O_k = O_k.transpose(1, 2).reshape(B * Hv, T, dv)
    o_tol = CHUNKWISE if dtype == torch.float32 else BF16
    for r, n_valid in enumerate(vl.tolist()):
        _close(O_k[r, :n_valid], O_p[r, :n_valid], o_tol)


@pytest.mark.cuda
def test_wrappers_check_their_inputs(cuda):
    """Wrong dtype or a non-contiguous state raises before any launch."""
    B, Hk, Hv, d = 1, 1, 2, 32
    q = torch.zeros(B, Hk, d, device=cuda)
    v = torch.zeros(B, Hv, d, device=cuda)
    g = torch.ones(B, Hv, device=cuda)
    S = torch.zeros(B, Hv, d, 2 * d, device=cuda)[..., :d]
    n = tdecode.launches
    with pytest.raises(ValueError, match="contiguous"):
        tdecode.gdn_decode(q, q, v, S, g, g)
    with pytest.raises(TypeError, match="float32"):
        tdecode.gdn_decode(q, q, v, S.contiguous(), g.double(), g)
    assert tdecode.launches == n


# ------------------------------------------------------------ flash attention

# (B, T, Hq, Hkv, hd, window, valid_len, peak): MHA, GQA 8:1 at the
# trained head dim, a ragged T, a window, valid_len (one row fully padded);
# the trained shape; a T that is no multiple of the 64-row tile; a window
# narrower than a tile, so every tile on the diagonal crosses its edge; a
# peaky softmax (q and k times ``peak``: scores spanning about +-30, where
# rounding P to bf16 is hardest); head dims 80 (h2o-danube-1.8b: 5
# k-steps, 10 copy chunks per row) and 256 (recurrentgemma-2b: 64-row
# forward and dq CTAs, dk/dv CTAs split between dK and dV), each with a
# window, with valid_len and with a T off the tile
FLASH_CASES = [(2, 128, 4, 4, 64, None, None, 1.0),
               (1, 256, 16, 2, 128, None, None, 1.0),
               (2, 100, 4, 2, 64, None, None, 1.0),
               (1, 192, 4, 2, 128, 40, None, 1.0),
               (3, 128, 4, 2, 64, None, (128, 70, 0), 1.0),
               (1, 2048, 16, 2, 128, None, None, 1.0),
               (2, 300, 8, 2, 128, None, None, 1.0),
               (1, 256, 4, 2, 128, 24, None, 1.0),
               (1, 512, 8, 2, 128, None, None, 2.75),
               (2, 200, 8, 2, 80, None, (200, 77), 1.0),
               (1, 256, 4, 1, 80, 48, None, 1.0),
               (1, 320, 16, 1, 256, 100, None, 1.0),
               (2, 130, 4, 2, 256, None, (130, 64), 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_vs_plain(cuda, dtype, case):
    """o, m, l, dq, dk, dv of the three kernels against the dense plain
    versions on the same inputs.  fp32: summation order only (1e-4 — the
    online softmax renormalizes by exp differences); bf16 outputs: one
    rounding step (2e-2); m and l are fp32 either way (1e-4).  With
    valid_len only valid rows of o, m, l and dq count, and only the
    batch rows whose valid_len > 0 (an all-padded row is garbage in the
    reference too)."""
    from repro_torch.kernels import flash_attn as tflash
    B, T, Hq, Hkv, hd, window, valid, peak = case
    G = Hq // Hkv
    rng = np.random.default_rng(13)
    q = _normal(rng, B * Hkv, G, T, hd, scale=peak).to(cuda, dtype)
    do = _normal(rng, B * Hkv, G, T, hd).to(cuda, dtype)
    k = _normal(rng, B * Hkv, T, hd, scale=peak).to(cuda, dtype)
    v = _normal(rng, B * Hkv, T, hd).to(cuda, dtype)
    vl = rows = None
    if valid is not None:
        vl = torch.repeat_interleave(torch.tensor(valid, dtype=torch.int32),
                                     Hkv).to(cuda)
        rows = torch.arange(T, device=cuda)[None, :] < vl[:, None]
        do = do * rows[:, None, :, None].to(dtype)
    n = dict(tflash.launches)
    o, m, l = tflash.flash_fwd(q, k, v, vl, window=window)
    dq, dk, dv = tflash.flash_bwd(q, k, v, o, m, l, do, vl, window=window)
    po, pm, pl = ref.flash_fwd_ref(q, k, v, vl, window=window)
    pdq, pdk, pdv = ref.flash_bwd_ref(q, k, v, o, m, l, do, vl,
                                      window=window)
    torch.cuda.synchronize()
    assert {k_: tflash.launches[k_] - n[k_] for k_ in n} == \
        {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    stat = dict(rtol=1e-4, atol=1e-4)
    tol = stat if dtype == torch.float32 else BF16
    keep = torch.ones(B * Hkv, dtype=torch.bool, device=cuda) if vl is None \
        else vl > 0
    sel = (torch.ones(B * Hkv, T, dtype=torch.bool, device=cuda)
           if rows is None else rows) & keep[:, None]
    sel4 = sel[:, None].expand(-1, G, -1)
    for got, want, t in ((o, po, tol), (m, pm, stat), (l, pl, stat),
                         (dq, pdq, tol)):
        _close(got[sel4], want[sel4], t)
    for got, want in ((dk, pdk), (dv, pdv)):
        _close(got[keep], want[keep], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [80, 128, 256])
def test_flash_dq_bitwise_reproducible(cuda, hd):
    """The bf16 dq kernel owns its rows (no atomics): five calls on the
    same inputs give the same bits."""
    from repro_torch.kernels import flash_attn as tflash
    rng = np.random.default_rng(16)
    BH, G, T = 2, 4, 300
    q, do = (_normal(rng, BH, G, T, hd).to(cuda, torch.bfloat16)
             for _ in range(2))
    k, v = (_normal(rng, BH, T, hd).to(cuda, torch.bfloat16)
            for _ in range(2))
    o, m, l = tflash.flash_fwd(q, k, v)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    args = (q, k, v, do, m, l, delta, None, hd ** -0.5, 0)
    first = tflash._dq_cuda(*args)
    for _ in range(4):
        assert torch.equal(tflash._dq_cuda(*args), first)


def _dkv_inputs(cuda, rng, BH, G, T, hd):
    q, do = (_normal(rng, BH, G, T, hd).to(cuda, torch.bfloat16)
             for _ in range(2))
    k, v = (_normal(rng, BH, T, hd).to(cuda, torch.bfloat16)
            for _ in range(2))
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("BH,G,T,hd", [(4, 8, 2048, 128), (2, 4, 640, 80),
                                       (1, 16, 512, 256)])
def test_flash_dkv_bitwise_reproducible(cuda, BH, G, T, hd):
    """The bf16 dk/dv kernel sums the G query heads in a fixed order (a
    thread block cluster, no atomics): five calls at the trained shape
    (B=2, T=2048, GQA 16:2), at head dim 80 and at 256 (dK and dV from
    separate CTAs of the one launch) give the same bits, from one launch
    each."""
    from repro_torch.kernels import flash_attn as tflash
    rng = np.random.default_rng(18)
    q, k, v, do = _dkv_inputs(cuda, rng, BH, G, T, hd)
    o, m, l = tflash.flash_fwd(q, k, v)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    args = (q, k, v, do, m, l, delta, None, hd ** -0.5, 0)
    n = tflash.launches["flash_bwd_dkv"]
    dk0, dv0 = tflash._dkv_cuda(*args)
    assert dk0.dtype == dv0.dtype == torch.bfloat16
    for _ in range(4):
        dk, dv = tflash._dkv_cuda(*args)
        assert torch.equal(dk, dk0) and torch.equal(dv, dv0)
    assert tflash.launches["flash_bwd_dkv"] == n + 5


# (G, hd, T, window, valid_len per batch row of 2): the registry's group
# sizes 1 (minicpm-2b; no cluster), 4 (yi-9b; 4 CTAs of one head), 7
# (llava-next-34b; 7 CTAs of one head) and 8 (h2o-danube, qwen3-next-gdn;
# 4 CTAs of two heads), and 16 (4 CTAs of four heads); each with a window
# or with valid_len whose second row leaves key tiles wholly past it (they
# must come out as zeros); head dim 80 at G 4 (h2o-danube-1.8b on a model
# axis of 2) and 256 at G 16 and 8 (recurrentgemma-2b's padded MQA heads,
# on one device and on a model axis of 2: CTAs split between dK and dV)
DKV_GROUP_CASES = [(1, 128, 200, 50, (200, 60)), (4, 64, 256, None, (256, 9)),
                   (7, 128, 200, 70, (131, 64)), (8, 128, 320, 100, (320, 1)),
                   (16, 64, 192, None, (192, 100)),
                   (4, 80, 256, None, (256, 9)),
                   (16, 256, 256, 100, (256, 70)),
                   (8, 256, 200, None, (131, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DKV_GROUP_CASES)
def test_flash_dkv_cluster_vs_plain(cuda, case):
    """dk and dv of the bf16 cluster kernel against the plain version at
    every cluster size the registry needs (2e-2: one bf16 rounding of an
    fp32 sum), and exactly zero on key rows at or past valid_len."""
    from repro_torch.kernels import flash_attn as tflash
    G, hd, T, window, valid = case
    rng = np.random.default_rng(19)
    Hkv = 2
    q, k, v, do = _dkv_inputs(cuda, rng, 2 * Hkv, G, T, hd)
    vl = torch.repeat_interleave(torch.tensor(valid, dtype=torch.int32),
                                 Hkv).to(cuda)
    rows = torch.arange(T, device=cuda)[None, :] < vl[:, None]
    do = do * rows[:, None, :, None].to(do.dtype)
    o, m, l = tflash.flash_fwd(q, k, v, vl, window=window)
    _, dk, dv = tflash.flash_bwd(q, k, v, o, m, l, do, vl, window=window)
    _, pdk, pdv = ref.flash_bwd_ref(q, k, v, o, m, l, do, vl, window=window)
    torch.cuda.synchronize()
    _close(dk, pdk, BF16)
    _close(dv, pdv, BF16)
    assert not dk[~rows].any() and not dv[~rows].any()


@pytest.mark.cuda
def test_flash_attention_backward_bitwise_on_card(cuda):
    """Two autograd backward passes of ``flash_attention`` through the
    kernels (bf16, GQA 8:1, a window) give bitwise-equal gradients."""
    from repro_torch.kernels import flash_attn as tflash
    rng = np.random.default_rng(20)
    B, T, Hq, Hkv, hd = 2, 384, 8, 1, 128
    xs = [_normal(rng, B, T, h, hd).to(cuda, torch.bfloat16)
          for h in (Hq, Hkv, Hkv)]
    w = _normal(rng, B, T, Hq, hd).to(cuda)
    grads = []
    for _ in range(2):
        ins = [x.clone().requires_grad_(True) for x in xs]
        o = tflash.flash_attention(*ins, window=200)
        (o.float() * w).sum().backward()
        grads.append([x.grad for x in ins])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_autograd_on_card(cuda):
    """FlashAttention's gradients through the kernels equal those through
    the plain versions on the same bf16 inputs (2e-2)."""
    from repro_torch.kernels import flash_attn as tflash
    rng = np.random.default_rng(14)
    B, T, Hq, Hkv, hd = 2, 128, 8, 2, 128
    xs = [_normal(rng, B, T, h, hd).to(torch.bfloat16)
          for h in (Hq, Hkv, Hkv)]
    w = _normal(rng, B, T, Hq, hd)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        ins = [x.to(dev).requires_grad_(True) for x in xs]
        o = tflash.flash_attention(*ins)
        (o.float() * w.to(dev)).sum().backward()
        grads.append([o.detach().cpu()] + [x.grad.cpu() for x in ins])
    for a, b in zip(*grads):
        _close(a, b, BF16)


# ------------------------------------------------------- attention decode

# the phase-2 shapes of chip_smoke.py: (a) qwen3-next-gdn's attention layer
# at the serving batch, ragged lengths; (b) an h2o-danube-1.8b layer, its
# 4096-slot rolling cache on both sides of the wrap, window 4096; plus a
# small fp32 MHA case with a window inside a wrapped buffer
ATTN_CASES = {
    "a": (4, 16, 2, 128, 1024, (1, 300, 777, 1024), None),
    "b": (4, 32, 8, 80, 4096, (100, 4096, 4500, 9000), 4096),
    "small_window": (2, 4, 4, 64, 96, (50, 200), 40),
}


def _attn_inputs(cuda, dtype, B, Hq, Hkv, d, T, lengths):
    rng = np.random.default_rng(15)
    q = _normal(rng, B, Hq, d).to(cuda, dtype)
    k, v = (_normal(rng, B, Hkv, T, d).to(cuda, dtype) for _ in range(2))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attn_decode_kernel_vs_plain_and_sdpa(cuda, dtype, case):
    """The flash-decode kernel against its plain version (fp32: summation
    order only, 1e-5; bf16 output: one rounding step, 2e-2) and against
    ``F.scaled_dot_product_attention`` with the same boolean mask (2e-2:
    SDPA's own bf16 arithmetic)."""
    from repro_torch.kernels import attn_decode as tattn
    B, Hq, Hkv, d, T, lengths, window = ATTN_CASES[case]
    q, k, v, length = _attn_inputs(cuda, dtype, B, Hq, Hkv, d, T, lengths)
    n = tattn.launches
    o = ops.attn_decode(q, k, v, length, window=window)
    want = ref.attn_decode_ref(q, k, v, length, window=window)
    mask = ref.attn_decode_visible(length, T, window)[:, None, None, :]
    lib = torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)[:, :, 0]
    torch.cuda.synchronize()
    assert tattn.launches == n + 1 and o.dtype == dtype
    _close(o, want, F32 if dtype == torch.float32 else BF16)
    _close(o, lib, BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attn_decode_one_launch_bitwise_and_empty_rows(cuda, dtype):
    """Shape (b) of chip_smoke.py with its second batch row emptied: one
    kernel launch per call (the merge is the last split's), five calls
    bitwise equal (the merge sums in split order whichever split is last),
    o = 0 exactly on the empty row, the other rows as the plain version."""
    from repro_torch.kernels import attn_decode as tattn
    B, Hq, Hkv, d, T, lengths, window = ATTN_CASES["b"]
    lengths = (lengths[0], 0) + lengths[2:]
    q, k, v, length = _attn_inputs(cuda, dtype, B, Hq, Hkv, d, T, lengths)

    def call():
        return tattn.attn_decode(q, k, v, length, window=window)

    first = call()
    n = tattn.launches
    for _ in range(4):
        assert torch.equal(call(), first)
    assert tattn.launches == n + 4
    from repro_torch.launch.profile_decode import kernels_per_call
    per_call, names = kernels_per_call(call)
    assert per_call == 1 and all("attn_decode" in x for x in names), names
    assert not first[1].any()
    want = ref.attn_decode_ref(q, k, v, length, window=window)
    _close(first, want, F32 if dtype == torch.float32 else BF16)


@pytest.mark.cuda
def test_reduced_serve_through_kernels(cuda):
    """The reduced qwen3-next-gdn (d=16, fp32: the CUDA-core prefill
    kernel) served through the GDN kernels on the card, as the serve CLI's
    default with ``--kernels`` does: prompts of 4 to 40 tokens staged in
    chunks of 16, every request decoded to its length, both kernels
    launched, the token streams those of the plain path."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving.engine import DecodeEngine, Request
    base = configs.get_arch("qwen3-next-gdn").reduced()
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, base.vocab, size=n, dtype=np.int32)
               for n in (4, 16, 23, 40)]
    streams = {}
    for kernels in (True, False):
        cfg = base.replace(use_pallas_serving=kernels)
        params = lm.init_lm(0, cfg, device="cuda")
        eng = DecodeEngine(cfg, params, max_slots=2, max_len=64, seed=0,
                           decode_block=4, prefill_chunk=16, device="cuda")
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=8))
        n = (tprefill.launches, tdecode.launches)
        done = sorted(eng.run_until_done(), key=lambda r: r.rid)
        assert all(len(r.output) == 8 for r in done)
        launched = (tprefill.launches > n[0], tdecode.launches > n[1])
        assert launched == (kernels, kernels)
        streams[kernels] = [list(r.output) for r in done]
    assert streams[True] == streams[False]


@pytest.mark.cuda
def test_reduced_mamba2_serve_through_kernels(cuda):
    """Reduced mamba2 (d_state 32 x headdim 16, fp32, one q/k head for 8
    value heads: the CUDA-core prefill kernel, the decode kernel at d_v 16)
    served through the GDN kernels with delta_rule=False, both kernels
    launched, the token streams those of the plain path."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving.engine import DecodeEngine, Request
    base = configs.get_arch("mamba2-1.3b").reduced()
    rng = np.random.default_rng(18)
    prompts = [rng.integers(1, base.vocab, size=n, dtype=np.int32)
               for n in (4, 16, 23, 40)]
    streams = {}
    for kernels in (True, False):
        cfg = base.replace(use_pallas_serving=kernels)
        params = lm.init_lm(0, cfg, device="cuda")
        eng = DecodeEngine(cfg, params, max_slots=2, max_len=64, seed=0,
                           decode_block=4, prefill_chunk=16, device="cuda")
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=8,
                               temperature=0.7 if i == 1 else 0.0))
        n = (tprefill.launches, tdecode.launches)
        done = sorted(eng.run_until_done(), key=lambda r: r.rid)
        assert all(len(r.output) == 8 for r in done)
        launched = (tprefill.launches > n[0], tdecode.launches > n[1])
        assert launched == (kernels, kernels)
        streams[kernels] = [list(r.output) for r in done]
    assert streams[True] == streams[False]


# ------------------------------------------------------------ CUDA graphs

def _graph_engines(prompts, news, temps):
    """The reduced qwen3-next-gdn served through the GDN kernels by an
    engine that replays CUDA graphs and one that runs eagerly, on one set
    of weights; each serves ``prompts`` twice (the first run takes every
    program through its eager first call and its capture, the second
    replays).  Returns {cuda_graphs: (engine, [[stream]] per run)}."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving.engine import DecodeEngine, Request
    cfg = configs.get_arch("qwen3-next-gdn").reduced().replace(
        use_pallas_serving=True)
    params = lm.init_lm(0, cfg, device="cuda")
    out = {}
    for graphs in (True, False):
        eng = DecodeEngine(cfg, params, max_slots=2, max_len=64, seed=0,
                           decode_block=4, prefill_chunk=16,
                           device="cuda", cuda_graphs=graphs)
        runs = []
        for _ in range(2):
            reqs = [Request(rid=i, prompt=p, max_new_tokens=n,
                            temperature=t, top_k=20 if t else 0)
                    for i, (p, n, t) in enumerate(zip(prompts, news, temps))]
            for r in reqs:
                eng.submit(r)
            eng.run_until_done()
            runs.append([list(r.output) for r in reqs])
        out[graphs] = (eng, runs)
    return out


@pytest.mark.cuda
def test_graphs_streams_bitwise_equal_eager(cuda):
    """Greedy and stochastic requests (prompts of 4 to 57 tokens: scans
    with placeholder chunks) through replayed graphs give the eager
    engine's streams; the GDN decode launches, counted under replay, are
    one per GDN layer and decode step, as eagerly."""
    rng = np.random.default_rng(21)
    prompts = [rng.integers(1, 256, size=n, dtype=np.int32)
               for n in (4, 57, 23, 40, 16)]
    n0 = tdecode.launches
    res = _graph_engines(prompts, (9, 5, 12, 3, 7),
                         (0.0, 0.8, 0.0, 1.1, 0.0))
    (geng, gruns), (eeng, eruns) = res[True], res[False]
    assert gruns == eruns and gruns[0] == gruns[1]
    progs = geng.executor.compiled_programs()
    assert progs["cuda_graphs"] > 0
    assert eeng.executor.compiled_programs()["cuda_graphs"] == 0
    assert {k: v for k, v in progs.items() if k != "cuda_graphs"} == \
        {k: v for k, v in eeng.executor.compiled_programs().items()
         if k != "cuda_graphs"}
    n_gdn = sum(k == "gdn" for k in geng.cfg.layer_kinds)
    assert tdecode.launches - n0 == n_gdn * (geng.decode_steps
                                             + eeng.decode_steps)


@pytest.mark.cuda
def test_graphs_admit_after_capture(cuda):
    """A request admitted into a slot after the decode graphs it joins
    were captured decodes as it does eagerly."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving.engine import DecodeEngine, Request
    cfg = configs.get_arch("qwen3-next-gdn").reduced().replace(
        use_pallas_serving=True)
    params = lm.init_lm(1, cfg, device="cuda")
    rng = np.random.default_rng(22)
    first, late = (rng.integers(1, 256, size=n, dtype=np.int32)
                   for n in (30, 19))
    streams = {}
    for graphs in (True, False):
        eng = DecodeEngine(cfg, params, max_slots=2, max_len=96, seed=0,
                           decode_block=2, prefill_chunk=16, device="cuda",
                           cuda_graphs=graphs)
        a = Request(rid=0, prompt=first, max_new_tokens=40)
        eng.submit(a)
        for _ in range(6):          # decode(2) runs eagerly, is captured,
            eng.step()              # then replays
        if graphs:
            assert eng.executor._programs[("decode", 2, False)].graph \
                is not None
        b = Request(rid=1, prompt=late, max_new_tokens=12, temperature=0.7)
        eng.submit(b)
        eng.run_until_done()
        streams[graphs] = (list(a.output), list(b.output))
    assert streams[True] == streams[False]


@pytest.mark.cuda
def test_graphs_count_within_the_program_shapes(cuda):
    """Across the masked planner's awkward lengths on one engine: at most
    one graph per (k bucket, stochastic) and, per staging buffer, one per
    scan shape and two per admit shape (greedy, stochastic)."""
    lengths = (1, 7, 8, 9, 23, 40, 41, 57)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, 256, size=n, dtype=np.int32)
               for n in lengths]
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving.engine import DecodeEngine, Request
    cfg = configs.get_arch("qwen3-next-gdn").reduced().replace(
        use_pallas_serving=True)
    params = lm.init_lm(0, cfg, device="cuda")
    eng = DecodeEngine(cfg, params, max_slots=2, max_len=64, seed=0,
                       decode_block=4, prefill_chunk=8, device="cuda")
    for _ in range(2):
        for i, (p, n) in enumerate(zip(prompts, (2, 9, 3, 2, 2, 4, 6, 3))):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=n,
                               temperature=0.8 if i % 3 == 1 else 0.0))
        eng.run_until_done()
    progs = eng.executor.compiled_programs()
    assert progs["decode"] <= 3 and progs["prefill"] <= 5
    bound = (2 * progs["decode"] + eng.staging_depth
             * (progs["prefill_scan"] + 2 * progs["prefill_admit"]))
    assert 0 < progs["cuda_graphs"] <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_graphs_streams_bitwise_equal_eager_new_archs(cuda, arch):
    """Reduced mamba2 (through the GDN kernels) and recurrentgemma (RG-LRU
    and a wrapped 32-slot swa window) served twice by a graph engine and
    an eager one: the same streams, greedy and stochastic."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving.engine import DecodeEngine, Request
    cfg = configs.get_arch(arch).reduced().replace(use_pallas_serving=True)
    params = lm.init_lm(0, cfg, device="cuda")
    rng = np.random.default_rng(24)
    prompts = [rng.integers(1, 256, size=n, dtype=np.int32)
               for n in (4, 57, 23, 40)]
    out = {}
    for graphs in (True, False):
        eng = DecodeEngine(cfg, params, max_slots=2, max_len=96, seed=0,
                           decode_block=4, prefill_chunk=16, device="cuda",
                           cuda_graphs=graphs)
        runs = []
        for _ in range(2):
            reqs = [Request(rid=i, prompt=p, max_new_tokens=9,
                            temperature=0.8 if i % 2 else 0.0,
                            top_k=20 if i % 2 else 0)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_done()
            runs.append([list(r.output) for r in reqs])
        out[graphs] = (eng.executor.compiled_programs(), runs)
    assert out[True][1] == out[False][1]
    assert out[True][1][0] == out[True][1][1]
    assert out[True][0]["cuda_graphs"] > 0 == out[False][0]["cuda_graphs"]


UNSAFE = r"""
import json, sys, torch
sys.path.insert(0, "src")
from repro_torch.runtime import graphs
x = torch.zeros((), device="cuda")
ran = []

def unsafe():
    ran.append(1)
    x.add_(1.0)
    return x + torch.tensor(1.0, device="cuda")   # a pageable copy

prog = graphs.Program(unsafe, torch.cuda.graph_pool_handle())
first = float(prog())
try:
    prog()
    err = None
except Exception as e:
    err = type(e).__name__
print(json.dumps({"first": first, "error": err, "ran": len(ran),
                  "graph": prog.graph is not None}))
"""


DEAD_ENGINE = r"""
import gc, json, sys
import numpy as np, torch
sys.path.insert(0, "src")
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.runtime import graphs
from repro_torch.serving.engine import DecodeEngine, Request
if sys.argv[1:] == ["unguarded"]:        # the capture without its guard
    class _Gc:
        collect = staticmethod(lambda *a: 0)
        isenabled = staticmethod(lambda: False)
        disable = enable = staticmethod(lambda: None)
    graphs.gc = _Gc
collect = gc.collect
gc.disable()
x = torch.zeros(1024, device="cuda")


def fn():
    y = x + 1.0
    collect()        # the collector may run at any allocation
    return y * 2.0


prog = graphs.Program(fn, torch.cuda.graph_pool_handle())
first = prog()                           # eager
cfg = configs.get_arch("qwen3-next-gdn").reduced().replace(
    use_pallas_serving=True)
eng = DecodeEngine(cfg, lm.init_lm(0, cfg, device="cuda"), max_slots=2,
                   max_len=64, seed=0, decode_block=4, prefill_chunk=16,
                   device="cuda")
eng.submit(Request(rid=0, prompt=np.arange(1, 40, dtype=np.int32),
                   max_new_tokens=12))
eng.run_until_done()
dead = eng.executor.compiled_programs()["cuda_graphs"]
del eng                                  # garbage in reference cycles
try:
    again = prog()                       # captured, then replayed
    err, same = None, bool(torch.equal(first, again))
except Exception as e:
    err, same = type(e).__name__ + ": " + str(e)[:160], False
print(json.dumps({"dead_graphs": dead, "error": err, "same": same}))
"""


@pytest.mark.cuda
def test_graphs_capture_survives_a_dropped_engine(cuda):
    """A dropped engine's executor and programs form reference cycles, so
    the collector frees its graphs when it runs, which may be in the
    middle of another program's capture; freed there they invalidate it.
    The capture collects first and holds the collector off (here the
    captured function runs the collector itself, where an allocation could
    have).  In a subprocess: a failed capture can leave the context
    unusable."""
    import json
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", DEAD_ENGINE], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["dead_graphs"] > 0
    assert (res["error"], res["same"]) == (None, True)


@pytest.mark.cuda
def test_graphs_capture_unsafe_program_raises(cuda):
    """A program that copies host data raises at its capture and is not
    run eagerly instead (a subprocess: a failed capture can leave the CUDA
    context unusable)."""
    import json
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", UNSAFE], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["first"] == 2.0 and res["error"] is not None
    # the eager first call and the failed capture: no third, eager run
    assert res["ran"] == 2 and res["graph"] is False


# ------------------------------------------------------------ training graphs

def _train_cfg():
    """Reduced qwen3-next-gdn in bf16 through the flash kernels (head dim
    64, which they take), remat on: every part of the full-width step."""
    from repro_torch import configs
    return configs.get_arch("qwen3-next-gdn").reduced().replace(
        head_dim=64, act_dtype="bfloat16", use_flash_kernel=True, remat=True)


def _train(cuda_graphs, fail_at=None, ckpt_dir=None, **kw):
    """A trainer over 4 steps of 2 x 2048 tokens (two cross-entropy chunks,
    each recomputed), warmup 2, run to its end."""
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    tc = TrainerConfig(steps=4, seq_len=2048, global_batch=2,
                       warmup_steps=2, log_every=1, ckpt_dir=ckpt_dir,
                       ckpt_every=2, ckpt_async=False, **kw)
    t = Trainer(_train_cfg(), tc, device="cuda", cuda_graphs=cuda_graphs)
    t.run(fail_at=fail_at)
    return t


def _words(t):
    """A tensor's bits as integers, on the host."""
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.detach().contiguous().view(bits[t.element_size()]).cpu()


def _assert_same_bits(a, b):
    from repro_torch.tree import leaves
    la, lb = leaves(a.state), leaves(b.state)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(_words(x), _words(y))


@pytest.mark.cuda
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_graphs_bitwise_equal_eager(cuda, microbatches):
    """The step replayed from its CUDA graph gives the eager step's losses,
    gradient norms, parameters, moments and counts bit for bit over 4
    steps (step 1 eager, step 2 captured, then replayed); the flash
    launches counted under replay equal the eager run's."""
    from repro_torch.kernels import flash_attn as kflash
    runs = {}
    for graphs in (False, True):
        before = dict(kflash.launches)
        t = _train(graphs, microbatches=microbatches)
        runs[graphs] = (t, {k: n - before[k]
                            for k, n in kflash.launches.items()})
    (e, e_launch), (g, g_launch) = runs[False], runs[True]
    assert g.program.graph is not None and e.program.graph is None
    assert g.program.calls == e.program.calls == 4
    assert [r["loss"] for r in g.logged] == [r["loss"] for r in e.logged]
    assert [r["grad_norm"] for r in g.logged] == \
        [r["grad_norm"] for r in e.logged]
    _assert_same_bits(g, e)
    n_attn = sum(k == "attn" for k in g.cfg.layer_kinds)
    assert g_launch == e_launch == {
        "flash_fwd": 2 * n_attn * 4 * microbatches,
        "flash_bwd_dq": n_attn * 4 * microbatches,
        "flash_bwd_dkv": n_attn * 4 * microbatches}


@pytest.mark.cuda
def test_train_graphs_restore_and_continue(cuda, tmp_path):
    """A fault at step 3 restores the step-2 checkpoint in place and goes
    on replaying the same graph: the run ends bit for bit where an
    unbroken graph run ends."""
    t = _train(True, fail_at=3, ckpt_dir=str(tmp_path / "fault"))
    ref = _train(True, ckpt_dir=str(tmp_path / "ref"))
    assert t.restarts == 1 and t.program.graph is not None
    assert t.program.calls == 5 and len(t.step_times) == 5
    _assert_same_bits(t, ref)


@pytest.mark.cuda
def test_train_graph_replay_runs_the_counted_flash_kernels(cuda):
    """The flash launches a replay adds to the counters are what a replayed
    step runs on the card (the profiler's count); a graph kept with
    ``keep_graph=True`` holds at least that many kernel nodes, and its
    capture and instantiation are timed apart."""
    from repro_torch.launch.profile_decode import kernel_counts
    from repro_torch.runtime.graphs import graph_nodes
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    tc = TrainerConfig(steps=4, seq_len=512, global_batch=2, warmup_steps=2)
    t = Trainer(_train_cfg(), tc, device="cuda").compile(keep_graph=True)
    t.batch(0)
    for _ in range(3):
        t.step()
    prog = t.program
    assert prog.capture_s > 0 and prog.instantiate_s > 0
    counts = kernel_counts(t.step, calls=2)
    prefixes = {"flash_fwd": "flash_fwd_", "flash_bwd_dq": "flash_dq_",
                "flash_bwd_dkv": "flash_dkv_"}
    got = {n: sum(c for key, c in counts.items() if p in key)
           for n, p in prefixes.items()}
    want = {name: n for (mod, name), n in prog.launches.items()
            if mod.endswith("flash_attn")}
    assert got == want and min(want.values()) > 0
    kernels, nodes = graph_nodes(prog.graph)
    assert sum(want.values()) <= kernels <= nodes


TRAIN_UNSAFE = r"""
import json, sys, torch
sys.path.insert(0, "src")
from repro_torch import configs
from repro_torch.runtime.trainer import GraphStepError, Trainer, TrainerConfig
cfg = configs.get_arch("qwen3-next-gdn").reduced().replace(
    head_dim=64, act_dtype="bfloat16", use_flash_kernel=True, remat=True)
tc = TrainerConfig(steps=4, seq_len=256, global_batch=2, warmup_steps=2)
tr = Trainer(cfg, tc, device="cuda").compile()
real, ran = tr.program.fn, []


def step():
    ran.append(1)
    out = real()
    float(out["loss"])            # a host read inside the step
    return out


tr.program.fn = step
try:
    tr.run()
    err = None
except GraphStepError as e:
    err = type(e.__cause__).__name__
print(json.dumps({"error": err, "ran": len(ran), "restarts": tr.restarts,
                  "graph": tr.program.graph is not None,
                  "steps": len(tr.step_times)}))
"""


@pytest.mark.cuda
def test_train_graph_capture_failure_raises(cuda):
    """A step that reads a tensor on the host fails its capture; ``run``
    raises ``GraphStepError`` with no restart and no eager step in its
    place (a subprocess: a failed capture can leave the CUDA context
    unusable)."""
    import json
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", TRAIN_UNSAFE], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["error"] is not None
    # the eager first step and the failed capture: no third, eager run
    assert (res["ran"], res["restarts"], res["graph"], res["steps"]) == \
        (2, 0, False, 1)


# ------------------------------------- batched staging, speculative decode

def _reduced_gdn(seed=0):
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.get_arch("qwen3-next-gdn").reduced().replace(
        use_pallas_serving=True)
    return cfg, lm.init_lm(seed, cfg, device="cuda")


def _slot_state(eng):
    from repro_torch.tree import leaves
    ex = eng.executor
    return ([t.clone() for t in leaves(ex.caches)]
            + [v.clone() for _, v in sorted(ex.sampler.items())]
            + [ex.tokens.clone()])


@pytest.mark.cuda
def test_batched_graphs_bitwise_equal_eager(cuda):
    """The batched scan and admit (three staging rows, prompts of 1 to 57
    tokens: placeholder rows and chunks, greedy and stochastic admits)
    replayed from graphs give the eager engine's streams and leave the
    slot buffers bitwise equal; the prefill programs are the batched
    ones."""
    from repro_torch.serving.engine import DecodeEngine, Request
    cfg, params = _reduced_gdn()
    rng = np.random.default_rng(31)
    prompts = [rng.integers(1, 256, size=n, dtype=np.int32)
               for n in (1, 57, 23, 40, 16, 9)]
    out = {}
    for graphs in (True, False):
        eng = DecodeEngine(cfg, params, max_slots=2, max_len=64, seed=0,
                           decode_block=4, prefill_chunk=8, staging_depth=3,
                           device="cuda", cuda_graphs=graphs)
        assert eng.prefill_batching
        runs = []
        for _ in range(2):
            reqs = [Request(rid=i, prompt=p, max_new_tokens=3 + i,
                            temperature=0.8 if i % 2 else 0.0)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_done()
            runs.append([list(r.output) for r in reqs])
        out[graphs] = (runs, _slot_state(eng),
                       eng.executor.compiled_programs())
    assert out[True][0] == out[False][0]
    assert out[True][0][0] == out[True][0][1]
    assert all(torch.equal(a, b) for a, b in zip(out[True][1],
                                                 out[False][1]))
    progs = out[True][2]
    assert progs["cuda_graphs"] > 0
    assert progs["prefill_scan"] == progs["prefill_admit"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 4, 8, 16, 32])
def test_prefill_kernel_pow2_tails_vs_plain(cuda, T):
    """The pow2 plans' unmasked tail chunks, T = C < 64, at the served head
    dim (bf16, d_k 128: the tensor-core kernel, which pads its 64-token
    tile) against the plain scan."""
    rng = np.random.default_rng(40 + T)
    B, Hk, Hv, d = 1, 2, 4, 128
    q = _normal(rng, B, T, Hk, d).to(cuda, torch.bfloat16)
    k = torch.nn.functional.normalize(_normal(rng, B, T, Hk, d),
                                      dim=-1).to(cuda, torch.bfloat16)
    v = _normal(rng, B, T, Hv, d).to(cuda, torch.bfloat16)
    lg = -torch.nn.functional.softplus(_normal(rng, B, T, Hv)).to(cuda)
    beta = torch.sigmoid(_normal(rng, B, T, Hv)).to(cuda)
    S0 = _normal(rng, B, Hv, d, d, scale=0.1).to(cuda)
    S_k = S0.clone()
    n = tprefill.launches
    O_k, _ = ops.gdn_prefill(q, k, v, lg, beta, S_k, chunk=64)
    rows = [x.transpose(1, 2).reshape(B * x.shape[2], T, *x.shape[3:])
            .contiguous() for x in (q, k, v, lg, beta)]
    O_p, S_p = ref.gdn_prefill_ref(*rows, S0.reshape(B * Hv, d, d), None,
                                   n_rep=Hv // Hk)
    torch.cuda.synchronize()
    assert tprefill.launches == n + 1
    _close(S_k.reshape(B * Hv, d, d), S_p, CHUNKWISE)
    _close(O_k.transpose(1, 2).reshape(B * Hv, T, d), O_p, BF16)


@pytest.mark.cuda
def test_spec_verify_graphs_bitwise_equal_eager(cuda):
    """Speculative decode with a draft of other weights (most drafts
    rejected: the rollback runs every tick), replayed from graphs, gives
    the eager engine's streams and slot state, and the plain engine's
    streams; the decode kernel ran on the checkpoint buffers."""
    from repro_torch.models import lm
    from repro_torch.serving.engine import DecodeEngine, Request
    cfg, params = _reduced_gdn()
    dparams = lm.init_lm(99, cfg, device="cuda")
    rng = np.random.default_rng(32)
    prompts = [rng.integers(1, 256, size=n, dtype=np.int32)
               for n in (5, 30, 17)]
    kw = dict(max_slots=2, max_len=64, seed=0, decode_block=2,
              prefill_chunk=8, device="cuda")

    def serve(eng):
        runs = []
        for _ in range(2):
            reqs = [Request(rid=i, prompt=p, max_new_tokens=10 + i,
                            temperature=0.8 if i == 1 else 0.0)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_done()
            runs.append([list(r.output) for r in reqs])
        return runs

    plain = serve(DecodeEngine(cfg, params, **kw))
    out = {}
    for graphs in (True, False):
        eng = DecodeEngine(cfg, params, speculative=True, k_draft=4,
                           draft_cfg=cfg, draft_params=dparams,
                           cuda_graphs=graphs, **kw)
        n = tdecode.launches
        runs = serve(eng)
        assert tdecode.launches > n
        out[graphs] = (runs, _slot_state(eng), eng.metrics())
    assert out[True][0] == out[False][0] == plain
    assert all(torch.equal(a, b) for a, b in zip(out[True][1],
                                                 out[False][1]))
    assert out[True][2]["acceptance_rate"] < 0.5


@pytest.mark.cuda
def test_bscatter_leaves_unassigned_slots_unchanged(cuda):
    """The multi-row scatter writes only its assigned slots: every other
    slot's caches, sampler row and token stay bitwise as they were, and
    the released rows are zero."""
    from repro_torch.serving.engine import DecodeEngine, Request
    from repro_torch.tree import leaves
    cfg, params = _reduced_gdn()
    eng = DecodeEngine(cfg, params, max_slots=3, max_len=64, seed=0,
                       decode_block=2, prefill_chunk=8, device="cuda")
    rng = np.random.default_rng(33)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=rng.integers(1, 256, size=20,
                                                      dtype=np.int32),
                           max_new_tokens=30))
    for _ in range(3):
        eng.step()
    ex = eng.executor
    assert len(eng.active) == 3
    before = _slot_state(eng)
    ex.bstage_begin(1, seed=0, rid=7, temperature=0.0, top_k=0, top_p=1.0,
                    eos_id=None, budget=5)
    ex.bstage_admit([(1, rng.integers(1, 256, size=6, dtype=np.int32), 6)])
    ex.bscatter([(2, 1)])
    after = _slot_state(eng)
    for a, b in zip(before, after):
        if a.ndim >= 2 and a.shape[1] == 3:         # stacked cache leaves
            assert torch.equal(a[:, :2], b[:, :2])
        else:                                       # sampler, tokens
            assert torch.equal(a[:2], b[:2])
    assert all(not t[:, 1].any() for t in leaves(ex.bstaging))


# ---------------------------------------------------------- state paging

def _paging_engine(**kw):
    from repro_torch.serving.engine import DecodeEngine, Request
    cfg, params = _reduced_gdn()
    rng = np.random.default_rng(41)
    prompts = [rng.integers(1, 256, size=n, dtype=np.int32)
               for n in (20, 33, 9)]

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=16,
                        temperature=0.8 if i == 0 else 0.0,
                        top_k=10 if i == 0 else 0)
                for i, p in enumerate(prompts)]
    return DecodeEngine(cfg, params, max_slots=2, max_len=64, seed=0,
                        decode_block=2, prefill_chunk=8, device="cuda",
                        **kw), reqs


@pytest.mark.cuda
def test_paging_pinned_round_trip(cuda):
    """A gathered image drains into pinned host buffers, equals the
    slot's bits, and restored into another slot reproduces them."""
    from repro_torch.tree import leaves
    eng, reqs = _paging_engine()
    for r in reqs()[:2]:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    ex = eng.executor
    slot = next(iter(eng.active))
    want = [t[:, slot].cpu() for t in leaves(ex.caches)]
    row = {k: v[slot].cpu() for k, v in ex.sampler.items()}
    pend = ex.gather_slot_async(slot)
    assert all(t.is_pinned() for t in leaves(ex._gather_bufs[pend.buf][1]))
    sw = ex.harvest(pend)
    assert sw.nbytes == ex.swap_bytes_per_slot
    assert bool(ex.sampler["done"][slot])           # the slot is frozen
    other = 1 - slot
    ex.restore_slot(other, sw)
    for t, w in zip(leaves(ex.caches), want):
        assert torch.equal(t[:, other].cpu(), w)
    for k, v in row.items():
        assert torch.equal(ex.sampler[k][other].cpu(), v), k


@pytest.mark.cuda
def test_paging_ready_turns_true_and_the_ring_holds(cuda):
    """``ready()`` turns True once the side stream's drain lands; with one
    gather buffer, a second gather before the harvest is refused, and the
    harvest hands the ticket back."""
    eng, reqs = _paging_engine(async_paging=True, gather_ring=1)
    for r in reqs()[:2]:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    ex = eng.executor
    a, b = sorted(eng.active)
    pend = ex.gather_slot_async(a)
    assert list(ex._gather_free) == [] and ex._gather_pending == {0: pend}
    with pytest.raises(RuntimeError, match="gather ring exhausted"):
        ex.gather_slot_async(b)
    for _ in range(10000):
        if pend.ready():
            break
    torch.cuda.synchronize()
    assert pend.ready()
    ex.harvest(pend)
    assert list(ex._gather_free) == [0] and not ex._gather_pending
    with pytest.raises(RuntimeError, match="not draining"):
        ex.harvest(pend)


@pytest.mark.cuda
@pytest.mark.parametrize("async_paging", [False, True],
                         ids=["sync", "async"])
def test_paging_restore_keeps_every_address(cuda, async_paging):
    """Pause, preempt and resume under replayed graphs: every slot buffer
    keeps its address, no paging call adds a program or a capture (each
    is watched), and the streams are the uninterrupted engine's."""
    from repro_torch.tree import leaves
    eng, reqs = _paging_engine(async_paging=async_paging)
    ex = eng.executor
    watched = []

    def watch(name):
        fn = getattr(ex, name)

        def call(*args, **kw):
            before = ex.compiled_programs()
            out = fn(*args, **kw)
            assert ex.compiled_programs() == before, name
            watched.append(name)
            return out
        setattr(ex, name, call)

    for name in ("gather_slot_async", "bgather_row_async", "harvest",
                 "prestage_restore", "restore_slot"):
        watch(name)
    want = reqs()                   # served once whole: every program made
    for r in want:
        eng.submit(r)
    eng.run_until_done()
    got = reqs()
    for r in got:
        eng.submit(r)
    while not (got[0].state == "active" and len(got[0].output) >= 6):
        eng.step()
    ptrs = [t.data_ptr() for t in leaves(ex.caches)] + \
        [v.data_ptr() for v in ex.sampler.values()] + [ex.tokens.data_ptr()]
    progs = ex.compiled_programs()
    assert progs["cuda_graphs"] > 0
    eng.pause(0)
    eng.step()
    eng.preempt()
    eng.step()
    eng.resume(0)
    eng.run_until_done()
    assert [list(r.output) for r in got] == [list(r.output) for r in want]
    assert ptrs == [t.data_ptr() for t in leaves(ex.caches)] + \
        [v.data_ptr() for v in ex.sampler.values()] + [ex.tokens.data_ptr()]
    assert {k: v for k, v in ex.compiled_programs().items()
            if k != "cuda_graphs"} == {k: v for k, v in progs.items()
                                       if k != "cuda_graphs"}
    assert {"gather_slot_async", "harvest", "restore_slot"} <= set(watched)
    m = eng.metrics()
    assert m["swap_outs"] == m["swap_ins"] >= 2
    assert m["swap_bytes"] == 2 * m["swap_outs"] * ex.swap_bytes_per_slot


# ------------------------------------------------ router, roles, workers

@pytest.mark.cuda
def test_router_disagg_through_graphs(cuda):
    """A prefill engine handing every request to a decode engine, both
    replaying CUDA graphs: the streams are one engine's, the decode
    engine makes no stage dispatch and the prefill engine no decode
    step."""
    from repro_torch.serving.engine import Router
    eng, reqs = _paging_engine()
    want = reqs()
    for r in want:
        eng.submit(r)
    eng.run_until_done()
    pre, _ = _paging_engine(role="prefill")
    dec, _ = _paging_engine(role="decode")
    router = Router([pre, dec])
    for run in range(2):                # cold (captures), then replayed
        got = reqs()
        for r in got:
            router.submit(r)
        router.run_until_done()
        assert [list(r.output) for r in got] == \
            [list(r.output) for r in want], run
    assert router.handoffs == 2 * len(want)
    assert dec.stage_dispatches == 0 and pre.decode_steps == 0
    assert dec.executor.compiled_programs()["cuda_graphs"] > 0


@pytest.mark.cuda
def test_rpc_workers_on_the_card(cuda):
    """A prefill and a decode worker process on the card, each drawing the
    weights from seed 0 and loading the built kernels: the streams are
    those of an in-process engine on the same seed, and both workers
    exit 0."""
    from repro_torch.serving.engine import EngineProxy, Router
    eng, reqs = _paging_engine()
    want = reqs()
    for r in want:
        eng.submit(r)
    eng.run_until_done()
    cfg = eng.cfg
    kw = dict(max_slots=2, max_len=64, seed=0, decode_block=2,
              prefill_chunk=8, device="cuda")
    workers = [EngineProxy(cfg, params_seed=0, role=role, **kw)
               for role in ("prefill", "decode")]
    try:
        assert all(w.device.startswith("cuda") for w in workers)
        router = Router(workers)
        got = reqs()
        for r in got:
            router.submit(r)
        router.run_until_done()
        assert [list(r.output) for r in got] == \
            [list(r.output) for r in want]
        assert router.metrics()["handoffs"] == len(want)
    finally:
        for w in workers:
            w.shutdown()
    assert [w.proc.returncode for w in workers] == [0, 0]


# ------------------------------------------------------------ MoE

def _reduced_mixtral(**kw):
    """Reduced mixtral-8x7b in bf16 (swa + MoE: the expert products
    through the fp32-output batched product)."""
    from repro_torch import configs
    return configs.get_arch("mixtral-8x7b").reduced().replace(
        act_dtype="bfloat16", **kw)


@pytest.mark.cuda
def test_bmm_f32_vs_fp32_operands(cuda):
    """The bf16 batched product with an fp32 result (the MoE experts')
    against the same product of the same values as fp32 operands: they
    differ in summation order only.  An expanded input (the decode's one
    row set for every expert) takes the same path.  Both gradients from
    the cotangent rounded to bf16 once (bf16 products, fp32
    accumulation): within 2% of the fp32 gradient's RMS.  The LM head
    (``logits_matmul``, E = 1, a transposed weight as a tied head
    passes it) takes the same product and the same rule."""
    from repro_torch.models import layers
    rng = np.random.default_rng(31)
    x = _normal(rng, 8, 96, 256).to(cuda, torch.bfloat16)
    w = _normal(rng, 8, 256, 192, scale=0.1).to(cuda, torch.bfloat16)
    y = layers.bmm_f32(x, w)
    assert y.dtype == torch.float32
    want = torch.bmm(x.float(), w.float())
    _close(y, want, dict(rtol=1e-5, atol=1e-4))
    xt = x[0, :4]
    _close(layers.bmm_f32(xt.expand(8, 4, 256), w),
           torch.bmm(xt.float().expand(8, 4, 256), w.float()),
           dict(rtol=1e-5, atol=1e-4))
    g = _normal(rng, 8, 96, 192).to(cuda)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    layers.bmm_f32(xr, wr).backward(g)
    assert xr.grad.dtype == wr.grad.dtype == torch.bfloat16
    xf, wf = x.float().requires_grad_(True), w.float().requires_grad_(True)
    torch.bmm(xf, wf).backward(g)
    # the cotangent's rounding (2^-9 relative per term) summed over 96 or
    # 192 terms of random sign, and the gradient's own: the error scales
    # with the gradient's RMS, not with each element (a sum near 0 keeps
    # the error of its terms)
    for got, want in ((wr.grad, wf.grad), (xr.grad, xf.grad)):
        rms = float(want.pow(2).mean().sqrt())
        _close(got, want, dict(rtol=2e-2, atol=2e-2 * rms))
    h = _normal(rng, 2, 48, 256).to(cuda, torch.bfloat16)
    table = _normal(rng, 320, 256, scale=0.1).to(cuda, torch.bfloat16)
    hr, tr = h.clone().requires_grad_(True), table.clone().requires_grad_(True)
    y = layers.logits_matmul(hr, tr.t())
    assert y.dtype == torch.float32 and y.shape == (2, 48, 320)
    hf, tf = h.float().requires_grad_(True), table.float().requires_grad_(True)
    want = torch.matmul(hf, tf.t())
    _close(y.detach(), want.detach(), dict(rtol=1e-5, atol=1e-4))
    g = _normal(rng, 2, 48, 320).to(cuda)
    y.backward(g)
    want.backward(g)
    assert hr.grad.dtype == tr.grad.dtype == torch.bfloat16
    for got, want in ((tr.grad, tf.grad), (hr.grad, hf.grad)):
        rms = float(want.pow(2).mean().sqrt())
        _close(got, want, dict(rtol=2e-2, atol=2e-2 * rms))


@pytest.mark.cuda
def test_bmm_f32_input_gradient_rounds_once(cuda):
    """The input's gradient through ``bmm_f32`` over a long sum (an LM
    head's vocabulary, minicpm-2b's 122,753) is its fp32 sum rounded to
    bf16 once, with torch's bf16 reductions of split partial sums allowed
    (the default): every element within one bf16 ulp of the fp64 product
    of the bf16-rounded cotangent."""
    from repro_torch.models import layers
    rng = np.random.default_rng(32)
    V = 122753
    h = _normal(rng, 1, 64, 256).to(cuda, torch.bfloat16)
    w = _normal(rng, 1, 256, V, scale=0.05).to(cuda, torch.bfloat16)
    g = _normal(rng, 1, 64, V).to(cuda)
    hr = h.clone().requires_grad_(True)
    matmul = torch.backends.cuda.matmul
    allowed = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = True
    try:
        layers.bmm_f32(hr, w).backward(g)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = allowed
    want = torch.bmm(g.to(torch.bfloat16).double(),
                     w.double().transpose(1, 2))
    ulp = torch.exp2(torch.floor(torch.log2(
        torch.clamp(want.abs(), min=1e-30))) - 7)
    assert hr.grad.dtype == torch.bfloat16
    assert bool(((hr.grad.double() - want).abs() <= ulp).all())


@pytest.mark.cuda
def test_moe_graphs_streams_bitwise_equal_eager(cuda):
    """Reduced bf16 mixtral served twice by a CUDA-graph engine and an
    eager one, greedy and stochastic: the same streams (the MoE
    dispatch, the dense decode and the sort-based top-k capture and
    replay), per-prompt staging on both."""
    from repro_torch.models import lm
    from repro_torch.serving.engine import DecodeEngine, Request
    cfg = _reduced_mixtral()
    params = lm.init_lm(0, cfg, device="cuda")
    rng = np.random.default_rng(25)
    prompts = [rng.integers(1, 256, size=n, dtype=np.int32)
               for n in (4, 57, 23, 40)]
    out = {}
    for graphs in (True, False):
        eng = DecodeEngine(cfg, params, max_slots=2, max_len=96, seed=0,
                           decode_block=4, prefill_chunk=16, device="cuda",
                           cuda_graphs=graphs)
        assert not eng.prefill_batching
        runs = []
        for _ in range(2):
            reqs = [Request(rid=i, prompt=p, max_new_tokens=9,
                            temperature=0.8 if i % 2 else 0.0,
                            top_k=20 if i % 2 else 0)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_done()
            runs.append([list(r.output) for r in reqs])
        out[graphs] = (eng.executor.compiled_programs(), runs)
    assert out[True][1] == out[False][1]
    assert out[True][1][0] == out[True][1][1]
    assert out[True][0]["cuda_graphs"] > 0 == out[False][0]["cuda_graphs"]


@pytest.mark.cuda
def test_moe_train_graphs_bitwise_equal_eager(cuda):
    """Reduced bf16 mixtral (head dim 64, which the flash kernels take;
    remat on) trained 3 steps of 2 x 512 tokens eagerly and through the
    step's CUDA graph: losses, aux losses, gradient norms, parameters,
    moments and counts bit for bit, the flash launches equal."""
    from repro_torch.kernels import flash_attn as kflash
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = _reduced_mixtral(head_dim=64, use_flash_kernel=True, remat=True)
    runs = {}
    for graphs in (False, True):
        before = dict(kflash.launches)
        tc = TrainerConfig(steps=3, seq_len=512, global_batch=2,
                           warmup_steps=1, log_every=1)
        t = Trainer(cfg, tc, device="cuda", cuda_graphs=graphs)
        t.run()
        runs[graphs] = (t, {k: n - before[k]
                            for k, n in kflash.launches.items()})
    (e, e_launch), (g, g_launch) = runs[False], runs[True]
    assert g.program.graph is not None and e.program.graph is None
    for key in ("loss", "aux", "grad_norm"):
        assert [r[key] for r in g.logged] == [r[key] for r in e.logged]
    assert all(r["aux"] > 0 for r in e.logged)
    _assert_same_bits(g, e)
    n_swa = sum(k == "swa" for k in cfg.layer_kinds)
    assert g_launch == e_launch == {"flash_fwd": 2 * n_swa * 3,
                                    "flash_bwd_dq": n_swa * 3,
                                    "flash_bwd_dkv": n_swa * 3}


# ----------------------------------------------------- mesh (PR 24 slice)

# the GDN kernels at the local shapes of full-width qwen3-next-gdn's
# serving mesh: (1,2) halves the heads, (2,1) the slots
MESH_SHAPES = {"model2": (4, 8, 16, 128), "data2": (2, 16, 32, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(MESH_SHAPES))
def test_gdn_kernels_at_mesh_local_shapes_vs_plain(cuda, shape):
    B, Hk, Hv, d = MESH_SHAPES[shape]
    rng = np.random.default_rng(24)
    bf = torch.bfloat16
    q = _normal(rng, B, Hk, d).to(cuda, bf)
    k = torch.nn.functional.normalize(_normal(rng, B, Hk, d),
                                      dim=-1).to(cuda, bf)
    v = _normal(rng, B, Hv, d).to(cuda, bf)
    S = _normal(rng, B, Hv, d, d, scale=0.2).to(cuda)
    g, beta = (torch.sigmoid(_normal(rng, B, Hv)).to(cuda) for _ in range(2))
    S_k = S.clone()
    o_k, _ = ops.gdn_decode(q, k, v, S_k, g, beta)
    o_p, S_p = ref.gdn_decode_ref(q, k, v, S, g, beta)
    torch.cuda.synchronize()
    _close(o_k, o_p, BF16)
    _close(S_k, S_p, F32)
    T, chunk = 128, 64
    valid = torch.tensor((128, 70, 0, 5)[:B], dtype=torch.int32, device=cuda)
    q = _normal(rng, B, T, Hk, d).to(cuda, bf)
    k = torch.nn.functional.normalize(_normal(rng, B, T, Hk, d),
                                      dim=-1).to(cuda, bf)
    v = _normal(rng, B, T, Hv, d).to(cuda, bf)
    lg = -torch.nn.functional.softplus(_normal(rng, B, T, Hv)).to(cuda)
    beta = torch.sigmoid(_normal(rng, B, T, Hv)).to(cuda)
    S0 = _normal(rng, B, Hv, d, d, scale=0.1).to(cuda)
    S_k = S0.clone()
    O_k, _ = ops.gdn_prefill(q, k, v, lg, beta, S_k, chunk=chunk,
                             valid_len=valid)
    rows = [x.transpose(1, 2).reshape(B * x.shape[2], T, *x.shape[3:])
            .contiguous() for x in (q, k, v, lg, beta)]
    vl = torch.repeat_interleave(valid, Hv)
    O_p, S_p = ref.gdn_prefill_ref(*rows, S0.reshape(B * Hv, d, d), vl,
                                   n_rep=Hv // Hk)
    torch.cuda.synchronize()
    _close(S_k.reshape(B * Hv, d, d), S_p, CHUNKWISE)
    O_k = O_k.transpose(1, 2).reshape(B * Hv, T, d)
    for r, n_valid in enumerate(vl.tolist()):
        _close(O_k[r, :n_valid], O_p[r, :n_valid], BF16)


@pytest.mark.cuda
def test_nccl_mesh_streams_equal_the_unsharded_engine(cuda):
    """A (1,1) NCCL mesh in this process (world size 1) on the default
    CUDA-graph engine: reduced qwen3-next-gdn through the GDN kernels,
    cold then warm, streams bitwise the unsharded engine's; the warm run's
    collectives run inside replayed graphs, none from the host unless a
    program takes its first call in it."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import lm
    from repro_torch.parallel import comm
    from repro_torch.serving.engine import DecodeEngine, Request
    cfg = configs.get_arch("qwen3-next-gdn").reduced().replace(
        use_pallas_serving=True)
    params = lm.init_lm(0, cfg, device="cuda")
    rng = np.random.default_rng(25)
    prompts = [rng.integers(1, cfg.vocab, size=n, dtype=np.int32)
               for n in (4, 16, 23, 40, 9)]
    kw = dict(max_slots=4, max_len=64, seed=0, decode_block=4,
              prefill_chunk=16, device="cuda")

    def serve(eng):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=8,
                        temperature=0.8 if i == 1 else 0.0)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        return [list(r.output) for r in reqs]

    base = serve(DecodeEngine(cfg, params, **kw))
    mesh_mod.init_ranks(0, 1, mesh_mod.free_port(), "nccl")
    try:
        eng = DecodeEngine(cfg, params, mesh=mesh_mod.make_serving_mesh(),
                           **kw)
        assert eng.executor.cuda_graphs
        assert serve(eng) == base
        shapes = eng.executor.compiled_programs()["total"]
        comm.reset_stats()
        assert serve(eng) == base
        assert comm.stats["replayed"] > 0
        if eng.executor.compiled_programs()["total"] == shapes:
            assert comm.stats["calls"] == 0
        assert eng.executor.compiled_programs()["cuda_graphs"] > 0
        assert eng.metrics()["mesh_model"] == 1
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_serve_cli_mesh_gloo_ranks_share_the_card(cuda, capfd):
    """``--mesh 1,2 --gloo`` starts two ranks on the card (eager, gloo
    staging each collective through host memory) and prints the streams
    of the unsharded engine on the same weights, greedy; without
    ``--gloo`` the mesh needs two cards for NCCL and raises naming the
    flag when fewer are visible."""
    import re
    from repro_torch.launch import serve
    argv = ["--arch", "qwen3-next-gdn", "--requests", "4", "--max-new", "6",
            "--slots", "4", "--max-len", "64", "--kernels",
            "--no-cuda-graphs"]
    serve.main(argv)
    plain = capfd.readouterr().out
    serve.main(argv + ["--mesh", "1,2", "--gloo"])
    mesh = capfd.readouterr().out
    assert "mesh: data=1 x model=2, 2 gloo ranks on cuda" in mesh

    def streams(text):
        return re.findall(r"req (\d+): .* toks: (\[.*\])", text)
    assert len(streams(plain)) == 4 and streams(mesh) == streams(plain)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="--gloo"):
            serve.main(argv + ["--mesh", "1,2"])


# ------------------------------- the mesh's model axis for the other kinds

@pytest.mark.cuda
def test_gdn_kernels_at_mamba2_model2_shape_vs_plain(cuda):
    """Both GDN kernels at full-width mamba2-1.3b's local shape on the
    (1,2) mesh (B 4, Hk 1, Hv 32, d_k 128, d_v 64, bf16, no delta rule)
    against their plain versions."""
    B, Hk, Hv, dk, dv = 4, 1, 32, 128, 64
    rng = np.random.default_rng(25)
    bf = torch.bfloat16
    q = _normal(rng, B, Hk, dk).to(cuda, bf)
    k = _normal(rng, B, Hk, dk).to(cuda, bf)
    v = _normal(rng, B, Hv, dv).to(cuda, bf)
    S = _normal(rng, B, Hv, dk, dv, scale=0.2).to(cuda)
    g = torch.sigmoid(_normal(rng, B, Hv)).to(cuda)
    ones = torch.ones_like(g)
    S_k = S.clone()
    o_k, _ = ops.gdn_decode(q, k, v, S_k, g, ones, delta_rule=False)
    o_p, S_p = ref.gdn_decode_ref(q, k, v, S, g, ones, delta_rule=False)
    torch.cuda.synchronize()
    _close(o_k, o_p, BF16)
    _close(S_k, S_p, F32)
    T, chunk = 128, 64
    valid = torch.tensor((128, 70, 0, 5), dtype=torch.int32, device=cuda)
    q = _normal(rng, B, T, Hk, dk).to(cuda, bf)
    k = _normal(rng, B, T, Hk, dk).to(cuda, bf)
    v = _normal(rng, B, T, Hv, dv).to(cuda, bf)
    lg = -torch.nn.functional.softplus(_normal(rng, B, T, Hv)).to(cuda)
    ones = torch.ones_like(lg)
    S0 = _normal(rng, B, Hv, dk, dv, scale=0.1).to(cuda)
    S_k = S0.clone()
    O_k, _ = ops.gdn_prefill(q, k, v, lg, ones, S_k, chunk=chunk,
                             valid_len=valid, delta_rule=False)
    rows = [x.transpose(1, 2).reshape(B * x.shape[2], T, *x.shape[3:])
            .contiguous() for x in (q, k, v, lg, ones)]
    vl = torch.repeat_interleave(valid, Hv)
    O_p, S_p = ref.gdn_prefill_ref(*rows, S0.reshape(B * Hv, dk, dv), vl,
                                   delta_rule=False, n_rep=Hv // Hk)
    torch.cuda.synchronize()
    _close(S_k.reshape(B * Hv, dk, dv), S_p, CHUNKWISE)
    O_k = O_k.transpose(1, 2).reshape(B * Hv, T, dv)
    for r, n_valid in enumerate(vl.tolist()):
        _close(O_k[r, :n_valid], O_p[r, :n_valid], BF16)


@pytest.mark.cuda
def test_arctic_expert_parallel_step_on_the_card(cuda):
    """Full-width arctic-480b cut to 1 layer: two gloo ranks on the card
    each draw half of its 128 experts (``lm.init_lm(..., mesh=)``) and
    take one decode step on the (1,2) mesh from a one-device prefill's
    state, against the one-device bf16 step by ``chip_smoke.py`` phase
    3's rule: no further from the fp32 step (fp32 activations, the bf16
    weights upcast in each product) than twice the one-device step, the
    argmax equal wherever its top-2 gap exceeds its own error."""
    import torch_mesh_ranks as ranks
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    cfg = configs.get_arch("arctic-480b").replace(n_layers=1)
    B, T, max_len = 4, 64, 128
    rng = np.random.default_rng(26)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (B, T))).to(cuda)
    tok = torch.from_numpy(rng.integers(1, cfg.vocab, (B,))).to(cuda)
    params = lm.init_lm(0, cfg, device="cuda")
    got = {}
    for key, c in (("one", cfg), ("truth", cfg.replace(act_dtype="float32"))):
        caches = lm.init_caches(c, B, max_len, device="cuda")
        lm.prefill_chunk(params, c, caches, tokens=toks)
        if key == "one":      # bf16 leaves as fp32 numpy (exact)
            state = tree_map(lambda t: (t.float() if t.is_floating_point()
                                        else t).cpu().numpy(), caches)
        got[key], _ = lm.decode_step(params, c, tok, caches)
        got[key] = got[key].float().cpu()
        del caches
    del params
    torch.cuda.empty_cache()
    group = ranks.start(2, [dict(name="step", kind="step", mesh=(1, 2),
                                 arch=cfg.name, layers=1, device="cuda",
                                 max_len=max_len)],
                        dict(state=(state, tok.cpu().numpy())))
    out = group.results(timeout=900)
    one, truth = got["one"], got["truth"]
    err_one = float((one - truth).abs().max())
    gap = one.topk(2, dim=-1).values
    gap = gap[:, 0] - gap[:, 1]
    for r in range(2):
        assert "error" not in out[r]["step"], out[r]["step"]["error"]
        mesh = torch.from_numpy(out[r]["step"]["logits"])
        assert mesh.shape == one.shape
        assert float((mesh - truth).abs().max()) <= 2 * err_one, r
        same = mesh.argmax(-1) == one.argmax(-1)
        assert bool((same | (gap <= err_one)).all()), r


@pytest.mark.cuda
def test_serve_cli_mesh_mamba2_gloo_ranks_share_the_card(cuda, capfd):
    """``--arch mamba2-1.3b --mesh 1,2 --gloo``: two ranks on the card
    split the SSD heads (the GDN kernels at the local shape, B and C
    gathered) and print the unsharded engine's streams, greedy."""
    import re
    from repro_torch.launch import serve
    argv = ["--arch", "mamba2-1.3b", "--requests", "4", "--max-new", "6",
            "--slots", "4", "--max-len", "64", "--kernels",
            "--no-cuda-graphs"]
    serve.main(argv)
    plain = capfd.readouterr().out
    serve.main(argv + ["--mesh", "1,2", "--gloo"])
    mesh = capfd.readouterr().out
    assert "mesh: data=1 x model=2, 2 gloo ranks on cuda" in mesh

    def streams(text):
        return re.findall(r"req (\d+): .* toks: (\[.*\])", text)
    assert len(streams(plain)) == 4 and streams(mesh) == streams(plain)
