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
# rounding P to bf16 is hardest)
FLASH_CASES = [(2, 128, 4, 4, 64, None, None, 1.0),
               (1, 256, 16, 2, 128, None, None, 1.0),
               (2, 100, 4, 2, 64, None, None, 1.0),
               (1, 192, 4, 2, 128, 40, None, 1.0),
               (3, 128, 4, 2, 64, None, (128, 70, 0), 1.0),
               (1, 2048, 16, 2, 128, None, None, 1.0),
               (2, 300, 8, 2, 128, None, None, 1.0),
               (1, 256, 4, 2, 128, 24, None, 1.0),
               (1, 512, 8, 2, 128, None, None, 2.75)]


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
def test_flash_dq_bitwise_reproducible(cuda):
    """The bf16 dq kernel owns its rows (no atomics): five calls on the
    same inputs give the same bits."""
    from repro_torch.kernels import flash_attn as tflash
    rng = np.random.default_rng(16)
    BH, G, T, hd = 2, 4, 300, 128
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
def test_flash_dkv_bitwise_reproducible(cuda):
    """The bf16 dk/dv kernel sums the G query heads in a fixed order (a
    thread block cluster, no atomics): five calls at the trained shape
    (B=2, T=2048, GQA 16:2) give the same bits, from one launch each."""
    from repro_torch.kernels import flash_attn as tflash
    rng = np.random.default_rng(18)
    BH, G, T, hd = 4, 8, 2048, 128
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
# must come out as zeros)
DKV_GROUP_CASES = [(1, 128, 200, 50, (200, 60)), (4, 64, 256, None, (256, 9)),
                   (7, 128, 200, 70, (131, 64)), (8, 128, 320, 100, (320, 1)),
                   (16, 64, 192, None, (192, 100))]


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
