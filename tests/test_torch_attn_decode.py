"""The port's one-token attention decode against the JAX reference: the
plain version of ``kernels.ops.attn_decode`` (what CPU tensors run) against
the reference's Pallas ``attn_decode_pallas`` in interpret mode, the
port's ``attention.attn_decode_pallas`` against the reference's on bridged
reduced yi-9b and h2o-danube-1.8b layers over rolling caches past their
wrap, and reduced h2o-danube-1.8b served through both engines.  The CUDA
kernel itself is held against the plain version only on the card
(``tests/test_torch_cuda.py``).  Inputs are made with numpy from a seed.

Tolerances: fp32 differs only in summation order (1e-5; 1e-4 for logits
through a whole reduced LM, as ``test_torch_model.py``); bf16 inputs are
the same bf16 values on both sides and the output allows one bf16
rounding step (2e-2).  Greedy token streams must be equal.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                    # noqa: E402
from repro.kernels import ops as jops, ref as jref       # noqa: E402
from repro.models import attention as jattn               # noqa: E402
from repro.models import lm as jlm                        # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest      # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch.bridge import to_torch                   # noqa: E402
from repro_torch.kernels import attn_decode as tkattn     # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
from repro_torch.launch import serve as tserve            # noqa: E402
from repro_torch.models import attention as tattn         # noqa: E402
from repro_torch.models import lm as tlm                  # noqa: E402
from repro_torch.serving.engine import DecodeEngine, Request  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
NEW_ARCHS = ("yi-9b", "h2o-danube-1.8b", "minitron-8b", "minicpm-2b",
             "llava-next-34b", "musicgen-medium")

_j_chunk = jax.jit(jattn.attn_prefill_chunk)
_j_decode_pallas = jax.jit(jattn.attn_decode_pallas)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------- kernel semantics

# (B, Hkv, G, T, d, lengths, window): ragged linear lengths; rolling
# lengths > T (one a multiple of T) at d = 20, the stand-in for d = 80;
# window < T on wrapped caches (the case of test_ragged_prefill.py's
# absolute-position test) with GQA and MHA
CASES = {
    "ragged": (2, 2, 4, 32, 16, (5, 32), None),
    "rolling_d20": (2, 1, 4, 16, 20, (21, 48), None),
    "window_wrapped": (2, 2, 1, 16, 16, (12, 37), 6),
    "window_wrapped_d20": (2, 1, 4, 32, 20, (40, 64), 24),
}


def _decode_inputs(seed, B, Hkv, G, T, d, lengths):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hkv * G, d)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, T, d)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, T, d)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case, dtype):
    B, Hkv, G, T, d, lengths, window = CASES[case]
    q, k, v, length = _decode_inputs(7, B, Hkv, G, T, d, lengths)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jo = jops.attn_decode(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                          jnp.asarray(length), block_t=8, window=window)
    to = tops.attn_decode(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                          torch.from_numpy(length), window=window)
    assert to.dtype == tdt and to.shape == (B, Hkv * G, d)
    np.testing.assert_allclose(_np(to), _np(jo),
                               **(F32 if dtype == "float32" else BF16))


def test_plain_matches_jax_oracle_in_linear_phase():
    """Where ``length <= T`` the window rule on absolute positions equals
    the reference oracle's rule on slot indices (``ref.py:65-68``)."""
    q, k, v, length = _decode_inputs(8, 3, 2, 4, 16, 16, (1, 9, 16))
    for window in (None, 4):
        jo = jref.attn_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(length),
                                  window=window)
        to = tref.attn_decode_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v),
                                  torch.from_numpy(length), window=window)
        np.testing.assert_allclose(_np(to), _np(jo), **F32)


def test_visible_slots_of_a_wrapped_cache():
    """length 12 on 8 slots, window 4: slots 0-3 hold positions 8-11."""
    vis = tref.attn_decode_visible(torch.tensor([12, 8, 3]), 8, 4)
    assert vis[0].nonzero().flatten().tolist() == [0, 1, 2, 3]
    assert vis[1].nonzero().flatten().tolist() == [4, 5, 6, 7]
    assert vis[2].nonzero().flatten().tolist() == [0, 1, 2]


def test_kernel_wrapper_checks_and_never_falls_back():
    """The CUDA wrapper takes no CPU tensor, and rejects shapes the kernel
    does not take before any launch; ``ops`` sends a meta tensor (the dry
    run's counting) to the plain version and raises on other devices."""
    q, k, v, length = (torch.from_numpy(a) for a in _decode_inputs(
        9, 1, 1, 2, 8, 16, (3,)))
    n = tkattn.launches
    with pytest.raises(ValueError, match="CUDA device"):
        tkattn.attn_decode(q, k, v, length)
    with pytest.raises(ValueError, match="multiples of 16"):
        tkattn.check_inputs(q[..., :8], k[..., :8], v[..., :8], length)
    with pytest.raises(ValueError, match="G <= 16"):
        tkattn.check_inputs(torch.zeros(1, 17, 16), k, v, length)
    with pytest.raises(ValueError, match="int32"):
        tkattn.check_inputs(q, k, v, length.long())
    o = tops.attn_decode(q.to("meta"), k.to("meta"), v.to("meta"),
                         length.to("meta"))
    assert o.device.type == "meta" and o.shape == q.shape
    other = types.SimpleNamespace(is_cuda=False, device=torch.device("xpu"))
    with pytest.raises(ValueError, match="device"):
        tops._on_cuda(other)
    assert tkattn.launches == n


def test_split_len_fills_the_card():
    """Splits at the three shapes of chip_smoke.py on 132 SMs, each just
    enough CTAs for 64 KiB of K/V in flight per SM: (a) one tile each
    (3-stage ring at d = 128: 64 KiB per CTA), (b) 16 of 256 slots (d = 80:
    2 stages, four CTAs per SM), (c) 32 of 1024; whole tiles, one split
    when the card is full without splitting."""
    assert tkattn.split_len(4, 2, 1024, 128, 2, 132) == 64
    assert tkattn.split_len(4, 8, 4096, 80, 2, 132) == 256
    assert tkattn.split_len(1, 4, 32768, 128, 2, 132) == 1024
    assert tkattn.split_len(64, 16, 100, 64, 4, 132) == 128


@pytest.mark.parametrize("d,itemsize,stages", [(128, 2, 3), (80, 2, 2),
                                               (64, 2, 2), (16, 2, 2),
                                               (128, 4, 2), (80, 4, 2)])
def test_ring_stages(d, itemsize, stages):
    """bf16 deepens its ring to 3 stages only where two tiles in flight
    reach 64 KiB and two CTAs still fit an SM (d = 128); fp32
    double-buffers."""
    assert tkattn.ring_stages(d, itemsize) == stages


# (label, B, Hkv, d, T, lengths with one row emptied): chip_smoke.py's three
# shapes; (split, splits per row of the grid, live splits per batch row)
SIZING = {
    "a": ((4, 2, 128, 1024, (1, 300, 0, 1024)), (64, 16, [1, 5, 0, 16])),
    "b": ((4, 8, 80, 4096, (100, 0, 4500, 9000)), (256, 16, [1, 0, 16, 16])),
    "c": ((1, 4, 128, 32768, (0,)), (1024, 32, [0])),
}


@pytest.mark.parametrize("shape", sorted(SIZING))
def test_split_and_counter_sizing(shape):
    """The host's plan at each shape with an empty batch row: the split,
    the grid's splits per (row, kv head), the live splits the kernel
    counts (ceil(min(length, T) / split); 0 for the empty row, whose
    output split 0 writes as zeros without touching a counter), and one
    arrival counter per (row, kv head)."""
    (B, Hkv, d, T, lengths), (split, n_split, live) = SIZING[shape]
    assert tkattn.split_len(B, Hkv, T, d, 2, 132) == split
    assert -(-T // split) == n_split
    assert tkattn.live_splits(lengths, T, split) == live
    assert max(live) <= n_split
    buf = tkattn._counter_buffer(torch.device("cpu"), B * Hkv)
    assert buf.numel() >= B * Hkv and buf.dtype == torch.int32
    assert not buf.any()
    assert tkattn._counter_buffer(torch.device("cpu"), B * Hkv) is buf


def _split_merge_emulation(q, k, v, length, window, split):
    """The one-launch kernel's arithmetic in fp32 on (B, Hq, d) q and (B,
    Hkv, T, d) caches: each live split's (m, l, acc) in log2 units, then
    the last split's merge in split order 0..n-1 — M = max m_s, w_s =
    exp2(m_s - M), o = sum w_s acc_s / max(sum w_s l_s, 1e-30); a row with
    no occupied slot gives 0."""
    B, Hq, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    vis = tref.attn_decode_visible(length, T, window)       # (B, T)
    s = torch.einsum("bhgd,bhtd->bhgt", q.reshape(B, Hkv, G, d), k)
    s = s * (d ** -0.5 * 1.4426950408889634)
    o = torch.zeros(B, Hkv, G, d)
    for b in range(B):
        live = tkattn.live_splits(length[b:b + 1].tolist(), T, split)[0]
        parts = []
        for sp in range(live):
            sl = slice(sp * split, min((sp + 1) * split,
                                       min(int(length[b]), T)))
            x = s[b, :, :, sl].masked_fill(~vis[b, sl], -1e30)
            m = x.amax(-1, keepdim=True)
            p = torch.where(vis[b, sl], torch.exp2(x - m), torch.zeros(()))
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("hgt,htd->hgd", p, v[b, :, sl])))
        if not parts:
            continue
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        num, den = 0.0, 0.0
        for m, l, acc in parts:
            w = torch.exp2(m - M)
            num, den = num + w * acc, den + w * l
        o[b] = num / torch.clamp(den, min=1e-30)
    return o.reshape(B, Hq, d)


@pytest.mark.parametrize("split", [8, 16, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_merge_emulation_matches_pallas(case, split):
    """The kernel's split-and-merge design on the CPU against the Pallas
    kernel in interpret mode (fp32, 1e-5) on the occupied rows.  The first
    batch row is emptied: the reference leaves a length-0 row undefined
    (its Pallas kernel averages V, its oracle gives NaN); the port's plain
    version, and so the kernel, gives o = 0."""
    B, Hkv, G, T, d, lengths, window = CASES[case]
    q, k, v, length = _decode_inputs(22, B, Hkv, G, T, d, lengths)
    length[0] = 0
    jo = jops.attn_decode(*(jnp.asarray(a) for a in (q, k, v)),
                          jnp.asarray(length), block_t=8, window=window)
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, length))
    to = _split_merge_emulation(tq, tk, tv, tl, window, split)
    np.testing.assert_allclose(to[1:].numpy(), _np(jo)[1:], **F32)
    assert not to[0].any()
    assert torch.equal(to[0], tref.attn_decode_ref(tq, tk, tv, tl,
                                                   window=window)[0])


# ------------------------------------------------------ attention layer

@pytest.fixture(scope="module", params=["yi-9b", "h2o-danube-1.8b"])
def layer(request):
    """A reduced layer of the arch (reference params through the bridge)
    and each package's 32-slot cache after its own ragged chunked prefill
    of 40 and 21 tokens — past the reduced window of 32, so row 0 has
    wrapped."""
    jcfg = jconfigs.get_arch(request.param).reduced()
    tcfg = tconfigs.get_arch(request.param).reduced()
    jp = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    lp_j = jax.tree.map(lambda a: a[0], jp["groups"][0][0]["mixer"])
    lp_t = {k: v[0] for k, v in to_torch(jax.tree.map(
        np.asarray, jp))["groups"][0][0]["mixer"].items()}
    B, C, size = 2, 8, 32
    kw = dict(rope_theta=jcfg.rope_theta, window=jcfg.window)
    shape = (B, jcfg.hkv_eff, size, jcfg.head_dim)
    jc = jattn.KVCache(jnp.zeros(shape), jnp.zeros(shape),
                       jnp.zeros((B,), jnp.int32))
    tc = tattn.KVCache(torch.zeros(shape), torch.zeros(shape),
                       torch.zeros(B, dtype=torch.int32))
    rng = np.random.default_rng(10)
    for valid in ([8, 8], [8, 8], [8, 5], [8, 0], [8, 0]):
        x = rng.normal(size=(B, C, jcfg.d_model)).astype(np.float32)
        vl = np.asarray(valid, np.int32)
        _, jc = _j_chunk(lp_j, jnp.asarray(x), jc, valid_len=jnp.asarray(vl),
                         **kw)
        _, tc = tattn.attn_prefill_chunk(lp_t, torch.from_numpy(x), tc,
                                         valid_len=torch.from_numpy(vl), **kw)
    assert tc.length.tolist() == [40, 21]
    return jcfg, lp_j, lp_t, jc, tc


def _clone(cache):
    return tattn.KVCache(*(t.clone() for t in cache))


def test_attn_decode_pallas_matches_reference(layer):
    """Two decode steps through each package's ``attn_decode_pallas``:
    outputs and caches (fp32)."""
    cfg, lp_j, lp_t, jc, tc = layer
    np.testing.assert_allclose(_np(tc.k), _np(jc.k), **F32)
    tc = _clone(tc)
    rng = np.random.default_rng(11)
    for _ in range(2):
        x = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
        jo, jc = _j_decode_pallas(lp_j, jnp.asarray(x), jc,
                                  rope_theta=cfg.rope_theta)
        to, tc = tattn.attn_decode_pallas(lp_t, torch.from_numpy(x), tc,
                                          rope_theta=cfg.rope_theta)
        np.testing.assert_allclose(_np(to), _np(jo), **F32)
        np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
        np.testing.assert_allclose(_np(tc.k), _np(jc.k), **F32)
        np.testing.assert_allclose(_np(tc.v), _np(jc.v), **F32)
    assert tc.length.tolist() == [42, 23]


def test_attn_decode_pallas_equals_xla_on_unpadded_layer(layer):
    """On a layer without head padding the kernel path and the mixers'
    ``attn_decode_xla`` give the same output and the same cache."""
    cfg, _, lp_t, _, tc = layer
    assert not cfg.n_heads_pad
    x = torch.from_numpy(np.random.default_rng(12).normal(
        size=(2, cfg.d_model)).astype(np.float32))
    ck, cx = _clone(tc), _clone(tc)
    ok, ck = tattn.attn_decode_pallas(lp_t, x, ck, rope_theta=cfg.rope_theta)
    ox, cx = tattn.attn_decode_xla(lp_t, x, cx, rope_theta=cfg.rope_theta,
                                   window=cfg.window)
    np.testing.assert_allclose(ok.numpy(), ox.numpy(), **F32)
    for a, b in zip(ck, cx):
        assert torch.equal(a, b)


# ------------------------------------------------------------------- LM

ENGINE = dict(max_slots=2, max_len=64, decode_block=4, prefill_chunk=8,
              seed=3)


def _requests(cls):
    rng = np.random.default_rng(13)
    return [cls(rid=i, prompt=rng.integers(1, 256, size=n, dtype=np.int32),
                max_new_tokens=m)
            for i, (n, m) in enumerate(((40, 6), (9, 5)))]


def test_danube_engine_streams_match_reference():
    """Reduced h2o-danube-1.8b (window 32): one prompt past the window and
    one short one, greedy, through both engines."""
    jcfg = jconfigs.get_arch("h2o-danube-1.8b").reduced()
    jp = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    jeng = JEngine(jcfg, jp, **ENGINE)
    jreqs = _requests(JRequest)
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_done()
    tcfg = tconfigs.get_arch("h2o-danube-1.8b").reduced()
    eng = DecodeEngine(tcfg, to_torch(jax.tree.map(np.asarray, jp)),
                       device="cpu", **ENGINE)
    reqs = _requests(Request)
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert [list(r.output) for r in reqs] == [list(r.output) for r in jreqs]
    assert [len(r.output) for r in reqs] == [6, 5]


def test_yi_decode_step_logits_match_reference():
    """Reduced yi-9b: a ragged two-chunk prefill, then one ``decode_step``."""
    jcfg = jconfigs.get_arch("yi-9b").reduced()
    tcfg = tconfigs.get_arch("yi-9b").reduced()
    jp = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
    tp = to_torch(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(14)
    toks = rng.integers(1, 256, size=(2, 2, 8)).astype(np.int32)
    vls = np.array([[8, 8], [8, 3]], np.int32)
    tok = rng.integers(1, 256, size=(2,)).astype(np.int32)
    jc = jlm.prefill_chunk_scan(jp, jcfg, jlm.init_caches(jcfg, 2, 32),
                                tokens=jnp.asarray(toks),
                                valid_lens=jnp.asarray(vls))
    jl, _ = jax.jit(jlm.decode_step, static_argnums=1)(jp, jcfg,
                                                       jnp.asarray(tok), jc)
    tc = tlm.prefill_chunk_scan(tp, tcfg, tlm.init_caches(tcfg, 2, 32,
                                                          device="cpu"),
                                tokens=torch.from_numpy(toks),
                                valid_lens=torch.from_numpy(vls))
    tl, _ = tlm.decode_step(tp, tcfg, torch.from_numpy(tok), tc)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_cli_serves_new_archs_on_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--requests", "2", "--max-new", "3",
                 "--slots", "2", "--max-len", "64", "--device", "cpu"])
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out
