"""The executor's compiled programs (static buffers, one program per shape;
replayed from CUDA graphs on the card) against the JAX reference, on the
CPU, where every program runs eagerly.

  * ``compiled_programs()`` counts the same program shapes as the
    reference's ``executor.compiled_programs()`` for the same requests
    (the prompt lengths of ``tests/test_ragged_prefill.py``'s masked
    planner test), both engines staging per prompt
    (``prefill_batching=False``; the batched default is held in
    ``tests/test_torch_batched.py``);
  * token streams through the static-buffer programs equal the live JAX
    engine's — greedy and stochastic requests, a prompt with a placeholder
    chunk (valid_len 0, run as a no-op), an embeds prompt, overlap on and
    off — on reduced qwen3-next-gdn (the GDN kernels' plain versions), on
    reduced minicpm-2b with its heads padded (the head mask), on reduced
    mamba2-1.3b (SSD through the GDN kernels' plain versions) and on
    reduced recurrentgemma-2b (RG-LRU, a wrapped swa window, MQA padded);
  * the draws under the sampler are jax's, bit for bit, after the change
    that made them capture-safe;
  * no program makes a tensor from host data or syncs with the host after
    its first call (the rule a CUDA graph capture enforces on the card),
    on each of those archs;
  * ``cuda_graphs=True`` on the CPU raises.

Everything is float32 at reduced width; each test takes seconds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                    # noqa: E402
from repro.models import lm as jlm                        # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest      # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch.bridge import to_torch                   # noqa: E402
from repro_torch.serving import sampling as ts            # noqa: E402
from repro_torch.serving.engine import DecodeEngine, Request  # noqa: E402
from torch_host_guard import guard_programs               # noqa: E402

PROGRAM_KEYS = ("decode", "prefill_scan", "prefill_admit", "prefill",
                "total")
# tests/test_ragged_prefill.py::test_at_most_two_prefill_shapes_per_prompt
LENGTHS = (1, 7, 8, 9, 23, 40, 41, 57)


def _params(jcfg):
    jp = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jp, to_torch(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def gdn():
    jcfg = jconfigs.get_arch("qwen3-next-gdn").reduced()
    tcfg = tconfigs.get_arch("qwen3-next-gdn").reduced()
    return (jcfg, tcfg) + _params(jcfg)


def _serve(cls, req_cls, cfg, params, requests, **kw):
    eng = cls(cfg, params, **kw)
    for rid, T, new in requests:
        eng.submit(req_cls(rid=rid, prompt=np.arange(1, T + 1,
                                                     dtype=np.int32),
                           max_new_tokens=new))
    eng.run_until_done()
    return eng


# ------------------------------------------------------- program counts

@pytest.mark.parametrize("T", LENGTHS)
def test_program_counts_per_prompt_match_reference(gdn, T):
    """One prompt per fresh engine: the same program shapes as the
    reference, at most 2 of them prefill programs."""
    jcfg, tcfg, jp, tp = gdn
    kw = dict(max_slots=1, max_len=64, decode_block=1, prefill_chunk=8)
    reqs = [(0, T, 2)]
    jeng = _serve(JEngine, JRequest, jcfg, jp, reqs, prefill_batching=False,
                  **kw)
    teng = _serve(DecodeEngine, Request, tcfg, tp, reqs, device="cpu",
                  prefill_batching=False, **kw)
    want = jeng.executor.compiled_programs()
    got = teng.executor.compiled_programs()
    assert {k: got[k] for k in PROGRAM_KEYS} == \
        {k: want[k] for k in PROGRAM_KEYS}
    assert got["prefill"] <= 2 and got["cuda_graphs"] == 0
    m = teng.metrics()
    assert (m["compiled_programs"], m["prefill_programs"]) == \
        (got["total"], got["prefill"])


def test_program_counts_across_prompts_match_reference(gdn):
    """One engine across every length, with budgets that take the decode
    ticks through the k buckets 1, 2 and 4: the same program shapes as
    the reference, at most 5 prefill programs."""
    jcfg, tcfg, jp, tp = gdn
    kw = dict(max_slots=2, max_len=64, decode_block=4, prefill_chunk=8)
    reqs = [(rid, T, new) for rid, (T, new) in
            enumerate(zip(LENGTHS, (2, 9, 3, 2, 2, 4, 6, 3)))]
    jeng = _serve(JEngine, JRequest, jcfg, jp, reqs, prefill_batching=False,
                  **kw)
    teng = _serve(DecodeEngine, Request, tcfg, tp, reqs, device="cpu",
                  prefill_batching=False, **kw)
    want = jeng.executor.compiled_programs()
    got = teng.executor.compiled_programs()
    assert {k: got[k] for k in PROGRAM_KEYS} == \
        {k: want[k] for k in PROGRAM_KEYS}
    assert got["prefill"] <= 5 and got["decode"] == 3


# ------------------------------------------------------------ streams

ENGINE = dict(max_slots=2, max_len=64, decode_block=4, prefill_chunk=8,
              seed=5)
# (prompt length, max_new_tokens, temperature, top_k, top_p, embeds):
# 45 tokens = 5 full chunks + a tail of 5, staged as two scans of m = 3,
# the second with a placeholder chunk
MIX = ((45, 6, 0.0, 0, 1.0, False), (9, 9, 0.9, 0, 0.8, False),
       (26, 5, 0.7, 12, 1.0, False), (19, 7, 0.0, 0, 1.0, True),
       (3, 4, 1.1, 0, 1.0, False))
ARCHS = {
    "qwen3-next-gdn": dict(use_pallas_serving=True),
    # reduced() drops the padding: pad 4 heads to 8 again (as the full
    # config pads 36 to 48)
    "minicpm-2b": dict(n_heads_pad=8, n_kv_heads_pad=8),
    # SSD through the GDN kernels' plain versions: one q/k head for 8
    # value heads, d_state 32 x headdim 16, conv carries at the boundary
    "mamba2-1.3b": dict(use_pallas_serving=True),
    # RG-LRU + swa (window 32: the 45-token prompt wraps it), the MQA q
    # heads padded 4 -> 8 as the full config pads 10 -> 16
    "recurrentgemma-2b": dict(n_heads_pad=8),
}


def _mix(cls, d_model):
    rng = np.random.default_rng(11)
    out = []
    for rid, (T, new, temp, top_k, top_p, embeds) in enumerate(MIX):
        if embeds:
            kw = dict(prompt_embeds=(rng.normal(size=(T, d_model)) * 0.5)
                      .astype(np.float32))
        else:
            kw = dict(prompt=rng.integers(1, 256, size=T, dtype=np.int32))
        out.append(cls(rid=rid, max_new_tokens=new, temperature=temp,
                       top_k=top_k, top_p=top_p, **kw))
    return out


@pytest.fixture(scope="module", params=sorted(ARCHS))
def reference(request):
    arch = request.param
    jcfg = jconfigs.get_arch(arch).reduced().replace(**ARCHS[arch])
    tcfg = tconfigs.get_arch(arch).reduced().replace(**ARCHS[arch])
    jp, tp = _params(jcfg)
    eng = JEngine(jcfg, jp, prefill_batching=False, **ENGINE)
    reqs = _mix(JRequest, jcfg.d_model)
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return (tcfg, tp, {r.rid: list(r.output) for r in reqs},
            eng.executor.compiled_programs())


@pytest.mark.parametrize("overlap", [True, False])
def test_streams_through_programs_match_reference(reference, overlap):
    tcfg, tp, streams, want = reference
    eng = DecodeEngine(tcfg, tp, overlap=overlap, device="cpu",
                       prefill_batching=False, **ENGINE)
    reqs = _mix(Request, tcfg.d_model)
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert {r.rid: list(r.output) for r in reqs} == streams
    got = eng.executor.compiled_programs()
    assert {k: got[k] for k in PROGRAM_KEYS} == \
        {k: want[k] for k in PROGRAM_KEYS}


def test_programs_stay_on_the_device_after_their_first_call(reference,
                                                            monkeypatch):
    """A CPU stand-in for the card's capture rules: from its second call on
    a program may neither make a tensor from host data (a pageable copy a
    capture refuses) nor read a tensor on the host (a sync)."""
    tcfg, tp, streams, _ = reference
    calls = guard_programs(monkeypatch)
    eng = DecodeEngine(tcfg, tp, device="cpu", prefill_batching=False,
                       **ENGINE)
    reqs = _mix(Request, tcfg.d_model)
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert calls["guarded"] > 0
    assert {r.rid: list(r.output) for r in reqs} == streams


# ------------------------------------------------------------ sampler

def test_uniform_and_gumbel_draws_are_jax_bits():
    """``uniform`` over [0, 1) and over gumbel's range [tiny, 1) is jax's
    draw bit for bit, and so is each draw along the sampler's key chain;
    ``gumbel`` is -log(-log(u)) of exactly those draws (torch's log, so it
    may differ from jax's gumbel by the last ulp of log, as
    ``tests/test_torch_sampling.py`` states)."""
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(9), r)
                      for r in range(3)])
    tkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
    n = 777
    tiny = float(np.finfo(np.float32).tiny)
    for lo, hi in ((0.0, 1.0), (tiny, 1.0)):
        want = jax.vmap(lambda k: jax.random.uniform(
            k, (n,), minval=lo, maxval=hi))(keys)
        np.testing.assert_array_equal(ts.uniform(tkeys, n, lo, hi).numpy(),
                                      np.asarray(want))
    u = torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.uniform(
        k, (n,), minval=tiny, maxval=1.0))(keys)))
    np.testing.assert_array_equal(ts.gumbel(tkeys, n).numpy(),
                                  (-torch.log(-torch.log(u))).numpy())
    # the sampler's own key chain draws from the same bits
    jk, tk = keys, tkeys
    for _ in range(2):
        jk, jsub = jax.vmap(_split)(jk)
        tk, tsub = ts.split(tk)
        np.testing.assert_array_equal(
            ts.uniform(tsub, n, tiny, 1.0).numpy(),
            np.asarray(jax.vmap(lambda k: jax.random.uniform(
                k, (n,), minval=tiny, maxval=1.0))(jsub)))


def _split(key):
    new, sub = jax.random.split(key)
    return new, sub


# ------------------------------------------------------------ switch

def test_cuda_graphs_switch_on_the_cpu(gdn):
    _, tcfg, _, tp = gdn
    kw = dict(max_slots=1, max_len=32, decode_block=2, prefill_chunk=8)
    with pytest.raises(ValueError, match="cuda_graphs=True needs a CUDA"):
        DecodeEngine(tcfg, tp, device="cpu", cuda_graphs=True, **kw)
    for flag in (None, False):
        eng = DecodeEngine(tcfg, tp, device="cpu", cuda_graphs=flag, **kw)
        assert eng.executor.cuda_graphs is False
        eng.submit(Request(rid=0, prompt=np.arange(1, 12, dtype=np.int32),
                           max_new_tokens=3))
        eng.run_until_done()
        assert eng.executor.compiled_programs()["cuda_graphs"] == 0
