"""The port's serving engine against the JAX reference's, on reduced
qwen3-next-gdn with ``use_pallas_serving=True`` (the reference runs its
Pallas kernels in interpret mode; the port's CPU tensors take the kernels'
plain versions).  Parameters come from the reference's init through the
bridge.  Token streams must be identical — greedy and stochastic, with
prefill/decode overlap on and off, both packages' default engines
staging in batches.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                    # noqa: E402
from repro.models import lm as jlm                        # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest      # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch.bridge import to_torch                   # noqa: E402
from repro_torch.launch import serve as tserve            # noqa: E402
from repro_torch.serving.engine import DecodeEngine, Request  # noqa: E402

ENGINE = dict(max_slots=2, max_len=64, decode_block=4, prefill_chunk=8,
              seed=3)
# prompts spanning several chunks with ragged tails, one exactly a chunk;
# (temperature, top_k) per request: greedy plus one stochastic
PROMPT_LENS = (21, 8, 30, 13)
SAMPLING = ((0.0, 0), (0.0, 0), (0.8, 20), (0.0, 0))
MAX_NEW = (7, 5, 9, 6)


def _requests(cls):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(1, 256, size=n, dtype=np.int32),
                max_new_tokens=m, temperature=t, top_k=k)
            for i, (n, (t, k), m) in enumerate(zip(PROMPT_LENS, SAMPLING,
                                                    MAX_NEW))]


@pytest.fixture(scope="module")
def reference():
    jcfg = jconfigs.get_arch("qwen3-next-gdn").reduced().replace(
        use_pallas_serving=True)
    jp = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    eng = JEngine(jcfg, jp, **ENGINE)
    reqs = _requests(JRequest)
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    streams = {r.rid: list(r.output) for r in reqs}
    tcfg = tconfigs.get_arch("qwen3-next-gdn").reduced().replace(
        use_pallas_serving=True)
    return streams, eng.metrics(), tcfg, to_torch(jax.tree.map(np.asarray,
                                                               jp))


@pytest.mark.parametrize("overlap", [True, False])
def test_engine_streams_match_reference(reference, overlap):
    streams, jm, tcfg, tp = reference
    eng = DecodeEngine(tcfg, tp, overlap=overlap, device="cpu", **ENGINE)
    reqs = _requests(Request)
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_done()
    assert len(done) == len(reqs)
    assert {r.rid: list(r.output) for r in reqs} == streams
    m = eng.metrics()
    assert set(m) <= set(jm)                    # the reference's key names
    for key in ("requests", "tokens", "decode_block", "prefill_chunk",
                "staging_depth", "plan_mode"):
        assert m[key] == jm[key], key


def test_engine_budget_ticks_and_admit_completion(reference):
    """max_new_tokens = 1 completes at admit (no slot, no tick); a tick
    never runs past the largest remaining budget."""
    _, _, tcfg, tp = reference
    eng = DecodeEngine(tcfg, tp, device="cpu", **ENGINE)
    eng.submit(Request(rid=0, prompt=np.arange(1, 12, dtype=np.int32),
                       max_new_tokens=1))
    eng.submit(Request(rid=1, prompt=np.arange(1, 5, dtype=np.int32),
                       max_new_tokens=3))
    eng.run_until_done()
    m = eng.metrics()
    assert m["tokens"] == 4 and m["decoded_tokens"] == 2
    assert m["ticks"] == 1                   # one k=2 bucket tick
    assert m["scatter_dispatches"] == 1


def test_engine_rejects_bad_requests_and_deferred_settings(reference):
    _, _, tcfg, tp = reference
    eng = DecodeEngine(tcfg, tp, device="cpu", **ENGINE)
    for req, match in ((Request(rid=0, prompt=np.ones(3), top_p=0.0),
                        "top_p"),
                       (Request(rid=0, prompt=np.ones(3), top_k=40),
                        "temperature"),
                       (Request(rid=0, prompt=np.ones(3),
                                max_new_tokens=0), "max_new_tokens"),
                       (Request(rid=0, prompt=np.ones(65)), "max_len"),
                       (Request(rid=0), "prompt")):
        with pytest.raises(ValueError, match=match):
            eng.submit(req)
    # paging's own errors: no live request to pause, bad settings
    with pytest.raises(KeyError, match="no live request"):
        eng.pause(0)
    for kw, match in ((dict(swap_policy="lru"), "swap_policy"),
                      (dict(swap_policy="idle"), "idle_swap_ms"),
                      (dict(gather_ring=0), "gather_ring"),
                      (dict(host_swap_bytes=1), "swap_spool_dir")):
        with pytest.raises(ValueError, match=match):
            DecodeEngine(tcfg, tp, device="cpu", **ENGINE, **kw)
    # a mesh is a DeviceMesh (tests/test_torch_mesh_serving.py serves
    # them); an unknown engine role is the reference's ValueError
    with pytest.raises(TypeError, match="DeviceMesh"):
        DecodeEngine(tcfg, tp, device="cpu", **ENGINE, mesh=object())
    with pytest.raises(ValueError, match="role must be"):
        DecodeEngine(tcfg, tp, device="cpu", **ENGINE, role="verifier")


def test_entry_points_need_a_card_unless_cpu_is_asked(reference):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, _, tcfg, tp = reference
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(tcfg, tp, **ENGINE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", "qwen3-next-gdn", "--requests", "1"])


def test_serve_cli_on_cpu(capsys):
    tserve.main(["--arch", "qwen3-next-gdn", "--requests", "3",
                 "--max-new", "3", "--slots", "2", "--max-len", "32",
                 "--kernels", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out


def _cli_streams(capsys, flags):
    tserve.main(["--arch", "qwen3-next-gdn", "--requests", "4",
                 "--max-new", "6", "--slots", "2", "--max-len", "48",
                 "--kernels", "--device", "cpu"] + flags)
    out = capsys.readouterr().out
    assert "served 4 requests, 24 tokens" in out
    return out, [line.split(":", 1)[0] + line.rsplit("toks:", 1)[1]
                 for line in out.splitlines() if "toks:" in line]


@pytest.mark.parametrize("flags", [
    ["--plan-mode", "pow2"], ["--no-prefill-batching"],
    ["--prefill-budget", "16"], ["--speculative"],
    ["--speculative", "--draft-config", "qwen3-next-gdn",
     "--adaptive-k-draft", "--k-draft", "2"]])
def test_serve_cli_flags_print_the_plain_streams(capsys, flags):
    """The serve CLI's staging and speculative flags print the streams of
    the plain run, and the staging or speculative report."""
    _, plain = _cli_streams(capsys, [])
    out, got = _cli_streams(capsys, flags)
    assert got == plain and len(plain) == 4
    if "--speculative" in flags:
        assert "speculative: draft=" in out and "accepted" in out
    else:
        assert ("per-prompt staging" in out) == (
            "--prefill-budget" not in flags)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_serve_cli_new_archs_on_cpu(capsys, arch):
    """The serve CLI's reduced mamba2 (through the GDN kernels' plain
    versions) and recurrentgemma (RG-LRU + swa) on the CPU."""
    tserve.main(["--arch", arch, "--requests", "3", "--max-new", "4",
                 "--slots", "2", "--max-len", "48", "--kernels",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out
