"""The model axis of the port's serving mesh for qwen3-next-gdn (GDN
heads, attention heads and KV context, the MLP and the vocab) and for the
``("gdn_naive", "attn")`` pattern (the Alg. 1 GDN decode on the same head
split) against the live JAX reference, on the CPU over gloo.

Four spawned ranks (``tests/torch_mesh_ranks.py``) serve the (1,2) mesh
on ranks 0-1 and the (2,2) mesh on all four, reduced fp32 config with the
reference's parameters through the numpy bridge.  The model axis splits
head and context reductions, so it is held at the tolerance of the
reference's own check: buffer placements by the rules (the reference's
asserts at ``tests/test_serving_mesh.py:370-383``), a ragged
``prefill_chunk``'s hidden states and a ``decode_step``'s logits within
rtol = atol = 2e-4 of the reference's (its check at ``:387-410``),
greedy streams equal, speculative decode on the mesh, the host guard,
the ranks' plans equal, and a swap image moved from (2,2) to one device.
``check_model_axis`` refuses what the model code does not split: a mixer
kind outside the registry's and dims the axis does not divide.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_ranks as ranks                          # noqa: E402
import torch_mesh_reference as mref                       # noqa: E402
from repro.models import lm as jlm                        # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch.bridge import to_torch                   # noqa: E402
from repro_torch.models.mixers import MIXERS              # noqa: E402
from repro_torch.serving.engine import DecodeEngine       # noqa: E402
from repro_torch.serving.executor import (MODEL_AXIS_KINDS,  # noqa: E402
                                          check_model_axis)

ARCH = "qwen3-next-gdn"
NAIVE = ranks.NAIVE
ENGINE = mref.ENGINE
SPEC = dict(speculative=True, k_draft=2)
REQS = {"greedy": mref.requests(5, False), "mixed": mref.requests(5, True)}
TOL = 2e-4

# (name, mesh, engine settings, requests)
SERVE = [
    ("tp_1x2", (1, 2), {}, "greedy"),
    ("tp_2x2", (2, 2), {}, "greedy"),
    ("tp_spec", (2, 2), SPEC, "mixed"),
]
GUARDED = ("tp_2x2", "tp_spec")


@pytest.fixture(scope="module")
def run():
    """The ranks serve every job while the reference serves here."""
    torch.set_num_threads(1)
    jcfg, jp, params = mref.bridged(ARCH)
    # the model-axis numerics: a ragged two-chunk prefill and one decode
    # step of four rows from zeroed caches
    rng = np.random.default_rng(0)
    inputs = dict(chunk1=rng.integers(1, jcfg.vocab, (4, 8)),
                  chunk2=rng.integers(1, jcfg.vocab, (4, 8)),
                  valid=np.array([8, 3, 5, 1], np.int32),
                  tok=rng.integers(1, jcfg.vocab, (4,)).astype(np.int32))
    jobs = [dict(name=name, kind="serve", mesh=mesh, arch=ARCH,
                 engine={**ENGINE, **kw}, reqs=kind, guard=name in GUARDED)
            for name, mesh, kw, kind in SERVE]
    jobs += [dict(name=f"logits_{m[0]}x{m[1]}", kind="logits", mesh=m,
                  arch=ARCH, batch=4, max_len=64, inputs=inputs)
             for m in ((1, 2), (2, 2))]
    jobs += [dict(name="swap_2x2", kind="swap", mesh=(2, 2), arch=ARCH,
                  engine=ENGINE, reqs="mixed")]
    jobs += mref.model_jobs(NAIVE, (1, 2), reqs="naive")
    ncfg, njp, nparams = mref.bridged(NAIVE)
    group = ranks.start(4, jobs, dict(
        params={ARCH: params, NAIVE: nparams},
        reqs={**REQS, "naive": mref.REQS["mixed"]}))

    base = JEngine(jcfg, jp, **ENGINE)
    ref = {kind: mref.jserve(base, REQS[kind]) for kind in REQS}
    ref[NAIVE, "default"] = mref.jserve(JEngine(ncfg, njp, **ENGINE),
                                        mref.REQS["mixed"])
    ref["numerics", NAIVE] = mref.jnumerics(ncfg, njp)
    ref["spec"] = mref.jserve(JEngine(jcfg, jp, **SPEC, **ENGINE),
                              REQS["mixed"])
    c = jlm.init_caches(jcfg, 4, 64)
    h1, c = jlm.prefill_chunk(jp, jcfg, c,
                              tokens=jnp.asarray(inputs["chunk1"]))
    h2, c = jlm.prefill_chunk(jp, jcfg, c,
                              tokens=jnp.asarray(inputs["chunk2"]),
                              valid_len=jnp.asarray(inputs["valid"]))
    logits, _ = jlm.decode_step(jp, jcfg, jnp.asarray(inputs["tok"]), c)
    ref["numerics"] = dict(h1=np.asarray(h1), h2=np.asarray(h2),
                           logits=np.asarray(logits))
    out = group.results()
    mref.no_errors(out)
    return dict(ref=ref, out=out, params=params)


def _rank0(run, name):
    return run["out"][0][name]


def test_model_axis_placements_follow_the_rules(run):
    """(2,2): the state heads at dim 2 and the KV context at dim 3 on
    "model", the slot axis at dim 1 on "data", tokens and sampler rows on
    "data", the staging ring unsharded on its slot axis but on "model"
    elsewhere; each rank holds its block."""
    def ax(entry):          # a spec entry as a tuple of axis names
        if entry is None:
            return ()
        return tuple(entry) if isinstance(entry, tuple) else (entry,)

    got = _rank0(run, "tp_2x2")
    place, shapes = got["placements"], got["shapes"]
    caches = dict(zip(got["cache_paths"], place["caches"]))
    s_specs = [s for p, s in caches.items() if p.endswith("/S")]
    kv = [s for p, s in caches.items() if p.endswith(("/k", "/v"))]
    assert s_specs and all(ax(s[1]) == ("data",) and ax(s[2]) == ("model",)
                           for s in s_specs)
    assert kv and all(ax(s[1]) == ("data",) and ax(s[3]) == ("model",)
                      for s in kv)
    assert ax(place["tokens"][0][0]) == ("data",)
    assert ax(place["sampler"]["key"][0]) == ("data",)
    assert all(len(s) < 2 or ax(s[1]) == () for s in place["staging"])
    assert any(ax(e) == ("model",) for s in place["staging"] for e in s)
    # the batched ring's two rows divide the data axis: on it
    assert all(ax(s[1]) == ("data",) for s in place["bstaging"]
               if len(s) > 1)
    for spec, full, local in zip(place["caches"],
                                 shapes["full_caches"], shapes["caches"]):
        assert local == tuple(n // (2 if ax else 1)
                              for n, ax in zip(full, list(spec) + [None]
                                               * (len(full) - len(spec))))
    assert shapes["tokens"] == (2,)
    params = got["param_placements"]
    assert params["embed/table"] == ("model", None)
    assert params["lm_head/w"] == (None, "model")
    assert params["groups/0/0/mixer/wv"] == (None, None, "model", None)
    assert params["groups/0/3/mixer/wk"] == (None, None, "model", None)
    assert params["groups/0/0/mlp/wo"] == (None, "model", None)
    assert got["metrics"]["mesh_data"] == 2
    assert got["metrics"]["mesh_model"] == 2


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_model_axis_numerics_within_tolerance(run, mesh):
    """Each rank's rows of the ragged prefill's hidden states and of the
    decode step's full-vocabulary logits, against the reference's."""
    want = run["ref"]["numerics"]
    n = 2 if mesh == "1x2" else 4
    for r in range(n):
        got = run["out"][r][f"logits_{mesh}"]
        rows = slice(*got["rows"])
        for key in ("h1", "h2", "logits"):
            w = want[key][rows]
            if key == "h2":      # rows past their valid length are garbage
                w = np.where(np.arange(8)[None, :, None]
                             < np.array([8, 3, 5, 1])[rows, None, None],
                             w, got[key])
            np.testing.assert_allclose(got[key], w, rtol=TOL, atol=TOL,
                                       err_msg=f"rank {r} {key}")
        assert got["collectives"] > 0


@pytest.mark.parametrize("name", ["tp_1x2", "tp_2x2"])
def test_model_axis_greedy_streams_equal_the_reference(run, name):
    got = _rank0(run, name)
    assert got["done"] and got["streams"] == run["ref"]["greedy"][0]


def test_model_axis_speculative_decode(run):
    """Self-draft speculative decode on the (2,2) mesh: the checkpoint and
    draft buffers take the caches' placements (the verify's commit needs
    no collective), and the streams are the reference's (the greedy
    requests among them exactly; the drawing ones only up to the
    tolerance of the model axis, so they are not compared)."""
    got = _rank0(run, "tp_spec")
    assert got["done"]
    place = got["placements"]
    assert place["ckpt"] == place["caches"]
    assert place["dckpt"] == place["dcaches"] == place["caches"]
    assert got["shapes"]["ckpt"] == got["shapes"]["caches"]
    want = run["ref"]["spec"][0]
    for r, (g, w) in enumerate(zip(got["streams"], want)):
        if REQS["mixed"][r]["temperature"] == 0.0:
            assert g == w, r


@pytest.mark.parametrize("name", GUARDED)
def test_mesh_programs_pass_the_host_guard(run, name):
    """The mesh programs' collectives read no tensor on the host and copy
    no host data after a program's first call (gloo on CPU tensors is no
    device sync)."""
    for r in range(4):
        assert run["out"][r][name]["guarded"] > 0


def test_every_rank_returns_the_same_streams_and_plans(run):
    """The ranks of each mesh made the same executor calls with the same
    arguments (a digest of every plan call) and emitted the same
    streams."""
    for name, mesh, *_ in SERVE:
        got = [run["out"][r][name] for r in range(mesh[0] * mesh[1])]
        assert len({g["plan"] for g in got}) == 1, name
        assert got[0]["plan_calls"] > 0
        assert all(g["streams"] == got[0]["streams"] for g in got), name


def test_swap_images_move_between_layouts(run):
    """An image taken on the (2,2) mesh (the same bytes on every rank)
    restores into a one-device port engine, whose continuation is the
    mesh's and the reference's."""
    sw = _rank0(run, "swap_2x2")
    want = run["ref"]["mixed"][0]
    assert sw["streams"] == want
    assert sw["image"].nbytes == sw["swap_bytes_per_slot"]
    for r in range(1, 4):
        other = run["out"][r]["swap_2x2"]["image"]
        for a, b in zip(ranks.leaves(other.caches),
                        ranks.leaves(sw["image"].caches)):
            assert a.tobytes() == b.tobytes()
    cfg = tconfigs.get_arch(ARCH).reduced()
    eng = DecodeEngine(cfg, to_torch(run["params"]), device="cpu", **ENGINE)
    assert eng.executor.swap_bytes_per_slot == sw["swap_bytes_per_slot"]
    ex = eng.executor
    ex.restore_slot(1, sw["image"])
    got = []
    while True:
        toks, valid = ex.decode(2)
        got += [int(t) for t, v in zip(toks[:, 1], valid[:, 1]) if v]
        if not valid[-1, 1]:
            break
    assert got == sw["after"] == want[0][sw["n"]:]


@pytest.mark.parametrize("check", ["placements", "streams", "numerics"])
def test_model_axis_gdn_naive_matches_the_reference(run, check):
    mref.check_model((run["ref"], run["out"], None), NAIVE, (1, 2), check)


def test_model_axis_refuses_a_kind_outside_the_registry():
    """Every registered kind splits; a kind registered later, whose
    model code knows no mesh, is refused (the data axis serves it)."""
    cfg = tconfigs.get_arch(ARCH).reduced()
    assert sorted(MIXERS) == sorted(MODEL_AXIS_KINDS)
    custom = cfg.replace(pattern=("gdn", "custom"))
    with pytest.raises(NotImplementedError, match=r"\['custom'\]"):
        check_model_axis(custom, 2, 64)
    check_model_axis(custom, 1, 64)


def test_model_axis_refuses_a_dim_it_does_not_divide():
    """The dims whose move the model code does not follow are refused
    when the axis does not divide them (ROADMAP queue 1 item 4g); the
    moves it follows pass: KV and query heads onto head_dim (gemma's one
    MQA head, its 10 query heads at 4), the experts onto d_ff (mixtral's
    8 at 16), the vocabulary onto d_model (minicpm-2b's 122,753)."""
    cfg = tconfigs.get_arch(ARCH).reduced()
    with pytest.raises(ValueError, match="gdn_k_heads.*item 4g"):
        check_model_axis(cfg, 4, 64)
    with pytest.raises(ValueError, match="max_len"):
        check_model_axis(cfg, 2, 63)
    gemma = tconfigs.get_arch("recurrentgemma-2b")
    with pytest.raises(ValueError, match="swa window"):
        check_model_axis(gemma, 2, 2047)
    with pytest.raises(ValueError, match="ssm_d_state"):
        check_model_axis(tconfigs.get_arch("mamba2-1.3b").replace(
            ssm_d_state=129), 2, 64)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        check_model_axis(cfg, 2, 64)
        for m in (2, 4):     # MQA: its one KV head moves to head_dim
            check_model_axis(gemma, m, 4096)
        check_model_axis(gemma.replace(n_heads_pad=0), 4, 4096)
        check_model_axis(tconfigs.get_arch("mixtral-8x7b"), 16, 4096)
        check_model_axis(tconfigs.get_arch("minicpm-2b"), 2, 4096)
