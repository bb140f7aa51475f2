"""The data axis of the port's serving mesh for qwen3-next-gdn (``gdn`` +
``attn``) against the live JAX reference, on the CPU over gloo.

Two spawned ranks (``tests/torch_mesh_ranks.py``) serve the (2,1) mesh on
the reduced fp32 config with the reference's parameters through the numpy
bridge, while the reference serves here.  The reference's own mesh tests
fail on this tree (its embedding gather), so the port is held against
the reference's one-device engine, which the reference promises
data-axis sharding leaves bitwise (``src/repro/serving/engine.py:95-104``):
streams bitwise the reference's, greedy and stochastic, through the
default batched staging, pow2 plans, speculative decode (self-draft;
``accepted_tokens`` too) and sync and async pause/resume with a prefetch
hit (the scenarios of the reference's ``tests/test_serving_mesh.py:317-420,
533-630, 651-715`` and ``tests/test_batched_prefill.py:400``); the ranks
agree on every tick's plan; a non-dividing slot count warns with
``pad_slots`` and completes; a bridged reference image restores into the
mesh; the speculative programs pass the host guard; the idle swap policy
evicts by rank 0's clock on both ranks, whatever each rank's own clock
says, and its streams are the reference's unpaged ones.  The model axis is
``tests/test_torch_mesh_model.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_ranks as ranks                          # noqa: E402
import torch_mesh_reference as mref                       # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest      # noqa: E402
from repro_torch.bridge import to_numpy, to_torch         # noqa: E402
from repro_torch.serving.executor import SwappedState     # noqa: E402

ARCH = "qwen3-next-gdn"
ENGINE = mref.ENGINE
SPEC = dict(speculative=True, k_draft=2)
REQS = {"greedy": mref.requests(5, False), "mixed": mref.requests(5, True)}

# (name, engine settings, requests, paging script) on the (2,1) mesh
SERVE = [
    ("dp_greedy", {}, "greedy", None),
    ("dp_mixed", {}, "mixed", None),
    ("dp_pow2", dict(plan_mode="pow2"), "mixed", None),
    ("dp_spec", SPEC, "mixed", None),
    ("dp_pause", {}, "mixed", "sync"),
    ("dp_async", dict(async_paging=True), "mixed", "async"),
    ("odd_slots", dict(max_slots=3), "greedy", None),
]
DATA_AXIS = [s[0] for s in SERVE if s[0].startswith("dp_")]
# the idle policy on the (2,1) mesh: a lease no real tick reaches, each
# rank's scheduler clock at its own offset, rank 1's jumping past the
# lease after two requests are touched (``torch_mesh_ranks.idle_job``)
IDLE = dict(lease_s=60.0, offsets=[0.0, 500.0], jump=[0.0, 600.0])


@pytest.fixture(scope="module")
def run():
    """A reference image first (a rank restores it), then the ranks serve
    every job while the reference serves here."""
    torch.set_num_threads(1)
    jcfg, jp, params = mref.bridged(ARCH)
    base = JEngine(jcfg, jp, **ENGINE)

    # a reference image of request 0 mid-decode and the stream it goes on
    # to emit after its resume
    reqs = [JRequest(**r) for r in REQS["mixed"]]
    for r in reqs:
        base.submit(r)
    ranks._step_until(base, lambda: reqs[0].state == "active"
                      and len(reqs[0].output) >= 2)
    base.pause(0)
    jsw = base.swapped[0].state
    n = len(reqs[0].output)
    base.resume(0)
    base.run_until_done()
    base.reset_metrics()
    ref = {"image_after": list(reqs[0].output[n:])}
    image = SwappedState(caches=to_numpy(to_torch(jsw.caches)),
                         sampler=to_numpy(to_torch(dict(jsw.sampler))),
                         token=np.asarray(jsw.token))

    jobs = [dict(name=name, kind="serve", mesh=(2, 1), arch=ARCH,
                 engine={**ENGINE, **kw}, reqs=kind, script=script,
                 guard=name == "dp_spec")
            for name, kw, kind, script in SERVE]
    jobs.append(dict(name="ref_image", kind="restore", mesh=(2, 1),
                     arch=ARCH, engine=ENGINE, image="reference", slot=3))
    jobs.append(dict(name="dp_idle", kind="idle", mesh=(2, 1), arch=ARCH,
                     engine=ENGINE, reqs="mixed", **IDLE))
    group = ranks.start(2, jobs, dict(params={ARCH: params}, reqs=REQS,
                                      images={"reference": image}))
    for name, kw, kind, script in SERVE:
        if name in DATA_AXIS and set(kw) <= {"async_paging"}:
            base.async_paging = bool(kw.get("async_paging"))
            ref[name] = mref.jserve(base, REQS[kind], script)
    ref["dp_pow2"] = mref.jserve(
        JEngine(jcfg, jp, plan_mode="pow2", **ENGINE), REQS["mixed"])
    ref["dp_spec"] = mref.jserve(JEngine(jcfg, jp, **SPEC, **ENGINE),
                                 REQS["mixed"])
    out = group.results()
    mref.no_errors(out)
    return dict(ref=ref, out=out)


def _rank0(run, name):
    return run["out"][0][name]


@pytest.mark.parametrize("name", DATA_AXIS)
def test_data_axis_streams_equal_the_reference(run, name):
    got = _rank0(run, name)
    want, jm = run["ref"][name]
    assert got["done"] and got["streams"] == want
    assert got["metrics"]["mesh_data"] == 2
    assert got["metrics"]["mesh_model"] == 1
    if name == "dp_spec":
        assert got["metrics"]["accepted_tokens"] == jm["accepted_tokens"]
        assert got["metrics"]["drafted_tokens"] == jm["drafted_tokens"]
    if name in ("dp_pause", "dp_async"):
        # the paged streams are the uninterrupted ones
        assert got["streams"] == run["ref"]["dp_mixed"][0]
        assert got["metrics"]["swap_outs"] == jm["swap_outs"] >= 1
    if name == "dp_async":
        assert got["metrics"]["swap_prefetch_hits"] == \
            jm["swap_prefetch_hits"] >= 1


def test_every_rank_returns_the_same_streams_and_plans(run):
    """The ranks made the same executor calls with the same arguments (a
    digest of every plan call) and emitted the same streams."""
    for name, *_ in SERVE:
        a, b = run["out"][0][name], run["out"][1][name]
        assert a["plan"] == b["plan"] and a["plan_calls"] > 0, name
        assert a["streams"] == b["streams"], name


def test_speculative_programs_pass_the_host_guard(run):
    """After its first call no program reads a tensor on the host or
    copies host data: the data axis' gathers run on CPU tensors (gloo,
    no device sync)."""
    for r in range(2):
        assert run["out"][r]["dp_spec"]["guarded"] > 0


def test_checkpoints_take_the_caches_placements(run):
    place = _rank0(run, "dp_spec")["placements"]
    assert place["ckpt"] == place["caches"]
    assert place["dckpt"] == place["dcaches"] == place["caches"]


def test_non_dividing_slots_warn_and_complete(run):
    got = _rank0(run, "odd_slots")
    assert any("pad_slots" in w for w in got["warnings"])
    assert got["done"]
    assert [len(s) for s in got["streams"]] == \
        [r["max_new_tokens"] for r in REQS["greedy"]]
    # replicated over "data", the slots keep the one-device arithmetic
    assert got["streams"] == run["ref"]["dp_greedy"][0]
    assert got["shapes"]["tokens"] == (3,)


def test_a_reference_image_restores_into_the_mesh(run):
    """A bridged reference image restored into slot 3 (held by data rank
    1) continues its stream as the reference's resume does, on both
    ranks."""
    for r in range(2):
        assert run["out"][r]["ref_image"]["got"] == \
            run["ref"]["image_after"]


def test_idle_policy_on_the_mesh_follows_rank_0s_clock(run):
    """Rank 0's clock decides each idle sweep for both ranks: they evict
    the same rids at the same ticks (the two untouched requests), though
    rank 1's own clock, past the lease, would evict all four; the paged
    streams are the reference's one-device streams without paging."""
    a, b = run["out"][0]["dp_idle"], run["out"][1]["dp_idle"]
    assert a["done"] and a["evicted"] and a["evicted"] == b["evicted"]
    tick, rids = a["evicted"][0]
    assert rids == a["untouched"] == b["untouched"]
    assert a["own"][0] == rids and len(b["own"][0]) == 4
    assert a["streams"] == b["streams"] == run["ref"]["dp_mixed"][0]
    assert a["swaps"] == b["swaps"] and a["swaps"][0] >= 2
