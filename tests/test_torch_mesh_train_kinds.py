"""The model axis in training for every mixer kind but gdn and attn, and
for the MoE's experts, against the live JAX one-device train step on the
CPU: reduced fp32 configs, the reference's initial state through the
numpy bridge, one group of four spawned gloo ranks
(``tests/torch_mesh_ranks.py``'s train jobs) training while the
reference runs here.

Cases, 3 steps each from the bridged initial state on the loader's
batches (bitwise the reference's), on the warmup-2 schedule of
``tests/test_torch_train.py``:

  * mamba2-1.3b (1,2): 4 of 8 SSD heads and 16 of 32 ``d_state`` per
    rank; B and C gathered (their gradient summed over "model"), the
    RMSNorm's mean square through ``comm.mean_over``;
  * recurrentgemma-2b (1,2): the RG-LRU's width slice (the post-conv x
    gathered before the gate products) and its MQA swa layer, whose one
    KV head is split on head_dim;
  * h2o-danube-1.8b (1,2): swa, a rank's query and KV heads;
  * mixtral-8x7b (1,2) and (2,2) with FSDP forced: 2 of 4 experts per
    rank, the router reading the FFN input before ``copy_to``, the combine
    gates' gradient summed over "model"; on (2,2) with the data axis's
    capacity groups and ``mean_over`` statistics;
  * arctic-480b (1,2): the experts and the dense MLP in one row-parallel
    sum;
  * qwen3-next-gdn with every gdn layer a gdn_naive one (1,2).

The swa cases (recurrentgemma, h2o-danube, mixtral) run at seq_len 64 on
both sides, so the reduced window of 32 binds.  Each case is held by
``tests/test_torch_mesh_train.py``'s ``_check`` (every rank's metrics
equal; loss and ce to 1e-5, the grad norm to 1e-5, the stepped state by
``_assert_stepped_state``; mamba2's with the sharp mask of both steps that
move the parameters: one embedding element of mamba2's, whose step-2
gradient is 2.3e-9, at AdamW's eps, leaves the reference by 1.4e-5
relative after step 3 in the one-device port as on the mesh, ROADMAP
queue 3), and after every step every state leaf the
specs replicate over "model" is the same bits on each model rank: the
leaves a rank uses only a slice of (ssm's ``w_B``, ``w_C``, the conv
filters of B and C, the conv biases, the norm scale) and the router take
their whole gradient on every rank.  ``comm.mean_over`` over "model" is
bitwise the serving form ``all_reduce(x) / size``.

In bf16 a model axis of one rank must take the one-device products
(``layers.dot_rows`` keeps its fp32 partial sums for a model axis of 2 or
more): qwen3-next-gdn's reduced config in bf16 on (1,1) is the one-device
port's run bit for bit, and on (2,1) its losses before the first update
are the bits of the one-device run with 2 microbatches.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_ranks as ranks                          # noqa: E402
from test_torch_mesh_train import (TC, LOSS, _check,      # noqa: E402
                                   _jrun, _jtc)

# the swa archs' seq_len: past the reduced window of 32
SWA = dict(seq_len=64, global_batch=2)
MOE = dict(global_batch=2)
# name -> (arch, mesh, FSDP forced, TrainerConfig settings over TC)
CASES = {
    "mamba2_1x2": ("mamba2-1.3b", (1, 2), False, {}),
    "gemma_1x2": ("recurrentgemma-2b", (1, 2), False, SWA),
    "danube_1x2": ("h2o-danube-1.8b", (1, 2), False, SWA),
    "mixtral_1x2": ("mixtral-8x7b", (1, 2), False, SWA),
    "mixtral_2x2_fsdp": ("mixtral-8x7b", (2, 2), True, SWA),
    "arctic_1x2": ("arctic-480b", (1, 2), False, MOE),
    "naive_1x2": (ranks.NAIVE_ALL, (1, 2), False, {}),
}
MOE_CASES = ("mixtral_1x2", "mixtral_2x2_fsdp", "arctic_1x2")
# the cases held with the sharp mask of every step that moved the
# parameters (module docstring)
EVERY_STEP = ("mamba2_1x2",)
# bf16 layouts whose model axis has one rank, against the one-device
# port's steps with as many microbatches as the data axis has ranks
BF16_CASES = {"bf16_1x1": (1, 1), "bf16_2x1": (2, 1)}


def _ref_key(name):
    arch, _, _, tc = CASES[name]
    return arch, tuple(sorted(tc.items()))


@pytest.fixture(scope="module")
def run():
    """{case: {rank: result}} and the reference's runs by (arch,
    settings)."""
    torch.set_num_threads(1)
    jobs = [dict(name=n, kind="train", mesh=mesh, arch=arch, fsdp=fsdp,
                 tc=dict(TC, **tc), steps=3, init=n)
            for n, (arch, mesh, fsdp, tc) in CASES.items()]
    jobs.append(dict(name="mean_over", kind="mean_over", mesh=(1, 4)))
    jobs += [dict(name=n, kind="train", mesh=mesh, arch=ranks.BF16,
                  fsdp=False, tc=TC, steps=3, init=None)
             for n, mesh in BF16_CASES.items()]
    ref = {}
    for name, (arch, _, _, tc) in CASES.items():
        key = _ref_key(name)
        if key not in ref:
            ref[key] = _jrun(arch, dict(TC, **tc), 3)
    shared = {"train": {n: ref[_ref_key(n)][0] for n in CASES}}
    out = ranks.start(4, jobs, shared).results()
    by_job = {}
    for r, res in out.items():
        for name, v in res.items():
            assert "error" not in v, f"rank {r}, {name}:\n{v['error']}"
            by_job.setdefault(name, {})[r] = v
    return by_job, ref


@pytest.mark.parametrize("name", sorted(CASES))
def test_kind_trains_as_the_reference(run, name):
    jobs, ref = run
    arch, mesh, _, tc = CASES[name]
    want = ref[_ref_key(name)][1]
    got = jobs[name]
    assert len(got) == mesh[0] * mesh[1]
    _check(got, want, _jtc(tc), every_step=name in EVERY_STEP)
    if name in MOE_CASES:
        for m, (_, jm) in zip(got[0]["metrics"], want):
            assert m["aux"] > 0
            np.testing.assert_allclose(m["aux"], jm["aux"], **LOSS)


def _one_device(microbatches):
    """The one-device port's 3 bf16 steps from its own draw: (per-step
    metrics, the final state's leaves as numpy, bf16 widened)."""
    from repro_torch.runtime import trainer as tmod
    from repro_torch.tree import leaves
    tc = tmod.TrainerConfig(**dict(TC, microbatches=microbatches))
    tr = tmod.Trainer(ranks.config(ranks.BF16), tc, device="cpu").compile()
    metrics = []
    for step in range(3):
        tr.batch(step)
        metrics.append({k: float(v) for k, v in tr.step().items()})
    return metrics, [ranks._host(t.detach()) for t in leaves(tr.state)]


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_model_axis_of_one_rank_is_the_one_device_step(run, name):
    """In bf16 a model axis of one rank takes the one-device products
    (``layers.dot_rows`` keeps no fp32 partial sum, the cross entropy
    needs no split): on (1,1) every step's metrics and the whole final
    state are the one-device run's bits; on (2,1) the losses of steps 1
    and 2 (lr 0 at step 1, so step 2's forward sees the drawn parameters)
    are the bits of the one-device run with 2 microbatches (the later
    steps differ in the data mean's summation order)."""
    from repro_torch.tree import leaves
    jobs, _ = run
    mesh = BF16_CASES[name]
    got = jobs[name]
    assert len(got) == mesh[0]
    metrics, state = _one_device(mesh[0])
    for r, v in got.items():
        if mesh == (1, 1):
            assert v["metrics"] == metrics
            mine = leaves(v["state"])
            assert len(mine) == len(state)
            bad = [i for i, (a, b) in enumerate(zip(mine, state))
                   if not np.array_equal(a, b)]
            assert not bad, bad[:10]
        else:
            assert [m["loss"] for m in v["metrics"][:2]] == \
                [m["loss"] for m in metrics[:2]], r


@pytest.mark.parametrize("name", sorted(CASES))
def test_replicated_leaves_equal_across_model_ranks(run, name):
    """After every step each leaf replicated over "model" holds the same
    bits on every model rank of a data coordinate (the sum over the axis
    supplied each rank's missing part of its gradient, and counted the
    parts every rank holds once)."""
    jobs, _ = run
    got = jobs[name]
    by_data = {}
    for r, v in got.items():
        by_data.setdefault(v["coords"]["data"], []).append(v["replicas"])
    for data, reps in by_data.items():
        assert len(reps) == CASES[name][1][1]
        for step, first in enumerate(reps[0]):
            assert first, "no replicated leaf"
            for other in reps[1:]:
                bad = [p for p in first if other[step][p] != first[p]]
                assert not bad, (data, step, bad[:5])


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_rank_holds_its_shards(run, name):
    """The local shapes are those the specs give, and the model axis
    splits leaves of every kind (none is held whole on every rank)."""
    jobs, _ = run
    for r, got in jobs[name].items():
        bad = [(p, a, b) for p, a, b, _ in got["shapes"] if a != b]
        assert not bad, (r, bad[:3])
        split = [p for p, a, _, w in got["shapes"]
                 if a != w and "/mixer/" in p]
        assert split, r
    shapes = {p: s for p, s, _, _ in jobs[name][0]["shapes"]}
    if name == "mamba2_1x2":
        # 4 of 8 heads (A_log), w_B replicated (the rank cuts its 16 of
        # 32 d_state columns)
        assert shapes["params/groups/0/0/mixer/A_log"] == (1, 4)
        assert shapes["params/groups/0/0/mixer/w_B"] == (1, 64, 32)
    if name.startswith("mixtral"):
        assert shapes["params/groups/0/0/moe/wi_gate"][1] == 2
    if name == "mixtral_1x2":
        assert shapes["params/groups/0/0/moe/router"] == (1, 64, 4)


def test_mean_over_is_the_serving_mean(run):
    """``comm.mean_over`` over a model axis of 4 is bitwise
    ``all_reduce(x) / 4`` in fp32, with and without a gradient tracked,
    and its gradient is the mean of the ranks' output gradients."""
    jobs, _ = run
    got = jobs["mean_over"]
    assert len(got) == 4
    ws = sorted((v["index"], v["w"]) for v in got.values())
    want = np.mean(np.stack([w for _, w in ws]), axis=0, dtype=np.float32)
    for v in got.values():
        assert v["plain"] and v["tracked"]
        np.testing.assert_allclose(v["grad"], want, rtol=1e-6, atol=1e-7)


def test_every_arch_passes_the_model_axis_check():
    """No kind is refused on a model axis of 2 that divides its dims: the
    trainer's check passes for every registered arch's reduced config, and
    at full width for every arch but minicpm-2b, whose vocab of 122,753 no
    axis divides (ROADMAP item 4e)."""
    from repro_torch import configs as tconfigs
    from repro_torch.parallel import sharding as trules
    for arch in tconfigs.ARCHS:
        trules.check_model_axis(tconfigs.get_arch(arch).reduced(), 2)
        full = tconfigs.get_arch(arch)
        if arch == "minicpm-2b":
            with pytest.raises(ValueError, match="vocab.*item 4e"):
                trules.check_model_axis(full, 2)
        else:
            trules.check_model_axis(full, 2)
