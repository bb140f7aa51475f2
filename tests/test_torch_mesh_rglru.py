"""The port's serving mesh for the ``rglru`` and ``swa`` kinds, against
the live JAX reference, on the CPU over gloo: reduced fp32
recurrentgemma-2b and h2o-danube-1.8b, their prompts past the 32-token
window, on the reference's parameters through the numpy bridge, four
spawned ranks.

The data axis, on the (2,1) mesh (recurrentgemma): the default batched
staging, pow2 plans, self-draft speculative decode and sync and async
pause/resume with a prefetch hit, on requests that both draw and take the
argmax, bitwise the reference's one-device engine
(``tests/torch_mesh_reference.py``).  The model axis, on the (1,2) mesh:
recurrentgemma's RG-LRU width (the post-conv input gathered for the
gates) and its MQA attention, whose one KV head ``fit_spec`` splits on
head_dim (gathered before RoPE), over a rolling window split by context:
placements by the reference's rules, greedy streams equal, a ragged
prefill's hidden states and a decode step's logits within the
reference's 2e-4; the same on the (1,4) mesh; and a (1,2) swap image
restored into a one-device engine.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_reference as mref                       # noqa: E402
from repro_torch.bridge import to_torch                   # noqa: E402
from repro_torch.serving.engine import DecodeEngine       # noqa: E402

ARCHS = ("recurrentgemma-2b",)
SWAP = dict(name="swap_1x2", kind="swap", mesh=(1, 2),
            arch="recurrentgemma-2b", engine=mref.ENGINE, reqs="mixed")


@pytest.fixture(scope="module")
def run():
    torch.set_num_threads(1)
    return mref.run(ARCHS, model_archs=ARCHS, world=4, extra_jobs=[
        SWAP, *mref.model_jobs("recurrentgemma-2b", (1, 4))])


@pytest.mark.parametrize("path", sorted(mref.PATHS))
@pytest.mark.parametrize("arch", ARCHS)
def test_data_axis_streams_equal_the_reference(run, arch, path):
    mref.check(run, arch, path)


@pytest.mark.parametrize("check", ["placements", "streams", "numerics"])
@pytest.mark.parametrize("mesh", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_model_axis_matches_the_reference(run, mesh, check):
    mref.check_model(run, "recurrentgemma-2b", mesh, check)


def test_model_axis_head_dim_split_follows_fit_spec(run):
    """recurrentgemma's one KV head does not divide the axis: its
    projections split head_dim, the query heads split as ever."""
    got = run[1][0]["recurrentgemma-2b/tp_1x2"]["param_placements"]
    assert got["groups/0/2/mixer/wk"] == (None, None, None, "model")
    assert got["groups/0/2/mixer/wv"] == (None, None, None, "model")
    assert got["groups/0/2/mixer/wq"] == (None, None, "model", None)


def test_swap_image_from_the_model_axis_into_one_device(run):
    """An image taken on the (1,2) mesh (the same bytes on both ranks)
    restores into a one-device port engine, whose continuation is the
    mesh's."""
    _, out, params = run
    sw = out[0]["swap_1x2"]
    assert sw["image"].nbytes == sw["swap_bytes_per_slot"]
    for a, b in zip(mref.ranks.leaves(out[1]["swap_1x2"]["image"].caches),
                    mref.ranks.leaves(sw["image"].caches)):
        assert a.tobytes() == b.tobytes()
    eng = DecodeEngine(mref.ranks.config("recurrentgemma-2b"),
                       to_torch(params["recurrentgemma-2b"]), device="cpu",
                       **mref.ENGINE)
    ex = eng.executor
    assert ex.swap_bytes_per_slot == sw["swap_bytes_per_slot"]
    ex.restore_slot(1, sw["image"])
    got = []
    while True:
        toks, valid = ex.decode(2)
        got += [int(t) for t, v in zip(toks[:, 1], valid[:, 1]) if v]
        if not valid[-1, 1]:
            break
    assert got == sw["after"]
