"""The port's serving mesh for the MoE FFN, against the live JAX
reference, on the CPU over gloo: reduced fp32 mixtral-8x7b (staged per
prompt by the MoE gate) and arctic-480b on the reference's parameters
through the numpy bridge, two spawned ranks.

The data axis, on the (2,1) mesh (mixtral), down every serving path of
``tests/torch_mesh_reference.py``, bitwise the reference's one-device
engine.  Expert parallelism, on the (1,2) mesh: each rank holds half the
experts and routes every token alike, mixtral's MoE and arctic's MoE
beside its column/row-parallel dense MLP summed by one all-reduce:
placements by the reference's rules, greedy streams equal, a ragged
prefill's hidden states and a decode step's logits within the
reference's 2e-4.  ``lm.init_lm(..., mesh=)`` draws a rank's shards
alone, bitwise the cut of the one-device draw, and an engine takes them.
Then the serve CLI's ``--mesh`` starts its own ranks, or mesh workers
behind a router (``--rpc``; ``--workers 2 --roles prefill,decode``), and
prints the one-engine run's streams.
"""
import re

import pytest

torch = pytest.importorskip("torch")

import torch_mesh_reference as mref                       # noqa: E402
from repro_torch.launch import serve                      # noqa: E402

ARCH = "mixtral-8x7b"
MODEL_ARCHS = (ARCH, "arctic-480b")
DRAW = dict(name="draw_1x2", kind="draw", mesh=(1, 2), arch="arctic-480b",
            engine=mref.ENGINE)


@pytest.fixture(scope="module")
def run():
    torch.set_num_threads(1)
    return mref.run((ARCH,), model_archs=MODEL_ARCHS, extra_jobs=[DRAW])


@pytest.mark.parametrize("path", sorted(mref.PATHS))
def test_data_axis_streams_equal_the_reference(run, path):
    mref.check(run, ARCH, path)


def test_moe_stages_per_prompt_on_the_mesh(run):
    _, out, _ = run
    assert out[0][f"{ARCH}/default"]["metrics"]["prefill_batching"] == 0


@pytest.mark.parametrize("check", ["placements", "streams", "numerics"])
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_expert_parallelism_matches_the_reference(run, arch, check):
    mref.check_model(run, arch, (1, 2), check)


def test_init_lm_draws_a_ranks_shards_alone(run):
    """Each rank's draw holds its 2 of the 4 experts, bitwise the cut of
    the one-device draw; an engine serves from it."""
    _, out, _ = run
    for r in range(2):
        got = out[r]["draw_1x2"]
        assert got["leaves"] > 0 and got["equal"], r
        assert got["expert_rows"][:2] == (1, 2)
        assert got["tokens"] == 3


def _streams(text):
    return re.findall(r"req (\d+): .* toks: (\[.*\])", text)


CLI = ["--arch", "qwen3-next-gdn", "--requests", "4", "--max-new", "5",
       "--max-len", "64", "--kernels", "--device", "cpu"]
_PLAIN = {}


def _plain(capfd):
    """The one-engine run's output (``--slots 4``), run once."""
    if not _PLAIN:
        serve.main(CLI + ["--slots", "4"])
        _PLAIN["out"] = capfd.readouterr().out
    return _PLAIN["out"]


def test_serve_cli_mesh(capfd):
    """``--mesh 2,1`` on the CPU starts two gloo ranks and prints the
    one-engine run's streams (an odd ``--slots`` padded to the data
    axis); ``--mesh`` with ``--rpc`` serves the mesh from a worker behind
    the router and prints them too."""
    plain = _plain(capfd)
    serve.main(CLI + ["--slots", "3", "--mesh", "data=2,model=1"])
    mesh = capfd.readouterr().out
    assert "--slots 3 padded to 4" in mesh
    assert "mesh: data=2 x model=1, 2 gloo ranks on cpu" in mesh
    assert len(_streams(plain)) == 4 and _streams(mesh) == _streams(plain)
    serve.main(CLI + ["--slots", "4", "--mesh", "2,1", "--rpc"])
    rpc = capfd.readouterr().out
    assert "topology: 1 worker process(es) on cpu, each a 2x1 gloo mesh" \
        in rpc
    assert _streams(rpc) == _streams(plain)


def test_serve_cli_mesh_workers_prefill_decode(capfd):
    """``--workers 2 --roles prefill,decode --mesh 1,2``: two (1,2) mesh
    workers, one prefilling and one decoding, print the one-engine run's
    streams and one handoff per request."""
    plain = _plain(capfd)
    serve.main(CLI + ["--slots", "4", "--workers", "2", "--roles",
                      "prefill,decode", "--mesh", "1,2"])
    out = capfd.readouterr().out
    assert "topology: 2 worker process(es) on cpu, each a 1x2 gloo mesh" \
        in out
    assert "roles=prefill,decode" in out
    assert "4 prefill→decode handoffs" in out
    assert len(_streams(plain)) == 4 and _streams(out) == _streams(plain)
