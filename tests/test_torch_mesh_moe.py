"""The data axis of the port's serving mesh for the MoE FFN, against the
live JAX reference's one-device engine, on the CPU over gloo: reduced
fp32 mixtral-8x7b (staged per prompt by the MoE gate) on the (2,1) mesh
of two spawned ranks, down every serving path of
``tests/torch_mesh_reference.py``.  Then the serve CLI's ``--mesh``
starts its own ranks and prints the one-engine run's streams.
"""
import re

import pytest

torch = pytest.importorskip("torch")

import torch_mesh_reference as mref                       # noqa: E402
from repro_torch.launch import serve                      # noqa: E402

ARCH = "mixtral-8x7b"


@pytest.fixture(scope="module")
def run():
    torch.set_num_threads(1)
    return mref.run((ARCH,))


@pytest.mark.parametrize("path", sorted(mref.PATHS))
def test_data_axis_streams_equal_the_reference(run, path):
    mref.check(run, ARCH, path)


def test_moe_stages_per_prompt_on_the_mesh(run):
    _, out = run
    assert out[0][f"{ARCH}/default"]["metrics"]["prefill_batching"] == 0


def _streams(text):
    return re.findall(r"req (\d+): .* toks: (\[.*\])", text)


def test_serve_cli_mesh(capfd):
    """``--mesh 2,1`` on the CPU starts two gloo ranks and prints the
    one-engine run's streams (an odd ``--slots`` padded to the data
    axis); ``--mesh`` with ``--rpc`` raises naming ROADMAP's item."""
    argv = ["--arch", "qwen3-next-gdn", "--requests", "4", "--max-new", "5",
            "--max-len", "64", "--kernels", "--device", "cpu"]
    serve.main(argv + ["--slots", "4"])
    plain = capfd.readouterr().out
    serve.main(argv + ["--slots", "3", "--mesh", "data=2,model=1"])
    mesh = capfd.readouterr().out
    assert "--slots 3 padded to 4" in mesh
    assert "mesh: data=2 x model=1, 2 gloo ranks on cpu" in mesh
    assert len(_streams(plain)) == 4 and _streams(mesh) == _streams(plain)
    with pytest.raises(NotImplementedError, match="item 4d"):
        serve.main(argv + ["--mesh", "2,1", "--rpc"])
