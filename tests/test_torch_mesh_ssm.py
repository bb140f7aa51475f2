"""The data axis of the port's serving mesh for the ``ssm`` kind, against
the live JAX reference's one-device engine, on the CPU over gloo: reduced
fp32 mamba2-1.3b on the reference's parameters through the numpy bridge,
on the (2,1) mesh of two spawned ranks: the default batched
staging, pow2 plans, self-draft speculative decode and sync and async
pause/resume with a prefetch hit, on requests that both draw and take the
argmax (``tests/torch_mesh_reference.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_reference as mref                       # noqa: E402

ARCHS = ("mamba2-1.3b",)


@pytest.fixture(scope="module")
def run():
    torch.set_num_threads(1)
    return mref.run(ARCHS)


@pytest.mark.parametrize("path", sorted(mref.PATHS))
@pytest.mark.parametrize("arch", ARCHS)
def test_data_axis_streams_equal_the_reference(run, arch, path):
    mref.check(run, arch, path)
