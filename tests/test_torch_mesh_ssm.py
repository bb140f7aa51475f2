"""The port's serving mesh for the ``ssm`` kind (and h2o-danube-1.8b's
``swa`` on the model axis), against the live JAX reference, on the CPU
over gloo: reduced fp32 configs on the reference's parameters through the
numpy bridge, four spawned ranks.

The data axis, on the (2,1) mesh: the default batched staging, pow2
plans, self-draft speculative decode and sync and async pause/resume with
a prefetch hit, on requests that both draw and take the argmax, bitwise
the reference's one-device engine (``tests/torch_mesh_reference.py``).
The model axis, on the (1,2) mesh (heads, the d_state slices of the B/C
conv carries gathered before the GDN kernels' plain versions, the RMSNorm
over the split d_inner), and on the (2,2) mesh: placements by the
reference's rules, the greedy streams equal, a ragged prefill's hidden
states and a decode step's logits within the reference's 2e-4.
h2o-danube-1.8b's grouped KV heads and rolling window on the (1,2) mesh,
its prompts past the 32-token window, the same way.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_reference as mref                       # noqa: E402

ARCHS = ("mamba2-1.3b",)
MODEL_ARCHS = ("mamba2-1.3b", "h2o-danube-1.8b")


@pytest.fixture(scope="module")
def run():
    torch.set_num_threads(1)
    return mref.run(ARCHS, model_archs=MODEL_ARCHS, world=4,
                    extra_jobs=mref.model_jobs("mamba2-1.3b", (2, 2)))


@pytest.mark.parametrize("path", sorted(mref.PATHS))
@pytest.mark.parametrize("arch", ARCHS)
def test_data_axis_streams_equal_the_reference(run, arch, path):
    mref.check(run, arch, path)


@pytest.mark.parametrize("check", ["placements", "streams", "numerics"])
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_model_axis_matches_the_reference(run, arch, check):
    mref.check_model(run, arch, (1, 2), check)


@pytest.mark.parametrize("check", ["placements", "streams", "numerics"])
def test_data_and_model_axes_together(run, check):
    mref.check_model(run, "mamba2-1.3b", (2, 2), check)
