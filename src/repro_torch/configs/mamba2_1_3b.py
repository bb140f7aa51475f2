"""mamba2-1.3b — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]  48L d_model=2048 d_ff=0 vocab=50280,
ssm_state=128.  d_inner = 2*d_model = 4096, headdim=64 -> 64 heads.

The paper's technique applies *directly*: SSD decode is the GDN recurrence
without the delta rule (S <- g S + B x^T, y = S^T C), served by the same
fused persistent-state kernel with delta_rule=False.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    vocab=50280,
    d_model=2048,
    n_layers=48,
    pattern=("ssm",),
    ffn="none",
    ssm_d_inner=4096,
    ssm_headdim=64,
    ssm_d_state=128,
    subquadratic=True,
    notes="O(1) state: long_500k decode state = 64 heads x 128 x 64 fp32 "
          "= 2 MB/layer — the paper's persistent-state regime exactly.",
)
