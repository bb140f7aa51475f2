"""mixtral-8x7b — MoE 8 experts top-2, GQA, sliding-window attention.

[arXiv:2401.04088; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, head_dim=128, 8e top-2, SWA window 4096.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    vocab=32000,
    d_model=4096,
    n_layers=32,
    pattern=("swa",),
    ffn="moe",
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    moe_experts=8,
    moe_top_k=2,
    moe_group_size=1024,
    window=4096,
    rope_theta=1e6,
    subquadratic=True,   # SWA per assignment -> long_500k runs
    notes="8-way EP on the model axis (2-way TP inside each expert). "
          "SWA window bounds the KV cache for long_500k decode.",
)
