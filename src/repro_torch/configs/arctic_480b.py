"""arctic-480b — 128-expert top-2 MoE with a parallel dense-residual MLP.

[hf:Snowflake/snowflake-arctic-base; hf]  35L d_model=7168 56H (GQA kv=8)
d_ff=4864 (per expert) vocab=32000, head_dim=128, 128e top-2 + dense residual.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    vocab=32000,
    d_model=7168,
    n_layers=35,
    pattern=("attn",),
    ffn="moe+dense",
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    d_ff_dense=4864,
    moe_experts=128,
    moe_top_k=2,
    moe_group_size=1024,
    subquadratic=False,
    notes="Largest assigned arch (~0.5T params): requires FSDP sharding of "
          "params/optimizer over the data axis on top of 16-way EP+TP, and "
          "factored/bf16 optimizer state to fit v5e HBM. long_500k skipped "
          "(full attention).",
)
