"""llava-next-34b — VLM backbone (anyres tiling frontend is a stub).

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000, head_dim=128.
Vision frontend: input_specs() provides precomputed patch embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    vocab=64000,
    d_model=7168,
    n_layers=60,
    pattern=("attn",),
    ffn="dense",
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    n_heads_pad=64,      # GQA group 7 -> 8 (one pad head per kv group;
                         # exact via ArchConfig.head_mask)
    d_ff=20480,
    rope_theta=1e6,
    frontend_stub="vision",
    subquadratic=False,
    notes="VLM backbone only; anyres patch embeddings stubbed via embeds "
          "input. long_500k skipped (pure full attention).",
)
