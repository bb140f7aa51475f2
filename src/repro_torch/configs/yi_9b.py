"""yi-9b — llama-arch GQA dense.

[arXiv:2403.04652; hf]  48L d_model=4096 32H (GQA kv=4) d_ff=11008
vocab=64000, head_dim=128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    vocab=64000,
    d_model=4096,
    n_layers=48,
    pattern=("attn",),
    ffn="dense",
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    subquadratic=False,
    notes="kv=4 < model-axis size: decode KV cache shards over the cache "
          "length dim instead of heads. long_500k skipped (full attention).",
)
