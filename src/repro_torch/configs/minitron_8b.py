"""minitron-8b — pruned nemotron dense GQA.

[arXiv:2407.14679; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000, head_dim=128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    vocab=256000,
    d_model=4096,
    n_layers=32,
    pattern=("attn",),
    ffn="dense",
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    subquadratic=False,
    notes="256k vocab exercises vocab-parallel embedding/logits sharding. "
          "long_500k skipped (full attention).",
)
