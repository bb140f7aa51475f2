"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; hf]  24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, head_dim=80, SWA window 4096.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    vocab=32000,
    d_model=2560,
    n_layers=24,
    pattern=("swa",),
    ffn="dense",
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    window=4096,
    subquadratic=True,   # SWA: O(window) KV -> long_500k decode runs
    notes="SWA bounds the KV cache to the 4096-token window: long_500k "
          "decode runs with an O(1)-in-seq-len rolling cache.",
)
