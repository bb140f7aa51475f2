"""recurrentgemma-2b — RG-LRU + local attention hybrid (1 attn : 2 rec).

[arXiv:2402.19427; hf]  26L d_model=2560 10H (GQA kv=1, MQA) d_ff=7680
vocab=256000, head_dim=256, local attention window 2048.
26 layers = 8 x (rec, rec, swa) + (rec, rec).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    vocab=256000,
    d_model=2560,
    n_layers=26,
    pattern=("rglru", "rglru", "swa"),
    ffn="dense",
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    n_heads_pad=16,      # MQA: q heads padded to the model axis (exact)
    d_ff=7680,
    window=2048,
    rglru_width=2560,
    subquadratic=True,
    notes="Vector (diagonal) recurrent state: persistence applies, the "
          "matrix-state MXU datapath does not (DESIGN.md "
          "§Arch-applicability). long_500k runs (O(1) state + windowed KV).",
)
