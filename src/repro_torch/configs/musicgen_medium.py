"""musicgen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf]  48L d_model=1536 24H (kv=24, MHA) d_ff=6144
vocab=2048, head_dim=64.  EnCodec frontend is a stub: input_specs()
provides precomputed frame embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    vocab=2048,
    d_model=1536,
    n_layers=48,
    pattern=("attn",),
    ffn="dense",
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    n_heads_pad=32,      # TP head padding (exact; ArchConfig.head_mask)
    n_kv_heads_pad=32,
    d_ff=6144,
    frontend_stub="audio",
    subquadratic=False,
    notes="Audio backbone only; EnCodec codebook interleaving stubbed via "
          "embeds input. long_500k skipped (full attention).",
)
