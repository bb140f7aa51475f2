"""minicpm-2b — dense llama-like, MHA, tied embeddings, WSD schedule.

[arXiv:2404.06395; hf]  40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753.
head_dim = 2304 / 36 = 64.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    vocab=122753,
    d_model=2304,
    n_layers=40,
    pattern=("attn",),
    ffn="dense",
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    n_heads_pad=48,      # TP head padding to the 16-wide model axis (exact
    n_kv_heads_pad=48,   # via output masking — see ArchConfig.head_mask)
    d_ff=5760,
    tie_embeddings=True,
    subquadratic=False,
    notes="Trains with the WSD (warmup-stable-decay) schedule "
          "(repro.optim.schedules.wsd). long_500k skipped (full attention).",
)
