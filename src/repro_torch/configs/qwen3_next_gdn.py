"""qwen3-next-gdn — the paper's own architecture (Qwen3-Next-style hybrid).

3:1 Gated DeltaNet : full attention (paper Fig. 2), with the GDN layer at
exactly the paper's configuration: h_q = h_k = 16, h_v = 32 (2:1 GVA),
head_dim d = 128 => 32 state matrices of 128x128 = 2 MB/layer fp32.
48 layers = 12 x (gdn, gdn, gdn, attn), d_model=2048.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-next-gdn",
    family="hybrid",
    vocab=32000,
    d_model=2048,
    n_layers=48,
    pattern=("gdn", "gdn", "gdn", "attn"),
    ffn="dense",
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=5504,
    gdn_k_heads=16,
    gdn_v_heads=32,
    gdn_head_dim=128,
    subquadratic=True,
    notes="Paper's own config: GDN decode is the dominant per-token "
          "primitive (36 of 48 layers). The 12 full-attention layers make "
          "long_500k bounded only by their KV; we run long_500k with the "
          "full-attn KV at 500k sharded over the model axis (36 GDN layers "
          "are O(1)).",
)
