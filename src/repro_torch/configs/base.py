"""Architecture config schema.

The PyTorch port's own copy of ``ArchConfig`` from ``repro.configs.base``:
every field, default, property and ``reduced()`` rule is identical, so a config converts one to
one between the two packages (``dataclasses.asdict`` equality is tested).
The unified hybrid LM in ``repro_torch.models.lm`` consumes it directly;
``reduced()`` produces the small same-family config of the CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    vocab: int
    d_model: int
    n_layers: int
    pattern: Tuple[str, ...]          # mixer kinds, cycled over layers
    ffn: str = "dense"                # dense | moe | moe+dense | none
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    # TP head padding: heads are padded (with zero weights + a static output
    # mask — mathematically exact) up to a multiple of the model axis so
    # attention shards by head instead of head_dim (head_dim sharding makes
    # every score block an all-reduce — measured 687 GB/device on
    # recurrentgemma prefill_32k, EXPERIMENTS.md §Perf i5). 0 = no padding.
    n_heads_pad: int = 0
    n_kv_heads_pad: int = 0
    window: Optional[int] = None      # sliding-window size for "swa" mixers
    rope_theta: float = 10000.0
    # ffn
    d_ff: int = 0
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_group_size: int = 1024
    moe_capacity_factor: float = 1.25
    d_ff_dense: int = 0               # arctic's parallel dense-residual MLP
    # gdn (paper layer)
    gdn_k_heads: int = 0
    gdn_v_heads: int = 0
    gdn_head_dim: int = 0
    # ssm (mamba2)
    ssm_d_inner: int = 0
    ssm_headdim: int = 0
    ssm_d_state: int = 0
    # rglru (recurrentgemma)
    rglru_width: int = 0
    # misc
    tie_embeddings: bool = False
    frontend_stub: Optional[str] = None   # vision | audio (embeds stand-ins)
    subquadratic: bool = False            # long_500k decode applicable
    norm_eps: float = 1e-6
    act_dtype: str = "bfloat16"
    state_dtype: str = "float32"      # recurrent-state dtype (paper: fp32);
                                      # "bfloat16" = beyond-paper traffic cut
    use_flash_kernel: bool = False    # Pallas flash attention for train
    use_pallas_serving: bool = False  # Pallas fused kernels in prefill/decode
    remat: bool = True
    notes: str = ""

    # ------------------------------------------------------------------
    @property
    def hq_eff(self) -> int:
        return self.n_heads_pad or self.n_heads

    @property
    def hkv_eff(self) -> int:
        return self.n_kv_heads_pad or self.n_kv_heads

    def head_mask(self):
        """(hq_eff,) float mask — 1 for real heads, 0 for TP padding.
        Padding is interleaved per GQA group so the q->kv mapping of real
        heads is unchanged."""
        import numpy as np
        hq, hkv = self.hq_eff, self.hkv_eff
        g_pad = hq // hkv
        g_real = (self.n_heads // self.n_kv_heads
                  if self.n_kv_heads else g_pad)
        h = np.arange(hq)
        real = ((h % g_pad) < g_real) & ((h // g_pad) < self.n_kv_heads)
        return real.astype(np.float32)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        reps = -(-self.n_layers // len(self.pattern))
        return (self.pattern * reps)[: self.n_layers]

    @property
    def uses_attention(self) -> bool:
        """Any softmax-attention mixer in the pattern (per the registry's
        declarative `is_attention` flag — new kinds classify themselves)."""
        from repro_torch.models.mixers import get_mixer
        return any(get_mixer(k).is_attention for k in self.layer_kinds)

    @property
    def pure_full_attention(self) -> bool:
        """True when every mixer has O(n) decode state (unwindowed softmax
        attention) — no fixed-size persistent state anywhere."""
        from repro_torch.models.mixers import get_mixer
        return all(get_mixer(k).quadratic for k in self.layer_kinds)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=len(self.pattern),
            d_model=64,
            vocab=256,
            act_dtype="float32",
            remat=False,
            n_heads_pad=0,
            n_kv_heads_pad=0,
        )
        if self.n_heads:
            kw.update(n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
                      head_dim=16)
            if self.n_kv_heads == self.n_heads:   # preserve MHA structure
                kw["n_kv_heads"] = 4
        if self.window:
            kw["window"] = 32
        if self.d_ff:
            kw["d_ff"] = 128
        if self.d_ff_dense:
            kw["d_ff_dense"] = 128
        if self.moe_experts:
            kw.update(moe_experts=4, moe_group_size=64)
        if self.gdn_v_heads:
            kw.update(gdn_k_heads=2, gdn_v_heads=4, gdn_head_dim=16)
        if self.ssm_d_inner:
            kw.update(ssm_d_inner=128, ssm_headdim=16, ssm_d_state=32)
        if self.rglru_width:
            kw.update(rglru_width=64)
        return self.replace(**kw)


@dataclass(frozen=True)
class ServingTopology:
    """Mesh topology of one serving engine (the reference's
    ``ServingTopology``): slot-axis data parallelism plus head/context
    tensor parallelism, the paper's head-parallelism axis scaled out.

    ``data``  shards the engine's slot axis (slot counts must be a
    multiple — ``pad_slots`` rounds up);
    ``model`` shards GDN state heads and the attention KV context dim;
    ``staging_depth`` is the executor's staging-ring size.  In the port
    each mesh device is one ``torch.distributed`` rank."""
    data: int = 1
    model: int = 1
    staging_depth: int = 2

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.data, self.model)

    @property
    def axes(self) -> Tuple[str, str]:
        return ("data", "model")

    @property
    def devices(self) -> int:
        return self.data * self.model

    def pad_slots(self, slots: int) -> int:
        """Round a slot count up to a multiple of the data-axis size so the
        slot axis shards evenly."""
        return -(-slots // self.data) * self.data

    @classmethod
    def parse(cls, text: str, *, staging_depth: int = 2
              ) -> "ServingTopology":
        """Parse a ``--mesh`` flag: "4,2" or "data=4,model=2"."""
        parts = [p.strip() for p in text.split(",") if p.strip()]
        try:
            if any("=" in p for p in parts):
                kv = dict(p.split("=", 1) for p in parts)
                data, model = int(kv.pop("data", 1)), int(kv.pop("model", 1))
                if kv:
                    raise ValueError(f"unknown mesh axes {sorted(kv)}")
            else:
                if len(parts) != 2:
                    raise ValueError("expected two axis sizes")
                data, model = int(parts[0]), int(parts[1])
        except ValueError as e:
            raise ValueError(
                f"--mesh must be 'DATA,MODEL' or 'data=D,model=M', got "
                f"{text!r} ({e})") from None
        if data < 1 or model < 1:
            raise ValueError(f"mesh axis sizes must be >= 1, got "
                             f"data={data}, model={model}")
        return cls(data=data, model=model, staging_depth=staging_depth)


@dataclass(frozen=True)
class ShapeConfig:
    """One benchmark cell's shape (the reference's ``ShapeConfig``)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs; reason when skipped."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: O(n) KV at 500k ctx is "
                       "quadratic-cost/unbounded-memory; skipped per "
                       "assignment (see DESIGN.md)")
    return True, ""
