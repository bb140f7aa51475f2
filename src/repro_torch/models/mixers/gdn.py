"""gdn mixer kind — Gated DeltaNet, the paper's primitive, wrapping
``repro_torch.models.gdn_layer``."""
from __future__ import annotations

from repro_torch.models import gdn_layer
from repro_torch.models.mixers import register
from repro_torch.models.mixers.base import (ArraySpec, CacheSpec,
                                            SequenceMixer, act_bytes,
                                            state_dtype)


@register
class GatedDeltaNet(SequenceMixer):
    kind = "gdn"
    supports_ragged_prefill = True
    supports_batched_ragged_prefill = True   # per-row (B,) valid_len
    state_passes = 2           # fused Alg. 2: one read + one write pass
    fused = True               # decode algorithm (Alg. 2 vs Alg. 1)

    @classmethod
    def init_params(cls, generator, cfg, dtype, device, reps):
        return gdn_layer.init_gdn(generator, cfg.d_model, cfg.gdn_k_heads,
                                  cfg.gdn_v_heads, cfg.gdn_head_dim, dtype,
                                  device, reps)

    @classmethod
    def train(cls, params, cfg, x):
        return gdn_layer.gdn_train(params, x)

    @classmethod
    def prefill(cls, params, cfg, x, cache):
        return gdn_layer.gdn_prefill(params, x, cache,
                                     use_pallas=cfg.use_pallas_serving)

    @classmethod
    def prefill_chunk(cls, params, cfg, x, cache, valid_len=None):
        return gdn_layer.gdn_prefill(params, x, cache,
                                     use_pallas=cfg.use_pallas_serving,
                                     valid_len=valid_len)

    @classmethod
    def decode(cls, params, cfg, x_t, cache):
        return gdn_layer.gdn_decode(params, x_t, cache,
                                    use_pallas=cfg.use_pallas_serving,
                                    fused=cls.fused)

    @classmethod
    def decode_flops(cls, cfg, seq):
        d = cfg.gdn_head_dim
        return cfg.gdn_v_heads * (7.0 * d * d + 8.0 * d)

    @classmethod
    def decode_token_bytes(cls, cfg):
        d = cfg.gdn_head_dim
        return (2 * cfg.gdn_k_heads * d + 2 * cfg.gdn_v_heads * d
                + 2 * cfg.gdn_v_heads) * act_bytes(cfg)

    @classmethod
    def param_count(cls, cfg):
        d, hd = cfg.d_model, cfg.gdn_head_dim
        return (d * hd * (2 * cfg.gdn_k_heads + cfg.gdn_v_heads)
                + cfg.gdn_v_heads * hd * d + 2 * d * cfg.gdn_v_heads)

    @classmethod
    def cache_spec(cls, cfg, batch, max_len):
        hd = cfg.gdn_head_dim
        return CacheSpec(gdn_layer.GDNState(
            S=ArraySpec((batch, cfg.gdn_v_heads, hd, hd), state_dtype(cfg),
                        "state")))
