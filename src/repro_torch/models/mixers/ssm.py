"""ssm mixer kind — Mamba-2 / SSD, wrapping ``repro_torch.models.ssm``."""
from __future__ import annotations

from repro_torch import device as _device
from repro_torch.models import ssm as ssm_layer
from repro_torch.models.mixers import register
from repro_torch.models.mixers.base import (ArraySpec, CacheSpec,
                                            SequenceMixer, act_bytes,
                                            state_dtype)

_CONV_W = ssm_layer.CONV_WIDTH


@register
class SSD(SequenceMixer):
    kind = "ssm"
    supports_ragged_prefill = True
    supports_batched_ragged_prefill = True   # per-row (B,) valid_len
    state_passes = 2           # S <- g*S + B x^T : one read + one write

    @classmethod
    def _dims(cls, cfg):
        return dict(d_inner=cfg.ssm_d_inner, headdim=cfg.ssm_headdim,
                    d_state=cfg.ssm_d_state)

    @classmethod
    def init_params(cls, generator, cfg, dtype, device, reps):
        return ssm_layer.init_ssm(generator, cfg.d_model, cfg.ssm_d_inner,
                                  cfg.ssm_headdim, cfg.ssm_d_state, dtype,
                                  device, reps)

    @classmethod
    def train(cls, params, cfg, x):
        return ssm_layer.ssm_train(params, x, **cls._dims(cfg))

    @classmethod
    def prefill(cls, params, cfg, x, cache):
        return ssm_layer.ssm_prefill(params, x, cache, **cls._dims(cfg),
                                     use_pallas=cfg.use_pallas_serving)

    @classmethod
    def prefill_chunk(cls, params, cfg, x, cache, valid_len=None):
        # ragged chunks: S masked in the kernel / pre-masked inputs, conv
        # carries gathered at the valid boundary
        return ssm_layer.ssm_prefill(params, x, cache, **cls._dims(cfg),
                                     use_pallas=cfg.use_pallas_serving,
                                     valid_len=valid_len)

    @classmethod
    def decode(cls, params, cfg, x_t, cache):
        return ssm_layer.ssm_decode(params, x_t, cache, **cls._dims(cfg),
                                    use_pallas=cfg.use_pallas_serving)

    @classmethod
    def decode_flops(cls, cfg, seq):
        nheads = cfg.ssm_d_inner // cfg.ssm_headdim
        return nheads * 5.0 * cfg.ssm_d_state * cfg.ssm_headdim

    @classmethod
    def decode_token_bytes(cls, cfg):
        nheads = cfg.ssm_d_inner // cfg.ssm_headdim
        return nheads * (2 * cfg.ssm_d_state
                         + 2 * cfg.ssm_headdim) * act_bytes(cfg)

    @classmethod
    def param_count(cls, cfg):
        d = cfg.d_model
        return (d * cfg.ssm_d_inner * 3 + 2 * d * cfg.ssm_d_state
                + d * (cfg.ssm_d_inner // cfg.ssm_headdim))

    @classmethod
    def cache_spec(cls, cfg, batch, max_len):
        nheads = cfg.ssm_d_inner // cfg.ssm_headdim
        act = _device.dtype(cfg.act_dtype)
        return CacheSpec(ssm_layer.SSMState(
            S=ArraySpec((batch, nheads, cfg.ssm_d_state, cfg.ssm_headdim),
                        state_dtype(cfg), "state"),
            conv_x=ArraySpec((batch, _CONV_W - 1, cfg.ssm_d_inner), act,
                             "state"),
            conv_B=ArraySpec((batch, _CONV_W - 1, cfg.ssm_d_state), act,
                             "state"),
            conv_C=ArraySpec((batch, _CONV_W - 1, cfg.ssm_d_state), act,
                             "state")))
