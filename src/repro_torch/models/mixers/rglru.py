"""rglru mixer kind — RG-LRU diagonal vector-state recurrence
(RecurrentGemma), wrapping ``repro_torch.models.rglru``."""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.models import rglru as rglru_layer
from repro_torch.models.mixers import register
from repro_torch.models.mixers.base import (ArraySpec, CacheSpec,
                                            SequenceMixer, act_bytes)

_CONV_W = rglru_layer.CONV_WIDTH


@register
class RGLRU(SequenceMixer):
    kind = "rglru"
    supports_ragged_prefill = True
    supports_batched_ragged_prefill = True   # per-row (B,) valid_len
    state_passes = 2           # h <- a*h + b : one read + one write

    @classmethod
    def init_params(cls, generator, cfg, dtype, device, reps):
        return rglru_layer.init_rglru(generator, cfg.d_model,
                                      cfg.rglru_width, dtype, device, reps)

    @classmethod
    def train(cls, params, cfg, x):
        return rglru_layer.rglru_train(params, x)

    @classmethod
    def prefill(cls, params, cfg, x, cache):
        return rglru_layer.rglru_prefill(params, x, cache)

    @classmethod
    def prefill_chunk(cls, params, cfg, x, cache, valid_len=None):
        # ragged chunks: padded gates forced to identity, conv carry
        # gathered at the valid boundary
        return rglru_layer.rglru_prefill(params, x, cache,
                                         valid_len=valid_len)

    @classmethod
    def decode(cls, params, cfg, x_t, cache):
        return rglru_layer.rglru_decode(params, x_t, cache)

    @classmethod
    def decode_flops(cls, cfg, seq):
        return 8.0 * cfg.rglru_width

    @classmethod
    def decode_token_bytes(cls, cfg):
        return 3 * cfg.rglru_width * act_bytes(cfg)

    @classmethod
    def param_count(cls, cfg):
        d, w = cfg.d_model, cfg.rglru_width
        return 2 * d * w + 2 * w * w + w * d

    @classmethod
    def cache_spec(cls, cfg, batch, max_len):
        # h is fp32 whatever state_dtype says, as in the reference
        return CacheSpec(rglru_layer.RGLRUState(
            h=ArraySpec((batch, cfg.rglru_width), torch.float32, "state"),
            conv=ArraySpec((batch, _CONV_W - 1, cfg.rglru_width),
                           _device.dtype(cfg.act_dtype), "state")))
