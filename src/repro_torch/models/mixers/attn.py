"""attn / swa mixer kinds — softmax attention over a (possibly rolling)
KV cache, wrapping ``repro_torch.models.attention``."""
from __future__ import annotations

import functools

import torch

from repro_torch import device as _device
from repro_torch.models import attention
from repro_torch.models.mixers import register
from repro_torch.models.mixers.base import (ArraySpec, CacheSpec,
                                            SequenceMixer, act_bytes)


@functools.lru_cache(maxsize=None)
def _head_mask(cfg, device):
    """The config's head mask on ``device``, copied there once: the
    programs that reach it may run inside a CUDA graph capture, which
    refuses a host-to-device copy."""
    if not cfg.n_heads_pad and not cfg.n_kv_heads_pad:
        return None
    return torch.as_tensor(cfg.head_mask(), device=device)


@register
class Attention(SequenceMixer):
    kind = "attn"
    is_attention = True
    supports_ragged_prefill = True
    supports_batched_ragged_prefill = True   # per-row (B,) valid_len
    quadratic = True           # O(T) KV — no fixed-size persistent state
    state_passes = 0

    @classmethod
    def _window(cls, cfg):
        return None

    @classmethod
    def init_params(cls, generator, cfg, dtype, device, reps):
        return attention.init_attention(generator, cfg.d_model, cfg.hq_eff,
                                        cfg.hkv_eff, cfg.head_dim, dtype,
                                        device, reps)

    @classmethod
    def train(cls, params, cfg, x, dims=None):
        return attention.attn_train(params, x, rope_theta=cfg.rope_theta,
                                    window=cls._window(cfg),
                                    use_flash_kernel=cfg.use_flash_kernel,
                                    head_mask=_head_mask(cfg, x.device),
                                    dims=dims)

    @classmethod
    def prefill(cls, params, cfg, x, cache):
        return attention.attn_prefill(params, x, cache,
                                      rope_theta=cfg.rope_theta,
                                      window=cls._window(cfg),
                                      head_mask=_head_mask(cfg, x.device))

    @classmethod
    def prefill_chunk(cls, params, cfg, x, cache, valid_len=None,
                      dims=None):
        # positions and visibility continue from cache.length; ragged
        # chunks skip the rolling insert of padded positions
        return attention.attn_prefill_chunk(params, x, cache,
                                            rope_theta=cfg.rope_theta,
                                            window=cls._window(cfg),
                                            head_mask=_head_mask(cfg,
                                                                 x.device),
                                            valid_len=valid_len,
                                            dims=dims)

    @classmethod
    def decode(cls, params, cfg, x_t, cache, dims=None):
        return attention.attn_decode_xla(params, x_t, cache,
                                         rope_theta=cfg.rope_theta,
                                         window=cls._window(cfg),
                                         head_mask=_head_mask(cfg,
                                                              x_t.device),
                                         dims=dims)

    @classmethod
    def decode_flops(cls, cfg, seq):
        w = cls._window(cfg)
        eff = seq if w is None else min(w, seq)
        return 2.0 * cfg.hq_eff * cfg.head_dim * eff * 2   # qk^T and pv

    @classmethod
    def decode_token_bytes(cls, cfg):
        return (2 * cfg.hq_eff * cfg.head_dim
                + 2 * cfg.hkv_eff * cfg.head_dim) * act_bytes(cfg)

    @classmethod
    def param_count(cls, cfg):
        d = cfg.d_model
        return (d * cfg.head_dim * (cfg.n_heads + 2 * cfg.n_kv_heads)
                + cfg.n_heads * cfg.head_dim * d)

    @classmethod
    def cache_spec(cls, cfg, batch, max_len):
        w = cls._window(cfg)
        size = max_len if w is None else min(w, max_len)
        dtype = _device.dtype(cfg.act_dtype)
        kv = (batch, cfg.hkv_eff, size, cfg.head_dim)
        return CacheSpec(attention.KVCache(
            k=ArraySpec(kv, dtype, "window"),
            v=ArraySpec(kv, dtype, "window"),
            length=ArraySpec((batch,), torch.int32, "meta")))


@register
class SlidingWindowAttention(Attention):
    kind = "swa"
    quadratic = False          # rolling window: O(window) state

    @classmethod
    def _window(cls, cfg):
        return cfg.window
