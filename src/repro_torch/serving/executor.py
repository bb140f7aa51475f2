"""Device executor: the serving engine's device buffers and programs (port
of the base tick of ``repro.serving.executor``).

The executor owns

  * the **slot buffers** — every layer's recurrent state / KV cache with a
    leading slot axis, the per-slot sampler tensors and the per-slot last
    tokens.  They are allocated once and updated in place by every
    program: that is the port's form of the reference's buffer donation;
  * the **staging ring** — ``staging_depth`` single-sequence cache trees
    that chunked prefill streams into while the resident slots decode,
    each copied into a real slot only once its staging completes;
  * the **programs** — eager PyTorch over those buffers:
    - ``decode(k)``: ``lm.decode_steps``, k fused decode+sample steps with
      one host sync (the (k, slots) token read);
    - ``stage_chunk_scan`` / ``stage_admit``: masked chunked prefill into a
      staging cache (``plan_prefill``), the admit fusing the first-token
      draw on the device (``lm.prefill_sample``);
    - ``scatter(slot, buf)``: copy a staging cache + sampler row + first
      token into ``slot``.  Staging buffers never alias slot buffers.

Deferred to later slices (each raises ``NotImplementedError`` naming its
ROADMAP item): ``plan_mode="pow2"``, ``prefill_batching=True``, ``mesh``,
speculative decode (draft models) and async paging.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.serving import sampling
from repro_torch.tree import leaves


class PlanStep(NamedTuple):
    """One prefill dispatch (see the reference's ``PlanStep``).

    kind   : "scan" (m full chunks) | "admit" (final chunk + fused draw)
    size   : chunk count m for "scan", token capacity for "admit"
    tokens : valid prompt tokens consumed by this step
    valid  : "scan": (m,) per-chunk valid lengths (0 = placeholder chunk);
             "admit": valid tokens of the fixed-size tail
    """
    kind: str
    size: int
    tokens: int
    valid: Optional[Any] = None


# cap on chunks per scan dispatch (keeps the prefill/decode overlap granular)
_MAX_SCAN_CHUNKS = 4


def deferred(what: str, item: str):
    """The error for a setting this slice of the port does not implement."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1, {item})")


class DeviceExecutor:
    """Owns the device buffers and programs of one decode engine."""

    def __init__(self, cfg: ArchConfig, params, *, max_slots: int,
                 max_len: int, decode_block: int, prefill_chunk: int = 16,
                 mesh=None, staging_depth: int = 2,
                 plan_mode: str = "masked",
                 prefill_batching: Optional[bool] = None,
                 draft_cfg: Optional[ArchConfig] = None, draft_params=None,
                 async_paging: bool = False, device=None):
        if plan_mode == "pow2":
            raise deferred("plan_mode='pow2'", "item 8 (pow2 plans)")
        if plan_mode != "masked":
            raise ValueError(f"plan_mode must be 'masked' or 'pow2', "
                             f"got {plan_mode!r}")
        if prefill_batching:
            raise deferred("prefill_batching=True",
                           "item 8 (batched staging)")
        if mesh is not None:
            raise deferred("mesh", "item 11 (multi-device)")
        if draft_cfg is not None or draft_params is not None:
            raise deferred("speculative decode (draft model)",
                           "item 10 (speculative decode)")
        if async_paging:
            raise deferred("async_paging", "item 10 (state paging)")
        if staging_depth < 1:
            raise ValueError(
                f"staging_depth must be >= 1, got {staging_depth}")
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if prefill_chunk > max_len:
            raise ValueError(
                f"prefill_chunk={prefill_chunk} exceeds max_len={max_len}: "
                f"a prefill chunk can never hold more tokens than the "
                f"context buffers — lower prefill_chunk or raise max_len")
        self.device = _device.resolve(device)
        self.prefill_batching = False
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.decode_block = decode_block
        self.mesh = None
        self.staging_depth = staging_depth
        self.plan_mode = plan_mode
        limit = min(max_len, cfg.window) if cfg.window else max_len
        self.prefill_chunk = min(prefill_chunk, limit)

        self.spec = lm.cache_specs(cfg, max_slots, max_len)
        slot_spec = lm.cache_specs(cfg, 1, max_len)
        self.state_bytes_per_slot = slot_spec.state_bytes
        self.window_bytes_per_slot = slot_spec.window_bytes
        self.cache_bytes = self.spec.nbytes

        for t in leaves(params):
            if t.device != self.device:
                raise ValueError(f"params live on {t.device}, the executor "
                                 f"on {self.device}")
        self.params = params
        self.caches = self.spec.zeros(self.device)
        self.tokens = torch.zeros((max_slots,), dtype=torch.int32,
                                  device=self.device)
        self.sampler = sampling.init_state(max_slots, self.device)
        # host mirror of each slot's temperature: a tick runs the stochastic
        # sampling pipeline only when some slot may draw (see sampling.sample)
        self._slot_temp = np.zeros((max_slots,), np.float32)

        self.staging: List[Any] = [lm.init_caches(cfg, 1, max_len,
                                                  self.device)
                                   for _ in range(staging_depth)]
        self._staging_clean = [True] * staging_depth
        self._staging_args: List[Optional[tuple]] = [None] * staging_depth
        self.staging_row: List[Any] = [None] * staging_depth
        self.staging_tok: List[Optional[torch.Tensor]] = [None] * staging_depth

    # ------------------------------------------------------------- plans
    def plan_prefill(self, length: int) -> List[PlanStep]:
        """Masked plan: full chunks run under one scan shape m (the
        balanced chunk count <= ``_MAX_SCAN_CHUNKS``; the last dispatch pads
        with valid_len = 0 placeholder chunks), and the ragged tail is one
        fixed-size masked admit chunk."""
        if length < 1:
            raise ValueError(f"cannot prefill an empty prompt ({length})")
        C = self.prefill_chunk
        tail = (length - 1) % C + 1
        n_full = (length - tail) // C
        steps: List[PlanStep] = []
        if n_full:
            n_disp = -(-n_full // _MAX_SCAN_CHUNKS)
            m = -(-n_full // n_disp)
            left = n_full
            for _ in range(n_disp):
                r = min(left, m)
                steps.append(PlanStep("scan", m, r * C,
                                      (C,) * r + (0,) * (m - r)))
                left -= r
        steps.append(PlanStep("admit", C, tail, tail))
        return steps

    # ----------------------------------------------------------- staging
    def stage_begin(self, buf: int, *, seed: int, rid: int,
                    temperature: float, top_k: int, top_p: float,
                    eos_id, budget: int):
        """Reset ring buffer ``buf`` and record the request's sampling
        parameters (the 1-row sampler state is built by the admit)."""
        if not self._staging_clean[buf]:
            for t in leaves(self.staging[buf]):
                t.zero_()
        self._staging_clean[buf] = False
        self._staging_args[buf] = (seed, rid, float(temperature), top_k,
                                   float(top_p),
                                   -1 if eos_id is None else eos_id, budget)
        self.staging_row[buf] = None
        self.staging_tok[buf] = None

    def _as_chunk(self, chunk, lead_shape, pad_to: int = 0):
        """Flat prompt slice -> device chunk: (n,) int tokens or (n, d)
        float embeds, zero-padded to ``pad_to`` tokens, reshaped to the
        program's layout.  Returns (tensor, is_embeds)."""
        chunk = np.asarray(chunk)
        if pad_to > chunk.shape[0]:
            pad = np.zeros((pad_to - chunk.shape[0],) + chunk.shape[1:],
                           chunk.dtype)
            chunk = np.concatenate([chunk, pad])
        if chunk.dtype.kind == "f":
            x = torch.as_tensor(chunk.astype(np.float32), device=self.device)
            x = x.to(_device.dtype(self.cfg.act_dtype))
            return x.reshape(*lead_shape, x.shape[-1]), True
        x = torch.as_tensor(chunk.astype(np.int64), device=self.device)
        return x.reshape(lead_shape), False

    def stage_chunk_scan(self, buf: int, chunks, valid_lens):
        """Advance ring buffer ``buf`` by m = len(valid_lens) chunks; the
        flat slice holds sum(valid_lens) tokens, zero-padded into (m, C)."""
        C = self.prefill_chunk
        m = len(valid_lens)
        x, is_embeds = self._as_chunk(chunks, (1, m, C), pad_to=m * C)
        kw = "embeds" if is_embeds else "tokens"
        self.staging[buf] = lm.prefill_chunk_scan(
            self.params, self.cfg, self.staging[buf],
            valid_lens=tuple(int(v) for v in valid_lens), **{kw: x})

    def stage_admit(self, buf: int, chunk, valid_len: int) -> torch.Tensor:
        """Final chunk (zero-padded to ``prefill_chunk``) + fused on-device
        first-token draw from the last valid position.  Returns the (1,)
        token tensor (still on the device) and keeps the advanced sampler
        row for the slot scatter."""
        s = self.prefill_chunk
        x, is_embeds = self._as_chunk(chunk, (1, s), pad_to=s)
        seed, rid, temp, top_k, top_p, eos, budget = self._staging_args[buf]
        row = sampling.admit_row(seed, rid, temp, top_k, top_p, eos, budget,
                                 device=self.device)

        def sample_fn(st, logits):
            return sampling.sample(st, logits, stochastic=temp > 0.0)

        kw = "embeds" if is_embeds else "tokens"
        tok, row, self.staging[buf] = lm.prefill_sample(
            self.params, self.cfg, self.staging[buf], row, sample_fn,
            valid_len=int(valid_len), **{kw: x})
        self.staging_tok[buf], self.staging_row[buf] = tok, row
        return tok

    def scatter(self, slot: int, buf: int):
        """Copy ring buffer ``buf``'s completed staging cache + sampler row
        + first token into slot ``slot`` (in place), then mark the ring
        buffer for reset."""
        for dst, src in zip(leaves(self.caches), leaves(self.staging[buf])):
            dst[:, slot].copy_(src[:, 0])
        for k, v in self.sampler.items():
            v[slot].copy_(self.staging_row[buf][k][0])
        self.tokens[slot] = self.staging_tok[buf][0]
        self._slot_temp[slot] = self._staging_args[buf][2]
        for t in leaves(self.staging[buf]):
            t.zero_()
        self._staging_clean[buf] = True
        self.staging_row[buf] = None
        self.staging_tok[buf] = None

    # ------------------------------------------------------------- ticks
    def decode(self, k: int):
        """One fused k-step decode+sample tick over all slots; the single
        host sync reads the (k, slots) token/validity tensors."""
        stochastic = bool((self._slot_temp > 0.0).any())

        def sample_fn(st, logits):
            return sampling.sample(st, logits, stochastic=stochastic)

        toks, valid, self.tokens, self.caches, self.sampler = \
            lm.decode_steps(self.params, self.cfg, self.tokens, self.caches,
                            k, sampler=self.sampler, sample_fn=sample_fn)
        return toks.cpu().numpy(), valid.cpu().numpy()

    def release_slot(self, slot: int):
        """A finished request left ``slot``: its sampler row is done on the
        device already; drop its temperature from the host mirror."""
        self._slot_temp[slot] = 0.0
