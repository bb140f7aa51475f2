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
  * the **programs** — fixed-shape functions over those buffers and the
    static input buffers the executor fills before each call, one per
    shape as the reference compiles one per shape (``compiled_programs``):
    - ``decode(k)``: ``lm.decode_steps``, k fused decode+sample steps with
      one host sync (the (k, slots) token read); one program per (k
      bucket, stochastic);
    - ``stage_chunk_scan`` / ``stage_admit``: masked chunked prefill into a
      staging cache (``plan_prefill``), the admit fusing the first-token
      draw on the device (``lm.prefill_sample``); one program per (ring
      buffer, m, is_embeds) and per (ring buffer, is_embeds, stochastic).
      A placeholder chunk (valid_len 0) runs as the exact no-op it is;
    - ``scatter(slot, buf)``: copy a staging cache + sampler row + first
      token into ``slot`` (eager copies).  Staging buffers never alias
      slot buffers.

On the card each program is captured once into a CUDA graph and replayed
(``runtime.graphs``); on the CPU, or with ``cuda_graphs=False``, it runs
eagerly.  Either way a program writes its results into the executor's
buffers, so every call sees one set of addresses.

Deferred to later slices (each raises ``NotImplementedError`` naming the
reference module that holds it): ``plan_mode="pow2"``,
``prefill_batching=True``, ``mesh``, speculative decode (draft models) and
async paging.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.runtime import graphs
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


def deferred(what: str, module: str):
    """The error for a setting this slice of the port does not implement:
    ``module`` is where the reference package ``repro`` holds it."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: the reference's "
        f"{module} (ROADMAP)")


class DeviceExecutor:
    """Owns the device buffers and programs of one decode engine."""

    def __init__(self, cfg: ArchConfig, params, *, max_slots: int,
                 max_len: int, decode_block: int, prefill_chunk: int = 16,
                 mesh=None, staging_depth: int = 2,
                 plan_mode: str = "masked",
                 prefill_batching: Optional[bool] = None,
                 draft_cfg: Optional[ArchConfig] = None, draft_params=None,
                 async_paging: bool = False, device=None,
                 cuda_graphs: Optional[bool] = None):
        if plan_mode == "pow2":
            raise deferred("plan_mode='pow2'", "serving/executor.py")
        if plan_mode != "masked":
            raise ValueError(f"plan_mode must be 'masked' or 'pow2', "
                             f"got {plan_mode!r}")
        if prefill_batching:
            raise deferred("prefill_batching=True", "serving/executor.py")
        if mesh is not None:
            raise deferred("mesh", "parallel/sharding.py")
        if draft_cfg is not None or draft_params is not None:
            raise deferred("speculative decode (draft model)",
                           "serving/executor.py")
        if async_paging:
            raise deferred("async_paging", "serving/scheduler.py")
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
        on_card = self.device.type == "cuda"
        if cuda_graphs and not on_card:
            raise ValueError(f"cuda_graphs=True needs a CUDA device; the "
                             f"executor is on {self.device}")
        self.cuda_graphs = on_card if cuda_graphs is None else cuda_graphs
        self._pool = (torch.cuda.graph_pool_handle() if self.cuda_graphs
                      else None)
        self._programs: Dict[tuple, graphs.Program] = {}
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
        # per ring buffer: the admit's 1-row sampler state (filled from the
        # host before the admit, advanced by it in place) and first token
        self.staging_row = [sampling.init_state(1, self.device)
                            for _ in range(staging_depth)]
        self.staging_tok = [torch.zeros((1,), dtype=torch.int32,
                                        device=self.device)
                            for _ in range(staging_depth)]
        # the prefill programs' static inputs, one per chunk layout
        self._chunk_in: Dict[tuple, torch.Tensor] = {}
        self._scan_vl: Dict[int, torch.Tensor] = {}
        self._admit_vl = torch.zeros((), dtype=torch.int32,
                                     device=self.device)

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

    # ---------------------------------------------------------- programs
    def _program(self, key: tuple, fn) -> graphs.Program:
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = graphs.Program(fn, self._pool)
        return prog

    def _fill_chunk(self, chunk, shape, pad_to: int) -> tuple:
        """Flat prompt slice -> the static input of its layout: (n,) int
        tokens or (n, d) float embeds, zero-padded to ``pad_to`` tokens,
        as ``shape`` + (d,) for embeds.  Returns (buffer, is_embeds)."""
        chunk = np.asarray(chunk)
        if pad_to > chunk.shape[0]:
            pad = np.zeros((pad_to - chunk.shape[0],) + chunk.shape[1:],
                           chunk.dtype)
            chunk = np.concatenate([chunk, pad])
        is_embeds = chunk.dtype.kind == "f"
        if is_embeds:
            x = torch.from_numpy(chunk.astype(np.float32)).to(
                _device.dtype(self.cfg.act_dtype))
            shape = shape + (x.shape[-1],)
        else:
            x = torch.from_numpy(chunk.astype(np.int64))
        key = (shape, is_embeds)
        dst = self._chunk_in.get(key)
        if dst is None:
            dst = self._chunk_in[key] = torch.empty(shape, dtype=x.dtype,
                                                    device=self.device)
        dst.copy_(x.reshape(shape))
        return dst, is_embeds

    def stage_chunk_scan(self, buf: int, chunks, valid_lens):
        """Advance ring buffer ``buf`` by m = len(valid_lens) chunks; the
        flat slice holds sum(valid_lens) tokens, zero-padded into (m, C)."""
        C = self.prefill_chunk
        m = len(valid_lens)
        x, is_embeds = self._fill_chunk(chunks, (1, m, C), m * C)
        vl = self._scan_vl.get(m)
        if vl is None:
            vl = self._scan_vl[m] = torch.empty((m,), dtype=torch.int32,
                                                device=self.device)
        vl.copy_(torch.tensor([int(v) for v in valid_lens],
                              dtype=torch.int32))
        kw = "embeds" if is_embeds else "tokens"

        def scan():
            lm.prefill_chunk_scan(self.params, self.cfg, self.staging[buf],
                                  valid_lens=vl, **{kw: x})

        self._program(("scan", buf, m, is_embeds), scan)()

    def stage_admit(self, buf: int, chunk, valid_len: int) -> torch.Tensor:
        """Final chunk (zero-padded to ``prefill_chunk``) + fused on-device
        first-token draw from the last valid position.  The request's
        sampler row is built on the host and copied into the ring buffer's
        row, which the admit advances in place.  Returns the ring buffer's
        (1,) token tensor (still on the device)."""
        s = self.prefill_chunk
        x, is_embeds = self._fill_chunk(chunk, (1, s), s)
        self._admit_vl.fill_(int(valid_len))
        seed, rid, temp, top_k, top_p, eos, budget = self._staging_args[buf]
        row = self.staging_row[buf]
        _assign(row, sampling.admit_row(seed, rid, temp, top_k, top_p, eos,
                                        budget, device="cpu"))
        stochastic = temp > 0.0
        kw = "embeds" if is_embeds else "tokens"

        def sample_fn(st, logits):
            return sampling.sample(st, logits, stochastic=stochastic)

        def admit():
            tok, new_row, _ = lm.prefill_sample(
                self.params, self.cfg, self.staging[buf], dict(row),
                sample_fn, valid_len=self._admit_vl, **{kw: x})
            self.staging_tok[buf].copy_(tok)
            _assign(row, new_row)

        self._program(("admit", buf, is_embeds, stochastic), admit)()
        return self.staging_tok[buf]

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

    # ------------------------------------------------------------- ticks
    def decode(self, k: int):
        """One fused k-step decode+sample tick over all slots; the single
        host sync reads the (k, slots) token/validity tensors."""
        stochastic = bool((self._slot_temp > 0.0).any())

        def sample_fn(st, logits):
            return sampling.sample(st, logits, stochastic=stochastic)

        def decode():
            toks, valid, tokens, _, sampler = lm.decode_steps(
                self.params, self.cfg, self.tokens, self.caches, k,
                sampler=dict(self.sampler), sample_fn=sample_fn)
            self.tokens.copy_(tokens)
            _assign(self.sampler, sampler)
            return toks, valid

        toks, valid = self._program(("decode", k, stochastic), decode)()
        return toks.cpu().numpy(), valid.cpu().numpy()

    def compiled_programs(self) -> Dict[str, int]:
        """Program shapes per family, counted as the reference counts its
        jitted programs: one decode program per k (stochastic is a branch
        inside it), one scan per (m, is_embeds), one admit per is_embeds,
        and the slot scatter in ``total``; ``cuda_graphs`` counts the
        graphs captured (one per program and ring buffer; 0 when eager)."""
        decode = {key[1] for key in self._programs if key[0] == "decode"}
        scan = {key[2:] for key in self._programs if key[0] == "scan"}
        admit = {key[2] for key in self._programs if key[0] == "admit"}
        prefill = len(scan) + len(admit)
        return {
            "decode": len(decode),
            "prefill_scan": len(scan),
            "prefill_admit": len(admit),
            "prefill": prefill,
            "total": len(decode) + prefill + 1,
            "cuda_graphs": sum(p.graph is not None
                               for p in self._programs.values()),
        }

    def release_slot(self, slot: int):
        """A finished request left ``slot``: its sampler row is done on the
        device already; drop its temperature from the host mirror."""
        self._slot_temp[slot] = 0.0


def _assign(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]):
    """Copy a sampler state into the buffers of ``dst`` in place."""
    for k, v in src.items():
        if v is not dst[k]:
            dst[k].copy_(v)
