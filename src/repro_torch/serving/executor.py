"""Device executor: the serving engine's device buffers and programs (port
of ``repro.serving.executor``).

The executor owns

  * the **slot buffers** — every layer's recurrent state / KV cache with a
    leading slot axis, the per-slot sampler tensors and the per-slot last
    tokens.  They are allocated once and updated in place by every
    program: that is the port's form of the reference's buffer donation;
  * the **staging ring** — under the default **batched** staging
    (``prefill_batching``), one ``(staging_depth, ...)`` cache tree whose
    rows are the staged prompts, a ``staging_depth``-row sampler state and
    per-row first tokens: every tick fuses all staged prompts into at most
    one fixed-shape ``(staging_depth, _MAX_SCAN_CHUNKS, prefill_chunk)``
    scan and one admit per input kind, with per-row valid lengths (rows
    and chunks past a prompt's end are bitwise no-op placeholders), and
    finished rows enter their slots through one multi-row scatter.  The
    per-prompt path (pow2 plans, MoE FFNs, mixer kinds without per-row
    masks, or ``prefill_batching=False``) keeps ``staging_depth``
    single-sequence cache trees instead, each scattered into a slot once
    its staging completes;
  * the **programs** — fixed-shape functions over those buffers and the
    static input buffers the executor fills before each call, one per
    shape as the reference compiles one per shape (``compiled_programs``):
    - ``decode(k)``: ``lm.decode_steps``, k fused decode+sample steps with
      one host sync; one program per (k bucket, stochastic);
    - per prompt: ``stage_chunk_scan`` / ``stage_chunk`` / ``stage_admit``
      into a ring buffer (``plan_prefill``: masked, or the pow2 baseline's
      unmasked power-of-two chunks), the admit fusing the first-token draw
      (``lm.prefill_sample``); one program per (ring buffer, shape);
    - batched: ``bstage_chunk_scan`` / ``bstage_admit``, one program per
      input kind (the admit also per stochastic);
    - speculative decode (``draft_cfg``): ``spec_draft(k)``,
      ``spec_verify(k)`` and ``draft_prefill_slot``;
    - ``scatter`` / ``bscatter``: eager copies into the slots;
  * **state paging** — a request's whole device residency (its cache
    column, sampler row and last token) gathers into a ring of
    ``gather_ring`` buffers and drains to a host ``SwappedState``
    (``gather_slot`` / ``gather_staging`` / ``bgather_row``, their
    ``_async`` forms and ``harvest``); a swap-in copies the image back
    through the copies every admit takes (``prestage_restore``,
    ``restore_slot``), so every slot buffer keeps its address.  On the
    card the drain and the put run on a side copy stream between device
    buffers and pinned host buffers, ordered against the compute stream
    by events, so they overlap the next tick's programs.

On the card each program is captured once into a CUDA graph and replayed
(``runtime.graphs``); on the CPU, or with ``cuda_graphs=False``, it runs
eagerly.  Either way a program writes its results into the executor's
buffers, so every call sees one set of addresses.

**Mesh sharding.**  With ``mesh`` set (a ``("data", "model")``
``DeviceMesh``, ``launch/mesh.py``) the engine is multi-controller SPMD:
one process per mesh device, each running the same scheduler on the same
requests and calling the same programs on its own shards.  Every buffer
is allocated as this rank's block under the rules of
``parallel/sharding.py``, as the reference's ``_build_shardings`` places
them: slot caches, sampler rows and last tokens with the slot axis on
"data" (``slot_specs``, ``sampler_specs``, ``token_slot_spec``), GDN state
heads and the attention KV context on "model"; the per-prompt staging
ring replicated over "data" (``staging_specs``); the batched ring's rows
on "data" when they divide it; the speculative checkpoints and draft
buffers as the caches (``checkpoint_specs``), so the verify's commit
needs no collective; parameters by ``params_specs(..., fsdp=False)``.
The programs run with the mesh active (``parallel.comm.use``): the model
code issues its collectives over "model", and the decode and verify
programs gather their (k, slots) tokens over "data", so every rank's
scheduler sees every slot at the tick's one host sync.  A slot count that
does not divide the data axis replicates the slots over it (a warning
names ``pad_slots``).  Swap images stay topology-free: a swap-out gathers
the shards into one full image on every rank, a swap-in cuts it back into
this rank's shards, so an image moves between layouts.  On a mesh a
swap-out drains at once (a drain's landing time differs between ranks,
and the schedulers must not).
"""
from __future__ import annotations

import warnings
from collections import deque
from typing import Any, Deque, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models.mixers import get_mixer
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as rules
from repro_torch.runtime import graphs
from repro_torch.serving import sampling
from repro_torch.tree import copy_leaves, leaves, tree_map, \
    tree_map_with_path


class PlanStep(NamedTuple):
    """One prefill dispatch (see the reference's ``PlanStep``).

    kind   : "scan" (m full chunks) | "chunk" (one interior pow2 tail
             sub-chunk) | "admit" (final chunk + fused draw)
    size   : chunk count m for "scan", token capacity for "chunk"/"admit"
    tokens : valid prompt tokens consumed by this step
    valid  : "scan": (m,) per-chunk valid lengths (0 = placeholder chunk);
             "admit": valid tokens of the fixed-size tail; None: unmasked
             (pow2)
    """
    kind: str
    size: int
    tokens: int
    valid: Optional[Any] = None


# cap on chunks per scan dispatch (keeps the prefill/decode overlap granular)
_MAX_SCAN_CHUNKS = 4


def _pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1)


# the mixer kinds whose math the port splits over the mesh's "model" axis:
# every kind of the registry (a kind registered later is refused)
MODEL_AXIS_KINDS = ("attn", "gdn", "gdn_naive", "rglru", "ssm", "swa")


def check_model_axis(cfg: ArchConfig, model: int, max_len: int):
    """Refuse a model axis of ``model`` > 1 that this port cannot serve: a
    mixer kind outside ``MODEL_AXIS_KINDS`` (``NotImplementedError``), or
    a dim the axis must divide (``ValueError``,
    ``parallel.sharding.check_model_axis``: the dims the trainer splits,
    and the KV context, ``max_len`` or a ``swa`` window's slots)."""
    if model == 1:
        return
    kinds = sorted(set(cfg.layer_kinds) - set(MODEL_AXIS_KINDS))
    if kinds:
        raise NotImplementedError(
            f"the mesh's model axis has no split for mixer kind(s) {kinds} "
            f"(split kinds: {list(MODEL_AXIS_KINDS)}); the data axis "
            f"serves every kind")
    rules.check_model_axis(cfg, model, max_len)


def _drop_data(specs):
    """Specs with every "data" entry removed (the slots replicated)."""
    def drop(_, s):
        return rules.P(*[None if a == "data" or (isinstance(a, tuple)
                                                and "data" in a) else a
                         for a in s])
    return tree_map_with_path(drop, specs)


def _batching_blocked(cfg: ArchConfig, plan_mode: str) -> Optional[str]:
    """Why batched staging cannot be bitwise per-prompt staging here, or
    None (the reference's gates, in its order)."""
    if plan_mode != "masked":
        return ("batched staging rides on masked (valid_len) chunks; "
                f"plan_mode is {plan_mode!r}")
    if cfg.ffn in ("moe", "moe+dense"):
        return ("MoE expert-capacity dispatch couples rows within a batch "
                "(cumsum queue positions over the whole group), so batched "
                "prefill cannot be bitwise-identical to per-prompt "
                "dispatch")
    unbatched = sorted({k for k in cfg.pattern
                        if not get_mixer(k).supports_batched_ragged_prefill})
    if unbatched:
        return (f"mixer kind(s) {unbatched} do not support per-row (B,) "
                f"valid_len prefill chunks (set "
                f"supports_batched_ragged_prefill = True after "
                f"generalizing the mask)")
    return None


class SwappedState(NamedTuple):
    """Host image of one request's device residency (the reference's
    ``SwappedState``), a fixed-size record since every mixer's state is a
    constant-shape block:

    caches  : numpy tree of ``(repeats, 1, ...)`` leaves in the nesting
              of the port's staging caches (recurrent state, rolling KV
              window and position meta of every layer group);
    sampler : the 1-row sampler state (the PRNG key mid-stream, remaining
              budget, done flag);
    token   : (1,) int32, the last emitted token (the next decode input).

    bfloat16 leaves hold their raw 2-byte words (numpy dtype ``V2``)."""
    caches: Any
    sampler: Dict[str, np.ndarray]
    token: np.ndarray

    @property
    def nbytes(self) -> int:
        """Bytes this image moves across the host boundary per swap."""
        return int(sum(np.asarray(x).nbytes for x in
                       leaves(self.caches) + list(self.sampler.values())
                       + [self.token]))


class PendingSwap:
    """One swap-out in flight: its gather-ring ticket ``buf`` and, on the
    card, the event recorded on the side copy stream after the image's
    copy into the ticket's pinned host buffer.  ``harvest`` returns the
    ticket, so a draining buffer is never handed out again before it."""

    __slots__ = ("buf", "nbytes", "event")

    def __init__(self, buf: int, nbytes: int, event=None):
        self.buf, self.nbytes, self.event = buf, nbytes, event

    def ready(self) -> bool:
        """True when the drain has landed (``harvest`` will not wait)."""
        return self.event is None or self.event.query()


_BF16_HOST = np.dtype("V2")


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A fresh numpy copy of host tensor ``t``'s bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_HOST).copy()
    return t.numpy().copy()


def _host_tensor(a, dtype: torch.dtype, shape) -> torch.Tensor:
    """Host array -> CPU tensor of ``dtype`` and ``shape``, bit for bit
    (bfloat16 from raw 2-byte words); raises when the image does not fit
    the slot's leaf."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if dtype == torch.bfloat16:
        fits = a.dtype.itemsize == 2 and a.dtype.kind in "Vf" \
            and a.dtype != np.float16
    else:
        fits = a.dtype == torch.empty((), dtype=dtype).numpy().dtype
    if not fits or tuple(a.shape) != tuple(shape):
        raise ValueError(f"swap image leaf {a.dtype}{tuple(a.shape)} does "
                         f"not fit the slot's {dtype}{tuple(shape)}")
    return torch.from_numpy(a.reshape(-1).view(np.uint8)).view(
        dtype).reshape(shape)


class DeviceExecutor:
    """Owns the device buffers and programs of one decode engine."""

    def __init__(self, cfg: ArchConfig, params, *, max_slots: int,
                 max_len: int, decode_block: int, prefill_chunk: int = 16,
                 mesh=None, staging_depth: int = 2,
                 plan_mode: str = "masked",
                 prefill_batching: Optional[bool] = None,
                 draft_cfg: Optional[ArchConfig] = None, draft_params=None,
                 k_draft: int = 4, gather_ring: int = 2, device=None,
                 cuda_graphs: Optional[bool] = None):
        if plan_mode not in ("masked", "pow2"):
            raise ValueError(f"plan_mode must be 'masked' or 'pow2', "
                             f"got {plan_mode!r}")
        if staging_depth < 1:
            raise ValueError(
                f"staging_depth must be >= 1, got {staging_depth}")
        if gather_ring < 1:
            raise ValueError(
                f"gather_ring must be >= 1, got {gather_ring}")
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if prefill_chunk > max_len:
            raise ValueError(
                f"prefill_chunk={prefill_chunk} exceeds max_len={max_len}: "
                f"a prefill chunk can never hold more tokens than the "
                f"context buffers — lower prefill_chunk or raise max_len")
        if plan_mode == "masked":
            unsupported = sorted({k for k in cfg.pattern
                                  if not get_mixer(k)
                                  .supports_ragged_prefill})
            if unsupported:
                warnings.warn(
                    f"mixer kind(s) {unsupported} do not implement ragged "
                    f"(valid_len-masked) prefill chunks — falling back to "
                    f"plan_mode='pow2'", RuntimeWarning)
                plan_mode = "pow2"
        blocked = _batching_blocked(cfg, plan_mode)
        if prefill_batching and blocked:
            warnings.warn(f"prefill_batching disabled: {blocked}",
                          RuntimeWarning)
        self.prefill_batching = (blocked is None if prefill_batching is None
                                 else bool(prefill_batching)
                                 and blocked is None)
        self.device = _device.resolve(device)
        on_card = self.device.type == "cuda"
        if cuda_graphs and not on_card:
            raise ValueError(f"cuda_graphs=True needs a CUDA device; the "
                             f"executor is on {self.device}")
        self.cuda_graphs = on_card if cuda_graphs is None else cuda_graphs
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.decode_block = decode_block
        self.mesh = mesh
        self._init_mesh(draft_cfg)
        self._pool = (torch.cuda.graph_pool_handle() if self.cuda_graphs
                      else None)
        self._programs: Dict[tuple, graphs.Program] = {}
        self.staging_depth = staging_depth
        self.plan_mode = plan_mode
        limit = min(max_len, cfg.window) if cfg.window else max_len
        self.prefill_chunk = min(prefill_chunk, limit)

        self.spec = lm.cache_specs(cfg, max_slots, max_len)
        slot_spec = lm.cache_specs(cfg, 1, max_len)
        self.state_bytes_per_slot = slot_spec.state_bytes
        self.window_bytes_per_slot = slot_spec.window_bytes
        self.cache_bytes = self.spec.nbytes

        self._check_device(params, "params")
        self.placements: Dict[str, Any] = {}
        self.params = self._shard_params("params", cfg, params)
        self.caches = self._alloc("caches", self.spec, self._slot_parts(
            cfg, self.spec, max_slots))
        self.tokens = torch.zeros((self._B,), dtype=torch.int32,
                                  device=self.device)
        self.sampler = sampling.init_state(self._B, self.device)
        if self.mesh is not None:
            self.placements["staging"] = self._stage_parts(cfg)
            self.placements["tokens"] = rules.token_slot_spec(mesh,
                                                              max_slots)
            self.placements["sampler"] = rules.sampler_specs(
                mesh, {k: torch.empty((max_slots,) + v.shape[1:],
                                      device="meta")
                       for k, v in self.sampler.items()}, max_slots)
        # what one swapped request moves across the host boundary each way:
        # the cache column, one sampler row and the last token
        self.swap_bytes_per_slot = (
            slot_spec.nbytes + self.tokens[:1].nbytes
            + sum(v[:1].nbytes for v in self.sampler.values()))
        # host mirror of each slot's temperature: a tick runs the stochastic
        # sampling pipeline only when some slot may draw (see sampling.sample)
        self._slot_temp = np.zeros((max_slots,), np.float32)

        self.speculative = draft_cfg is not None
        self.k_draft = k_draft
        if self.speculative:
            self._init_speculative(draft_cfg, draft_params, params)

        # per-prompt staging ring (batched staging allocates its own on
        # first use, _ensure_batched): per ring buffer a one-row cache
        # tree, the admit's 1-row sampler state (filled from the host
        # before the admit, advanced by it in place) and first token
        n_ring = 0 if self.prefill_batching else staging_depth
        one = lm.cache_specs(cfg, 1, max_len)
        self.staging: List[Any] = [
            self._alloc("staging", one, self._stage_parts(cfg))
            for _ in range(n_ring)]
        self.staging_row = [sampling.init_state(1, self.device)
                            for _ in range(n_ring)]
        self.staging_tok = [torch.zeros((1,), dtype=torch.int32,
                                        device=self.device)
                            for _ in range(n_ring)]
        self._staging_clean = [True] * n_ring
        self._staging_args: List[Optional[tuple]] = [None] * n_ring
        # the programs' static inputs, one per layout (_fill)
        self._chunk_in: Dict[tuple, torch.Tensor] = {}
        self._admit_vl = torch.zeros((), dtype=torch.int32,
                                     device=self.device)
        # batched staging: built on its first use (_ensure_batched)
        self._batched_ready = False
        # state paging: ``gather_ring`` tickets bound the swap-outs
        # draining at once; a ticket leaves _gather_free at the gather and
        # returns at its harvest.  Each ticket's device and pinned host
        # buffers and the side copy stream are made on first use.  Every
        # gather drains on the side stream: synchronous paging is the
        # scheduler harvesting at once.
        self.gather_ring = gather_ring
        self._gather_free: Deque[int] = deque(range(gather_ring))
        self._gather_pending: Dict[int, PendingSwap] = {}
        self._gather_bufs: Dict[int, tuple] = {}
        self._copy_stream = None

    # -------------------------------------------------------------- mesh
    def _init_mesh(self, draft_cfg):
        """This rank's axes and slot block (the whole slot axis without a
        mesh): ``_B`` local slots from global slot ``_slot0``."""
        S = self.max_slots
        self._axes = None
        self._sparts: Dict[ArchConfig, Any] = {}
        self._B, self._slot0, self._slots_sharded = S, 0, False
        if self.mesh is None:
            return
        if not hasattr(self.mesh, "mesh_dim_names"):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                            f"(launch.mesh.make_serving_mesh), got "
                            f"{type(self.mesh).__name__}")
        names = tuple(self.mesh.mesh_dim_names)
        if names != ("data", "model"):
            raise ValueError(f"a serving mesh has axes ('data', 'model'), "
                             f"got {names} (launch.mesh.make_serving_mesh)")
        axes = self._axes = comm.MeshAxes(self.mesh)
        for cfg in (self.cfg,) + ((draft_cfg,) if draft_cfg else ()):
            check_model_axis(cfg, axes.model.size, self.max_len)
        backends = {a.backend for a in axes.axes.values()}
        if "nccl" in backends and self.device.type != "cuda":
            raise ValueError(f"an NCCL mesh needs a CUDA executor, not "
                             f"{self.device}")
        if "gloo" in backends and self.cuda_graphs:
            raise ValueError(
                "a gloo mesh's collectives are host calls, which a CUDA "
                "graph cannot capture: pass cuda_graphs=False (or give "
                "each rank its own card and an NCCL mesh)")
        data = axes.data.size
        if S % data:
            warnings.warn(
                f"max_slots={S} does not divide the data axis ({data}); the "
                f"slot axis cannot shard evenly, so every rank holds every "
                f"slot (replicated over 'data', where the reference may "
                f"re-place 'data' on a state dim) — pad slots with "
                f"ServingTopology.pad_slots", RuntimeWarning)
            return
        self._B = S // data
        self._slot0 = axes.data.index * self._B
        self._slots_sharded = True

    def _local(self, slot: int) -> Optional[int]:
        """The local index of global slot ``slot``, or None when another
        data rank holds it."""
        i = slot - self._slot0
        return i if 0 <= i < self._B else None

    def _slot_owner(self, slot: int) -> Optional[int]:
        """The data coordinate holding ``slot`` (None: every rank)."""
        return slot // self._B if self._slots_sharded else None

    def _slot_parts(self, cfg, spec, slots: int):
        """The slot buffers' specs (None without a mesh)."""
        if self.mesh is None:
            return None
        parts = rules.slot_specs(cfg, self.mesh, spec.tree, slots)
        return parts if slots % self._axes.data.size == 0 \
            else _drop_data(parts)

    def _stage_parts(self, cfg):
        """One-row staging specs: the slot specs with the slot cleared."""
        if self.mesh is None:
            return None
        parts = self._sparts.get(cfg)
        if parts is None:
            spec = lm.cache_specs(cfg, self.max_slots, self.max_len)
            parts = self._sparts[cfg] = rules.staging_specs(
                self._slot_parts(cfg, spec, self.max_slots))
        return parts

    def _alloc(self, name: str, spec, parts):
        """Zeroed buffers of ``spec``: this rank's blocks under ``parts``."""
        if parts is None:
            return spec.zeros(self.device)
        self.placements.setdefault(name, parts)
        sizes = self._axes.sizes
        return rules.map_specs(
            lambda s, p: torch.zeros(rules.local_shape(s.shape, p, sizes),
                                     dtype=s.dtype, device=self.device),
            spec.tree, parts)

    def _shard_params(self, name: str, cfg, params):
        """This rank's shards of a parameter tree: each leaf whole (cut
        here) or already this rank's block (``lm.init_lm(..., mesh=)``),
        placed by the rules on the full shapes."""
        if self.mesh is None:
            return params
        full = lm.init_lm(None, cfg, device="meta")
        parts = rules.params_specs(cfg, full, False, self.mesh)
        self.placements.setdefault(name, parts)
        return rules.shard_tree(params, parts, self._axes.coords,
                                self._axes.sizes, full=full)

    def _slots_out(self, *ts):
        """(k, local slots) results -> (k, slots) on every rank: one
        all-gather over "data" (none when the slots are replicated)."""
        if not self._slots_sharded:
            return ts
        packed = torch.stack([t.to(torch.int32) for t in ts])
        g = self._axes.data.all_gather(packed, 2).unbind(0)
        return tuple(x.to(t.dtype) for x, t in zip(g, ts))

    def _check_device(self, tree, what: str):
        for t in leaves(tree):
            if t.device != self.device:
                raise ValueError(f"{what} live on {t.device}, the executor "
                                 f"on {self.device}")

    # ------------------------------------------------------------- plans
    def plan_prefill(self, length: int) -> List[PlanStep]:
        """Decompose a prompt of ``length`` tokens into dispatch steps.

        **masked** (default): full chunks run under one scan shape m (the
        balanced chunk count <= ``_MAX_SCAN_CHUNKS``; the last dispatch
        pads with valid_len = 0 placeholder chunks) and the ragged tail is
        one fixed-size masked admit chunk.

        **pow2** (baseline): power-of-two scan counts and power-of-two
        unmasked tail sub-chunks, the last being the fused-sample admit;
        no padding, O(log chunk) tail programs."""
        if length < 1:
            raise ValueError(f"cannot prefill an empty prompt ({length})")
        C = self.prefill_chunk
        tail = (length - 1) % C + 1
        n_full = (length - tail) // C
        steps: List[PlanStep] = []
        if self.plan_mode == "pow2":
            while n_full:
                m = min(_pow2_floor(n_full), _MAX_SCAN_CHUNKS)
                steps.append(PlanStep("scan", m, m * C))
                n_full -= m
            while tail:
                s = _pow2_floor(tail)
                steps.append(PlanStep("chunk", s, s))
                tail -= s
            last = steps[-1]
            steps[-1] = PlanStep("admit", last.size, last.tokens)
            return steps
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

    # ---------------------------------------------------------- programs
    def _program(self, key: tuple, fn) -> graphs.Program:
        prog = self._programs.get(key)
        if prog is None:
            if self.mesh is not None:
                def fn(_fn=fn):
                    with comm.use(self._axes):
                        return _fn()
            prog = self._programs[key] = graphs.Program(fn, self._pool)
        return prog

    def _fill(self, key: tuple, x: np.ndarray, dtype) -> torch.Tensor:
        """Copy host array ``x`` into the static input buffer ``key`` (made
        on first use, one per layout)."""
        dst = self._chunk_in.get(key)
        if dst is None:
            dst = self._chunk_in[key] = torch.empty(x.shape, dtype=dtype,
                                                    device=self.device)
        dst.copy_(torch.from_numpy(x).to(dtype))
        return dst

    def _host_chunk(self, chunk, shape, pad_to: int):
        """Flat prompt slice -> (host array of ``shape`` (+ (d,) for
        embeds), zero-padded to ``pad_to`` tokens; is_embeds)."""
        chunk = np.asarray(chunk)
        if pad_to > chunk.shape[0]:
            pad = np.zeros((pad_to - chunk.shape[0],) + chunk.shape[1:],
                           chunk.dtype)
            chunk = np.concatenate([chunk, pad])
        is_embeds = chunk.dtype.kind == "f"
        if is_embeds:
            return (chunk.astype(np.float32).reshape(shape
                                                     + chunk.shape[-1:]),
                    True)
        return chunk.astype(np.int64).reshape(shape), False

    def _input_dtype(self, is_embeds: bool) -> torch.dtype:
        return (_device.dtype(self.cfg.act_dtype) if is_embeds
                else torch.int64)

    def _fill_chunk(self, chunk, shape, pad_to: int) -> tuple:
        """Flat prompt slice -> the static input of its layout.  Returns
        (buffer, is_embeds)."""
        x, is_embeds = self._host_chunk(chunk, shape, pad_to)
        return (self._fill(("chunk", x.shape, is_embeds), x,
                           self._input_dtype(is_embeds)), is_embeds)

    @staticmethod
    def _inputs_kw(x, is_embeds: bool) -> dict:
        return {"embeds" if is_embeds else "tokens": x}

    # ------------------------------------------------- per-prompt staging
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

    def stage_chunk_scan(self, buf: int, chunks, valid_lens=None):
        """Advance ring buffer ``buf`` by m chunks in one dispatch: m * C
        tokens unmasked (pow2), or, masked, ``sum(valid_lens)`` tokens
        zero-padded into (m, C) with per-chunk valid lengths (a 0 entry is
        a placeholder chunk)."""
        C = self.prefill_chunk
        masked = valid_lens is not None
        m = len(valid_lens) if masked else len(chunks) // C
        x, is_embeds = self._fill_chunk(chunks, (1, m, C), m * C)
        vl = None
        if masked:
            vl = self._fill(("scan_vl", m),
                            np.asarray(valid_lens, np.int32), torch.int32)

        def scan():
            lm.prefill_chunk_scan(self.params, self.cfg, self.staging[buf],
                                  valid_lens=vl,
                                  **self._inputs_kw(x, is_embeds))

        self._program(("scan", buf, m, is_embeds, masked), scan)()

    def stage_chunk(self, buf: int, chunk):
        """Advance ring buffer ``buf`` by one interior tail sub-chunk,
        unmasked (pow2 plans only)."""
        s = len(chunk)
        x, is_embeds = self._fill_chunk(chunk, (1, s), s)

        def step():
            lm.prefill_chunk(self.params, self.cfg, self.staging[buf],
                             **self._inputs_kw(x, is_embeds))

        self._program(("chunk", buf, s, is_embeds), step)()

    def stage_admit(self, buf: int, chunk, valid_len=None) -> torch.Tensor:
        """Final chunk + fused on-device first-token draw.  Masked
        (``valid_len`` set): the slice is zero-padded to ``prefill_chunk``
        and the draw reads the last valid position; pow2: the chunk is
        exactly the tail.  The request's sampler row is built on the host
        and copied into the ring buffer's row, which the admit advances in
        place.  Returns the ring buffer's (1,) token tensor (on the
        device)."""
        masked = valid_len is not None
        s = self.prefill_chunk if masked else len(chunk)
        x, is_embeds = self._fill_chunk(chunk, (1, s), s)
        vl = None
        if masked:
            vl = self._admit_vl
            vl.fill_(int(valid_len))
        seed, rid, temp, top_k, top_p, eos, budget = self._staging_args[buf]
        row = self.staging_row[buf]
        copy_leaves(row, sampling.admit_row(seed, rid, temp, top_k, top_p,
                                            eos, budget, device="cpu"))
        stochastic = temp > 0.0

        def sample_fn(st, logits):
            return sampling.sample(st, logits, stochastic=stochastic)

        def admit():
            tok, new_row, _ = lm.prefill_sample(
                self.params, self.cfg, self.staging[buf], dict(row),
                sample_fn, valid_len=vl, **self._inputs_kw(x, is_embeds))
            self.staging_tok[buf].copy_(tok)
            copy_leaves(row, new_row)

        self._program(("admit", buf, s, is_embeds, masked, stochastic),
                      admit)()
        return self.staging_tok[buf]

    def scatter(self, slot: int, buf: int):
        """Copy ring buffer ``buf``'s completed staging cache + sampler row
        + first token into slot ``slot`` (eager copies, in place), then
        mark the ring buffer for reset."""
        self._fill_slot(slot, self.staging[buf], self.staging_row[buf],
                        self.staging_tok[buf], 0,
                        self._staging_args[buf][2])
        for t in leaves(self.staging[buf]):
            t.zero_()
        self._staging_clean[buf] = True

    def _fill_slot(self, slot: int, caches, sampler, toks, row: int,
                   temperature: float):
        """Copy row ``row`` of a staging cache tree, sampler state and
        first tokens into slot ``slot`` (eager copies, in place; on a mesh
        by the ranks holding the slot)."""
        i = self._local(slot)
        if i is not None:
            for dst, src in zip(leaves(self.caches), leaves(caches)):
                dst[:, i].copy_(src[:, row])
            for k, v in self.sampler.items():
                v[i].copy_(sampler[k][row])
            self.tokens[i] = toks[row]
        self._slot_temp[slot] = temperature

    # ---------------------------------------------------- batched staging
    def _ensure_batched(self):
        """Allocate the batched staging buffers on first use: one
        (staging_depth, ...) cache tree (every staged prompt is a row), a
        staging_depth-row sampler state holding the advanced admit rows,
        the (staging_depth,) first tokens, the admit's D-row sampling
        parameters (a static buffer filled from the host before each
        admit) and the host mirror of the rows' parameters.  On a mesh the
        rows shard on "data" like the slot axis (``slot_specs`` with batch
        = staging_depth) when they divide it, and are replicated over it
        otherwise (the reference's guard: a non-dividing count never
        re-places "data" on a state dim)."""
        if self._batched_ready:
            return
        D = self.staging_depth
        self.bspec = lm.cache_specs(self.cfg, D, self.max_len)
        self._D, self._row0, self._rows_sharded = D, 0, False
        if self.mesh is not None and D % self._axes.data.size == 0:
            self._D = D // self._axes.data.size
            self._row0 = self._axes.data.index * self._D
            self._rows_sharded = True
        self.bstaging = self._alloc("bstaging", self.bspec, self._slot_parts(
            self.cfg, self.bspec, D))
        self.bsampler = sampling.init_state(self._D, self.device)
        self.btoks = torch.zeros((self._D,), dtype=torch.int32,
                                 device=self.device)
        # every row's first token, gathered over "data" by the admit
        self._btoks_all = (torch.zeros((D,), dtype=torch.int32,
                                       device=self.device)
                           if self._rows_sharded else self.btoks)
        self._brows = sampling.init_state(self._D, self.device)
        self._bargs = {
            "rid": np.zeros((D,), np.int32),
            "temperature": np.zeros((D,), np.float32),
            "top_k": np.zeros((D,), np.int32),
            "top_p": np.ones((D,), np.float32),
            "eos_id": np.full((D,), -1, np.int32),
            "budget": np.ones((D,), np.int32),
        }
        self._bseed = 0
        self._batched_ready = True

    def bstage_begin(self, row: int, *, seed: int, rid: int,
                     temperature: float, top_k: int, top_p: float,
                     eos_id, budget: int):
        """Record a request's sampling parameters for staging row ``row``
        (host only: rows are zeroed when the multi-row scatter releases
        them, so beginning a row costs no device work)."""
        self._ensure_batched()
        self._bseed = seed
        self._bargs["rid"][row] = rid
        self._bargs["temperature"][row] = temperature
        self._bargs["top_k"][row] = top_k
        self._bargs["top_p"][row] = top_p
        self._bargs["eos_id"][row] = -1 if eos_id is None else eos_id
        self._bargs["budget"][row] = budget

    def _batched_input(self, entries, lead, fill):
        """Host (D, *lead) tokens or (D, *lead, d) embeds with each entry's
        slice written by ``fill(x, row, chunk, n)``; returns (x,
        is_embeds)."""
        first = np.asarray(entries[0][1])
        is_embeds = first.dtype.kind == "f"
        shape = (self.staging_depth,) + lead
        x = (np.zeros(shape + first.shape[-1:], np.float32) if is_embeds
             else np.zeros(shape, np.int64))
        for row, chunk, n in entries:
            fill(x, row, np.asarray(chunk), n)
        return x, is_embeds

    def bstage_chunk_scan(self, entries):
        """Advance several staging rows by their next full chunks in one
        fixed-shape (D, _MAX_SCAN_CHUNKS, C) dispatch.  entries: list of
        ``(row, flat_chunk, take)``, ``take`` full chunks for row ``row``;
        rows taking fewer chunks, and rows with no entry, pad with
        valid_len = 0 placeholder chunks (bitwise no-ops)."""
        D, C, M = self.staging_depth, self.prefill_chunk, _MAX_SCAN_CHUNKS
        self._ensure_batched()
        vl = np.zeros((M, D), np.int32)

        def fill(x, row, chunk, take):
            x[row, :take] = chunk.reshape((take, C) + chunk.shape[1:])
            vl[:take, row] = C

        xh, is_embeds = self._batched_input(entries, (M, C), fill)
        rows = slice(self._row0, self._row0 + self._D)
        x = self._fill(("bscan_in", is_embeds), xh[rows],
                       self._input_dtype(is_embeds))
        v = self._fill(("bscan_vl",), vl[:, rows], torch.int32)

        def scan():
            lm.prefill_chunk_scan(self.params, self.cfg, self.bstaging,
                                  valid_lens=v,
                                  **self._inputs_kw(x, is_embeds))

        self._program(("bscan", is_embeds), scan)()

    def bstage_admit(self, entries):
        """Final (ragged tail) chunk + fused first-token draw for several
        staging rows in one dispatch.  The D rows' sampler states are
        built on the host (``sampling.admit_rows``: keys folded from
        (seed, rid) as the per-prompt path folds them) and copied into a
        static buffer; the program prefills the fixed-size masked tail,
        samples, and merges tokens and sampler rows under the admit mask
        (rows not admitting are valid_len = 0 no-ops and keep their
        values).  entries: list of ``(row, flat_chunk, valid_len)``."""
        D, C = self.staging_depth, self.prefill_chunk
        self._ensure_batched()
        vl = np.zeros((D,), np.int32)
        amask = np.zeros((D,), bool)

        def fill(x, row, chunk, valid):
            x[row, :valid] = chunk
            vl[row] = valid
            amask[row] = True

        xh, is_embeds = self._batched_input(entries, (C,), fill)
        rows = slice(self._row0, self._row0 + self._D)
        x = self._fill(("badmit_in", is_embeds), xh[rows],
                       self._input_dtype(is_embeds))
        v = self._fill(("badmit_vl",), vl[rows], torch.int32)
        am = self._fill(("badmit_mask",), amask[rows], torch.bool)
        a = self._bargs
        brows = sampling.admit_rows(
            self._bseed, a["rid"], a["temperature"], a["top_k"], a["top_p"],
            a["eos_id"], a["budget"], device="cpu")
        copy_leaves(self._brows, {k: t[rows] for k, t in brows.items()})
        # the stochastic branch is neutral for greedy rows
        stochastic = bool((a["temperature"][amask] > 0.0).any())

        def sample_fn(st, logits):
            return sampling.sample(st, logits, stochastic=stochastic)

        def admit():
            tok, rows, _ = lm.prefill_sample(
                self.params, self.cfg, self.bstaging, dict(self._brows),
                sample_fn, valid_len=v, **self._inputs_kw(x, is_embeds))
            self.btoks.copy_(torch.where(am, tok, self.btoks))
            for k, w in self.bsampler.items():
                m = am.reshape((-1,) + (1,) * (w.ndim - 1))
                w.copy_(torch.where(m, rows[k].to(w.dtype), w))
            if self._rows_sharded:
                self._btoks_all.copy_(self._axes.data.all_gather(
                    self.btoks, 0))

        self._program(("badmit", is_embeds, stochastic), admit)()

    def bscatter(self, assigns, release_rows=()):
        """Admit finished staging rows into their slots and release rows.
        assigns: ``(slot, row)`` pairs (distinct slots); release_rows:
        extra rows to zero without scattering (requests that finished at
        admit).  Assigned rows are always released.

        Eager copies, as ``scatter``: one per leaf and assigned row, then
        one zero per leaf and released row.  The reference's fixed-shape
        program (a ``(D,)`` slot map with an out-of-range "no slot"
        sentinel, dropped by ``mode="drop"``) has no torch counterpart
        short of a ``where`` over the whole slot cache per call."""
        self._ensure_batched()
        release = set(release_rows)
        for slot, row in assigns:
            self._fill_slot(slot, *self._brow(slot, row),
                            self._bargs["temperature"][row])
            release.add(row)
        for row in sorted(release):
            i = row - self._row0
            if 0 <= i < self._D:
                for t in leaves(self.bstaging):
                    t[:, i].zero_()

    def _brow(self, slot: int, row: int):
        """Where staging row ``row`` is read for slot ``slot``: (caches,
        sampler, tokens, index).  On a mesh whose rows shard on "data", a
        row held by another data rank than the slot's is broadcast over
        "data" from its holder first."""
        if not self._rows_sharded:
            return self.bstaging, self.bsampler, self.btoks, row
        src = row // self._D
        i = row - self._row0
        if self._slot_owner(slot) == src:
            return self.bstaging, self.bsampler, self.btoks, i
        dp = self._axes.data
        mine = dp.index == src
        out = tree_map(lambda t: (t[:, i:i + 1].clone() if mine else
                                  torch.empty_like(t[:, :1])),
                       self.bstaging)
        samp = {k: (v[i:i + 1].clone() if mine else torch.empty_like(v[:1]))
                for k, v in self.bsampler.items()}
        tok = (self.btoks[i:i + 1].clone() if mine
               else torch.empty_like(self.btoks[:1]))
        for t in leaves((out, samp, tok)):
            dp.broadcast(t, src)
        return out, samp, tok, 0

    def btoks_host(self) -> np.ndarray:
        """The batched ring's (staging_depth,) first tokens on the host
        (every row's: the admit gathers them over "data" when the rows
        shard on it)."""
        return self._btoks_all.cpu().numpy()

    # ------------------------------------------------------ state paging
    def _acquire_ticket(self) -> int:
        """Claim a gather-ring ticket.  The scheduler makes room first
        (force-harvesting the oldest drain), so an empty ring here is a
        bookkeeping fault, not backpressure."""
        if not self._gather_free:
            raise RuntimeError(
                f"gather ring exhausted: all {self.gather_ring} buffers "
                f"are draining — harvest a pending swap before "
                f"dispatching another gather")
        return self._gather_free.popleft()

    def _side_copy(self, dst, src) -> torch.cuda.Event:
        """Copy each leaf of ``src`` into ``dst`` on the side copy stream,
        after the work queued so far on the compute stream; returns the
        event recorded after the copies."""
        side = self._copy_stream
        if side is None:
            side = self._copy_stream = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for d, s in zip(leaves(dst), leaves(src)):
                d.copy_(s, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        return event

    def _gather(self, caches, row, tok, owner=None) -> PendingSwap:
        """Snapshot a one-row image into a gather-ring buffer on the
        compute stream (so after every program queued before it, and
        immune to what runs after), then, on the card, drain it into the
        ticket's pinned host buffer on the side stream.

        On a mesh the ring buffers hold the full image on every rank: the
        ranks of data coordinate ``owner`` (every rank when None) gather
        their "model" shards of ``caches`` (one-row slices, None on the
        other ranks), then ``owner`` broadcasts the image over "data"; the
        drain is synchronous (``PendingSwap.event`` None)."""
        buf = self._acquire_ticket()
        ring = self._gather_bufs.get(buf)
        if ring is None:
            dev = (lm.init_caches(self.cfg, 1, self.max_len, self.device),
                   sampling.init_state(1, self.device),
                   torch.zeros((1,), dtype=torch.int32, device=self.device))
            host = (tree_map(lambda t: torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True), dev)
                if self.device.type == "cuda" else dev)
            ring = self._gather_bufs[buf] = (dev, host)
        dev, host = ring
        if self.mesh is None:
            copy_leaves(dev, (caches, row, tok))
        else:
            self._assemble(dev, caches, row, tok, owner)
        event = None
        if self.device.type == "cuda":
            event = self._side_copy(host, dev)
            if self.mesh is not None:
                event.synchronize()
                event = None
        pend = PendingSwap(buf, sum(t.nbytes for t in leaves(dev)), event)
        self._gather_pending[buf] = pend
        return pend

    def _assemble(self, dev, caches, row, tok, owner):
        """Fill the full image ``dev`` from this rank's shards (``_gather``
        on a mesh)."""
        axes = self._axes
        if owner is None or owner == axes.data.index:
            full = rules.map_specs(
                lambda t, s: rules.gather_shard(t, s, axes.axes), caches,
                self._stage_parts(self.cfg))
            copy_leaves(dev, (full, row, tok))
        if owner is not None and axes.data.size > 1:
            for t in leaves(dev):
                axes.data.broadcast(t, owner)

    def gather_slot_async(self, slot: int) -> PendingSwap:
        """Swap-out of resident slot ``slot`` without waiting for the
        drain: its cache column, sampler row and last token go into a
        gather-ring buffer, then the vacated slot's done flag is frozen
        (an inert slot until the next admit writes it) and its
        temperature leaves the host mirror.  The slot is reusable at
        once: the gathered values are a snapshot."""
        i = self._local(slot)
        src = (None, None, None) if i is None else (
            tree_map(lambda t: t[:, i:i + 1], self.caches),
            {k: v[i:i + 1] for k, v in self.sampler.items()},
            self.tokens[i:i + 1])
        pend = self._gather(*src, owner=self._slot_owner(slot))
        if i is not None:
            self.sampler["done"][i] = True
        self.release_slot(slot)
        return pend

    def gather_staging_async(self, buf: int) -> PendingSwap:
        """Swap-out of per-prompt ring buffer ``buf`` (a staged-ready
        request pausing at the admit boundary): its staging caches,
        admit-advanced sampler row and first token.  The ring buffer stays
        dirty: the next ``stage_begin`` zeroes it."""
        return self._gather(self.staging[buf], self.staging_row[buf],
                            self.staging_tok[buf])

    def bgather_row_async(self, row: int) -> PendingSwap:
        """Swap-out of batched staging row ``row`` (the admit-boundary swap
        on the batched path).  A pure read: the scheduler marks the row
        dirty, so the next multi-row scatter zeroes it."""
        self._ensure_batched()
        i = row - self._row0
        if not 0 <= i < self._D:
            return self._gather(None, None, None, owner=row // self._D)
        return self._gather(
            tree_map(lambda t: t[:, i:i + 1], self.bstaging),
            {k: v[i:i + 1] for k, v in self.bsampler.items()},
            self.btoks[i:i + 1],
            owner=row // self._D if self._rows_sharded else None)

    def harvest(self, pend: PendingSwap) -> SwappedState:
        """Materialize a drained swap-out as host numpy and return its
        gather-ring ticket; waits only for what has not drained yet (on
        the card, the side stream's event)."""
        if self._gather_pending.get(pend.buf) is not pend:
            raise RuntimeError(
                f"harvest of gather buffer {pend.buf} that is not "
                f"draining — double harvest or foreign PendingSwap")
        if pend.event is not None:
            pend.event.synchronize()
        caches, row, tok = self._gather_bufs[pend.buf][1]
        sw = SwappedState(caches=tree_map(_host_array, caches),
                          sampler={k: _host_array(v) for k, v in row.items()},
                          token=_host_array(tok))
        del self._gather_pending[pend.buf]
        self._gather_free.append(pend.buf)
        return sw

    # the synchronous forms: the same copies, harvested at once
    def gather_slot(self, slot: int) -> SwappedState:
        return self.harvest(self.gather_slot_async(slot))

    def gather_staging(self, buf: int) -> SwappedState:
        return self.harvest(self.gather_staging_async(buf))

    def bgather_row(self, row: int) -> SwappedState:
        return self.harvest(self.bgather_row_async(row))

    def prestage_restore(self, sw: SwappedState) -> tuple:
        """Put a host image back on the device for a later
        ``restore_slot``: (cache leaves, sampler row, token, event).  On
        the card the image is copied into pinned memory, then onto the
        device on the side stream (``event`` marks its end; the tensors
        are recorded on that stream, so their memory is not reused before
        it); on the CPU the tensors view the image.  On a mesh the image
        is cut into this rank's "model" shards first."""
        slots = self.spec.leaves()
        flat = leaves(sw.caches)
        if len(flat) != len(slots) or set(sw.sampler) != set(self.sampler):
            raise ValueError(f"swap image of {len(flat)} cache leaves and "
                             f"sampler keys {sorted(sw.sampler)} does not "
                             f"fit this engine's slots")
        full = [_host_tensor(a, t.dtype, (t.shape[0], 1) + t.shape[2:])
                for a, t in zip(flat, slots)]
        if self.mesh is not None:
            full = [rules.local_shard(t, p, self._axes.coords,
                                      self._axes.sizes).contiguous()
                    for t, p in zip(full, leaves(
                        self._stage_parts(self.cfg)))]
        host = (full,
                {k: _host_tensor(sw.sampler[k], v.dtype, (1,) + v.shape[1:])
                 for k, v in self.sampler.items()},
                _host_tensor(sw.token, self.tokens.dtype, (1,)))
        if self.device.type != "cuda":
            return host + (None,)
        host = tree_map(lambda t: t.pin_memory(), host)
        dev = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                             device=self.device), host)
        event = self._side_copy(dev, host)
        for t in leaves(dev):
            t.record_stream(self._copy_stream)
        return dev + (event,)

    def restore_slot(self, slot: int, sw: SwappedState, prestaged=None):
        """Swap-in: copy the image (``prestaged``, or put now) into slot
        ``slot`` through ``_fill_slot``, the copies every admit takes, so
        every slot buffer keeps its address and the captured programs read
        the restored state.  The compute stream waits for the put first."""
        caches, row, tok, event = (prestaged if prestaged is not None
                                   else self.prestage_restore(sw))
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        self._fill_slot(slot, caches, row, tok, 0,
                        float(np.asarray(sw.sampler["temperature"])
                              .reshape(-1)[0]))

    # ------------------------------------------------- speculative decode
    def _init_speculative(self, draft_cfg, draft_params, params):
        """Draft model buffers and the rollback checkpoints (see the
        reference's executor): ``ckpt`` / ``dckpt`` from the mixers'
        ``checkpoint_spec``, the committed draft state ``dcaches``, and the
        static inputs of the draft, verify and draft-rebuild programs.  A
        self-draft (``draft_params is params``) shares the target's
        weights."""
        if self.k_draft < 1:
            raise ValueError(f"k_draft must be >= 1, got {self.k_draft}")
        if draft_cfg.vocab != self.cfg.vocab:
            raise ValueError(
                f"draft model must share the target vocab "
                f"({draft_cfg.vocab} != {self.cfg.vocab}) — draft proposals "
                f"are token ids the target verifies")
        unsupported = sorted({k for k in draft_cfg.pattern
                              if not get_mixer(k).supports_ragged_prefill})
        if unsupported:
            raise ValueError(
                f"draft mixer kind(s) {unsupported} do not support ragged "
                f"(valid_len-masked) prefill chunks — the draft state "
                f"rebuild at slot activation runs one fixed-shape masked "
                f"chunk scan")
        cfg, S, L = self.cfg, self.max_slots, self.max_len
        self.draft_cfg = draft_cfg
        self.ckpt_spec = lm.checkpoint_specs(cfg, S, L)
        self.dspec = lm.cache_specs(draft_cfg, S, L)
        self.dckpt_spec = lm.checkpoint_specs(draft_cfg, S, L)
        self.checkpoint_bytes_per_slot = lm.checkpoint_specs(cfg, 1,
                                                             L).nbytes
        self.draft_bytes_per_slot = (
            lm.cache_specs(draft_cfg, 1, L).nbytes
            + lm.checkpoint_specs(draft_cfg, 1, L).nbytes)
        self.speculative_bytes = (self.ckpt_spec.nbytes + self.dspec.nbytes
                                  + self.dckpt_spec.nbytes)
        if draft_params is not params:
            self._check_device(draft_params, "draft params")
            draft_params = self._shard_params("draft_params", draft_cfg,
                                              draft_params)
        else:
            draft_params = self.params
        self.draft_params = draft_params
        self.dcaches = self._alloc("dcaches", self.dspec, self._slot_parts(
            draft_cfg, self.dspec, S))
        self.ckpt = self._alloc("ckpt", self.ckpt_spec, self._slot_parts(
            cfg, self.ckpt_spec, S))
        self.dckpt = self._alloc("dckpt", self.dckpt_spec, self._slot_parts(
            draft_cfg, self.dckpt_spec, S))
        # the draft rebuild: one (1, n, C) masked scan from zero state in a
        # one-row scratch cache, then a copy into the slot; C is the
        # target's staged chunk, so a self-draft rebuild hits the same
        # chunk boundaries
        dlimit = (min(L, draft_cfg.window) if draft_cfg.window else L)
        self._dchunk = min(self.prefill_chunk, dlimit)
        self._dchunks = -(-L // self._dchunk)
        self._dstage = self._alloc("dstage", lm.cache_specs(draft_cfg, 1, L),
                                   self._stage_parts(draft_cfg))
        self._dslot = torch.zeros((1,), dtype=torch.int64,
                                  device=self.device)
        # on a mesh: whether this rank holds the rebuilt slot
        self._down = torch.ones((), dtype=torch.bool, device=self.device)
        # the draft tokens of each k, read by the verify of that k
        self._dtoks: Dict[int, torch.Tensor] = {}

    def _draft_buffer(self, k: int) -> torch.Tensor:
        buf = self._dtoks.get(k)
        if buf is None:
            buf = self._dtoks[k] = torch.zeros(
                (k, self._B), dtype=torch.int32, device=self.device)
        return buf

    def _stochastic(self) -> bool:
        return bool((self._slot_temp > 0.0).any())

    def spec_draft(self, k: int) -> torch.Tensor:
        """Propose ``k`` draft tokens per slot: ``lm.decode_steps`` on the
        draft model, on the device with no host sync.  The port's decode
        updates caches in place, so the draft runs in ``dckpt``, a scratch
        copy of the committed ``dcaches`` (which the verify advances);
        the sampler is never updated in place, so the draft reads the
        slots' own and leaves it as it was.  The draw stream is the
        slot's (seed, rid)-folded key sequence, the keys the verify will
        consume.  Returns the (k, slots) draft tokens (a static buffer the
        verify of that k reads); k = 0 dispatches nothing."""
        out = self._draft_buffer(k)
        if k == 0:
            return out
        stochastic = self._stochastic()

        def sample_fn(st, logits):
            return sampling.sample(st, logits, stochastic=stochastic)

        def draft():
            copy_leaves(self.dckpt, self.dcaches)
            toks, _, _, _, _ = lm.decode_steps(
                self.draft_params, self.draft_cfg, self.tokens, self.dckpt,
                k, sampler=dict(self.sampler), sample_fn=sample_fn)
            out.copy_(toks)

        self._program(("draft", k, stochastic), draft)()
        return out

    def spec_verify(self, k: int, dtoks: torch.Tensor):
        """Score a pending k-token draft with ``lm.verify_steps`` and commit
        each slot's state through its emitted prefix: the single host sync
        of a speculative tick (up to k+1 tokens per slot).

        The reference swaps the roles of ``caches`` and ``ckpt`` every
        tick (the run-ahead finals land in the donated checkpoint).  A
        captured graph needs fixed addresses, and the slot scatter, the
        draft rebuild and plain decode all write the committed state, so
        here the committed state stays in ``caches`` / ``dcaches``: the
        verify copies it into ``ckpt`` / ``dckpt``, runs ahead there and
        commits back with a ``where`` per position (one state copy per
        tick more than the swap; one program per k, not per parity).
        Returns host (k+1, slots) toks/valid, ``decode``'s layout."""
        buf = self._draft_buffer(k)
        if dtoks is not buf:
            buf.copy_(dtoks)
        stochastic = self._stochastic()

        def sample_fn(st, logits, active):
            return sampling.sample_where(st, logits, active,
                                         stochastic=stochastic)

        def verify():
            toks, valid, last, _, _, _, _, st = lm.verify_steps(
                self.params, self.cfg, self.draft_params, self.draft_cfg,
                self.tokens, buf, self.caches, self.dcaches, self.ckpt,
                self.dckpt, dict(self.sampler), sample_fn)
            self.tokens.copy_(last)
            copy_leaves(self.sampler, st)
            return self._slots_out(toks, valid)

        toks, valid = self._program(("verify", k, stochastic), verify)()
        return toks.cpu().numpy(), valid.cpu().numpy()

    def draft_prefill_slot(self, slot: int, tokens_1d):
        """Rebuild slot ``slot``'s draft state from the request's consumed
        tokens (prompt + every emitted token but the last), at every slot
        activation: one fixed-shape program, a masked (1, n, C) chunk scan
        from zero state into a one-row scratch cache, then a copy into the
        slot.  Streams longer than max_len keep their last max_len
        tokens."""
        toks = np.asarray(tokens_1d, np.int64).reshape(-1)[-self.max_len:]
        if toks.size == 0:
            raise ValueError("draft_prefill_slot needs >= 1 consumed "
                             "token (prompts are never empty)")
        C, n = self._dchunk, self._dchunks
        flat = np.zeros((n * C,), np.int64)
        flat[:toks.size] = toks
        vls = np.zeros((n,), np.int32)
        full, tail = divmod(toks.size, C)
        vls[:full] = C
        if tail:
            vls[full] = tail
        x = self._fill(("dprefill_in",), flat.reshape(1, n, C), torch.int64)
        vl = self._fill(("dprefill_vl",), vls, torch.int32)
        i = self._local(slot)
        self._dslot.fill_(0 if i is None else i)
        self._down.fill_(i is not None)
        mesh = self.mesh is not None

        def dprefill():
            for t in leaves(self._dstage):
                t.zero_()
            lm.prefill_chunk_scan(self.draft_params, self.draft_cfg,
                                  self._dstage, tokens=x, valid_lens=vl)
            for dst, src in zip(leaves(self.dcaches), leaves(self._dstage)):
                if mesh:    # every rank scans; the slot's holders copy
                    src = torch.where(self._down, src,
                                      dst.index_select(1, self._dslot))
                dst.index_copy_(1, self._dslot, src)

        self._program(("dprefill",), dprefill)()

    # ------------------------------------------------------------- ticks
    def decode(self, k: int):
        """One fused k-step decode+sample tick over all slots; the single
        host sync reads the (k, slots) token/validity tensors."""
        stochastic = self._stochastic()

        def sample_fn(st, logits):
            return sampling.sample(st, logits, stochastic=stochastic)

        def decode():
            toks, valid, tokens, _, sampler = lm.decode_steps(
                self.params, self.cfg, self.tokens, self.caches, k,
                sampler=dict(self.sampler), sample_fn=sample_fn)
            self.tokens.copy_(tokens)
            copy_leaves(self.sampler, sampler)
            return self._slots_out(toks, valid)

        toks, valid = self._program(("decode", k, stochastic), decode)()
        return toks.cpu().numpy(), valid.cpu().numpy()

    def compiled_programs(self) -> Dict[str, int]:
        """Program shapes per family, counted as the reference counts its
        jitted programs: one decode program per k (stochastic is a branch
        inside it), one per-prompt scan per (m, is_embeds, masked), chunk
        per (size, is_embeds), admit per (size, is_embeds, masked), one
        batched scan and admit per is_embeds, the speculative programs
        (draft and verify per k, the draft rebuild), and in ``total`` the
        slot scatter and, once built, the batched ring's multi-row
        scatter; ``cuda_graphs`` counts the graphs captured (one per
        program, ring buffer and stochastic flag; 0 when eager)."""
        def shapes(family, sl):
            return {key[sl] for key in self._programs if key[0] == family}

        decode = shapes("decode", 1)
        scan = shapes("scan", slice(2, 5))
        chunk = shapes("chunk", slice(2, 4))
        admit = shapes("admit", slice(2, 5))
        bscan, badmit = shapes("bscan", 1), shapes("badmit", 1)
        prefill = (len(scan) + len(chunk) + len(admit) + len(bscan)
                   + len(badmit))
        spec = (len(shapes("draft", 1)) + len(shapes("verify", 1))
                + len(shapes("dprefill", 0)))
        return {
            "decode": len(decode),
            "prefill_scan": len(scan) + len(bscan),
            "prefill_chunk": len(chunk),
            "prefill_admit": len(admit) + len(badmit),
            "prefill": prefill,
            "speculative": spec,
            "total": (len(decode) + prefill + spec + 1
                      + (1 if self._batched_ready else 0)),
            "cuda_graphs": sum(p.graph is not None
                               for p in self._programs.values()),
        }

    def release_slot(self, slot: int):
        """A finished request left ``slot``: its sampler row is done on the
        device already; drop its temperature from the host mirror."""
        self._slot_temp[slot] = 0.0
