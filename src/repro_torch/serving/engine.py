"""Continuous-batching decode engine — thin façade over the scheduler /
executor split (port of ``repro.serving.engine``).

  * ``repro_torch.serving.scheduler.Scheduler`` — host side: queue, slot
    assignment, request lifecycle, overlapped chunked-prefill staging
    (batched by default, per prompt with ``prefill_batching=False`` or
    ``plan_mode="pow2"``; ``prefill_budget`` caps the batched packer's
    tokens per tick), budget-aware ticks, speculative draft-verify ticks
    (``speculative=True``, ``k_draft``, ``adaptive_k``, ``draft_cfg`` /
    ``draft_params``; a self-draft by default), state paging (``pause`` /
    ``resume`` / ``preempt`` / ``touch``, ``swap_policy``,
    ``idle_swap_ms``, ``max_live_requests``, ``async_paging`` with
    ``gather_ring``, spill through ``host_swap_bytes`` /
    ``swap_spool_dir``), engine roles (``role="prefill"`` / ``"decode"``
    / ``"both"``) and the router-facing surface, metrics.
  * ``repro_torch.serving.executor.DeviceExecutor`` — device side: slot,
    staging, draft and checkpoint buffers allocated once and updated in
    place, the decode, prefill, speculative and scatter programs, and the
    swap images' gather ring and side copy stream.

``DecodeEngine(cfg, params, ..., device=None)`` runs on ``cuda`` unless
``device="cpu"`` is passed.  With ``cfg.use_pallas_serving`` the GDN layers
go through the hand-written CUDA kernels on the card (their plain versions
on the CPU).  ``cuda_graphs`` (default None: on the card, not on the CPU)
replays each decode and prefill program from a CUDA graph;
``cuda_graphs=False`` runs them eagerly on the card, ``True`` on the CPU
raises.

  * ``repro_torch.serving.router.Router`` fronts several engines
    (placement, backlog and resume-claim migration, drain, the
    prefill->decode handoff sweep, worker-death recovery);
  * ``repro_torch.serving.rpc.EngineProxy`` runs an engine in a worker
    process behind the same surface (``WorkerDied`` when it is gone).

``mesh=`` (a ``("data", "model")`` ``DeviceMesh``, ``launch/mesh.py``)
shards one engine over several ranks, each a process running this engine
on the same requests: the slot axis on "data" (streams bitwise the
one-device engine's), and on "model" each kind's heads or width (GDN
and SSD state heads, attention heads and the KV context, the RG-LRU
width), the MLP, the MoE's experts and the vocab: every kind of the
registry splits.  Where the axis does not divide such a dim the
reference's ``fit_spec`` moves it onto another (the vocab onto d_model,
the experts onto d_ff, query heads onto head_dim), and the model code
follows those moves; ``executor.check_model_axis`` refuses only the
moves it does not follow (ROADMAP queue 1 item 4g).
"""
from __future__ import annotations

from repro_torch.serving.router import Router
from repro_torch.serving.rpc import EngineProxy, WorkerDied
from repro_torch.serving.scheduler import Request, Scheduler


class DecodeEngine(Scheduler):
    """The serving entry point: ``submit`` / ``step`` / ``run_until_done`` /
    ``metrics``."""


__all__ = ["DecodeEngine", "EngineProxy", "Request", "Router",
           "WorkerDied"]
