"""Continuous-batching decode engine — thin façade over the scheduler /
executor split (port of ``repro.serving.engine``, base tick only).

  * ``repro_torch.serving.scheduler.Scheduler`` — host side: queue, slot
    assignment, request lifecycle, overlapped chunked-prefill staging,
    budget-aware ticks, metrics.
  * ``repro_torch.serving.executor.DeviceExecutor`` — device side: slot and
    staging buffers allocated once and updated in place, and the decode,
    prefill and scatter programs.

``DecodeEngine(cfg, params, ..., device=None)`` runs on ``cuda`` unless
``device="cpu"`` is passed.  With ``cfg.use_pallas_serving`` the GDN layers
go through the hand-written CUDA kernels on the card (their plain versions
on the CPU).  ``cuda_graphs`` (default None: on the card, not on the CPU)
replays each decode and prefill program from a CUDA graph;
``cuda_graphs=False`` runs them eagerly on the card, ``True`` on the CPU
raises.  The router, RPC workers, paging and speculative decode of the
reference come in later slices; asking for them raises
``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.serving.scheduler import Request, Scheduler


class DecodeEngine(Scheduler):
    """The serving entry point: ``submit`` / ``step`` / ``run_until_done`` /
    ``metrics``."""


__all__ = ["DecodeEngine", "Request"]
