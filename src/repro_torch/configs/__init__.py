"""Architecture registry of the PyTorch port.

Only architectures whose every mixer kind and FFN the port implements are
listed: the paper's own qwen3-next-gdn (gdn + attn) and the six dense
attention-only archs (attn / swa with a dense FFN).  The reference
registry (``repro.configs``) has four more — mamba2 (ssm), recurrentgemma
(rglru), mixtral and arctic (MoE) — which join here together with their
mixer kinds and FFNs (ROADMAP queue 1, item 9).  ``frontend_stub`` (llava,
musicgen) is read only by the reference's ``launch/steps.py``; the served
LM is the token path, as in the reference.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.h2o_danube_1_8b import CONFIG as h2o_danube_1_8b
from repro_torch.configs.llava_next_34b import CONFIG as llava_next_34b
from repro_torch.configs.minicpm_2b import CONFIG as minicpm_2b
from repro_torch.configs.minitron_8b import CONFIG as minitron_8b
from repro_torch.configs.musicgen_medium import CONFIG as musicgen_medium
from repro_torch.configs.qwen3_next_gdn import CONFIG as qwen3_next_gdn
from repro_torch.configs.yi_9b import CONFIG as yi_9b

ARCHS = {c.name: c for c in [
    llava_next_34b, minicpm_2b, minitron_8b, yi_9b, h2o_danube_1_8b,
    musicgen_medium, qwen3_next_gdn,
]}


def get_arch(name: str) -> ArchConfig:
    key = name.replace("_", "-")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(ARCHS)} "
                       f"(mamba2, recurrentgemma, mixtral and arctic need "
                       f"the ssm/rglru mixer kinds or MoE FFNs, not yet "
                       f"ported — ROADMAP queue 1, item 9)")
    return ARCHS[key]


__all__ = ["ArchConfig", "ARCHS", "get_arch"]
