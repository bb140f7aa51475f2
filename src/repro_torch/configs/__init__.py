"""Architecture registry of the PyTorch port.

Every architecture of the reference's registry (``repro.configs``): the
paper's own qwen3-next-gdn (gdn + attn), mamba2-1.3b (ssm, no FFN),
recurrentgemma-2b (rglru + swa), the six dense attention-only archs (attn
/ swa with a dense FFN) and the two MoE archs, mixtral-8x7b (swa + MoE)
and arctic-480b (attn + MoE beside a dense MLP).
``frontend_stub`` (llava, musicgen) is read only by the reference's
``launch/steps.py``; the served LM is the token path, as in the reference.
"""
from __future__ import annotations

from repro_torch.configs.arctic_480b import CONFIG as arctic_480b
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.h2o_danube_1_8b import CONFIG as h2o_danube_1_8b
from repro_torch.configs.llava_next_34b import CONFIG as llava_next_34b
from repro_torch.configs.mamba2_1_3b import CONFIG as mamba2_1_3b
from repro_torch.configs.minicpm_2b import CONFIG as minicpm_2b
from repro_torch.configs.minitron_8b import CONFIG as minitron_8b
from repro_torch.configs.mixtral_8x7b import CONFIG as mixtral_8x7b
from repro_torch.configs.musicgen_medium import CONFIG as musicgen_medium
from repro_torch.configs.qwen3_next_gdn import CONFIG as qwen3_next_gdn
from repro_torch.configs.recurrentgemma_2b import CONFIG as recurrentgemma_2b
from repro_torch.configs.yi_9b import CONFIG as yi_9b

ARCHS = {c.name: c for c in [
    llava_next_34b, minicpm_2b, minitron_8b, yi_9b, h2o_danube_1_8b,
    musicgen_medium, qwen3_next_gdn, mamba2_1_3b, recurrentgemma_2b,
    mixtral_8x7b, arctic_480b,
]}


def get_arch(name: str) -> ArchConfig:
    key = name.replace("_", "-")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(ARCHS)}")
    return ARCHS[key]


__all__ = ["ArchConfig", "ARCHS", "get_arch"]
