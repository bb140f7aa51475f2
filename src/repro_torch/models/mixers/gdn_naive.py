"""gdn_naive mixer kind — Gated DeltaNet with the Alg. 1 three-pass decode
step from ``repro_torch.core.gdn`` (retrieval, update, output as separate
passes over S), the HBM-round-trip baseline of the paper
(``state_passes=4``: three reads + one write).

Parameters, train and prefill are those of ``gdn``: with
``use_pallas_serving`` its prefill runs the hand-written ``gdn_prefill``
kernel.  Its decode is always the plain PyTorch Alg. 1 step, on the card
too: Alg. 1 is the baseline and has no kernel in either package (the
reference's ``gdn_layer.gdn_decode`` takes its kernel only when
``use_pallas and fused``).  It is not a fallback that stands in for a
kernel.
"""
from __future__ import annotations

from repro_torch.models.mixers import register
from repro_torch.models.mixers.gdn import GatedDeltaNet


@register
class GatedDeltaNetNaive(GatedDeltaNet):
    kind = "gdn_naive"
    state_passes = 4           # Alg. 1: 3 read passes + 1 write pass
    fused = False
    trains_on_model_axis = False
