"""GDN recurrence math and the decode intensity model (port of
``repro.core``)."""
from repro_torch.core import gdn, intensity
from repro_torch.core.gdn import (
    gates,
    log_gate,
    decode_step_naive,
    decode_step_fused,
    ssd_decode_step,
    prefill_sequential,
    prefill_chunkwise,
    gdn_decode,
    gdn_prefill,
)

__all__ = [
    "gdn",
    "intensity",
    "gates",
    "log_gate",
    "decode_step_naive",
    "decode_step_fused",
    "ssd_decode_step",
    "prefill_sequential",
    "prefill_chunkwise",
    "gdn_decode",
    "gdn_prefill",
]
