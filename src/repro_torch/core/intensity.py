"""Arithmetic-intensity model for batch-1 decode (paper Fig. 1 + Table II);
the port's copy of ``repro.core.intensity``, built on the port's mixer
registry (``cache_spec``, ``checkpoint_spec``, ``state_passes``,
``decode_flops``, ``decode_token_bytes``).

Counts per-token FLOPs and off-chip bytes for the *mixer* primitive of each
architecture family, at batch 1, FP32 state (paper convention).  This is the
analytical model used to reproduce the paper's claims:

  * GQA/MHSA transformer decode  ~  1 FLOP/B
  * GDN / DeltaNet / Mamba-2     <  1 FLOP/B  (more memory-bound)
  * ours (persistent state)      ~ 88 FLOP/B  (state I/O eliminated)
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Profile:
    name: str
    flops: float          # per token, mixer only
    state_bytes: float    # recurrent state / KV traffic per token (off-chip)
    token_bytes: float    # per-token input/output traffic

    @property
    def total_bytes(self) -> float:
        return self.state_bytes + self.token_bytes

    @property
    def intensity(self) -> float:
        return self.flops / self.total_bytes


def gdn_profile(h_v=32, h_k=16, d=128, w=4, persistent=False,
                fused=True) -> Profile:
    """Paper's GDN layer (Qwen3-Next config): h_v d x d state matrices.

    FLOPs per head (fused Alg. 2):
      read pass (r and S^T q):  2 * 2 * d^2      (two d x d mat-vecs)
      delta + output correct :  ~6 d
      write pass (rank-1 upd): 3 * d^2           (mul + mul + add)
    ~= 7 d^2 per v-head  -> h_v * 7 d^2 ~= 3.7 M;  with q^T k etc ~= 4.2 M
    (paper reports ~4.2 MFLOPs / token for the full layer).
    """
    flops = h_v * (7 * d * d + 8 * d)
    if persistent:
        state = 0.0
    else:
        # naive GPU reference: 3 read passes + 1 write; fused: 1 read + 1 write
        n_read = 1 if fused else 3
        state = (n_read + 1) * h_v * d * d * w
    token = (2 * h_k * d + 2 * h_v * d + 2 * h_v) * w  # q,k,v,o,gates
    return Profile("gdn", flops, state, token)


def gqa_profile(h_q=32, h_kv=8, d=128, seq=4096, w=2) -> Profile:
    """GQA softmax-attention decode: read the KV cache once per token."""
    flops = 2 * h_q * d * seq * 2           # qk^T and pv
    state = 2 * h_kv * d * seq * w          # K and V read
    state += 2 * h_kv * d * w               # append one kv
    token = (2 * h_q * d + 2 * h_kv * d) * w
    return Profile("gqa", flops, state, token)


def mamba2_profile(nheads=64, d_head=64, d_state=128, w=4,
                   persistent=False) -> Profile:
    """SSD decode: state (nheads, d_state, d_head); S = a S + B x^T; y = C^T S."""
    flops = nheads * (5 * d_state * d_head)
    state = 0.0 if persistent else 2 * nheads * d_state * d_head * w
    token = nheads * (2 * d_state + 2 * d_head) * w
    return Profile("mamba2", flops, state, token)


def rglru_profile(width=2560, w=4, persistent=False) -> Profile:
    """RG-LRU: elementwise diagonal recurrence over a vector state."""
    flops = 8 * width
    state = 0.0 if persistent else 2 * width * w
    token = 3 * width * w
    return Profile("rglru", flops, state, token)


# ---------------------------------------------------------------------------
# Spec-driven profiles: derive state bytes / intensity for a *config* from
# the same declarative `cache_spec` the model and serving engine are built
# on (single source of truth — no per-kind byte formulas duplicated here).
# ---------------------------------------------------------------------------

def mixer_cache_spec(cfg, kind: str, *, batch: int = 1, max_len: int = 4096):
    """The declarative cache spec of one mixer layer of `cfg`."""
    from repro_torch.models.mixers import get_mixer
    return get_mixer(kind).cache_spec(cfg, batch, max_len)


def mixer_state_bytes(cfg, kind: str) -> int:
    """Fixed-size persistent recurrent state of one layer (batch 1)."""
    return mixer_cache_spec(cfg, kind).state_bytes


def arch_state_bytes(cfg) -> int:
    """Whole-model persistent-state budget (batch 1) — the paper's Eq. 8
    'does the state fit on chip' precondition, summed over layers."""
    return sum(mixer_state_bytes(cfg, k) for k in cfg.layer_kinds)


def mixer_decode_profile(cfg, kind: str, *, seq: int = 4096,
                         persistent: bool = False) -> Profile:
    """Batch-1 decode profile of one mixer layer of `cfg`.

    Off-chip state traffic = `state_passes` (declared by the mixer: reads +
    writes per token on a round-trip backend) x the spec's state bytes, plus
    one read of any context-sized window/KV buffers.  `persistent=True`
    zeroes the fixed-state term (the paper's accelerator), leaving only the
    irreducible window/KV and token I/O.
    """
    from repro_torch.models.mixers import get_mixer
    m = get_mixer(kind)
    spec = m.cache_spec(cfg, 1, seq)
    state = 0.0 if persistent else float(m.state_passes * spec.state_bytes)
    state += float(spec.window_bytes)       # KV / rolling window read
    return Profile(kind, float(m.decode_flops(cfg, seq)), state,
                   float(m.decode_token_bytes(cfg)))


def arch_decode_profile(cfg, *, seq: int = 4096,
                        persistent: bool = False) -> Profile:
    """Whole-model batch-1 decode profile: per-layer profiles summed over
    the cycled pattern."""
    ps = [mixer_decode_profile(cfg, k, seq=seq, persistent=persistent)
          for k in cfg.layer_kinds]
    return Profile(cfg.name, sum(p.flops for p in ps),
                   sum(p.state_bytes for p in ps),
                   sum(p.token_bytes for p in ps))


def mixer_checkpoint_bytes(cfg, kind: str, *, max_len: int = 4096) -> int:
    """Per-slot speculative-rollback image of one layer — straight from
    the mixer's declarative ``checkpoint_spec`` (default: the full cache
    spec, i.e. one extra state copy per slot)."""
    from repro_torch.models.mixers import get_mixer
    return get_mixer(kind).checkpoint_spec(cfg, 1, max_len).nbytes


def arch_checkpoint_bytes(cfg, *, max_len: int = 4096) -> int:
    """Whole-model per-slot checkpoint budget, summed over layers."""
    return sum(mixer_checkpoint_bytes(cfg, k, max_len=max_len)
               for k in cfg.layer_kinds)


def speculative_decode_profile(cfg, *, k_draft: int, acceptance: float,
                               draft_cfg=None, seq: int = 4096,
                               persistent: bool = False) -> Profile:
    """Analytical per-*emitted*-token decode profile under draft–verify
    speculative decoding.

    A speculative tick runs the target datapath over k_draft + 1
    positions, the draft over 2 * k_draft + 1 (k_draft proposal steps
    plus the teacher-forced re-run inside the verify), and one
    checkpoint-buffer copy (a read + a write of the rollback image, the
    ``arch_checkpoint_bytes`` cost the cache-spec declaration
    propagates here).  It emits 1 + acceptance * k_draft tokens, so the
    per-emitted-token cost is the tick totals divided by that.  Note the
    target's state traffic per emitted token does NOT shrink (every
    verify position is a state pass) — what speculative decode amortizes
    is the *host sync* and per-tick scheduling overhead, by up to
    k_draft + 1 tokens per sync; the checkpoint makes that cost one
    state copy instead of a replay pass.

    ``acceptance`` is the per-drafted-token acceptance rate in [0, 1]
    (the scheduler's ``acceptance_rate`` metric).  ``draft_cfg``
    defaults to ``cfg`` (self-draft)."""
    if not 0.0 <= acceptance <= 1.0:
        raise ValueError(f"acceptance must be in [0, 1], got {acceptance}")
    if k_draft < 0:
        raise ValueError(f"k_draft must be >= 0, got {k_draft}")
    if draft_cfg is None:
        draft_cfg = cfg
    target = arch_decode_profile(cfg, seq=seq, persistent=persistent)
    draft = arch_decode_profile(draft_cfg, seq=seq, persistent=persistent)
    ckpt = 2.0 * arch_checkpoint_bytes(cfg, max_len=seq)   # read + write
    emitted = 1.0 + acceptance * k_draft
    positions = k_draft + 1
    flops = (target.flops * positions
             + draft.flops * (2 * k_draft + 1)) / emitted
    state = (target.state_bytes * positions
             + draft.state_bytes * (2 * k_draft + 1) + ckpt) / emitted
    token = (target.token_bytes * positions
             + draft.token_bytes * (2 * k_draft + 1)) / emitted
    return Profile(f"{cfg.name}+spec(k={k_draft})", flops, state, token)


def paper_table2() -> dict:
    """Reproduce paper Table II (h_v=32, d=128, FP32)."""
    gpu = gdn_profile(persistent=False, fused=False)
    ours = gdn_profile(persistent=True)
    return {
        "gpu": {"flops": gpu.flops, "state_bytes": gpu.state_bytes,
                "token_bytes": gpu.token_bytes,
                "intensity": gpu.intensity},
        "ours": {"flops": ours.flops, "state_bytes": 0.0,
                 "token_bytes": ours.token_bytes,
                 "intensity": ours.intensity},
    }


def fig1_intensities() -> dict:
    """Batch-1 decode intensity by family (paper Fig. 1 ordering)."""
    return {
        "mhsa_gqa": gqa_profile().intensity,
        "gdn": gdn_profile(persistent=False, fused=False).intensity,
        "mamba2": mamba2_profile().intensity,
        "gdn_ours_persistent": gdn_profile(persistent=True).intensity,
    }
