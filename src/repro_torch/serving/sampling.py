"""On-device batched sampling for the decode engine (port of
``repro.serving.sampling``).

Sampler state is a dict of per-slot tensors on the device:

  key         (S, 2) int64    per-slot PRNG key: two uint32 words held in
                              int64 (torch has no full uint32 arithmetic)
  temperature (S,)   float32  0 => greedy (argmax of raw logits)
  top_k       (S,)   int32    0 => disabled
  top_p       (S,)   float32  1.0 => disabled
  eos_id      (S,)   int32    -1 => no EOS
  remaining   (S,)   int32    token budget left
  done        (S,)   bool     device-side finished flag (EOS or budget)

Streams are keyed exactly as the reference keys them: ``fold_in(
PRNGKey(seed), rid)``, one key ``split`` per sampling step and Gumbel-max
draws from ``uniform`` bits — all under jax's partitionable threefry2x32
(jax 0.9's default), which is implemented here in torch with uint32
arithmetic emulated in int64.  Keys and uniform bits are bitwise those of
``jax.random``.  ``filter_logits_np`` / ``sample_np`` are the NumPy mirror
of the filtering pipeline (the test reference).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

SamplerState = Dict[str, torch.Tensor]

_NEG_INF = float("-inf")
_MIN_TEMP = 1e-6
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


# ------------------------------------------------------------- threefry

def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds), as jax's ``threefry2x32_p``.
    All arguments are int64 tensors (or ints) holding uint32 values and
    broadcast together; returns the two uint32 output words as int64."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device=None):
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (2,) int64."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)``: key (..., 2) -> (..., 2)."""
    zero = torch.zeros_like(key[..., 0])
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], zero,
                          zero + (int(data) & _M32))
    return torch.stack([y0, y1], dim=-1)


def split(key):
    """``jax.random.split(key)`` (num=2, partitionable): key (..., 2) ->
    (new key (..., 2), subkey (..., 2))."""
    zero = torch.zeros_like(key[..., 0])
    a = threefry2x32(key[..., 0], key[..., 1], zero, zero)
    b = threefry2x32(key[..., 0], key[..., 1], zero, zero + 1)
    return torch.stack(a, dim=-1), torch.stack(b, dim=-1)


def random_bits(key, n: int):
    """``jax.random.bits(key, (n,), uint32)`` per row: key (S, 2) ->
    (S, n) int64 (partitionable: word0 ^ word1 of the hash of counter i)."""
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[:, :1], key[:, 1:], torch.zeros_like(counts),
                          counts)
    return y0 ^ y1


def uniform(key, n: int, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` per row,
    bit for bit: the top 23 bits become the mantissa of a float in [1, 2)."""
    bits = random_bits(key, n)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key, n: int):
    """``jax.random.gumbel(key, (n,), float32)`` per row (mode "low")."""
    tiny = float(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(uniform(key, n, tiny, 1.0)))


# --------------------------------------------------------------- state

def init_state(max_slots: int, device=None) -> SamplerState:
    """All slots start done (free); admits activate them."""
    z = dict(device=device)
    return {
        "key": torch.zeros((max_slots, 2), dtype=torch.int64, **z),
        "temperature": torch.zeros((max_slots,), dtype=torch.float32, **z),
        "top_k": torch.zeros((max_slots,), dtype=torch.int32, **z),
        "top_p": torch.ones((max_slots,), dtype=torch.float32, **z),
        "eos_id": torch.full((max_slots,), -1, dtype=torch.int32, **z),
        "remaining": torch.zeros((max_slots,), dtype=torch.int32, **z),
        "done": torch.ones((max_slots,), dtype=torch.bool, **z),
    }


def admit_row(seed, rid, temperature, top_k, top_p, eos_id, budget,
              device=None) -> SamplerState:
    """One-row sampler state for a request being admitted (key folded from
    (seed, rid), so its draws depend only on how many tokens it has
    decoded).  ``eos_id`` is -1 or None for "no EOS"."""
    z = dict(device=device)
    return {
        "key": fold_in(prng_key(seed, device), rid)[None],
        "temperature": torch.tensor([temperature], dtype=torch.float32, **z),
        "top_k": torch.tensor([top_k], dtype=torch.int32, **z),
        "top_p": torch.tensor([top_p], dtype=torch.float32, **z),
        "eos_id": torch.tensor([-1 if eos_id is None else eos_id],
                               dtype=torch.int32, **z),
        "remaining": torch.tensor([budget], dtype=torch.int32, **z),
        "done": torch.zeros((1,), dtype=torch.bool, **z),
    }


def admit_rows(seed, rids, temperature, top_k, top_p, eos_id, budget,
               device=None) -> SamplerState:
    """Batched ``admit_row``: (D,) parameter vectors -> a D-row sampler
    state for the batched admit.  Row d's key is ``fold_in(PRNGKey(seed),
    rids[d])``, bit for bit the key ``admit_row`` builds for that request,
    so a request draws the same stream admitted alone or batched.  Rows
    not admitting carry stale parameters; the admit mask discards them.
    ``eos_id`` entries are -1 for "no EOS"."""
    z = dict(device=device)
    base = prng_key(seed, device)
    rids = [int(r) for r in np.asarray(rids).reshape(-1)]
    return {
        "key": torch.stack([fold_in(base, r) for r in rids]),
        "temperature": torch.tensor(np.asarray(temperature, np.float32),
                                    **z).reshape(-1),
        "top_k": torch.tensor(np.asarray(top_k, np.int32), **z).reshape(-1),
        "top_p": torch.tensor(np.asarray(top_p, np.float32),
                              **z).reshape(-1),
        "eos_id": torch.tensor(np.asarray(eos_id, np.int32),
                               **z).reshape(-1),
        "remaining": torch.tensor(np.asarray(budget, np.int32),
                                  **z).reshape(-1),
        "done": torch.zeros((len(rids),), dtype=torch.bool, **z),
    }


def admit_slot(state: SamplerState, slot: int, *, seed: int, rid: int,
               temperature: float, top_k: int, top_p: float, eos_id,
               budget: int) -> SamplerState:
    """Write one request's sampling parameters into slot ``slot`` (returns
    a new state; the input is not modified)."""
    row = admit_row(seed, rid, temperature, top_k, top_p, eos_id, budget,
                    device=state["key"].device)
    out = {k: v.clone() for k, v in state.items()}
    for k in out:
        out[k][slot] = row[k][0]
    return out


# ------------------------------------------------------------- filtering

def filter_logits(logits, temperature, top_k, top_p):
    """(S, V) logits + per-slot parameter tensors -> (S, V) scaled
    log-probs with excluded tokens at -inf.  Tokens tied with a cutoff are
    kept; both cutoffs come from one full-vocab sort (as the reference)."""
    logits = logits.float()
    v = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    scaled = logp / torch.clamp(temperature, min=_MIN_TEMP)[:, None]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    top_k = top_k.long()[:, None]
    kth = desc.gather(1, torch.clamp(top_k - 1, 0, v - 1))
    neg = torch.full((), _NEG_INF, device=logits.device)
    desc = torch.where((top_k > 0) & (desc < kth), neg, desc)
    keep = (top_k <= 0) | (scaled >= kth)
    p_desc = torch.softmax(desc, dim=-1)
    exclusive = torch.cumsum(p_desc, dim=-1) - p_desc
    inf = torch.full((), float("inf"), device=logits.device)
    cutoff = torch.where(exclusive < top_p[:, None], desc, inf).amin(-1)
    keep = keep & ((top_p >= 1.0)[:, None] | (scaled >= cutoff[:, None]))
    return torch.where(keep, scaled, neg)


# -------------------------------------------------------------- sampling

def sample(state: SamplerState, logits, stochastic=None):
    """One sampling step over all slots + done-flag advance.

    logits: (S, V).  Greedy slots (temperature <= 0) take the argmax of the
    raw logits; stochastic slots draw by Gumbel-max over the filtered
    log-probs.  ``stochastic`` is the caller's host-side knowledge that some
    slot may be live with temperature > 0 (None: read it from the device,
    a host sync); with False the filter/sort/draw pipeline is skipped, as
    the reference's ``lax.cond`` skips it.  The key splits every step for
    every slot.  Returns (tokens (S,) int32, new state)."""
    logits = logits.float()
    new_key, sub = split(state["key"])
    greedy = torch.argmax(logits, dim=-1)
    if stochastic is None:
        stochastic = bool(((state["temperature"] > 0.0)
                           & ~state["done"]).any())
    if stochastic:
        filtered = filter_logits(logits, state["temperature"],
                                 state["top_k"], state["top_p"])
        drawn = torch.argmax(filtered + gumbel(sub, logits.shape[-1]),
                             dim=-1)
        tok = torch.where(state["temperature"] > 0.0, drawn, greedy)
    else:
        tok = greedy
    tok = tok.to(torch.int32)
    active = ~state["done"]
    remaining = state["remaining"] - active.to(torch.int32)
    hit_eos = (state["eos_id"] >= 0) & (tok == state["eos_id"])
    done = state["done"] | (active & (hit_eos | (remaining <= 0)))
    return tok, {**state, "key": new_key, "remaining": remaining,
                 "done": done}


def sample_where(state: SamplerState, logits, active, stochastic=None):
    """``sample``, but only rows where ``active`` ((S,) bool) advance their
    state: the speculative verify stops a slot's key at its first rejected
    position, so the key splits once per emitted token, as plain decode
    splits it.  Rows are computed by the unmodified ``sample`` and masked
    back to the old state where inactive; inactive rows' tokens are
    whatever ``sample`` drew (callers mask them).  ``stochastic`` as in
    ``sample``: the stochastic branch is neutral for greedy rows, so a
    caller may pass ``True`` whenever any row it can touch draws."""
    tok, advanced = sample(state, logits, stochastic=stochastic)
    out = {}
    for k, old in state.items():
        mask = active.reshape(active.shape + (1,) * (old.ndim - 1))
        out[k] = torch.where(mask, advanced[k], old)
    return tok, out


# -------------------------------------------- NumPy mirror (host + tests)

def filter_logits_np(logits: np.ndarray, temperature: float, top_k: int,
                     top_p: float) -> np.ndarray:
    """Reference pipeline for one (V,) row — identical cutoff rules to
    ``filter_logits`` (ties with the cutoff value are kept)."""
    logits = np.asarray(logits, np.float64)
    logp = logits - np.logaddexp.reduce(logits)
    scaled = logp / max(temperature, _MIN_TEMP)
    if top_k > 0:
        kth = np.sort(scaled)[::-1][min(top_k, logits.size) - 1]
        scaled = np.where(scaled < kth, _NEG_INF, scaled)
    if top_p < 1.0:
        probs = np.exp(scaled - np.logaddexp.reduce(
            scaled[np.isfinite(scaled)]))
        desc = np.sort(probs)[::-1]
        exclusive = np.cumsum(desc) - desc
        cutoff = np.min(desc[exclusive < top_p])
        scaled = np.where(probs < cutoff, _NEG_INF, scaled)
    return scaled


def sample_np(rng: np.random.Generator, logits: np.ndarray, *,
              temperature: float, top_k: int = 0,
              top_p: float = 1.0) -> int:
    """Host-side draw matching the device pipeline's distribution."""
    if temperature <= 0.0:
        return int(np.argmax(logits))
    scaled = filter_logits_np(logits, temperature, top_k, top_p)
    keep = np.isfinite(scaled)
    p = np.zeros_like(scaled)
    p[keep] = np.exp(scaled[keep] - np.logaddexp.reduce(scaled[keep]))
    return int(rng.choice(p.size, p=p / p.sum()))
