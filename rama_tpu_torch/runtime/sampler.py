"""Token sampling: greedy argmax and temperature + nucleus (top-p).

The port of rama_tpu/runtime/sampler.py. Reference semantics kept exactly
(engine/src/device/cpu.rs:155-179, engine/src/transformer/infer.rs:55-85):
- temperature == 0 -> greedy argmax;
- temperature < 1 scales logits; temperature > 1 does NOT (a reference
  quirk the goldens depend on);
- top-p: drop probs <= (1-p)/(V-1), sort descending, cut at the first prefix
  whose cumulative mass exceeds p, draw r = u * cum_prob and walk the CDF.

The uniforms are inputs (`_top_p_from_u`), so tests can feed the port the
JAX package's draws and compare ids exactly. For serving, each draw is a
counter-based function `uniform_from_key(slot_key, pos)` computed with
integer tensor ops, bit-identical on the CPU and on CUDA, so a slot's
stream does not depend on how steps are grouped into ticks — the contract
`fold_in_pos` gives in JAX (sampler.py:133-152). It does NOT reproduce
JAX's threefry bits: the same seed gives other samples than rama_tpu.
"""

from __future__ import annotations

import torch

# top-k prefilter width: when the nucleus provably closes within the top
# TOPK_CAP probabilities (or everything past them is under the top-p floor)
# the CDF walk runs on (B, TOPK_CAP); otherwise the exact full sort runs.
# Results are identical to the always-full-sort path (sampler.py:30-37).
TOPK_CAP = 1024


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """(..., V) logits -> (...,) int64 argmax ids (first maximum on ties)."""
    return torch.argmax(logits, dim=-1)


def _nucleus_walk(sp, si, u, tp, cutoff) -> torch.Tensor:
    """Reference CDF walk over descending probs sp (B, W) with ids si."""
    keep = sp > cutoff
    spk = torch.where(keep, sp, torch.zeros_like(sp))
    csum = torch.cumsum(spk, dim=-1)
    over = csum > tp
    n_kept = keep.sum(dim=-1).clamp(min=1)
    first_over = torch.argmax(over.to(torch.int8), dim=-1)
    last_index = torch.where(over.any(dim=-1), first_over, n_kept - 1)
    cum_prob = torch.gather(csum, 1, last_index[:, None])[:, 0]
    r = u * cum_prob
    idx = torch.arange(sp.shape[-1], device=sp.device)[None, :]
    cand = (r[:, None] < csum) & (idx <= last_index[:, None]) & keep
    pick = torch.where(cand.any(dim=-1), torch.argmax(cand.to(torch.int8), dim=-1),
                       last_index)
    return torch.gather(si, 1, pick[:, None])[:, 0]


def _full_sort(probs):
    return torch.sort(probs, dim=-1, descending=True, stable=True)


def _top_p_from_u(logits: torch.Tensor, u: torch.Tensor, temperature, top_p
                  ) -> torch.Tensor:
    """Nucleus sampling over (B, V) logits with one uniform u (B,) in [0, 1)
    per row -> (B,) int64 ids. temperature / top_p: scalars or (B,)."""
    b, v = logits.shape
    dev = logits.device
    logits = logits.float()
    tp = torch.as_tensor(top_p, dtype=torch.float32, device=dev).expand(b)[:, None]
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=dev).expand(b)[:, None]
    # reference only scales when temperature < 1.0 (cpu.rs:170-172)
    scale = torch.where(temp < 1.0, 1.0 / temp.clamp(min=1e-6), torch.ones_like(temp))
    probs = torch.softmax(logits * scale, dim=-1)
    u = u.to(device=dev, dtype=torch.float32)
    cutoff = (1.0 - tp) / (v - 1)
    if v <= 2 * TOPK_CAP:
        sp, si = _full_sort(probs)
        return _nucleus_walk(sp, si, u, tp, cutoff)
    topv, topi = torch.topk(probs, TOPK_CAP, dim=-1, sorted=True)
    kept_cap = torch.where(topv > cutoff, topv, torch.zeros_like(topv))
    row_exact = (topv[:, -1] <= cutoff[:, 0]) | (kept_cap.sum(dim=-1) > tp[:, 0])
    if bool(row_exact.all()):
        return _nucleus_walk(topv, topi, u, tp, cutoff)
    sp, si = _full_sort(probs)
    return _nucleus_walk(sp, si, u, tp, cutoff)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for 32-bit values held in int64, without overflow:
    the constant is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer (a bijective avalanche mix)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniform_from_key(slot_keys: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Counter-based uniforms: slot_keys (B, 2) holding uint32 values, pos
    (B,) -> (B,) float32 in [0, 1), a pure function of (key, position).
    Integer ops only, so the CPU and the card give the same bits."""
    k = slot_keys.to(torch.int64) & _M32
    p = pos.to(torch.int64) & _M32
    h = _fmix32(k[:, 0] ^ _fmix32((p + 0x9E3779B9) & _M32))
    h = _fmix32(h ^ k[:, 1])
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def sample_batched_keyed(logits: torch.Tensor, slot_keys: torch.Tensor,
                         pos: torch.Tensor, temperature: torch.Tensor,
                         top_p: torch.Tensor) -> torch.Tensor:
    """Per-slot sampling for the engine: slot i draws u(slot_keys[i], pos[i]);
    rows with temperature == 0 decode greedily."""
    u = uniform_from_key(slot_keys, pos)
    nucleus = _top_p_from_u(logits, u, temperature, top_p)
    return torch.where(temperature == 0.0, sample_greedy(logits), nucleus)
