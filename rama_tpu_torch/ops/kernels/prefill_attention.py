"""Kernel 4: causal flash attention for prefill, masked by prompt length.

The counterpart of `rama_tpu/ops/pallas/prefill_attention.py`'s
`prefill_attention`: query t of slot b (position t) sees cache row s iff
s <= t and s < plen[b]; the unnormalized probabilities are rounded to the
cache dtype before P.V, the normalizer is taken from the unrounded ones
(`csrc/prefill_attention.cu`).

One deliberate difference: a row with no visible key (plen == 0) outputs
zeros here. The Pallas kernel's -1e30 fill makes such a row the mean of
the first S-tile's values instead; the engine never prefills plen == 0
(every prompt starts with BOS), so no caller sees either value.

Dispatch: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
`prefill_attention_plain`.
"""

from __future__ import annotations

import math

import torch

from rama_tpu_torch.ops.kernels import build
from rama_tpu_torch.ops.kernels.build import I, P, require

launches = 0  # kernel launches since the last reset (chip_smoke reads it)

_SIGNATURES = {
    "rama_prefill_attention": [P, P, P, P, P, I, I, I, I, I, I, I, P],
}


def prefill_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, plen: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version. q (B, T, nh, hd); caches (B, nkv, S, hd) with
    rows 0..T-1 written; plen (B,). Returns (B, T, nh, hd) in q's dtype."""
    b, t, nh, hd = q.shape
    nkv, s = k_cache.shape[1], k_cache.shape[2]
    rep = nh // nkv
    qg = q.reshape(b, t, nkv, rep, hd).float()
    scores = torch.einsum("btkrh,bksh->btkrs", qg, k_cache.float()) / math.sqrt(hd)
    tpos = torch.arange(t, device=q.device)
    spos = torch.arange(s, device=q.device)
    visible = ((spos[None, None, :] <= tpos[None, :, None])
               & (spos[None, None, :] < plen.long()[:, None, None]))   # (B, T, S)
    scores = scores.masked_fill(~visible[:, :, None, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m)                                          # masked -> 0
    l = e.sum(dim=-1, keepdim=True)
    pv = torch.einsum("btkrs,bksh->btkrh", e.to(v_cache.dtype).float(),
                      v_cache.float())
    out = pv / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(b, t, nh, hd).to(q.dtype)


def prefill_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      plen: torch.Tensor) -> torch.Tensor:
    """Causal prefill attention over freshly written cache stripes.

    q (B, T, nh, hd): the prompt's queries at positions 0..T-1;
    k_cache/v_cache (B, nkv, S, hd), S >= T, rows 0..T-1 written;
    plen (B,) int32. Returns (B, T, nh, hd) in q's dtype."""
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k_cache, v_cache, plen)
    global launches
    require(q.device.type == "cuda", f"unsupported device {q.device}")
    require(q.dim() == 4 and k_cache.dim() == 4 and k_cache.shape == v_cache.shape,
            "q (B, T, nh, hd) and caches (B, nkv, S, hd) expected")
    b, t, nh, hd = q.shape
    bc, nkv, s, hdc = k_cache.shape
    require(bc == b and hdc == hd and s >= t, f"q {tuple(q.shape)} does not fit "
            f"cache {tuple(k_cache.shape)}")
    require(nh % nkv == 0 and 64 % (nh // nkv) == 0,
            f"GQA group nh/nkv={nh}/{nkv} must divide 64")
    require(hd % 2 == 0 and hd <= 256, f"head_dim {hd} must be even and <= 256")
    require(q.dtype == k_cache.dtype == v_cache.dtype,
            f"q {q.dtype} and cache {k_cache.dtype} dtypes differ")
    require(all(x.is_contiguous() for x in (q, k_cache, v_cache)),
            "q and caches must be contiguous")
    require(plen.dtype == torch.int32 and plen.shape == (b,) and plen.device == q.device
            and plen.is_contiguous(), "plen must be a contiguous (B,) int32 CUDA tensor")
    dtype = build.dtype_code(q)
    lib = build.library("prefill_attention", _SIGNATURES)
    out = torch.empty_like(q)
    err = lib.rama_prefill_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), plen.data_ptr(),
        out.data_ptr(), b, t, nh, nkv, s, hd, dtype, build.stream_ptr(q))
    build.check(lib, err, "prefill_attention")
    launches += 1
    return out
