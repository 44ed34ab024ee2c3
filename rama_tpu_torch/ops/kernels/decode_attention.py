"""Kernel 3: T=1 decode attention against layer l of the stacked KV cache.

The counterpart of `rama_tpu/ops/pallas/decode_attention.py`'s
`decode_attention_layer` and `decode_attention_layer_tiled` (one function:
GQA softmax(q k^T / sqrt(hd)) v over cache rows s <= pos[b]). On the card,
a flash-decoding kernel split over S plus a combine pass
(`csrc/decode_attention.cu`).

Dispatch: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
`decode_attention_plain`.
"""

from __future__ import annotations

import math

import torch

from rama_tpu_torch.ops.kernels import build
from rama_tpu_torch.ops.kernels.build import I, P, require

launches = 0  # kernel launches since the last reset (chip_smoke reads it)

CHUNK = 64  # cache rows per CTA (csrc/decode_attention.cu)

_SIGNATURES = {
    "rama_decode_attention": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P],
}


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: torch.Tensor,
                           layer: int) -> torch.Tensor:
    """Plain PyTorch version (the XLA einsum path of rama_tpu's `_attention`):
    fp32 scores, -1e30 mask fill, softmax, probabilities cast to the cache
    dtype before P.V. Returns (B, nh * hd) in q's dtype."""
    k, v = k_cache[layer], v_cache[layer]            # (B, nkv, S, hd)
    b, nh, hd = q.shape
    nkv, s = k.shape[1], k.shape[2]
    qg = q.reshape(b, nkv, nh // nkv, hd).float()
    scores = torch.einsum("bkrh,bksh->bkrs", qg, k.float()) / math.sqrt(hd)
    visible = torch.arange(s, device=q.device)[None, :] <= pos.long()[:, None]
    scores = torch.where(visible[:, None, None, :], scores,
                         torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrs,bksh->bkrh", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, nh * hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor, layer: int) -> torch.Tensor:
    """q (B, nh, hd) against layer `layer` of k/v caches (L, B, nkv, S, hd),
    visible rows s <= pos[b] (pos (B,) int32, clamped to [0, S-1] on the
    card). Returns (B, nh * hd) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos, layer)
    global launches
    require(q.device.type == "cuda", f"unsupported device {q.device}")
    require(q.dim() == 3 and k_cache.dim() == 5 and k_cache.shape == v_cache.shape,
            "q (B, nh, hd) and caches (L, B, nkv, S, hd) expected")
    b, nh, hd = q.shape
    L, bc, nkv, s, hdc = k_cache.shape
    require(bc == b and hdc == hd, f"q {tuple(q.shape)} does not fit cache "
            f"{tuple(k_cache.shape)}")
    require(nh % nkv == 0 and nh // nkv <= 8, f"GQA group nh/nkv={nh}/{nkv} must be <= 8")
    require(hd % 8 == 0 and hd <= 256, f"head_dim {hd} must be a multiple of 8, <= 256")
    require(0 <= layer < L, f"layer {layer} out of range for {L} layers")
    require(q.dtype == k_cache.dtype == v_cache.dtype,
            f"q {q.dtype} and cache {k_cache.dtype} dtypes differ")
    require(all(t.is_contiguous() for t in (q, k_cache, v_cache)),
            "q and caches must be contiguous")
    require(pos.dtype == torch.int32 and pos.shape == (b,) and pos.device == q.device
            and pos.is_contiguous(), "pos must be a contiguous (B,) int32 CUDA tensor")
    dtype = build.dtype_code(q)
    lib = build.library("decode_attention", _SIGNATURES)
    nsplit = -(-s // CHUNK)
    out = torch.empty((b, nh * hd), dtype=q.dtype, device=q.device)
    part_o = torch.empty((b, nh, nsplit, hd), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, nh, nsplit, 2), dtype=torch.float32, device=q.device)
    off = layer * b * nkv * s * hd * q.element_size()
    err = lib.rama_decode_attention(
        q.data_ptr(), k_cache.data_ptr() + off, v_cache.data_ptr() + off,
        pos.data_ptr(), out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
        b, nh, nkv, s, hd, CHUNK, dtype, build.stream_ptr(q))
    build.check(lib, err, "decode_attention")
    launches += 1
    return out
