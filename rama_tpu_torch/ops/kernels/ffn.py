"""Kernel 2: the SwiGLU FFN of one layer at decode M, int8 or packed int4
weights, out = (silu(x @ W1[l]) * (x @ W3[l])) @ W2[l].

The counterpart of `rama_tpu/ops/pallas/ffn.py`'s `ffn_fused_layered`
(its int8 and int4 branches). Two launches on the card (`csrc/ffn.cu`): a
w13 GEMV whose last CTA per hidden tile applies silu(a) * c and writes h in
x's dtype (the Pallas kernel rounds h to bf16 in VMEM, ffn.py:170; on the
bf16 serving path the rounding is the same), then the w2 GEMV of
`csrc/qmv.cuh` over h. Each weight's bits choose its kernels'
instantiation; the int8 and int4 FFNs have their own launch counts.

Dispatch: a CUDA tensor launches the kernels (or raises), a CPU tensor runs
`ffn_plain`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rama_tpu_torch.ops.kernels import build
from rama_tpu_torch.ops.kernels.build import I, P, require
from rama_tpu_torch.ops.kernels.quant_matmul import (_QMV_COLS, check_weight,
                                                     layer_of, rows_per_cta,
                                                     split_k, weight_ptrs)
from rama_tpu_torch.ops.quant import QuantizedTensor, dequantize, matmul_plain

# wrapper calls that launched the kernels since the last reset, by the w13
# weight's bits
launches = {8: 0, 4: 0}

_UNITS = 256      # hidden units per w13 CTA (csrc/ffn.cu)
FFN_MAX_M = 32    # rows the kernels serve (csrc/ffn.cu: 8-row chunks above 8)

_SIGNATURES = {
    "rama_ffn_w13": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P],
    "rama_ffn_w2": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
}


def split_h13(h13: torch.Tensor, w13) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a fused up-projection activation into (h1, h3), honoring the
    w13 column layout: plain halves, or il-wide tiles interleaved
    [W1_0 W3_0 W1_1 W3_1 ...] (rama_tpu/models/llama.py:332-341)."""
    il = getattr(w13, "il", 0)
    if not il:
        return tuple(torch.chunk(h13, 2, dim=-1))
    *lead, n = h13.shape
    t = h13.reshape(*lead, n // (2 * il), 2, il)
    return (t[..., 0, :].reshape(*lead, n // 2), t[..., 1, :].reshape(*lead, n // 2))


def ffn_plain(x: torch.Tensor, w13: QuantizedTensor, w2: QuantizedTensor,
              layer: int) -> torch.Tensor:
    """Plain PyTorch version: fp32 up-projections of the x.dtype-rounded
    weights, h = silu(a) * c rounded to x's dtype, then the w2 product."""
    h13 = x.float() @ dequantize(layer_of(w13, layer), dtype=x.dtype).float()
    a, c = split_h13(h13, w13)
    h = (F.silu(a) * c).to(x.dtype)
    return matmul_plain(h, layer_of(w2, layer))


def ffn(x: torch.Tensor, w13: QuantizedTensor, w2: QuantizedTensor,
        layer: int) -> torch.Tensor:
    """x (M, K) -> (silu(x @ W1[l]) * (x @ W3[l])) @ W2[l], (M, N) in x's dtype.

    w13: stacked fused (L, K, 2H) with plain or il-interleaved columns;
    w2: stacked (L, H, N); each int8 or int4 (packed along K)."""
    if x.device.type == "cpu":
        return ffn_plain(x, w13, w2, layer)
    require(x.device.type == "cuda", f"unsupported device {x.device}")
    require(x.dim() == 2 and x.is_contiguous(), "x must be a contiguous (M, K) matrix")
    check_weight(w13, x.device)
    check_weight(w2, x.device)
    m, k = x.shape
    require(m <= FFN_MAX_M, f"the FFN kernel serves decode M <= {FFN_MAX_M}, got {m}")
    require(w13.q.dim() == 3 and w2.q.dim() == 3, "stacked (L, K, N) w13 / w2 expected")
    h2 = w13.q.shape[-1]
    hdim, n = w2.k_dim, w2.q.shape[-1]
    require(k == w13.k_dim and h2 == 2 * hdim, f"w13 {w13.shape} / w2 {w2.shape} do "
            f"not fit x {tuple(x.shape)}")
    require(not w13.il or hdim % w13.il == 0, f"il {w13.il} does not divide H={hdim}")
    dtype = build.dtype_code(x)
    q13, s13 = weight_ptrs(w13, layer)
    q2, s2 = weight_ptrs(w2, layer)
    lib = build.library("ffn", _SIGNATURES)
    stream = build.stream_ptr(x)
    mt = rows_per_cta(m)
    mchunks = -(-m // mt)

    h = torch.empty((m, hdim), dtype=x.dtype, device=x.device)
    tiles = -(-hdim // _UNITS)
    ks, bps = split_k(k // w13.k_block, tiles, w13.k_block, mt)
    part = (torch.empty((ks, m, h2), dtype=torch.float32, device=x.device)
            if ks > 1 else h)
    tk = build.tickets(x.device, max(tiles, -(-n // _QMV_COLS)) * mchunks)
    err = lib.rama_ffn_w13(x.data_ptr(), q13, s13, h.data_ptr(), part.data_ptr(),
                           tk.data_ptr(), m, k, hdim, w13.group_size, w13.il, ks, bps,
                           w13.bits, dtype, stream)
    build.check(lib, err, f"ffn (w13, int{w13.bits})")

    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    ks2, bps2 = split_k(hdim // w2.k_block, -(-n // _QMV_COLS), w2.k_block, mt)
    part2 = (torch.empty((ks2, m, n), dtype=torch.float32, device=x.device)
             if ks2 > 1 else y)
    err = lib.rama_ffn_w2(h.data_ptr(), q2, s2, y.data_ptr(), part2.data_ptr(),
                          tk.data_ptr(), m, hdim, n, w2.group_size, ks2, bps2, w2.bits,
                          dtype, stream)
    build.check(lib, err, f"ffn (w2, int{w2.bits})")
    launches[w13.bits] += 1
    return y
