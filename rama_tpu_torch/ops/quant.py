"""Weight-only group quantization over torch tensors: INT8 and packed INT4.

The port of `rama_tpu/ops/quant.py`. The consumption of the reference's v2
export format (engine/export/export.py:46-70, 182-260): symmetric per-group
scales, group_size contiguous input-dim elements per scale.

Layout contract (kernel-facing), as in the JAX package:
    q:      int8, (.., K, N) for int8, (.., K//2, N) for int4
    scales: fp32 or bf16, (.., K//gs, N) — one scale per (input-group, column);
            bf16 only after `cast_scales`, and every consumer (the plain
            paths here, the kernels) upcasts them to fp32 before use
INT4 packs two nibbles per byte in a *block-local split* layout: within each
block of 2*gs consecutive K rows, byte row j (j < gs) holds logical row
block_start + j in the low nibble and block_start + gs + j in the high
nibble, values in [-7, 7] (scale = absmax/7). Each byte row's two nibbles
belong to the block's two scale groups.

`quantize_int8` / `quantize_int4` / `quantize_embedding` are bit-identical
to the JAX package's (`quant.py:65-123,222-239`): the same fp32 divide and
round-half-to-even (`torch.round` rounds like `np.round`), the same group
size reduction and nibble packing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class QuantizedTensor:
    """Group-quantized 2-D (K, N) or stacked 3-D (L, K, N) weight: int8
    values, or int4 nibbles packed two per byte along K (q (.., K//2, N)).

    il > 0 marks the tile-interleaved fused-w13 column layout: columns are
    alternating il-wide tiles [W1_0 W3_0 W1_1 W3_1 ...] instead of the plain
    [W1 | W3] concat (models.llama._interleave_w13). Both tensors are kept
    contiguous: the CUDA kernels assume row-major (.., K, N)."""

    q: torch.Tensor        # int8; (.., K, N) for int8, (.., K//2, N) for int4
    scales: torch.Tensor   # fp32 or bf16 (cast_scales) (.., K//gs, N)
    group_size: int
    bits: int = 8
    il: int = 0

    @property
    def k_dim(self) -> int:
        k = self.q.shape[-2]
        return k * 2 if self.bits == 4 else k

    @property
    def shape(self) -> tuple:
        return (*self.q.shape[:-2], self.k_dim, self.q.shape[-1])

    @property
    def k_block(self) -> int:
        """Rows of K that no split may cut: a scale group (int8), or an int4
        packing block of two scale groups whose rows share bytes."""
        return 2 * self.group_size if self.bits == 4 else self.group_size

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(q=self.q.to(device), scales=self.scales.to(device),
                               group_size=self.group_size, bits=self.bits,
                               il=self.il)


@dataclass
class QuantizedEmbedding:
    """Embedding table quantized per-row along the feature dim: q (V, D)
    int8, scales (V, D//gs) fp32 — the v2 file's tok_embedding layout — or
    bf16 after cast_scales."""

    q: torch.Tensor
    scales: torch.Tensor
    group_size: int

    def to(self, device) -> "QuantizedEmbedding":
        return QuantizedEmbedding(q=self.q.to(device),
                                  scales=self.scales.to(device),
                                  group_size=self.group_size)

    def lookup(self, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
        rows = self.q[ids].float()                       # (.., D)
        s = self.scales[ids].float()                     # (.., D//gs)
        *lead, d = rows.shape
        gs = self.group_size
        out = rows.reshape(*lead, d // gs, gs) * s[..., None]
        return out.reshape(*lead, d).to(dtype)

    def as_classifier(self) -> QuantizedTensor:
        """Shared-classifier weight: exactly the embedding bytes in the kernel
        layout (D, V) with scales (D//gs, V). The JAX package returns a
        transposed view; here the transpose is materialized once, at load,
        because the kernels read row-major (K, N) only."""
        return QuantizedTensor(q=self.q.t().contiguous(),
                               scales=self.scales.t().contiguous(),
                               group_size=self.group_size, bits=8)


def _as_f32(w) -> torch.Tensor:
    if isinstance(w, np.ndarray):
        w = torch.from_numpy(np.ascontiguousarray(w, dtype=np.float32))
    return w.to(torch.float32)


def quantize_int8(w, group_size: int) -> QuantizedTensor:
    """w: (.., K, N) float -> Q8_0 along K in groups of group_size.

    group_size is reduced per tensor when it doesn't divide K (e.g.
    stories15M's dim 288 with the default 64 -> 32), as in the JAX package.
    """
    group_size = max(1, math.gcd(group_size, w.shape[-2]))
    wf = _as_f32(w)
    *lead, k, n = wf.shape
    wf = wf.reshape(*lead, k // group_size, group_size, n)
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scales = torch.clamp(absmax / 127.0, min=1e-10)
    q = torch.round(wf / scales).to(torch.int8).reshape(*lead, k, n)
    return QuantizedTensor(q=q.contiguous(), scales=scales[..., 0, :].contiguous(),
                           group_size=group_size, bits=8)


def quantize_embedding(w, group_size: int) -> QuantizedEmbedding:
    """w: (V, D) float -> per-row Q8_0 along D."""
    v, d = w.shape
    group_size = max(1, math.gcd(group_size, d))
    wf = _as_f32(w).reshape(v, d // group_size, group_size)
    absmax = wf.abs().amax(dim=-1, keepdim=True)
    scales = torch.clamp(absmax / 127.0, min=1e-10)
    q = torch.round(wf / scales).to(torch.int8).reshape(v, d)
    return QuantizedEmbedding(q=q.contiguous(), scales=scales[..., 0].contiguous(),
                              group_size=group_size)


def pick_int4_group_size(k: int, group_size: int, max_tp: int = 8) -> int:
    """Largest gs <= group_size with 2*gs dividing K/max_tp, so every TP shard
    boundary (tp | max_tp) falls on a packing-block boundary."""
    base = k // (2 * max_tp) if k % (2 * max_tp) == 0 else k // 2
    return max(math.gcd(group_size, base), 1)


def quantize_int4(w, group_size: int) -> QuantizedTensor:
    """w: (.., K, N) float -> block-local split packed int4 (module docstring).

    group_size may be reduced (pick_int4_group_size) so packing blocks align
    with row-parallel shard boundaries up to tp=8, as in the JAX package.
    """
    wf = _as_f32(w)
    *lead, k, n = wf.shape
    group_size = pick_int4_group_size(k, group_size)
    wf = wf.reshape(*lead, k // group_size, group_size, n)
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scales = torch.clamp(absmax / 7.0, min=1e-10)
    q = torch.clamp(torch.round(wf / scales), -7, 7).to(torch.int32)
    # (.., nb, 2, gs, n): axis -3 separates each block's lo/hi halves
    qb = q.reshape(*lead, k // (2 * group_size), 2, group_size, n)
    packed = (qb[..., 0, :, :] & 0x0F) | ((qb[..., 1, :, :] & 0x0F) << 4)
    packed = packed.to(torch.uint8).view(torch.int8).reshape(*lead, k // 2, n)
    return QuantizedTensor(q=packed.contiguous(), scales=scales[..., 0, :].contiguous(),
                           group_size=group_size, bits=4)


def unpack_int4(packed: torch.Tensor, group_size: int) -> torch.Tensor:
    """(.., K//2, N) block-local packed -> (.., K, N) int8 (sign-extended)."""
    p = packed.to(torch.int16)
    lo = (((p & 0x0F) ^ 8) - 8).to(torch.int8)
    hi = (p >> 4).to(torch.int8)  # arithmetic shift: int8 sign == high-nibble sign
    *lead, kh, n = packed.shape
    nb = kh // group_size
    out = torch.stack([lo.reshape(*lead, nb, group_size, n),
                       hi.reshape(*lead, nb, group_size, n)], dim=-3)  # (.., nb, 2, gs, n)
    return out.reshape(*lead, kh * 2, n)


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    q = unpack_int4(qt.q, qt.group_size) if qt.bits == 4 else qt.q
    *lead, k, n = q.shape
    gs = qt.group_size
    w = q.float().reshape(*lead, k // gs, gs, n) * qt.scales.float()[..., :, None, :]
    return w.reshape(*lead, k, n).to(dtype)


def from_q80_file_layout(q_file: np.ndarray, s_file: np.ndarray,
                         group_size: int) -> QuantizedTensor:
    """Convert checkpoint.QuantParams entries — int8 (.., out, in) with scales
    (.., out, in//gs) — to the kernel layout (.., in, out) / (.., in//gs, out)."""
    q = torch.from_numpy(np.ascontiguousarray(np.swapaxes(q_file, -1, -2)))
    s = torch.from_numpy(np.ascontiguousarray(np.swapaxes(s_file, -1, -2),
                                              dtype=np.float32))
    return QuantizedTensor(q=q, scales=s, group_size=group_size, bits=8)


def cast_scales(params: dict, dtype=torch.bfloat16) -> dict:
    """Cast every quantized leaf's STORED scales to `dtype` (usually bf16),
    as `rama_tpu/ops/quant.py:164 cast_scales` does: fewer weight bytes a
    step for a <= 2^-9 relative rounding of each scale; every path upcasts
    the scales to fp32 before use. Returns a new params dict; leaves that
    are not quantized pass through unchanged."""

    def one(p):
        if isinstance(p, QuantizedTensor):
            return QuantizedTensor(q=p.q, scales=p.scales.to(dtype).contiguous(),
                                   group_size=p.group_size, bits=p.bits, il=p.il)
        if isinstance(p, QuantizedEmbedding):
            return QuantizedEmbedding(q=p.q, scales=p.scales.to(dtype).contiguous(),
                                      group_size=p.group_size)
        return p

    return {k: one(v) for k, v in params.items()}


def matmul_plain(x: torch.Tensor, qt: QuantizedTensor, dtype=None) -> torch.Tensor:
    """Reference path: dequantize to `dtype` (default x's), then an fp32
    product — the counterpart of `matmul_xla` (quant.py:188-191), which
    dots the `dtype`-rounded weights with fp32 accumulation."""
    dtype = dtype or x.dtype
    w = dequantize(qt, dtype=dtype)
    return (x.to(dtype).float() @ w.float()).to(x.dtype)
