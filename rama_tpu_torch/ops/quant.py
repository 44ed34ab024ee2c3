"""Weight-only INT8 group quantization over torch tensors.

The port of `rama_tpu/ops/quant.py` for the int8 slice (int4 is later work,
see ROADMAP.md). The consumption of the reference's v2 export format
(engine/export/export.py:46-70, 182-260): symmetric per-group scales,
group_size contiguous input-dim elements per scale.

Layout contract (kernel-facing), as in the JAX package:
    q:      int8, (.., K, N)        — input-dim-major, output columns
    scales: fp32, (.., K//gs, N)    — one scale per (input-group, column)

`quantize_int8` / `quantize_embedding` are bit-identical to the JAX
package's (`quant.py:65-89,222-239`): the same fp32 divide and
round-half-to-even (`torch.round` rounds like `np.round`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class QuantizedTensor:
    """Group-quantized 2-D (K, N) or stacked 3-D (L, K, N) int8 weight.

    il > 0 marks the tile-interleaved fused-w13 column layout: columns are
    alternating il-wide tiles [W1_0 W3_0 W1_1 W3_1 ...] instead of the plain
    [W1 | W3] concat (models.llama._interleave_w13). Both tensors are kept
    contiguous: the CUDA kernels assume row-major (.., K, N)."""

    q: torch.Tensor        # int8 (.., K, N)
    scales: torch.Tensor   # fp32 (.., K//gs, N)
    group_size: int
    bits: int = 8
    il: int = 0

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(q=self.q.to(device), scales=self.scales.to(device),
                               group_size=self.group_size, bits=self.bits,
                               il=self.il)


@dataclass
class QuantizedEmbedding:
    """Embedding table quantized per-row along the feature dim: q (V, D)
    int8, scales (V, D//gs) fp32 — the v2 file's tok_embedding layout."""

    q: torch.Tensor
    scales: torch.Tensor
    group_size: int

    def to(self, device) -> "QuantizedEmbedding":
        return QuantizedEmbedding(q=self.q.to(device),
                                  scales=self.scales.to(device),
                                  group_size=self.group_size)

    def lookup(self, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
        rows = self.q[ids].float()                       # (.., D)
        s = self.scales[ids]                             # (.., D//gs)
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


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    if qt.bits != 8:
        raise NotImplementedError("int4 weights are not ported yet (ROADMAP.md)")
    *lead, k, n = qt.q.shape
    gs = qt.group_size
    w = qt.q.float().reshape(*lead, k // gs, gs, n) * qt.scales.float()[..., :, None, :]
    return w.reshape(*lead, k, n).to(dtype)


def from_q80_file_layout(q_file: np.ndarray, s_file: np.ndarray,
                         group_size: int) -> QuantizedTensor:
    """Convert checkpoint.QuantParams entries — int8 (.., out, in) with scales
    (.., out, in//gs) — to the kernel layout (.., in, out) / (.., in//gs, out)."""
    q = torch.from_numpy(np.ascontiguousarray(np.swapaxes(q_file, -1, -2)))
    s = torch.from_numpy(np.ascontiguousarray(np.swapaxes(s_file, -1, -2),
                                              dtype=np.float32))
    return QuantizedTensor(q=q, scales=s, group_size=group_size, bits=8)


def matmul_plain(x: torch.Tensor, qt: QuantizedTensor, dtype=None) -> torch.Tensor:
    """Reference path: dequantize to `dtype` (default x's), then an fp32
    product — the counterpart of `matmul_xla` (quant.py:188-191), which
    dots the `dtype`-rounded weights with fp32 accumulation."""
    dtype = dtype or x.dtype
    w = dequantize(qt, dtype=dtype)
    return (x.to(dtype).float() @ w.float()).to(x.dtype)
