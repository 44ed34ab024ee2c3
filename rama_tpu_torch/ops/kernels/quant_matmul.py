"""Kernel 1: int8 weight-only quantized matmul, y = x @ dequant(W[layer]).

The counterpart of `rama_tpu/ops/pallas/quant_matmul.py`'s
`quant_matmul_layered` (stacked weights, layer chosen by the kernel's
index maps) and `quant_matmul` (one 2-D weight): one CUDA kernel for both,
the layer is a pointer offset computed here from a Python int
(`csrc/quant_matmul.cu`, `csrc/qmv.cuh`).

Dispatch: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
`quant_matmul_plain`. Any K that is a multiple of the group size and any N
are taken; the ragged edges are masked in the kernel.
"""

from __future__ import annotations

import torch

from rama_tpu_torch.ops.kernels import build
from rama_tpu_torch.ops.kernels.build import I, P, require
from rama_tpu_torch.ops.quant import QuantizedTensor, matmul_plain

launches = 0  # kernel launches since the last reset (chip_smoke reads it)

# M <= 8 takes the weight-streaming GEMV (one CTA serves all rows); larger M
# the tiled kernel, which reads W once per 64 rows — so W streams once for
# any M <= 64, and the 8-slot decode step takes the GEMV.
GEMV_MAX_M = 8
_TARGET_CTAS = 264    # two CTAs per SM on the H100's 132
_QMV_COLS = 512       # output columns per GEMV CTA (csrc/qmv.cuh)
_SMEM_X_BYTES = 48 * 1024

_SIGNATURES = {
    "rama_qmv": [P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    "rama_qmm": [P, P, P, P, I, I, I, I, I, P],
}


def layer_of(qt: QuantizedTensor, layer: int | None) -> QuantizedTensor:
    if layer is None:
        return qt
    return QuantizedTensor(q=qt.q[layer], scales=qt.scales[layer],
                           group_size=qt.group_size, bits=qt.bits, il=qt.il)


def quant_matmul_plain(x: torch.Tensor, qt: QuantizedTensor,
                       layer: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: dequantize W[layer] to x's dtype, fp32 product."""
    return matmul_plain(x, layer_of(qt, layer))


def rows_per_cta(m: int) -> int:
    """MT of the GEMV: rows of x one CTA serves (1, 2, 4 or 8)."""
    return 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else 8


def split_k(ngroups: int, col_tiles: int, gs: int, mt: int) -> tuple[int, int]:
    """(ks, groups per split) for the split-K GEMV: enough splits that the
    grid covers ~2 CTAs per SM, whole scale groups per split, and the
    split's x slab (mt x gps*gs fp32) within the shared-memory budget."""
    ks = max(1, min(ngroups, -(-_TARGET_CTAS // col_tiles)))
    gps = -(-ngroups // ks)
    gps = max(1, min(gps, _SMEM_X_BYTES // (4 * mt * gs)))
    return -(-ngroups // gps), gps


def weight_ptrs(qt: QuantizedTensor, layer: int | None) -> tuple[int, int]:
    """Device addresses of W[layer]'s int8 values and fp32 scales."""
    if layer is None:
        require(qt.q.dim() == 2, f"2-D weight expected, got {tuple(qt.q.shape)}")
        return qt.q.data_ptr(), qt.scales.data_ptr()
    require(qt.q.dim() == 3, f"stacked (L, K, N) weight expected, got {tuple(qt.q.shape)}")
    L, k, n = qt.q.shape
    require(0 <= layer < L, f"layer {layer} out of range for {L} layers")
    return (qt.q.data_ptr() + layer * k * n,
            qt.scales.data_ptr() + layer * (k // qt.group_size) * n * 4)


def check_weight(qt: QuantizedTensor, device: torch.device) -> None:
    require(qt.bits == 8, "only int8 weights are ported (int4 is a later slice)")
    require(qt.q.dtype == torch.int8 and qt.scales.dtype == torch.float32,
            f"int8 q / float32 scales expected, got {qt.q.dtype} / {qt.scales.dtype}")
    require(qt.q.device == device and qt.scales.device == device,
            "weight and activation on different devices")
    require(qt.q.is_contiguous() and qt.scales.is_contiguous(),
            "weight q and scales must be contiguous (row-major (.., K, N))")
    k, n = qt.q.shape[-2:]
    require(k % qt.group_size == 0, f"K={k} not a multiple of group size {qt.group_size}")
    require(tuple(qt.scales.shape[-2:]) == (k // qt.group_size, n),
            f"scales shape {tuple(qt.scales.shape)} does not match q {tuple(qt.q.shape)}")


def quant_matmul(x: torch.Tensor, qt: QuantizedTensor,
                 layer: int | None = None) -> torch.Tensor:
    """x (M, K) @ dequant(qt[layer]) -> (M, N) in x's dtype, fp32 accumulation.

    qt is (K, N) with layer None, or stacked (L, K, N) with an int layer."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, qt, layer)
    global launches
    require(x.device.type == "cuda", f"unsupported device {x.device}")
    require(x.dim() == 2 and x.is_contiguous(), "x must be a contiguous (M, K) matrix")
    check_weight(qt, x.device)
    m, k = x.shape
    kq, n = qt.q.shape[-2:]
    require(k == kq, f"K mismatch: x {k} vs weight {kq}")
    dtype = build.dtype_code(x)
    qp, sp = weight_ptrs(qt, layer)
    gs = qt.group_size
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    lib = build.library("quant_matmul", _SIGNATURES)
    stream = build.stream_ptr(x)
    if m <= GEMV_MAX_M:
        mt = rows_per_cta(m)
        col_tiles = -(-n // _QMV_COLS)
        ks, gps = split_k(k // gs, col_tiles, gs, mt)
        part = (torch.empty((ks, m, n), dtype=torch.float32, device=x.device)
                if ks > 1 else y)
        tk = build.tickets(x.device, col_tiles * -(-m // mt))
        err = lib.rama_qmv(x.data_ptr(), qp, sp, y.data_ptr(), part.data_ptr(),
                           tk.data_ptr(), m, k, n, gs, ks, gps, dtype, stream)
    else:
        err = lib.rama_qmm(x.data_ptr(), qp, sp, y.data_ptr(), m, k, n, gs, dtype,
                           stream)
    build.check(lib, err, "quant_matmul")
    launches += 1
    return y
