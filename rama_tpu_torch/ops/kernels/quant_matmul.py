"""Kernel 1: weight-only quantized matmul, y = x @ dequant(W[layer]), with
int8 or block-local packed int4 weights.

The counterpart of `rama_tpu/ops/pallas/quant_matmul.py`'s
`quant_matmul_layered` (stacked weights, layer chosen by the kernel's
index maps) and `quant_matmul` (one 2-D weight): one CUDA kernel for both,
the layer is a pointer offset computed here from a Python int
(`csrc/quant_matmul.cu`, `csrc/swapab.cuh`, `csrc/qmv.cuh`). The int8
and the int4 weights take sibling instantiations of the same kernels (a
`bits` argument), and each has its own launch count. So do f32 and
bf16-stored scales (`cast_scales`; a scale-type code, counted in
`launches_by_scale`): every body reads bf16 scales as they are and turns
each into f32 where it reads it, with the same plan as for f32 scales, so
a bf16-scale launch equals the same body fed `scales.float()` bit for bit.
A bf16 scale is never upcast into a temporary f32 copy here.

Dispatch: a CUDA tensor launches a kernel body (or raises), a CPU tensor
runs `quant_matmul_plain`. The body is fixed by dtype and M before the
launch (`body_for`): bf16 up to MMV_MAX_M rows takes the swap-AB
tensor-core body ("mmv": every row of x in one CTA, each weight byte read
once, the shared body of `csrc/swapab.cuh`; `mmv_plan` picks its CTA width
and K splits), larger M the tensor-core GEMM ("mma"); fp32 up to
GEMV_MAX_M rows the split-K GEMV on the CUDA cores ("gemv"), larger M the
CUDA-core tiled GEMM ("simt"). A refused launch raises; it never gives
way to another body. Any K that is a multiple of the group size (of two
group sizes, a packing block, for int4) and any N are taken; the ragged
edges are masked in the kernel.
"""

from __future__ import annotations

import functools
import math

import torch

from rama_tpu_torch.ops.kernels import build
from rama_tpu_torch.ops.kernels.build import I, P, require
from rama_tpu_torch.ops.quant import QuantizedTensor, matmul_plain

# kernel launches since the last reset, by weight bits (chip_smoke reads them)
launches = {8: 0, 4: 0}
launches_by_body = {"mmv": 0, "gemv": 0, "mma": 0, "simt": 0}   # the same launches by body
launches_by_scale = {"f32": 0, "bf16": 0}   # ... and by the weight scales' stored dtype
# the weight-scale dtypes the kernels read (passed as build.dtype_code), by
# their launches_by_scale key
SCALE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}

# Small M takes a weight-streaming body whose CTAs serve every row (the
# 8-slot decode step; in bf16 also a verify round of 8 slots x 4 tokens:
# the swap-AB body beats the GEMM at M = 16 and 32 on the H100, PERF.md);
# larger M a GEMM that reads W once per 32-256 rows (prefill chunks).
GEMV_MAX_M = 8     # fp32: the CUDA-core GEMV
MMV_MAX_M = 32     # bf16: the swap-AB tensor-core body (its NT = 4 n8 tiles)
_TARGET_CTAS = 264    # two CTAs per SM on the H100's 132
_QMV_COLS = 512       # output columns per GEMV CTA (csrc/qmv.cuh)
_SMEM_X_BYTES = 48 * 1024
MMA_BK = 64           # logical K rows per slab of the tensor-core GEMM
MMA_BN = 128          # output columns per CTA of it (csrc/quant_matmul.cu)
_MMA_MIN_SLABS = 4    # K slabs a split runs at least (the cp.async ring fills)
_MMA_CTAS_PER_SM = {32: 3, 64: 2, 128: 2, 256: 1}   # MmaCfg::kCtas
_SMS = 132            # the H100's SMs
_MMA_MAX_SPLITS = 8
MMV_WIDTHS = (128, 256)      # columns a CTA of the decode body (csrc/quant_matmul.cu)
_MMV_CTAS_PER_SM = {128: 4, 256: 2}   # MmvCfg::kCtas (the register cap)
_SMEM_PER_SM = 233472        # the H100's shared memory an SM (228 KB)
_SMEM_PER_CTA = 1024         # reserved by the runtime for each resident CTA
SWAB_MIN_SLABS = 4           # K slabs a split of a swap-AB body runs at least
SWAB_MAX_SPLITS = 16         # (the cp.async ring fills)

_SIGNATURES = {
    "rama_qmv": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P],
    "rama_qmm": [P, P, P, P, I, I, I, I, I, I, P],
    "rama_qmm_mma": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P],
    "rama_qmv_mma": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P],
}


def body_for(dtype: torch.dtype, m: int) -> str:
    """The kernel body a CUDA call of M rows launches: for bf16 "mmv" (the
    swap-AB tensor-core body) up to MMV_MAX_M rows, then "mma" (the
    tensor-core GEMM); for fp32 "gemv" (the CUDA-core GEMV) up to GEMV_MAX_M
    rows, then "simt" (the CUDA-core tiled GEMM)."""
    if dtype == torch.bfloat16:
        return "mmv" if m <= MMV_MAX_M else "mma"
    return "gemv" if m <= GEMV_MAX_M else "simt"


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


def split_k(nblocks: int, col_tiles: int, block_rows: int, mt: int,
            target: int = _TARGET_CTAS) -> tuple[int, int]:
    """(ks, K blocks per split) for the split-K GEMV: enough splits that the
    grid covers ~`target` CTAs (two per SM by default), whole K blocks per
    split (QuantizedTensor.k_block: scale groups for int8, packing blocks
    for int4), and the split's x slab (mt x bps*block_rows fp32) within the
    shared-memory budget."""
    ks = max(1, min(nblocks, -(-target // col_tiles)))
    bps = -(-nblocks // ks)
    bps = max(1, min(bps, _SMEM_X_BYTES // (4 * mt * block_rows)))
    return -(-nblocks // bps), bps


@functools.lru_cache(maxsize=None)
def mma_plan(m: int, n: int, k: int, k_block: int, vec: bool = True,
             sms: int = _SMS) -> tuple[int, int, int]:
    """(bm, ks, slabs per split) of the tensor-core GEMM: bm rows a CTA (32
    up to M = 32, 64 up to 64, 128 up to 128, else 256; 64 on the masked
    path, vec False), and K split across ks CTAs in whole MMA_BK-row slabs
    and whole K blocks (QuantizedTensor.k_block), each split running at
    least _MMA_MIN_SLABS slabs where K has them. At bm 32 (a verify round:
    the weight bytes set the pace) the splits fill the CTA slots (`sms` x
    _MMA_CTAS_PER_SM[bm]) up to _MMA_MAX_SPLITS; at larger bm (the tensor
    cores set the pace) K is split only when the output tiles fill less
    than a third of the slots, as the extra partial sums cost more than a
    tail wave saves."""
    bm = 64 if not vec else 32 if m <= 32 else 64 if m <= 64 else 128 if m <= 128 else 256
    nslabs = -(-k // MMA_BK)
    unit = math.lcm(MMA_BK, k_block) // MMA_BK     # slabs a split unit
    nunits = -(-nslabs // unit)
    tiles = -(-m // bm) * -(-n // MMA_BN)
    slots = sms * _MMA_CTAS_PER_SM[bm]
    if bm == 32:
        want = min(slots // tiles, _MMA_MAX_SPLITS)
    else:
        want = -(-slots // tiles) if 3 * tiles < slots else 1
    ks = max(1, min(want, nslabs // _MMA_MIN_SLABS, nunits))
    sps = -(-nunits // ks) * unit
    return bm, -(-nslabs // sps), sps


def mmv_ctas_per_sm(bn: int, nt: int, bits: int) -> int:
    """CTAs of the decode body an SM holds: MmvCfg's register cap, or fewer
    where its shared memory (swab_smem_bytes, csrc/swapab.cuh: a ring of 4
    stages of x rows, raw weight bytes and scale rows) does not fit. A
    stage keeps room for 4 f32 scale rows whichever the scales' dtype, so
    the plan does not depend on it."""
    xrows = 16 if nt < 2 else 8 * nt
    qrows = MMA_BK if bits == 8 else MMA_BK // 2
    stage = xrows * (MMA_BK + 8) * 2 + qrows * (bn + 16) + 4 * bn * 4
    smem = max(4 * stage, xrows * (bn + 4) * 4)
    return min(_MMV_CTAS_PER_SM[bn], _SMEM_PER_SM // (smem + _SMEM_PER_CTA))


def split_options(k: int, k_block: int):
    """Each way a swap-AB body (K1's qmv_mma, K3's ffn_mma) may split K
    across CTAs: whole MMA_BK-row slabs and whole K blocks (k_block: a
    scale group, or an int4 packing block), at least SWAB_MIN_SLABS slabs
    a split where K has them, up to SWAB_MAX_SPLITS splits. Yields (ks,
    sps): ks splits of sps slabs (the last may hold fewer), by rising ks."""
    nslabs = -(-k // MMA_BK)
    unit = math.lcm(MMA_BK, k_block) // MMA_BK     # slabs a split unit
    nunits = -(-nslabs // unit)
    seen = set()
    for want in range(1, max(1, min(nunits, nslabs // SWAB_MIN_SLABS, SWAB_MAX_SPLITS)) + 1):
        sps = -(-nunits // want) * unit
        ks = -(-nslabs // sps)
        if ks not in seen:
            seen.add(ks)
            yield ks, sps


@functools.lru_cache(maxsize=None)
def mmv_plan(m: int, n: int, k: int, k_block: int, bits: int, vec: bool = True,
             sms: int = _SMS) -> tuple[int, int, int, int]:
    """(bn, tiles, ks, sps) of the decode body: bn columns a CTA (one of
    MMV_WIDTHS), `tiles` column tiles, and K in ks splits of sps slabs
    (split_options). The grid that fills the most of one wave of CTA slots
    (mmv_ctas_per_sm) without starting a second, the narrower width on a
    tie: once every CTA is resident, a call takes about as long as its
    longest split's stream, so the most CTAs that run at once win, and a
    second, partial wave costs a whole split (a sweep over both widths and
    1-32 splits at 7B's wqkv, wo and lm_head, int8 and int4, M = 1 / 8 / 16
    / 32, on the H100). Where no split of either width fits one wave, 256
    columns and one split. The masked path (vec False) has 128-column CTAs
    only."""
    nt = 1 if m <= 8 else 2 if m <= 16 else 4
    best = None
    for bn in MMV_WIDTHS if vec else (128,):
        tiles = -(-n // bn)
        slots = sms * mmv_ctas_per_sm(bn, nt, bits)
        for ks, sps in split_options(k, k_block):
            fill = tiles * ks / slots
            if fill <= 1 and (best is None or fill > best[0]):
                best = (fill, bn, tiles, ks, sps)
    if best is None:
        bn = 256 if vec else 128
        return bn, -(-n // bn), 1, -(-k // MMA_BK)
    return best[1:]


def mma_vec(x: torch.Tensor, qt: QuantizedTensor, qp: int, sp: int) -> bool:
    """Whether the tensor-core GEMM takes its cp.async path: 16-byte copies
    of x, weight and scale rows (N and the group size multiples of 16, so
    f32 and bf16 scale rows alike start on 16 bytes; every pointer 16-byte
    aligned), and a group size that divides, or is a
    multiple of, a slab's weight rows (64, or 32 packed int4 byte rows);
    the masked path otherwise."""
    gs, span = qt.group_size, MMA_BK if qt.bits == 8 else MMA_BK // 2
    return (qt.q.shape[-1] % 16 == 0 and gs % 16 == 0 and (span % gs == 0 or gs % span == 0)
            and all(p % 16 == 0 for p in (x.data_ptr(), qp, sp)))


def weight_ptrs(qt: QuantizedTensor, layer: int | None) -> tuple[int, int]:
    """Device addresses of W[layer]'s values (int8 or packed int4 bytes) and
    scales (f32 or bf16: the offset is in the scales' own element size)."""
    if layer is None:
        require(qt.q.dim() == 2, f"2-D weight expected, got {tuple(qt.q.shape)}")
        return qt.q.data_ptr(), qt.scales.data_ptr()
    require(qt.q.dim() == 3, f"stacked (L, K, N) weight expected, got {tuple(qt.q.shape)}")
    L = qt.q.shape[0]
    require(0 <= layer < L, f"layer {layer} out of range for {L} layers")
    return (qt.q.data_ptr() + layer * qt.q.stride(0),
            qt.scales.data_ptr() + layer * qt.scales.stride(0) * qt.scales.element_size())


def check_weight(qt: QuantizedTensor, device: torch.device) -> None:
    require(qt.bits in (8, 4), f"int8 or int4 weights expected, got bits={qt.bits}")
    require(qt.q.dtype == torch.int8 and qt.scales.dtype in SCALE_NAMES,
            f"int8 q / float32 or bfloat16 scales expected, got {qt.q.dtype} / "
            f"{qt.scales.dtype}")
    require(qt.q.device == device and qt.scales.device == device,
            "weight and activation on different devices")
    require(qt.q.is_contiguous() and qt.scales.is_contiguous(),
            "weight q and scales must be contiguous (row-major (.., K, N))")
    k, n = qt.k_dim, qt.q.shape[-1]
    require(k % qt.k_block == 0, f"K={k} not a multiple of {qt.k_block} (the K block "
            f"of an int{qt.bits} weight with group size {qt.group_size})")
    require(tuple(qt.scales.shape[-2:]) == (k // qt.group_size, n),
            f"scales shape {tuple(qt.scales.shape)} does not match the weight {qt.shape}")


def quant_matmul(x: torch.Tensor, qt: QuantizedTensor,
                 layer: int | None = None) -> torch.Tensor:
    """x (M, K) @ dequant(qt[layer]) -> (M, N) in x's dtype, fp32 accumulation.

    qt is (K, N) with layer None, or stacked (L, K, N) with an int layer
    (int8, or int4 packed to (.., K//2, N))."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, qt, layer)
    require(x.device.type == "cuda", f"unsupported device {x.device}")
    require(x.dim() == 2 and x.is_contiguous(), "x must be a contiguous (M, K) matrix")
    check_weight(qt, x.device)
    m, k = x.shape
    n = qt.q.shape[-1]
    require(k == qt.k_dim, f"K mismatch: x {k} vs weight {qt.k_dim}")
    dtype, sdt = build.dtype_code(x), build.dtype_code(qt.scales)
    qp, sp = weight_ptrs(qt, layer)
    gs = qt.group_size
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    lib = build.library("quant_matmul", _SIGNATURES)
    stream = build.stream_ptr(x)
    body = body_for(x.dtype, m)
    if body == "mmv":
        vec = mma_vec(x, qt, qp, sp)
        bn, tiles, ks, sps = mmv_plan(m, n, k, qt.k_block, qt.bits, vec)
        part = (torch.empty((ks, m, tiles * bn), dtype=torch.float32, device=x.device)
                if ks > 1 else y)
        tk = build.tickets(x.device, tiles)
        err = lib.rama_qmv_mma(x.data_ptr(), qp, sp, y.data_ptr(), part.data_ptr(),
                               tk.data_ptr(), m, k, n, gs, qt.bits, bn, ks, sps, int(vec),
                               sdt, stream)
    elif body == "gemv":
        mt = rows_per_cta(m)
        col_tiles = -(-n // _QMV_COLS)
        ks, bps = split_k(k // qt.k_block, col_tiles, qt.k_block, mt)
        part = (torch.empty((ks, m, n), dtype=torch.float32, device=x.device)
                if ks > 1 else y)
        tk = build.tickets(x.device, col_tiles * -(-m // mt))
        err = lib.rama_qmv(x.data_ptr(), qp, sp, y.data_ptr(), part.data_ptr(),
                           tk.data_ptr(), m, k, n, gs, ks, bps, qt.bits, dtype, sdt, stream)
    elif body == "mma":
        vec = mma_vec(x, qt, qp, sp)
        bm, ks, sps = mma_plan(m, n, k, qt.k_block, vec)
        part = (torch.empty((ks, m, n), dtype=torch.float32, device=x.device)
                if ks > 1 else y)
        tk = build.tickets(x.device, -(-m // bm) * -(-n // MMA_BN))
        err = lib.rama_qmm_mma(x.data_ptr(), qp, sp, y.data_ptr(), part.data_ptr(),
                               tk.data_ptr(), m, k, n, gs, qt.bits, bm, ks, sps, int(vec),
                               sdt, stream)
    else:
        err = lib.rama_qmm(x.data_ptr(), qp, sp, y.data_ptr(), m, k, n, gs, qt.bits, sdt,
                           stream)
    build.check(lib, err, f"quant_matmul (int{qt.bits}, {body})")
    launches[qt.bits] += 1
    launches_by_body[body] += 1
    launches_by_scale[SCALE_NAMES[qt.scales.dtype]] += 1
    return y
