"""Kernel 2: the SwiGLU FFN of one layer at any M (a decode step's slots, a
verify round's slots x tokens), int8 or packed int4 weights,
out = (silu(x @ W1[l]) * (x @ W3[l])) @ W2[l].

The counterpart of `rama_tpu/ops/pallas/ffn.py`'s `ffn_fused_layered`
(its int8 and int4 branches), which takes any M. Two launches on the card
(`csrc/ffn.cu`): the w13 product whose epilogue applies silu(a) * c and
writes h in x's dtype (the Pallas kernel rounds h to bf16 in VMEM,
ffn.py:170; on the bf16 serving path the rounding is the same), then the w2
product over h. The body is fixed by the activation dtype before the
launch (`body_for`): bf16 takes "mma", the tensor-core body, fp32 "simt",
the CUDA-core GEMVs (8-row chunks of M). On "mma" a call of M <= FFN_MAX_M
rows runs the "one" form, whose CTAs hold every row of x, so each weight
byte is read once a call; a larger M the "rows" form, ceil(M / 64) row
blocks of 64 side by side on the grid (`form_for`, `mma_plan`: the n8
tiles, column tiles, K splits and row blocks; `mma_vec`: cp.async or
masked loads). The K split depends on the shapes, not on M, so a row has
the same bits in every form. A refused launch raises; it never gives way
to another body. Each weight's bits choose its kernels' instantiation; the
int8 and int4 FFNs have their own launch counts, and `launches_by_form`
counts the calls by form. Each weight's stored scale dtype (f32, or bf16
after `cast_scales`) chooses its scale type (a scale-type code;
`launches_by_scale` counts the calls by w13's): a bf16-scale call equals
the same bodies fed `scales.float()` bit for bit.

Dispatch: a CUDA tensor launches the kernels (or raises), a CPU tensor runs
`ffn_plain`.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from rama_tpu_torch.ops.kernels import build
from rama_tpu_torch.ops.kernels.build import I, P, require
from rama_tpu_torch.ops.kernels.quant_matmul import (_QMV_COLS, _SMEM_PER_CTA, _SMEM_PER_SM,
                                                     _SMS, MMA_BK, SCALE_NAMES, check_weight,
                                                     layer_of, rows_per_cta, split_k,
                                                     split_options, weight_ptrs)
from rama_tpu_torch.ops.quant import QuantizedTensor, dequantize, matmul_plain

# wrapper calls that launched the kernels since the last reset, by the w13
# weight's bits
launches = {8: 0, 4: 0}
launches_by_body = {"mma": 0, "simt": 0}   # the same calls by body
launches_by_scale = {"f32": 0, "bf16": 0}   # ... and by w13's stored scale dtype
# ... and by form: "one", every row in one CTA (M <= FFN_MAX_M), or "rows",
# row blocks of FFN_MAX_M
launches_by_form = {"one": 0, "rows": 0}

FFN_MAX_M = 64    # rows one tensor-core CTA holds (NT 8 n8 tiles: csrc/swapab.cuh)
FORMS_NT = (1, 2, 4, 8)   # the tensor-core body's forms: n8 tiles of rows a CTA
_UNITS = 256      # hidden units per simt w13 CTA (csrc/ffn.cu)
MMA_COLS = 256            # weight columns a tensor-core CTA (csrc/ffn.cu: kFfnBN)
MMA_UNITS = MMA_COLS // 2  # hidden units a phase-A CTA (their W1 and W3 columns)
_MMA_CTAS_PER_SM = 2      # ffn_mma's __launch_bounds__ (kFfnCtas)
_MMA_WAVE_FILL = 0.95     # the share of the last wave's CTA slots a plan fills

_SIGNATURES = {
    "rama_ffn_w13": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P],
    "rama_ffn_w2": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P],
    "rama_ffn_mma": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, I, I, P],
    "rama_ffn_mma_occupancy": [I, I, I, I, I, P],
}


def body_for(dtype: torch.dtype, m: int) -> str:
    """The kernel body a CUDA call of m >= 1 rows launches: "mma" (tensor
    cores) for bf16, "simt" (fp32 on the CUDA cores) for fp32."""
    require(m >= 1, f"the FFN kernel serves M >= 1 rows, got {m}")
    return "mma" if dtype == torch.bfloat16 else "simt"


def form_for(m: int) -> str:
    """The form a call of m rows runs: "one" (every row in one CTA, m <=
    FFN_MAX_M) or "rows" (row blocks of FFN_MAX_M rows)."""
    return "one" if m <= FFN_MAX_M else "rows"


def mma_smem_bytes(nt: int, bits: int) -> int:
    """Dynamic shared memory of the tensor-core body's form with nt n8 tiles
    (swab_smem_bytes<NT, BITS, 256>, csrc/swapab.cuh): a ring of stages of
    x rows (bf16, 72 a row), raw weight bytes (272 a row) and four f32-sized
    scale rows, four stages (three for the 64-row int8 form), or the fp32
    epilogue tile where that is larger."""
    xrows = 16 if nt < 2 else 8 * nt
    qrows = MMA_BK if bits == 8 else MMA_BK // 2
    stage = xrows * (MMA_BK + 8) * 2 + qrows * (MMA_COLS + 16) + 4 * MMA_COLS * 4
    stages = 3 if nt == 8 and bits == 8 else 4
    return max(stages * stage, xrows * (MMA_COLS + 4) * 4)


def mma_ctas_per_sm(nt: int, bits: int) -> int:
    """CTAs of a form an SM holds: the register cap (_MMA_CTAS_PER_SM), or
    fewer where its shared memory does not fit (the occupancy API on the
    card: `occupancy`)."""
    return min(_MMA_CTAS_PER_SM, _SMEM_PER_SM // (mma_smem_bytes(nt, bits) + _SMEM_PER_CTA))


@functools.lru_cache(maxsize=None)
def mma_plan(m: int, k: int, nout: int, k_block: int, phase_a: bool,
             sms: int = _SMS) -> tuple[int, int, int, int, int]:
    """(nt, tiles, ks, sps, rblocks) of one phase of the tensor-core body:
    nt n8 tiles of rows a CTA (1, 2, 4 or 8: the smallest that holds every
    one of the m rows; 8 above FFN_MAX_M), `tiles` column tiles (MMA_UNITS
    hidden units in phase A, MMA_COLS output columns in phase B), K split
    across ks CTAs of sps MMA_BK-row slabs each (quant_matmul.split_options:
    whole K blocks), and rblocks = ceil(m / FFN_MAX_M) row blocks. ks is the
    smallest count whose one-row-block grid fills its last wave of CTA slots
    (sms x _MMA_CTAS_PER_SM, the CTAs an SM every form gets:
    mma_ctas_per_sm) to _MMA_WAVE_FILL, else the best fill: it depends on
    the tiles and K, not on m, so a row's split order, and its bits, are the
    same in every form. The row blocks multiply that grid, whose fill of
    its last wave is then at least the one-block fill (tiles x ks x rblocks
    CTAs over the same slots: every form holds _MMA_CTAS_PER_SM)."""
    require(m >= 1, f"the FFN kernel serves M >= 1 rows, got {m}")
    nt = next(nt for nt in FORMS_NT if m <= 8 * nt or nt == FORMS_NT[-1])
    tiles = -(-nout // (MMA_UNITS if phase_a else MMA_COLS))
    slots = sms * _MMA_CTAS_PER_SM
    best = None
    for ks, sps in split_options(k, k_block):
        ctas = tiles * ks
        fill = ctas / (-(-ctas // slots) * slots)
        if best is None or fill > best[0]:
            best = (fill, ks, sps)
        if fill >= _MMA_WAVE_FILL:
            break
    return nt, tiles, best[1], best[2], -(-m // FFN_MAX_M)


def occupancy(nt: int, bits: int, vec: bool, phase_a: bool,
              scale_dtype: torch.dtype = torch.float32) -> int:
    """The CTAs an SM that the tensor-core body's form gets on the current
    card (cudaOccupancyMaxActiveBlocksPerMultiprocessor; launches nothing).
    Card only."""
    import ctypes

    lib = build.library("ffn", _SIGNATURES)
    out = (ctypes.c_int * 1)()
    code = build.DTYPE_CODES[scale_dtype]
    build.check(lib, lib.rama_ffn_mma_occupancy(nt, bits, int(vec), int(phase_a), code,
                                                ctypes.cast(out, ctypes.c_void_p)),
                "ffn occupancy")
    return out[0]


def mma_vec(qt: QuantizedTensor, ptrs: tuple[int, ...], phase_a: bool) -> bool:
    """Whether a phase of the tensor-core body takes its cp.async path:
    16-byte copies of x, weight and scale rows (the weight's width a
    multiple of 16, and in phase A the hidden width and the interleave tile
    too, so 16 units' W1 or W3 columns are 16 adjacent ones), a group size
    that is a multiple of 16 and divides, or is a multiple of, a slab's
    weight rows (64, or 32 packed int4 byte rows), every pointer 16-byte
    aligned; the masked path otherwise."""
    gs, span = qt.group_size, MMA_BK if qt.bits == 8 else MMA_BK // 2
    n = qt.q.shape[-1]
    cols_ok = n % 16 == 0 and (not phase_a or ((n // 2) % 16 == 0 and qt.il % 16 == 0))
    return (cols_ok and gs % 16 == 0 and (span % gs == 0 or gs % span == 0)
            and all(p % 16 == 0 for p in ptrs))


def pair_columns(j: int, hdim: int, il: int) -> tuple[int, int]:
    """The w13 columns of hidden unit j, (W1, W3): plain halves (j, j + H)
    or, under il-interleaving, j's column in its W1 tile and the same
    offset in the W3 tile beside it. The tensor-core body pairs them in
    one CTA this way (ColsW13, csrc/ffn.cu); split_h13 is its inverse."""
    c1 = (j // il) * 2 * il + j % il if il else j
    return c1, c1 + (il or hdim)


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
    body = body_for(x.dtype, m)
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
    h = torch.empty((m, hdim), dtype=x.dtype, device=x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if body == "mma":
        for phase_a, xin, qt, qp, sp, out in ((True, x, w13, q13, s13, h),
                                              (False, h, w2, q2, s2, y)):
            kdim, nout = xin.shape[1], out.shape[1]
            _, tiles, ks, sps, rblocks = mma_plan(m, kdim, nout, qt.k_block, phase_a)
            vec = mma_vec(qt, (xin.data_ptr(), qp, sp), phase_a)
            part = (torch.empty((rblocks, ks, min(m, FFN_MAX_M), tiles * MMA_COLS),
                                dtype=torch.float32, device=x.device) if ks > 1 else out)
            tk = build.tickets(x.device, tiles * rblocks)
            err = lib.rama_ffn_mma(xin.data_ptr(), qp, sp, out.data_ptr(), part.data_ptr(),
                                   tk.data_ptr(), m, kdim, qt.q.shape[-1], nout,
                                   qt.group_size, qt.il if phase_a else 0, qt.bits,
                                   int(phase_a), tiles, ks, sps, rblocks, int(vec),
                                   build.dtype_code(qt.scales), stream)
            build.check(lib, err, f"ffn ({'w13' if phase_a else 'w2'}, int{qt.bits}, mma)")
    else:
        mt = rows_per_cta(m)
        mchunks = -(-m // mt)
        tiles = -(-hdim // _UNITS)
        ks, bps = split_k(k // w13.k_block, tiles, w13.k_block, mt)
        part = (torch.empty((ks, m, h2), dtype=torch.float32, device=x.device)
                if ks > 1 else h)
        tk = build.tickets(x.device, max(tiles, -(-n // _QMV_COLS)) * mchunks)
        err = lib.rama_ffn_w13(x.data_ptr(), q13, s13, h.data_ptr(), part.data_ptr(),
                               tk.data_ptr(), m, k, hdim, w13.group_size, w13.il, ks, bps,
                               w13.bits, dtype, build.dtype_code(w13.scales), stream)
        build.check(lib, err, f"ffn (w13, int{w13.bits}, simt)")
        ks2, bps2 = split_k(hdim // w2.k_block, -(-n // _QMV_COLS), w2.k_block, mt)
        part2 = (torch.empty((ks2, m, n), dtype=torch.float32, device=x.device)
                 if ks2 > 1 else y)
        err = lib.rama_ffn_w2(h.data_ptr(), q2, s2, y.data_ptr(), part2.data_ptr(),
                              tk.data_ptr(), m, hdim, n, w2.group_size, ks2, bps2, w2.bits,
                              dtype, build.dtype_code(w2.scales), stream)
        build.check(lib, err, f"ffn (w2, int{w2.bits}, simt)")
    launches[w13.bits] += 1
    launches_by_body[body] += 1
    launches_by_scale[SCALE_NAMES[w13.scales.dtype]] += 1
    launches_by_form[form_for(m)] += 1
    return y
