"""Kernel 14: the fused attention block of the T = 1 decode step on a dense
cache — RoPE of q and of the new k row, the in-place write of the row at
pos into layer l of the stacked cache, and attention over the rows before
pos plus the new row; the full form also applies the quantized wo[l].

The counterparts of `rama_tpu/ops/pallas/attn_block.py`'s
`attn_rope_write_layered` (light: -> att (B, nh * hd) in q's dtype) and
`attn_block_layered` (full: att kept in fp32, then att @ wo[l] with int8 or
block-split int4 wo and group scales -> (B, N) in q's dtype). Numerics, as
the Pallas kernels compute them: RoPE in fp32 (`rope_lane_tables`,
`_rope_lanes`), scores and probabilities in fp32, the new row's key in
fp32 (not rounded to the cache dtype) and its value as given, and NO
rounding of the probabilities to the cache dtype before P.V — unlike the
unfused path (`apply_rope` rounds the roped rows to the activation dtype,
K4 the probabilities to the cache's). pos is clamped to [0, S-1] for the
write and the attention (the port's T = 1 overshoot rule; the Pallas kernel
is not defined past the cache).

On the card one hand-written kernel (`csrc/attn_block.cu`): the light form
one launch of a CTA per (slot, kv head), the full form ONE cooperative
launch whose persistent grid runs the same attention items, a grid-wide
barrier, then K1's split-K GEMV tiles of wo (`csrc/qmv.cuh`). A CUDA tensor
launches the kernel or raises (a refused cooperative launch included); a
CPU tensor runs the plain version (`*_plain`). The model takes this path
under RAMA_ATTN_BLOCK = 1 / 2 (`models/llama.py`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from rama_tpu_torch.ops.kernels import build
from rama_tpu_torch.ops.kernels import quant_matmul as _qm
from rama_tpu_torch.ops.kernels.build import I, P, require
from rama_tpu_torch.ops.kernels.decode_attention import layer_ptrs
from rama_tpu_torch.ops.quant import QuantizedTensor, matmul_plain

# launches since the last reset, by form and wo bits (chip_smoke reads them)
launches = {"attn_rope_write_layered": 0, "attn_block_layered": 0,
            "attn_block_layered_int4": 0}

CHUNK = 64        # cache rows a tile (csrc/attn_block.cu)
HEAD_DIM = 128    # the kernel's head_dim (kAbHeadDim)
MAX_REP = 8       # GQA group rows a CTA keeps in registers
MAX_SLOTS = 32    # attn_block_supported's batch limit

_SIGNATURES = {
    "rama_attn_rope_write": [P] * 9 + [I] * 9 + [P],
    "rama_attn_block": [P] * 14 + [I] * 14 + [P, P],
}


def attn_block_supported(wo, s: int, b: int) -> bool:
    """Whether the fused block applies (rama_tpu's attn_block_supported):
    a quantized wo of 128-aligned N and whole K blocks (scale groups; two
    of them, a packing block, for int4), an 8-aligned cache, at most 32
    slots."""
    if not isinstance(wo, QuantizedTensor):
        return False
    d, n = wo.k_dim, wo.shape[-1]
    if n % 128 or d % wo.k_block:
        return False
    return s % 8 == 0 and b <= MAX_SLOTS


def rope_lane_tables(cos_rows: torch.Tensor, sin_rows: torch.Tensor):
    """(B, hd/2) cos / sin rows -> (c2, s2s), each (B, hd) f32: c2[2i] =
    c2[2i+1] = cos[i]; s2s[2i] = -sin[i], s2s[2i+1] = +sin[i]."""
    half = cos_rows.shape[-1]
    c2 = cos_rows.float().repeat_interleave(2, dim=-1)
    s2 = sin_rows.float().repeat_interleave(2, dim=-1)
    sign = torch.tensor([-1.0, 1.0], device=cos_rows.device).repeat(half)
    return c2, s2 * sign


def _rope_lanes(x: torch.Tensor, c2: torch.Tensor, s2s: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair RoPE in fp32: x * c2 + swap_adjacent(x) * s2s."""
    swap = x.reshape(*x.shape[:-1], -1, 2).flip(-1).reshape(x.shape)
    return x * c2 + swap * s2s


def _attend_plain(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full, pos, layer):
    """The light form's attention in fp32, (B, nh * hd), with row pos of
    layer `layer` written in place."""
    b, nh, hd = q.shape
    nkv, s = k_full.shape[2], k_full.shape[3]
    rep = nh // nkv
    p = pos.long().clamp(0, s - 1)
    c2, s2s = (t[:, None] for t in rope_lane_tables(cos_rows, sin_rows))
    qr = _rope_lanes(q.float(), c2, s2s).reshape(b, nkv, rep, hd)
    kr = _rope_lanes(k_new.float(), c2, s2s)                        # (B, nkv, hd)
    vn = v_new.float()
    scale = 1.0 / math.sqrt(hd)
    kc, vc = k_full[layer].float(), v_full[layer].float()          # (B, nkv, S, hd)
    scores = torch.einsum("bkrh,bksh->bkrs", qr, kc) * scale
    before = torch.arange(s, device=q.device)[None, :] < p[:, None]   # rows s < pos
    scores = torch.where(before[:, None, None, :], scores,
                         torch.tensor(-1e30, device=q.device))
    cur = (qr * kr[:, :, None, :]).sum(-1, keepdim=True) * scale   # the new row
    probs = torch.softmax(torch.cat([cur, scores], dim=-1), dim=-1)
    att = (probs[..., :1] * vn[:, :, None, :]
           + torch.einsum("bkrs,bksh->bkrh", probs[..., 1:], vc))
    bi = torch.arange(b, device=q.device)[:, None]
    hi = torch.arange(nkv, device=q.device)[None, :]
    k_full[layer].index_put_((bi, hi, p[:, None]), kr.to(k_full.dtype))
    v_full[layer].index_put_((bi, hi, p[:, None]), v_new.to(v_full.dtype))
    return att.reshape(b, nh * hd)


def attn_rope_write_layered_plain(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full,
                                  pos, layer: int) -> torch.Tensor:
    """Plain PyTorch version of the light form: (B, nh * hd) in q's dtype."""
    return _attend_plain(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full, pos,
                         layer).to(q.dtype)


def attn_block_layered_plain(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full,
                             wo: QuantizedTensor, pos, layer: int) -> torch.Tensor:
    """Plain PyTorch version of the full form: the fp32 attention times
    dequant(wo[layer]) in fp32, (B, N) in q's dtype."""
    att = _attend_plain(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full, pos, layer)
    return matmul_plain(att, _qm.layer_of(wo, layer)).to(q.dtype)


def _rows_ok(x: torch.Tensor, n: int, hd: int) -> bool:
    """x (B, n, hd) with heads and lanes contiguous (any slot stride)."""
    return x.dim() == 3 and x.shape[1:] == (n, hd) and x.stride(2) == 1 and x.stride(1) == hd


def _check(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full, pos, layer) -> None:
    require(q.device.type == "cuda", f"unsupported device {q.device}")
    require(q.dim() == 3 and k_full.dim() == 5 and k_full.shape == v_full.shape,
            "q (B, nh, hd) and caches (L, B, nkv, S, hd) expected")
    b, nh, hd = q.shape
    L, bc, nkv, s, hdc = k_full.shape
    require(hd == HEAD_DIM and hdc == hd, f"head_dim {hd} / cache {hdc}: the kernel takes "
            f"{HEAD_DIM}")
    require(bc == b and nh % nkv == 0 and nh // nkv <= MAX_REP,
            f"q {tuple(q.shape)} does not fit cache {tuple(k_full.shape)} (GQA group <= "
            f"{MAX_REP})")
    require(0 <= layer < L, f"layer {layer} out of range for {L} layers")
    require(_rows_ok(q, nh, hd) and _rows_ok(k_new, nkv, hd) and _rows_ok(v_new, nkv, hd)
            and k_new.shape[0] == v_new.shape[0] == b and k_new.stride(0) == v_new.stride(0),
            "q (B, nh, hd), k_new / v_new (B, nkv, hd) with contiguous heads, k and v "
            "rows one stride apart")
    require(q.dtype == k_new.dtype == v_new.dtype == k_full.dtype == v_full.dtype,
            f"q {q.dtype}, new rows and cache {k_full.dtype} dtypes differ")
    require(cos_rows.shape == sin_rows.shape == (b, hd // 2)
            and cos_rows.dtype == sin_rows.dtype == torch.float32
            and cos_rows.is_contiguous() and sin_rows.is_contiguous(),
            "cos / sin rows must be contiguous (B, hd/2) float32")
    require(k_full.is_contiguous() and v_full.is_contiguous()
            and k_full.data_ptr() % 16 == 0 and v_full.data_ptr() % 16 == 0,
            "caches must be contiguous and 16-byte aligned")
    require(pos.dtype == torch.int32 and pos.shape == (b,) and pos.is_contiguous(),
            "positions must be a contiguous (B,) int32 tensor")
    require(all(t.device == q.device for t in (k_new, v_new, cos_rows, sin_rows, k_full,
                                               v_full, pos)), "operands on one device")


def _common_args(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full, pos, layer):
    b, nh, hd = q.shape
    nkv, s = k_full.shape[2], k_full.shape[3]
    kc, vc = layer_ptrs((k_full, v_full), layer * b * nkv * s)
    return ([q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cos_rows.data_ptr(),
             sin_rows.data_ptr(), kc, vc, pos.data_ptr()],
            [b, nh, nkv, s, hd, CHUNK, q.stride(0), k_new.stride(0)])


def attn_rope_write_layered(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full, pos,
                            layer: int) -> torch.Tensor:
    """K14, light: q (B, nh, hd), k_new / v_new (B, nkv, hd) UN-roped (any
    slot stride: slices of one wqkv output row), cos_rows / sin_rows (B,
    hd/2) f32 RoPE rows at pos, k_full / v_full (L, B, nkv, S, hd) updated
    in place at row pos of layer `layer`, pos (B,) int32. Returns att
    (B, nh * hd) in q's dtype."""
    if q.device.type == "cpu":
        return attn_rope_write_layered_plain(q, k_new, v_new, cos_rows, sin_rows, k_full,
                                             v_full, pos, layer)
    _check(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full, pos, layer)
    ptrs, ints = _common_args(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full, pos, layer)
    att = torch.empty((q.shape[0], q.shape[1] * q.shape[2]), dtype=q.dtype, device=q.device)
    lib = build.library("attn_block", _SIGNATURES)
    err = lib.rama_attn_rope_write(*ptrs, att.data_ptr(), *ints, build.dtype_code(q),
                                   build.stream_ptr(q))
    build.check(lib, err, "attn_rope_write_layered")
    launches["attn_rope_write_layered"] += 1
    return att


_grid_cache: dict[tuple, int] = {}


def _plan(q, wo: QuantizedTensor, nkv: int) -> tuple[int, int, int]:
    """(ks, bps, tickets) of the full form's phase C: the split-K GEMV's K
    splits aimed at the cooperative grid's size (resident CTAs per SM x SMs,
    from the occupancy API once per shape), K blocks per split, and the
    ticket counters the launch needs (column tiles x row chunks + the
    barrier's two)."""
    b, nh, hd = q.shape
    n, k = wo.shape[-1], wo.k_dim
    key = (q.device, q.dtype, b, nh, nkv, n, k, wo.group_size, wo.bits)
    if key not in _grid_cache:
        info = occupancy(b, nh, nkv, n, k, wo.group_size, wo.bits, q.dtype)
        require(info["ctas_per_sm"] >= 1,
                f"the fused attention block does not fit on an SM: {info}")
        _grid_cache[key] = info["ctas_per_sm"] * _sms()
    mt = 1 if b <= 1 else 8
    col_tiles = -(-n // _qm._QMV_COLS)
    ks, bps = _qm.split_k(k // wo.k_block, col_tiles, wo.k_block, mt,
                          target=_grid_cache[key])
    return ks, bps, col_tiles * -(-b // mt) + 2


def _sms() -> int:
    return torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count


def attn_block_layered(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full,
                       wo: QuantizedTensor, pos, layer: int) -> torch.Tensor:
    """K14, full: attn_rope_write_layered's operands plus wo, the stacked
    (L, nh * hd, N) int8 or int4 weight; returns att @ dequant(wo[layer])
    (B, N) in q's dtype, att in fp32 between the two."""
    if q.device.type == "cpu":
        return attn_block_layered_plain(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full,
                                        wo, pos, layer)
    _check(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full, pos, layer)
    _qm.check_weight(wo, q.device)
    b, nh, hd = q.shape
    require(wo.k_dim == nh * hd, f"wo K {wo.k_dim} != nh * hd {nh * hd}")
    require(b <= MAX_SLOTS, f"{b} slots: the fused block takes at most {MAX_SLOTS}")
    ks, bps, nt = _plan(q, wo, k_full.shape[2])
    n = wo.shape[-1]
    ptrs, ints = _common_args(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full, pos, layer)
    att = torch.empty((b, nh * hd), dtype=torch.float32, device=q.device)
    out = torch.empty((b, n), dtype=q.dtype, device=q.device)
    part = torch.empty((ks, b, n), dtype=torch.float32, device=q.device) if ks > 1 else out
    qp, sp = _qm.weight_ptrs(wo, layer)
    lib = build.library("attn_block", _SIGNATURES)
    err = lib.rama_attn_block(*ptrs, att.data_ptr(), qp, sp, out.data_ptr(), part.data_ptr(),
                              build.tickets(q.device, nt).data_ptr(), *ints, n, wo.group_size,
                              ks, bps, wo.bits, build.dtype_code(q), build.stream_ptr(q), None)
    build.check(lib, err, f"attn_block_layered (int{wo.bits})")
    launches["attn_block_layered" if wo.bits == 8 else "attn_block_layered_int4"] += 1
    return out


def occupancy(b: int, nh: int, nkv: int, n: int, k: int, gs: int, bits: int,
              dtype: torch.dtype = torch.bfloat16) -> dict:
    """The full form's cooperative grid for these shapes on the current
    card, as the CUDA occupancy API reports it: resident CTAs per SM,
    registers per thread, dynamic shared bytes per CTA, CTAs of the grid
    (with the wo GEMV's K split for one CTA per SM; the register count,
    not the split's few KB of shared memory, sets the residency). Launches
    nothing."""
    out = (ctypes.c_int * 4)()
    k_block = 2 * gs if bits == 4 else gs
    ks, bps = _qm.split_k(k // k_block, -(-n // _qm._QMV_COLS), k_block, 1 if b <= 1 else 8,
                          target=_sms())
    lib = build.library("attn_block", _SIGNATURES)
    build.check(lib, lib.rama_attn_block(
        *[None] * 14, b, nh, nkv, 8, HEAD_DIM, CHUNK, 0, 0, n, gs, ks, bps, bits,
        build.DTYPE_CODES[dtype], None, out), "attn_block occupancy")
    return {"ctas_per_sm": out[0], "registers": out[1], "smem_bytes": out[2], "grid": out[3]}
