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

On the card one hand-written kernel file (`csrc/attn_block.cu`). bf16
(`body_for`: "mma") runs split tensor-core attention: a CTA per (slot, kv
head, 64-row split of the rows before pos) on the decode attention's
m16n8k16 body (`csrc/dattn_mma.cuh`), q roped in fp32 and rounded to bf16
as its operand, then a combine launch that folds in the new row's fp32
score and writes the row. Any whole GQA group: the group's query rows a
kv head run in the body's row form (`form_for`: 8 rows up to a group of
8, then 16, 32, 64; above 64 in row groups of 64), the same form the
decode attention's `row_form` gives T = 1. fp32 ("simt") keeps one CTA per
(slot, kv head) walking its stripe on the CUDA cores (groups above 8 in
row groups of 8). The full form is the light form,
then K1 (`quant_matmul`) on att: the swap-AB tensor-core body on bf16 att,
the fp32 GEMV on fp32 att -- so mode 2 launches what mode 1 and its wo
launch do; one cooperative launch of the same work measured slower on an
H100. A CUDA tensor launches the kernels or raises; a CPU tensor runs the
plain version (`*_plain`). The model takes this path under
RAMA_ATTN_BLOCK = 1 / 2 (`models/llama.py`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from rama_tpu_torch.ops.kernels import build
from rama_tpu_torch.ops.kernels import decode_attention as da
from rama_tpu_torch.ops.kernels import quant_matmul as _qm
from rama_tpu_torch.ops.kernels.build import I, P, require
from rama_tpu_torch.ops.kernels.decode_attention import layer_ptrs
from rama_tpu_torch.ops.quant import QuantizedTensor, matmul_plain

# launches since the last reset, by form and wo bits (chip_smoke reads them),
# every one of them by the body the kernel file reports it ran, and by the
# row form (query rows a CTA) it reports it launched
launches = {"attn_rope_write_layered": 0, "attn_block_layered": 0,
            "attn_block_layered_int4": 0}
launches_by_body = {"mma": 0, "simt": 0}
SIMT_FORMS = (1, 8)   # the fp32 body's query rows a CTA (groups above 8: row groups of 8)
launches_by_form = {"mma": dict.fromkeys(da.FORMS, 0), "simt": dict.fromkeys(SIMT_FORMS, 0)}

CHUNK = 64        # cache rows a split / tile (csrc/attn_block.cu, kMaxChunk)
HEAD_DIM = 128    # the kernel's head_dim (kAbHeadDim)
MAX_SLOTS = 32    # attn_block_supported's batch limit

_BODIES = {1: "mma", 0: "simt"}   # the body code the C entry reports it launched

_SIGNATURES = {
    "rama_attn_rope_write": [P] * 11 + [I] * 10 + [P, P, P, P],
}


def body_for(dtype: torch.dtype) -> str:
    """The attention body a CUDA launch of either form runs: "mma" (split
    tensor-core attention) for bf16, "simt" (CUDA cores) for fp32."""
    return "mma" if dtype == torch.bfloat16 else "simt"


def nsplit(s: int) -> int:
    """64-row splits of the bf16 workspace: every row below the last
    position of a cache of s rows, at least one."""
    return max(1, -(-(s - 1) // CHUNK))


def form_for(dtype: torch.dtype, rep: int) -> tuple[int, int]:
    """(rows, groups): the query rows a CTA of the body `body_for(dtype)`
    holds for a GQA group of rep, and its row groups a kv head. bf16: the
    tensor-core bodies' row form of T = 1 (`decode_attention.row_form(1,
    rep)`: 8 rows up to a group of 8, then 16, 32, 64, groups of 64 past
    64; csrc form_rows); fp32: 1 row for rep 1, else groups of 8."""
    if body_for(dtype) == "mma":
        return da.row_form(1, rep)
    return (1, 1) if rep == 1 else (8, -(-rep // 8))


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
    require(bc == b and nkv > 0 and nh % nkv == 0,
            f"q {tuple(q.shape)} does not fit cache {tuple(k_full.shape)} (a whole GQA group)")
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


def _light(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full, pos, layer: int,
           what: str, rows: int | None) -> tuple[torch.Tensor, str]:
    """Launch the light form's kernels: att (B, nh * hd) in q's dtype, and
    the body the kernel file reports it ran (the caller counts the launch
    by name and body; here it is counted by the form the kernel file
    reports, which must be `form_for`'s, or `rows`)."""
    ptrs, ints = _common_args(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full, pos, layer)
    b, nh, hd = q.shape
    nkv, s = k_full.shape[2], k_full.shape[3]
    rep = nh // nkv
    att = torch.empty((b, nh * hd), dtype=q.dtype, device=q.device)
    body = body_for(q.dtype)
    form = form_for(q.dtype, rep)[0]
    part_o = part_ml = None
    if rows is not None:
        require(body == "mma" and rows in da.FORMS and rows >= form,
                f"rows {rows}: only a bf16 launch runs a larger form ({da.FORMS}) than "
                f"its group's {form}")
        form = rows
    if body == "mma":
        ns = nsplit(s)
        # the splits' partial o (B, nh, ns, hd), then their (m, l) (B, nh, ns, 2)
        scratch = torch.empty(b * nh * ns * (hd + 2), dtype=torch.float32, device=q.device)
        part_o = scratch.data_ptr()
        part_ml = part_o + 4 * b * nh * ns * hd
    ran, ran_form = ctypes.c_int(-1), ctypes.c_int(0)
    lib = build.library("attn_block", _SIGNATURES)
    err = lib.rama_attn_rope_write(*ptrs, att.data_ptr(), part_o, part_ml, *ints,
                                   build.dtype_code(q), rows or 0, build.stream_ptr(q),
                                   ctypes.byref(ran), ctypes.byref(ran_form), None)
    build.check(lib, err, what)
    ran_body = _BODIES[ran.value]
    require(ran_body == body and ran_form.value == form,
            f"{what}: the kernel ran the {ran_body} body's {ran_form.value}-row form for GQA "
            f"group {rep}, not the {body} body's {form}-row form the launch was sized for")
    launches_by_form[body][form] += 1
    return att, body


def attn_rope_write_layered(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full, pos,
                            layer: int, *, _rows: int | None = None) -> torch.Tensor:
    """K14, light: q (B, nh, hd), k_new / v_new (B, nkv, hd) UN-roped (any
    slot stride: slices of one wqkv output row), cos_rows / sin_rows (B,
    hd/2) f32 RoPE rows at pos, k_full / v_full (L, B, nkv, S, hd) updated
    in place at row pos of layer `layer`, pos (B,) int32, nh any whole
    multiple of nkv. Returns att (B, nh * hd) in q's dtype. `_rows`
    (private, for the card tests): run a larger bf16 row form than the
    group's."""
    if q.device.type == "cpu":
        return attn_rope_write_layered_plain(q, k_new, v_new, cos_rows, sin_rows, k_full,
                                             v_full, pos, layer)
    _check(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full, pos, layer)
    att, body = _light(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full, pos, layer,
                       "attn_rope_write_layered", _rows)
    launches["attn_rope_write_layered"] += 1
    launches_by_body[body] += 1
    return att


def attn_block_layered(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full,
                       wo: QuantizedTensor, pos, layer: int, *,
                       _rows: int | None = None) -> torch.Tensor:
    """K14, full: attn_rope_write_layered's operands plus wo, the stacked
    (L, nh * hd, N) int8 or int4 weight; returns att @ dequant(wo[layer])
    (B, N) in q's dtype, att in fp32 between the two (bf16: rounded to bf16
    as the wo product's operand). The light form's launches, then K1 on
    att. `_rows` as attn_rope_write_layered's."""
    if q.device.type == "cpu":
        return attn_block_layered_plain(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full,
                                        wo, pos, layer)
    _check(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full, pos, layer)
    _qm.check_weight(wo, q.device)
    b, nh, hd = q.shape
    require(wo.k_dim == nh * hd, f"wo K {wo.k_dim} != nh * hd {nh * hd}")
    require(b <= MAX_SLOTS, f"{b} slots: the fused block takes at most {MAX_SLOTS}")
    att, body = _light(q, k_new, v_new, cos_rows, sin_rows, k_full, v_full, pos, layer,
                       f"attn_block_layered (int{wo.bits})", _rows)
    out = _qm.quant_matmul(att, wo, layer)
    launches["attn_block_layered" if wo.bits == 8 else "attn_block_layered_int4"] += 1
    launches_by_body[body] += 1
    return out


def light_occupancy(nh: int, nkv: int, s: int = 1024) -> dict:
    """The bf16 light form's two kernels on the current card, in
    `form_for`'s row form for a GQA group of nh / nkv over a cache of s
    rows: the split kernel's and the combine kernel's resident CTAs per SM,
    registers and local (spill) bytes per thread, and dynamic shared bytes.
    Launches nothing."""
    lib = build.library("attn_block", _SIGNATURES)
    out = (ctypes.c_int * 8)()
    build.check(lib, lib.rama_attn_rope_write(
        *[None] * 11, 1, nh, nkv, s, HEAD_DIM, CHUNK, 0, 0, build.DTYPE_CODES[torch.bfloat16],
        0, None, None, None, out), "attn_rope_write occupancy")
    keys = ("ctas_per_sm", "registers", "smem_bytes", "local_bytes")
    return {"split": dict(zip(keys, out[:4])), "combine": dict(zip(keys, out[4:]))}
