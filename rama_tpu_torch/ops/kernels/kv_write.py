"""Kernels 6, 8 and 11: quantize K/V rows to int8 and write them into the
int8 KV cache in place.

The counterparts of `rama_tpu/ops/pallas/kv_write.py`'s `write_kv_rows_q8`
(the decode step's rows of one layer), `write_kv_chunk_q8` (a speculative
verification chunk's T consecutive rows per slot, one layer) and
`write_kv_strips_q8` (an admission's prefilled strips into their slots,
every layer). The Pallas
kernels take rows that `kv_quant_rows` already quantized; here the row
quantization is fused into the write (`csrc/kv_write.cu`), so both entry
points take the rows in the activation dtype.

The cache is `QuantKVCache`'s four tensors: k8/v8 (L, B, nkv, S, hd) int8
and ks/vs (L, B, nkv, S) f32, updated in place (the JAX package donates
them and returns new arrays).

Dispatch: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
the plain version (`*_plain`), which is `kv_quant_rows` followed by an
index write.
"""

from __future__ import annotations

import torch

from rama_tpu_torch.ops.kernels import build
from rama_tpu_torch.ops.kernels.build import I, P, require

# kernel launches since the last reset, by entry (chip_smoke reads them)
launches = {"write_kv_rows_q8": 0, "write_kv_strips_q8": 0, "write_kv_chunk_q8": 0}

_SIGNATURES = {
    "rama_kv_write_rows": [P, P, P, P, P, P, P, I, I, I, I, I, P],
    "rama_kv_write_strips": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P],
    "rama_kv_write_chunk": [P, P, P, P, P, P, P, I, I, I, I, I, I, P],
}


def kv_quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) float -> (int8 rows, f32 absmax/127 scales (...,)), bit for
    bit rama_tpu's kv_quant_rows: true divisions (the 127 is a tensor, so
    no backend turns the division into a product by its reciprocal) and
    round half to even."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax / amax.new_tensor(127.0), 1e-10)
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


def write_kv_rows_q8_plain(k8, v8, ks, vs, k: torch.Tensor, v: torch.Tensor,
                           pos: torch.Tensor, layer: int) -> None:
    """Plain PyTorch version: quantize the (B, nkv, hd) rows and write them
    at [layer, b, :, pos[b]] (pos clamped to [0, S-1], as the dense cache's
    row write clamps a finished slot's overshoot)."""
    b, nkv, _ = k.shape
    dev = k.device
    bi = torch.arange(b, device=dev)[:, None]
    hi = torch.arange(nkv, device=dev)[None, :]
    pi = pos.long().clamp(0, k8.shape[3] - 1)[:, None]
    for rows, q8, sc in ((k, k8, ks), (v, v8, vs)):
        q, s = kv_quant_rows(rows)
        q8[layer].index_put_((bi, hi, pi), q)
        sc[layer].index_put_((bi, hi, pi), s)


def scatter_rows_(dst: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor) -> None:
    """dst[b, h, pos[b, t]] = rows[b, t, h] in place, for dst (B, nkv, S,
    ...), rows (B, T, nkv, ...) and positions pos (B, T) >= 0. Rows at or
    past S are dropped, as JAX's scatter drops them, without a host sync: a
    dropped row repeats its slot's last kept write (the same row with the
    same value), or rewrites row S - 1 with its own content when the slot
    keeps none, so repeated indices carry equal values."""
    b, t, nkv = rows.shape[:3]
    s = dst.shape[2]
    dev = rows.device
    pos = pos.long()
    cols = torch.arange(t, device=dev)[None, :].expand(b, t)
    kept = pos < s
    last = torch.where(kept, cols, -1).amax(dim=1, keepdim=True)        # (B, 1)
    src = torch.where(kept, cols, last.clamp(min=0))                     # column to write
    pi = torch.where(last >= 0, pos.gather(1, src), s - 1)
    tail = (1,) * (rows.dim() - 2)
    vals = rows.gather(1, src.view(b, t, *tail).expand(rows.shape)).to(dst.dtype)
    vals = torch.where((last < 0).view(b, 1, *tail), dst[:, :, s - 1].unsqueeze(1), vals)
    bi = torch.arange(b, device=dev)[:, None, None]
    hi = torch.arange(nkv, device=dev)[None, None, :]
    dst.index_put_((bi, hi, pi[:, :, None]), vals)


def chunk_positions(pos0: torch.Tensor, t: int) -> torch.Tensor:
    """(B, T) positions pos0[b] + t of a chunk."""
    return pos0.long()[:, None] + torch.arange(t, device=pos0.device)[None, :]


def write_kv_chunk_q8_plain(k8, v8, ks, vs, k: torch.Tensor, v: torch.Tensor,
                            pos0: torch.Tensor, layer: int) -> None:
    """Plain PyTorch version: quantize the (B, T, nkv, hd) rows and write
    them at [layer, b, :, pos0[b] + t], rows at or past S dropped."""
    pos = chunk_positions(pos0, k.shape[1])
    for rows, q8, sc in ((k, k8, ks), (v, v8, vs)):
        q, s = kv_quant_rows(rows)
        scatter_rows_(q8[layer], q, pos)
        scatter_rows_(sc[layer], s, pos)


def write_kv_strips_q8_plain(k8, v8, ks, vs, k: torch.Tensor, v: torch.Tensor,
                             slots: torch.Tensor, t_ins: int) -> None:
    """Plain PyTorch version: quantize rows 0:t_ins of strips j < len(slots)
    of the (L, K, nkv, T, hd) scratch and write them at [:, slots[j], :,
    0:t_ins]."""
    n = slots.shape[0]
    idx = slots.long()
    for strips, q8, sc in ((k, k8, ks), (v, v8, vs)):
        q, s = kv_quant_rows(strips[:, :n, :, :t_ins])
        q8[:, idx, :, :t_ins] = q
        sc[:, idx, :, :t_ins] = s


def _check_cache(k8, v8, ks, vs) -> None:
    require(k8.dim() == 5 and k8.shape == v8.shape and k8.dtype == v8.dtype == torch.int8,
            "k8/v8 must be (L, B, nkv, S, hd) int8")
    require(ks.shape == vs.shape == k8.shape[:4]
            and ks.dtype == vs.dtype == torch.float32,
            "ks/vs must be (L, B, nkv, S) float32")
    require(all(t.is_contiguous() and t.device == k8.device for t in (k8, v8, ks, vs)),
            "the cache tensors must be contiguous and on one device")
    hd = k8.shape[4]
    require(hd <= 256, f"head_dim {hd} must be <= 256")


def write_kv_rows_q8(k8, v8, ks, vs, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, layer: int) -> None:
    """K6: quantize the decode step's post-RoPE rows k/v (B, nkv, hd) and
    write them, with their scales, at [layer, b, :, pos[b]] of the int8
    cache, in place (pos (B,) int32, clamped to [0, S-1])."""
    if k.device.type == "cpu":
        return write_kv_rows_q8_plain(k8, v8, ks, vs, k, v, pos, layer)
    require(k.device.type == "cuda", f"unsupported device {k.device}")
    _check_cache(k8, v8, ks, vs)
    L, B, nkv, S, hd = k8.shape
    require(k.shape == v.shape == (B, nkv, hd), f"rows {tuple(k.shape)} / {tuple(v.shape)} "
            f"do not fit cache {tuple(k8.shape)}")
    require(k.dtype == v.dtype and k.is_contiguous() and v.is_contiguous()
            and k.device == v.device == k8.device, "k/v rows must be contiguous, of one "
            "dtype, on the cache's device")
    require(0 <= layer < L, f"layer {layer} out of range for {L} layers")
    require(pos.dtype == torch.int32 and pos.shape == (B,) and pos.device == k.device
            and pos.is_contiguous(), "pos must be a contiguous (B,) int32 CUDA tensor")
    lib = build.library("kv_write", _SIGNATURES)
    off8, offs = layer * B * nkv * S * hd, layer * B * nkv * S * 4
    err = lib.rama_kv_write_rows(
        k.data_ptr(), v.data_ptr(), pos.data_ptr(), k8.data_ptr() + off8,
        v8.data_ptr() + off8, ks.data_ptr() + offs, vs.data_ptr() + offs,
        B, nkv, S, hd, build.dtype_code(k), build.stream_ptr(k))
    build.check(lib, err, "write_kv_rows_q8")
    launches["write_kv_rows_q8"] += 1


def write_kv_chunk_q8(k8, v8, ks, vs, k: torch.Tensor, v: torch.Tensor,
                      pos0: torch.Tensor, layer: int) -> None:
    """K11: quantize a verification chunk's post-RoPE rows k/v (B, T, nkv,
    hd) and write them, with their scales, at [layer, b, :, pos0[b] + t] of
    the int8 cache, in place (pos0 (B,) int32); rows at or past S are
    dropped."""
    if k.device.type == "cpu":
        return write_kv_chunk_q8_plain(k8, v8, ks, vs, k, v, pos0, layer)
    require(k.device.type == "cuda", f"unsupported device {k.device}")
    _check_cache(k8, v8, ks, vs)
    L, B, nkv, S, hd = k8.shape
    require(k.dim() == 4 and k.shape == v.shape and k.shape[0] == B and k.shape[2:] == (nkv, hd),
            f"rows {tuple(k.shape)} / {tuple(v.shape)} do not fit cache {tuple(k8.shape)}")
    require(k.dtype == v.dtype and k.is_contiguous() and v.is_contiguous()
            and k.device == v.device == k8.device, "k/v rows must be contiguous, of one "
            "dtype, on the cache's device")
    require(0 <= layer < L, f"layer {layer} out of range for {L} layers")
    require(pos0.dtype == torch.int32 and pos0.shape == (B,) and pos0.device == k.device
            and pos0.is_contiguous(), "pos0 must be a contiguous (B,) int32 CUDA tensor")
    lib = build.library("kv_write", _SIGNATURES)
    off8, offs = layer * B * nkv * S * hd, layer * B * nkv * S * 4
    err = lib.rama_kv_write_chunk(
        k.data_ptr(), v.data_ptr(), pos0.data_ptr(), k8.data_ptr() + off8,
        v8.data_ptr() + off8, ks.data_ptr() + offs, vs.data_ptr() + offs,
        B, k.shape[1], nkv, S, hd, build.dtype_code(k), build.stream_ptr(k))
    build.check(lib, err, "write_kv_chunk_q8")
    launches["write_kv_chunk_q8"] += 1


def write_kv_strips_q8(k8, v8, ks, vs, k: torch.Tensor, v: torch.Tensor,
                       slots: torch.Tensor, t_ins: int) -> None:
    """K8: quantize rows 0:t_ins of the prefilled strips j < len(slots) of
    k/v (L, K, nkv, T, hd) and write them at [:, slots[j], :, 0:t_ins] of
    the int8 cache, every layer in one launch, in place. Duplicate slots
    entries must carry identical strips (batch padding does)."""
    if k.device.type == "cpu":
        return write_kv_strips_q8_plain(k8, v8, ks, vs, k, v, slots, t_ins)
    require(k.device.type == "cuda", f"unsupported device {k.device}")
    _check_cache(k8, v8, ks, vs)
    L, B, nkv, S, hd = k8.shape
    require(k.dim() == 5 and k.shape == v.shape and k.shape[0] == L and k.shape[2] == nkv
            and k.shape[4] == hd, f"strips {tuple(k.shape)} do not fit cache "
            f"{tuple(k8.shape)}")
    K, T = k.shape[1], k.shape[3]
    require(k.dtype == v.dtype and k.is_contiguous() and v.is_contiguous()
            and k.device == v.device == k8.device, "strips must be contiguous, of one "
            "dtype, on the cache's device")
    require(0 < t_ins <= min(T, S), f"t_ins {t_ins} must be in [1, min(T={T}, S={S})]")
    require(slots.dtype == torch.int32 and slots.dim() == 1 and slots.device == k.device
            and slots.is_contiguous() and slots.shape[0] <= K,
            "slots must be a contiguous (n,) int32 CUDA tensor with n <= K")
    lib = build.library("kv_write", _SIGNATURES)
    err = lib.rama_kv_write_strips(
        k.data_ptr(), v.data_ptr(), slots.data_ptr(), k8.data_ptr(), v8.data_ptr(),
        ks.data_ptr(), vs.data_ptr(), L, K, slots.shape[0], B, nkv, T, S, t_ins, hd,
        build.dtype_code(k), build.stream_ptr(k))
    build.check(lib, err, "write_kv_strips_q8")
    launches["write_kv_strips_q8"] += 1
