"""Kernels 6, 8, 11 and 13: quantize K/V rows to int8 and write them into
the int8 KV cache, or into the int8 page pool, in place.

The counterparts of `rama_tpu/ops/pallas/kv_write.py`'s `write_kv_rows_q8`
(the decode step's rows of one layer), `write_kv_chunk_q8` (a speculative
verification chunk's T consecutive rows per slot, one layer) and
`write_kv_strips_q8` (an admission's prefilled strips into their slots,
every layer), and of the paged `write_kv_paged_q8` (1 .. 8 consecutive
rows a slot into pages of the pool, through the page tables) and
`write_kv_prefill_paged_q8` (an admission group's strips into their
slots' pages; the Pallas kernel writes one slot a call). The Pallas
kernels take rows that `kv_quant_rows` already quantized; here the row
quantization is fused into the write (`csrc/kv_write.cu`), so every entry
point takes the rows in the activation dtype.

The cache is `QuantKVCache`'s four tensors: k8/v8 (L, B, nkv, S, hd) int8
and ks/vs (L, B, nkv, S) f32, or `QuantPagedKVCache`'s pools (L, P, nkv,
ps, hd) and (L, P, nkv, ps), updated in place (the JAX package donates
them and returns new arrays).

Where each writer runs in the forwards (models/llama.py, runtime/paged.py):
K8 / K13 (b) write every admission's strips. K6, K11 and K13 (a) run as
launches of their own only where the attention after them does not take
the int8 walk (fp32 activations, a head dim other than 48 / 64 / 128); on
the walk, the dense decode step's rows (K6, a finished slot's overshoot
clamped onto the last row), the verification chunk's rows (K11) and the
paged step's or chunk's rows (K13 (a)) are written by the attention
launch itself, bit for bit as these kernels write them
(`decode_attention.decode_attention_q8`, `chunk_attention_q8`,
`paged_attention.paged_*_attention_q8` with `k_new` / `v_new`, over the
row quantization of csrc/kv_quant.cuh that both share). The kernels here
stay that fused write's oracle on the card.

K8 and K13 (b) each have two bodies (`prefill_body_for`): bf16 strips at a
head dim of STREAM_HEAD_DIMS take the streaming kernel ("stream": a CTA a
run of up to 64 rows inside one slot or page, 16-byte loads, 8-byte
stores; one body for both writers), anything else the warp-a-row kernel
("rows"); `strips_launches_by_body` (K8) and `launches_by_body` (K13 (b))
count them. The warp-a-row bodies are routes chosen by dtype and head dim,
never a fallback of the streaming one.

Dispatch: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
the plain version (`*_plain`), which is `kv_quant_rows` followed by an
index write.
"""

from __future__ import annotations

import torch

from rama_tpu_torch.ops.kernels import build
from rama_tpu_torch.ops.kernels.build import I, P, require

# kernel launches since the last reset, by entry (chip_smoke reads them)
launches = {"write_kv_rows_q8": 0, "write_kv_strips_q8": 0, "write_kv_chunk_q8": 0,
            "write_kv_paged_q8": 0, "write_kv_prefill_paged_q8": 0}

# K8's and K13 (b)'s launches by the body each ran (prefill_body_for)
strips_launches_by_body = {"stream": 0, "rows": 0}
launches_by_body = {"stream": 0, "rows": 0}
PREFILL_BODIES = {"rows": 0, "stream": 1}   # body codes of both C entries (csrc rama::StripBody)
STREAM_HEAD_DIMS = (48, 64, 128)            # the streaming body's instantiations

_SIGNATURES = {
    "rama_kv_write_rows": [P, P, P, P, P, P, P, I, I, I, I, I, P],
    "rama_kv_write_strips": [P] * 7 + [I] * 11 + [P],
    "rama_kv_write_chunk": [P, P, P, P, P, P, P, I, I, I, I, I, I, P],
    "rama_kv_write_paged": [P] * 8 + [I] * 8 + [P],
    "rama_kv_write_prefill_paged": [P] * 7 + [I] * 12 + [P],
}


def prefill_body_for(dtype: torch.dtype, hd: int) -> str:
    """K8's and K13 (b)'s body on the card: "stream" for bf16 strips at a
    head dim of STREAM_HEAD_DIMS, "rows" (a warp a row) for anything else."""
    return "stream" if dtype == torch.bfloat16 and hd in STREAM_HEAD_DIMS else "rows"


def _body_of(forced: str | None, k: torch.Tensor, v: torch.Tensor, hd: int) -> str:
    """The body a strip writer launches: `forced`, else prefill_body_for's."""
    body = forced or prefill_body_for(k.dtype, hd)
    require(body in PREFILL_BODIES, f"unknown strip writer body {body!r}")
    require(body == "rows" or (k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0),
            "strips must start 16-byte aligned (the streaming body loads 16-byte pieces)")
    return body


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
    0:t_ins]; a strip whose slot lies outside [0, B) is written nowhere, as
    the kernel leaves it."""
    idx = slots.long()
    keep = ((idx >= 0) & (idx < k8.shape[1])).nonzero()[:, 0]
    for strips, q8, sc in ((k, k8, ks), (v, v8, vs)):
        q, s = kv_quant_rows(strips[:, keep, :, :t_ins])
        q8[:, idx[keep], :, :t_ins] = q
        sc[:, idx[keep], :, :t_ins] = s


def _check_cache(k8, v8, ks, vs) -> None:
    require(k8.dim() == 5 and k8.shape == v8.shape and k8.dtype == v8.dtype == torch.int8,
            "k8/v8 must be (L, B, nkv, S, hd) (or pools (L, P, nkv, ps, hd)) int8")
    require(ks.shape == vs.shape == k8.shape[:4]
            and ks.dtype == vs.dtype == torch.float32,
            "ks/vs must be float32 of k8's shape without head_dim")
    require(all(t.is_contiguous() and t.device == k8.device for t in (k8, v8, ks, vs)),
            "the cache tensors must be contiguous and on one device")
    hd = k8.shape[4]
    require(hd <= 256, f"head_dim {hd} must be <= 256")


def write_kv_rows_q8(k8, v8, ks, vs, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, layer: int) -> None:
    """K6: quantize the decode step's post-RoPE rows k/v (B, nkv, hd) and
    write them, with their scales, at [layer, b, :, pos[b]] of the int8
    cache, in place (pos (B,) int32, clamped to [0, S-1]). The decode step
    reaches it only where its attention does not take the int8 walk, which
    writes the rows itself (module docstring)."""
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
    dropped. The forward calls it only where the chunk attention does not
    take the int8 walk, which writes the rows itself (module docstring)."""
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
                       slots: torch.Tensor, t_ins: int, _body: str | None = None) -> None:
    """K8: quantize rows 0:t_ins of the prefilled strips j < len(slots) of
    k/v (L, K, nkv, T, hd) and write them at [:, slots[j], :, 0:t_ins] of
    the int8 cache, every layer in one launch, in place, on the body
    `prefill_body_for` picks (the private `_body` forces "rows", the
    warp-a-row body, to time it beside the streaming one). A slot outside
    [0, B) is written nowhere. Duplicate slots entries must carry identical
    strips (batch padding does)."""
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
    body = _body_of(_body, k, v, hd)
    lib = build.library("kv_write", _SIGNATURES)
    err = lib.rama_kv_write_strips(
        k.data_ptr(), v.data_ptr(), slots.data_ptr(), k8.data_ptr(), v8.data_ptr(),
        ks.data_ptr(), vs.data_ptr(), L, K, slots.shape[0], B, nkv, T, S, t_ins, hd,
        build.dtype_code(k), PREFILL_BODIES[body], build.stream_ptr(k))
    build.check(lib, err, "write_kv_strips_q8")
    launches["write_kv_strips_q8"] += 1
    strips_launches_by_body[body] += 1


# -- K13: the paged pool ------------------------------------------------------


def paged_rows(tables: torch.Tensor, pos: torch.Tensor,
               pool: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(page, in-page row) of each position pos (B, T) >= 0 through page
    tables (B, mp) into a pool (L, P, nkv, ps, ...): page tables[b, min(p //
    ps, mp - 1)] (clamped to [0, P - 1]) at row p % ps. Rows past the
    slot's table clip into its page mp - 1, as rama_tpu's fused paged paths
    do; none is dropped."""
    num_pages, ps = pool.shape[1], pool.shape[3]
    mp = tables.shape[1]
    pos = pos.long().clamp(min=0)
    pages = tables.long().clamp(0, num_pages - 1).gather(1, (pos // ps).clamp(max=mp - 1))
    return pages, pos % ps


def put_rows_(pages_l: torch.Tensor, rows: torch.Tensor, pages: torch.Tensor,
              offs: torch.Tensor) -> None:
    """pages_l[pages[b, t], h, offs[b, t]] = rows[b, t, h] in place, for one
    layer of a pool (P, nkv, ps, ...) and rows (B, T, nkv, ...)."""
    hi = torch.arange(rows.shape[2], device=rows.device)[None, None, :]
    pages_l.index_put_((pages[:, :, None], hi, offs[:, :, None]), rows.to(pages_l.dtype))


def put_strips_(pool: torch.Tensor, strips: torch.Tensor, tables: torch.Tensor,
                t_ins: int) -> None:
    """Rows 0:t_ins of strips j < len(tables) of (L, K, nkv, T, ...) into a
    pool (L, P, nkv, ps, ...) in place: row i of strip j at page tables[j,
    i // ps] (clamped to [0, P - 1]), in-page row i % ps."""
    n, ps = tables.shape[0], pool.shape[3]
    i = torch.arange(t_ins, device=strips.device)
    pages = tables.long().clamp(0, pool.shape[1] - 1)[:, i // ps]           # (n, t_ins)
    hi = torch.arange(strips.shape[2], device=strips.device)[None, :, None]
    pool[:, pages[:, None, :], hi, (i % ps)[None, None, :]] = (
        strips[:, :n, :, :t_ins].to(pool.dtype))


def write_kv_paged_q8_plain(k8, v8, ks, vs, k: torch.Tensor, v: torch.Tensor,
                            pos0: torch.Tensor, tables: torch.Tensor, layer: int) -> None:
    """Plain PyTorch version: quantize the (B, T, nkv, hd) rows and write
    them, through the page tables (B, mp), at the pages and in-page rows of
    positions pos0[b] + t of layer `layer` of the int8 pool (paged_rows)."""
    pages, offs = paged_rows(tables, chunk_positions(pos0, k.shape[1]), k8)
    for rows, q8, sc in ((k, k8, ks), (v, v8, vs)):
        q, s = kv_quant_rows(rows)
        put_rows_(q8[layer], q, pages, offs)
        put_rows_(sc[layer], s, pages, offs)


def write_kv_prefill_paged_q8_plain(k8, v8, ks, vs, k: torch.Tensor, v: torch.Tensor,
                                    tables: torch.Tensor, t_ins: int) -> None:
    """Plain PyTorch version: quantize rows 0:t_ins of strips j < len(tables)
    of the (L, K, nkv, T, hd) scratch and write them through table row j
    into the int8 pool, every layer (put_strips_)."""
    n = tables.shape[0]
    for strips, q8, sc in ((k, k8, ks), (v, v8, vs)):
        q, s = kv_quant_rows(strips[:, :n, :, :t_ins])
        put_strips_(q8, q, tables, t_ins)
        put_strips_(sc, s, tables, t_ins)


def _check_tables(tables: torch.Tensor, rows: int, device) -> None:
    require(tables.dtype == torch.int32 and tables.dim() == 2 and tables.shape[0] == rows
            and tables.device == device and tables.is_contiguous(),
            f"page tables must be a contiguous ({rows}, mp) int32 CUDA tensor")


def write_kv_paged_q8(k8, v8, ks, vs, k: torch.Tensor, v: torch.Tensor, pos0: torch.Tensor,
                      tables: torch.Tensor, layer: int) -> None:
    """K13 (a): quantize T = 1 .. 8 consecutive post-RoPE rows a slot, k/v
    (B, T, nkv, hd) at positions pos0[b] + t (pos0 (B,) int32), and write
    them with their scales into layer `layer` of the int8 pool k8/v8
    (L, P, nkv, ps, hd), ks/vs (L, P, nkv, ps), in place, through the page
    tables (B, mp) int32; rows past a slot's table clip into its page
    mp - 1 (paged_rows). The paged forward calls it only where the paged
    attention does not take the int8 walk, which writes the rows itself
    (module docstring)."""
    if k.device.type == "cpu":
        return write_kv_paged_q8_plain(k8, v8, ks, vs, k, v, pos0, tables, layer)
    require(k.device.type == "cuda", f"unsupported device {k.device}")
    _check_cache(k8, v8, ks, vs)
    L, num_pages, nkv, ps, hd = k8.shape
    require(k.dim() == 4 and k.shape == v.shape and k.shape[2:] == (nkv, hd),
            f"rows {tuple(k.shape)} / {tuple(v.shape)} do not fit pool {tuple(k8.shape)}")
    B, T = k.shape[:2]
    require(k.dtype == v.dtype and k.is_contiguous() and v.is_contiguous()
            and k.device == v.device == k8.device, "k/v rows must be contiguous, of one "
            "dtype, on the pool's device")
    require(0 <= layer < L, f"layer {layer} out of range for {L} layers")
    require(pos0.dtype == torch.int32 and pos0.shape == (B,) and pos0.device == k.device
            and pos0.is_contiguous(), "pos0 must be a contiguous (B,) int32 CUDA tensor")
    _check_tables(tables, B, k.device)
    lib = build.library("kv_write", _SIGNATURES)
    off8, offs = layer * num_pages * nkv * ps * hd, layer * num_pages * nkv * ps * 4
    err = lib.rama_kv_write_paged(
        k.data_ptr(), v.data_ptr(), pos0.data_ptr(), tables.data_ptr(), k8.data_ptr() + off8,
        v8.data_ptr() + off8, ks.data_ptr() + offs, vs.data_ptr() + offs, B, T, nkv,
        tables.shape[1], ps, num_pages, hd, build.dtype_code(k), build.stream_ptr(k))
    build.check(lib, err, "write_kv_paged_q8")
    launches["write_kv_paged_q8"] += 1


def write_kv_prefill_paged_q8(k8, v8, ks, vs, k: torch.Tensor, v: torch.Tensor,
                              tables: torch.Tensor, t_ins: int, _body: str | None = None) -> None:
    """K13 (b): quantize rows 0:t_ins of the prefilled strips j < len(tables)
    of k/v (L, K, nkv, T, hd) and write them through table row j (tables
    (n, mp) int32, n <= K, t_ins <= mp * ps) into the int8 pool, every
    layer and slot of the admission group in one launch, in place, on the
    body `prefill_body_for` picks (the private `_body` forces "rows", the
    warp-a-row body, to time it beside the streaming one). Pass only the
    group's real entries: pad rows would rewrite a real slot's pages with
    the same rows."""
    if k.device.type == "cpu":
        return write_kv_prefill_paged_q8_plain(k8, v8, ks, vs, k, v, tables, t_ins)
    require(k.device.type == "cuda", f"unsupported device {k.device}")
    _check_cache(k8, v8, ks, vs)
    L, num_pages, nkv, ps, hd = k8.shape
    require(k.dim() == 5 and k.shape == v.shape and k.shape[0] == L and k.shape[2] == nkv
            and k.shape[4] == hd, f"strips {tuple(k.shape)} do not fit pool {tuple(k8.shape)}")
    K, T = k.shape[1], k.shape[3]
    require(k.dtype == v.dtype and k.is_contiguous() and v.is_contiguous()
            and k.device == v.device == k8.device, "strips must be contiguous, of one "
            "dtype, on the pool's device")
    n = tables.shape[0] if tables.dim() == 2 else -1
    require(0 < n <= K, f"{n} table rows for {K} strips")
    _check_tables(tables, n, k.device)
    mp = tables.shape[1]
    require(0 < t_ins <= min(T, mp * ps), f"t_ins {t_ins} must be in [1, min(T={T}, "
            f"mp * ps={mp * ps})]")
    body = _body_of(_body, k, v, hd)
    lib = build.library("kv_write", _SIGNATURES)
    err = lib.rama_kv_write_prefill_paged(
        k.data_ptr(), v.data_ptr(), tables.data_ptr(), k8.data_ptr(), v8.data_ptr(),
        ks.data_ptr(), vs.data_ptr(), L, K, n, nkv, T, t_ins, mp, ps, num_pages, hd,
        build.dtype_code(k), PREFILL_BODIES[body], build.stream_ptr(k))
    build.check(lib, err, "write_kv_prefill_paged_q8")
    launches["write_kv_prefill_paged_q8"] += 1
    launches_by_body[body] += 1
