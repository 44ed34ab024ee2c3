"""Kernel 12: decode and chunk attention over the shared page pool of the
paged KV cache, bf16 / f32 or int8 with row scales.

The counterparts of `rama_tpu/ops/pallas/paged_attention.py`'s
`paged_decode_attention_layer`, `paged_decode_attention_layer_q8`,
`paged_chunk_attention_layer` and `paged_chunk_attention_layer_q8` (all
four through one shared `pallas_call`, `_paged_call`): q (B, T, nh, hd)
against layer `layer` of the pools (L, P, nkv, ps, hd), reached through
per-slot page tables (B, mp) int32 whose entries past a slot's last used
page may hold any id (clamped to [0, P - 1]); query t of slot b at
position pos0[b] + t sees the slot's rows s <= pos0[b] + t of its mp * ps.

On the card these are the paged forms of the decode-attention kernel
(`csrc/decode_attention.cu`, K4 / K7 / K10): a tile of `split_rows(ps)`
rows lies inside one page, so only the address of its rows goes through
the table, and the splits are `decode_attention.split_plan`'s for mp * ps
rows (at 64- and 128-row pages the dense cache's). Each launch takes the
body `decode_attention.body_for` picks: bf16 at head dim 48 / 64 / 128 a
tensor-core body (the int8 pool's walk body, whose splits of G tiles
find each tile's page), decode and chunk forms alike; fp32 the SIMT
body. The plain versions gather each slot's pages into the dense (B,
nkv, mp * ps, hd) view, as `rama_tpu/runtime/paged.py`'s gather path
does, and run the dense kernels' plain versions over it.

K13 (a) inside K12: the int8 entries take `k_new` / `v_new`, the step's
or chunk's new rows, and write them first through the tables as
`kv_write.write_kv_paged_q8` would (a row past a slot's table clipped into
its page mp - 1). On the card, where the launch takes the walk body
(`da.walk_writes_rows`), the walk launch writes them itself (the CTA whose
items hold the tile of a new row's page and in-page row stores it before
its walk copies it), so no launch of its own; on any other body the
standalone K13 (a) kernel writes them first. The plain versions run the
plain paged writer, then the plain attention.

Dispatch: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
the plain version (`*_plain`).
"""

from __future__ import annotations

import ctypes

import torch

from rama_tpu_torch.ops.kernels import build
from rama_tpu_torch.ops.kernels import decode_attention as da
from rama_tpu_torch.ops.kernels import kv_write as kvw
from rama_tpu_torch.ops.kernels.build import require

# kernel launches since the last reset, by entry (chip_smoke reads them)
launches = {"paged_decode_attention": 0, "paged_decode_attention_q8": 0,
            "paged_chunk_attention": 0, "paged_chunk_attention_q8": 0}
launches_by_body = {"mma": 0, "walk": 0, "simt": 0}   # the same launches (all four forms) by body
# ... on a tensor-core body, by the row form the C entry reports it ran
launches_by_form = {body: dict.fromkeys(da.FORMS, 0) for body in ("mma", "walk")}
launches_write_q8 = 0   # int8 launches (decode or chunk) that also wrote the rows (K13 (a) fused)


split_rows = da.split_rows   # cache rows a tile of the paged kernel reads: within one page


def check(nh: int, nkv: int, hd: int, ps: int, q8: bool) -> None:
    """Raise (naming the limit) unless the kernel serves a GQA group nh /
    nkv with head_dim hd over pages of ps rows (any T queries a slot: any
    T * nh / nkv query rows a kv head, `da.row_form`)."""
    da.check_group(nh, nkv)
    da.check_head_dim(hd, q8)
    split_rows(ps)


def gather_pages(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """One layer of a pool, (P, nkv, ps, ...), through page tables (B, mp)
    -> the dense (B, nkv, mp * ps, ...) view (table entries clamped to
    [0, P - 1])."""
    b, mp = tables.shape
    g = pages[tables.long().clamp(0, pages.shape[0] - 1)]    # (B, mp, nkv, ps, ...)
    g = g.transpose(1, 2)
    return g.reshape(b, g.shape[1], mp * g.shape[3], *g.shape[4:])


def paged_chunk_attention_plain(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                                pos0: torch.Tensor, tables: torch.Tensor,
                                layer: int) -> torch.Tensor:
    """Plain PyTorch version: the gathered view through chunk_attention_plain.
    q (B, T, nh, hd) -> (B, T, nh * hd)."""
    views = [gather_pages(p[layer], tables)[None] for p in (k_pool, v_pool)]
    return da.chunk_attention_plain(q, *views, pos0, 0)


def paged_chunk_attention_q8_plain(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                                   ks_pool: torch.Tensor, vs_pool: torch.Tensor,
                                   pos0: torch.Tensor, tables: torch.Tensor,
                                   layer: int, k_new: torch.Tensor | None = None,
                                   v_new: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version over the int8 pool: the gathered int8 rows and
    scales through chunk_attention_q8_plain. With k_new / v_new (B, T, nkv,
    hd) the plain paged writer (`kv_write.write_kv_paged_q8_plain`) writes
    them first."""
    if da.new_rows(k_new, v_new) is not None:
        kvw.write_kv_paged_q8_plain(k_pool, v_pool, ks_pool, vs_pool, k_new, v_new, pos0,
                                    tables, layer)
    views = [gather_pages(p[layer], tables)[None] for p in (k_pool, v_pool, ks_pool, vs_pool)]
    return da.chunk_attention_q8_plain(q, *views, pos0, 0)


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                                 pos: torch.Tensor, tables: torch.Tensor,
                                 layer: int) -> torch.Tensor:
    """paged_chunk_attention_plain of one query per slot: q (B, nh, hd) ->
    (B, nh * hd)."""
    return paged_chunk_attention_plain(q[:, None], k_pool, v_pool, pos, tables, layer)[:, 0]


def paged_decode_attention_q8_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                    v_pool: torch.Tensor, ks_pool: torch.Tensor,
                                    vs_pool: torch.Tensor, pos: torch.Tensor,
                                    tables: torch.Tensor, layer: int,
                                    k_new: torch.Tensor | None = None,
                                    v_new: torch.Tensor | None = None) -> torch.Tensor:
    """paged_chunk_attention_q8_plain of one query per slot (new rows k_new
    / v_new (B, nkv, hd))."""
    rows = da.new_rows(k_new, v_new)
    return paged_chunk_attention_q8_plain(
        q[:, None], k_pool, v_pool, ks_pool, vs_pool, pos, tables, layer,
        *((None, None) if rows is None else (k_new[:, None], v_new[:, None])))[:, 0]


def _walk_rows(q: torch.Tensor, pools: tuple, rows: tuple | None, pos0: torch.Tensor,
               tables: torch.Tensor, layer: int) -> tuple | None:
    """The new rows (B, T, nkv, hd) an int8 launch for q is to write
    itself: all of them where it takes the walk body (`da.walk_writes_rows`),
    else none, K13 (a)'s own launch having written them first."""
    if rows is None or da.walk_writes_rows(q):
        return rows
    kvw.write_kv_paged_q8(*pools, *rows, pos0, tables, layer)
    return None


def _launch(q: torch.Tensor, pools: tuple, pos0: torch.Tensor, tables: torch.Tensor,
            layer: int, what: str, tiles: int | None = None,
            rows: tuple | None = None) -> torch.Tensor:
    """Check and launch the paged kernel for q (B, T, nh, hd) against layer
    `layer` of pools (k, v) or (k8, v8, ks, vs), over `da.split_plan`'s
    splits (G `tiles` on the walk body when given); `rows` (k_new, v_new):
    the int8 pool's new rows, which the walk launch writes first
    (`da.rows_ptrs`; counted in launches_write_q8). Returns (B, T, nh *
    hd)."""
    global launches_write_q8
    require(q.device.type == "cuda", f"unsupported device {q.device}")
    k, v = pools[0], pools[1]
    q8 = len(pools) == 4
    require(q.dim() == 4 and k.dim() == 5 and k.shape == v.shape,
            "q (B, T, nh, hd) and pools (L, P, nkv, ps, hd) expected")
    b, t, nh, hd = q.shape
    L, npages, nkv, ps, hdc = k.shape
    require(hdc == hd, f"q {tuple(q.shape)} does not fit pool {tuple(k.shape)}")
    check(nh, nkv, hd, ps, q8)
    require(0 <= layer < L, f"layer {layer} out of range for {L} layers")
    body = da.check_caches(q, pools)
    require(pos0.dtype == torch.int32 and pos0.shape == (b,) and pos0.device == q.device
            and pos0.is_contiguous(), "positions must be a contiguous (B,) int32 CUDA tensor")
    require(tables.dtype == torch.int32 and tables.dim() == 2 and tables.shape[0] == b
            and tables.device == q.device and tables.is_contiguous(),
            "page tables must be a contiguous (B, mp) int32 CUDA tensor")
    mp = tables.shape[1]
    require(q8 or rows is None, "new rows are written into an int8 pool only")
    knew, vnew = da.rows_ptrs(q, rows, nkv)
    plan = da.split_plan(mp * ps, ps, walk=body == "walk", tiles=tiles)
    lib = build.library("decode_attention", da._SIGNATURES)
    out, part_o, part_ml = da.scratch(q, plan)
    pointers = (q.data_ptr(), *da.layer_ptrs(pools, layer * npages * nkv * ps))
    tail = (pos0.data_ptr(), tables.data_ptr(), out.data_ptr(), part_o.data_ptr(),
            part_ml.data_ptr(), b, t, nh, nkv, mp, ps, npages, hd, plan.tile)
    ran = ctypes.c_int(0)
    if q8:
        ctas = (da.walk_launch_ctas(q.device.index, b, t, nh, nkv, hd, plan)
                if body == "walk" else 0)
        err = lib.rama_paged_attention_q8(*pointers, knew, vnew, *tail, plan.tiles, ctas,
                                          build.dtype_code(q), da.BODIES[body],
                                          build.stream_ptr(q), ctypes.byref(ran))
    else:
        err = lib.rama_paged_attention(*pointers, *tail, build.dtype_code(q), da.BODIES[body],
                                       build.stream_ptr(q), ctypes.byref(ran))
    build.check(lib, err, what)
    launches[what] += 1
    launches_write_q8 += rows is not None
    da.count_launch(launches_by_body, launches_by_form, body, ran.value, t, nh // nkv)
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           pos: torch.Tensor, tables: torch.Tensor, layer: int) -> torch.Tensor:
    """K12, decode: q (B, nh, hd) against layer `layer` of the pools
    (L, P, nkv, ps, hd) through page tables (B, mp) int32, visible rows
    s <= pos[b] (pos (B,) int32). Returns (B, nh * hd) in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, pos, tables, layer)
    return _launch(q[:, None], (k_pool, v_pool), pos, tables, layer,
                   "paged_decode_attention")[:, 0]


def paged_decode_attention_q8(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                              ks_pool: torch.Tensor, vs_pool: torch.Tensor, pos: torch.Tensor,
                              tables: torch.Tensor, layer: int,
                              k_new: torch.Tensor | None = None,
                              v_new: torch.Tensor | None = None) -> torch.Tensor:
    """K12, decode over an int8 pool: k/v (L, P, nkv, ps, hd) int8 with f32
    row scales ks/vs (L, P, nkv, ps); otherwise as paged_decode_attention.
    With k_new / v_new (B, nkv, hd), the step's post-RoPE rows, they are
    first written at pos[b] through the tables as write_kv_paged_q8 would
    (see paged_chunk_attention_q8)."""
    rows = da.new_rows(k_new, v_new)
    if q.device.type == "cpu":
        return paged_decode_attention_q8_plain(q, k_pool, v_pool, ks_pool, vs_pool, pos,
                                               tables, layer, k_new, v_new)
    q, pools = q[:, None], (k_pool, v_pool, ks_pool, vs_pool)
    rows = _walk_rows(q, pools, None if rows is None else tuple(r[:, None] for r in rows), pos,
                      tables, layer)
    return _launch(q, pools, pos, tables, layer, "paged_decode_attention_q8", rows=rows)[:, 0]


def paged_chunk_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                          pos0: torch.Tensor, tables: torch.Tensor, layer: int) -> torch.Tensor:
    """K12, chunk: q (B, T, nh, hd), T consecutive queries a slot from
    pos0[b], against layer `layer` of the pools through page tables (B, mp);
    the chunk's own rows written first. Returns (B, T, nh * hd)."""
    if q.device.type == "cpu":
        return paged_chunk_attention_plain(q, k_pool, v_pool, pos0, tables, layer)
    return _launch(q, (k_pool, v_pool), pos0, tables, layer, "paged_chunk_attention")


def paged_chunk_attention_q8(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                             ks_pool: torch.Tensor, vs_pool: torch.Tensor, pos0: torch.Tensor,
                             tables: torch.Tensor, layer: int,
                             k_new: torch.Tensor | None = None,
                             v_new: torch.Tensor | None = None) -> torch.Tensor:
    """K12, chunk over an int8 pool. With k_new / v_new (B, T, nkv, hd), the
    chunk's post-RoPE rows, they are first quantized and written at
    positions pos0[b] + t through the tables, as write_kv_paged_q8 would
    (a row past a slot's table clipped into its page mp - 1): on the card
    by the walk launch itself where it takes the walk (counted in
    launches_write_q8), else by K13 (a)'s own launch first (`_walk_rows`)."""
    rows = da.new_rows(k_new, v_new)
    if q.device.type == "cpu":
        return paged_chunk_attention_q8_plain(q, k_pool, v_pool, ks_pool, vs_pool, pos0,
                                              tables, layer, k_new, v_new)
    pools = (k_pool, v_pool, ks_pool, vs_pool)
    return _launch(q, pools, pos0, tables, layer, "paged_chunk_attention_q8",
                   rows=_walk_rows(q, pools, rows, pos0, tables, layer))
