"""Kernels 4, 7, 9 and 10: decode attention against layer l of the stacked
KV cache, for one query per slot — bf16 / f32 cache (K4) or int8 with row
scales (K7) — or against one layer's cache (K9, both caches), or for a
chunk of T consecutive queries per slot on either cache (K10, speculative
verification), at any GQA group.

The counterparts of `rama_tpu/ops/pallas/decode_attention.py`'s
`decode_attention_layer` and `decode_attention_layer_tiled` (one function:
GQA softmax(q k^T / sqrt(hd)) v over cache rows s <= pos[b]), of
`decode_attention_layer_q8` and `decode_attention_layer_tiled_q8` (the same
over an int8 cache, scales applied after the products), and of
`chunk_attention_layer`, `_tiled`, `_q8` and `_tiled_q8` (query t of slot b
at position pos0[b] + t sees rows s <= pos0[b] + t). On the card, one
flash-decoding kernel split over S plus a combine pass, instantiated for
both caches (`csrc/decode_attention.cu`), with two bodies (below); T = 1
is the decode step.

Kernel 9 is `decode_attention` and `decode_attention_q8` of the same Pallas
file: the same function as K4 / K7 over ONE layer's cache (B, nkv, S, hd)
instead of layer l of the stacked one — the generic `_layer`'s T = 1 path
(`prefill` of a one-token prompt, `forward(..., logit_rows=...)` at T = 1).
Its wrappers (`decode_attention_flat`, `_flat_q8`) launch the same
hand-written kernel on the one-layer view as a stack of one layer, layer 0:
the cache bytes each (slot, head) reads, and so the bound, are K4's / K7's.

The same kernels read the paged cache's pool through page tables: kernel
12, whose wrappers are in ops/kernels/paged_attention.py.

Dispatch: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
the plain version (`*_plain`). The split kernel's body is fixed by q's
dtype, the head dim and the cache before the launch (`body_for`): bf16 at
a head dim of MMA_HEAD_DIMS takes a tensor-core body, "mma" over a bf16
cache and "walk" over an int8 one, for one query row a kv head (the
decode step) as for a verification chunk; fp32 and any other head dim
the SIMT body ("simt"). One body for both is what lets greedy
speculation accept its own drafts: a verification row then computes
exactly what the decode step computes at that position. A refused launch
raises; it never gives way to another body.

The splits each launch's partials are sized for come from `split_plan`:
one tile of CHUNK rows (a pool: `split_rows` of its page) a split, but on
the walk body, where a split is G tiles, G a function of the cache's rows
alone.

The T * nh / nkv query rows of a kv head run in one of four forms of the
tensor-core bodies (`row_form`): 8 rows (every Llama-2 shape at T <= 8,
and a decode step of a GQA group <= 8), or 16, 32 or 64 rows of whole m16
tiles, past 64 rows in row groups of 64 on a grid dimension; the SIMT
body takes groups of 8. A query row computes the same bits in every form,
so a verified row equals the decode step's whatever the group.

K11 inside K10: `chunk_attention_q8` with `k_new` / `v_new`, the chunk's
new rows, writes them first, as `kv_write.write_kv_chunk_q8` would. On the
card the entry picks who writes them (`walk_writes_rows`): where the
launch takes the walk body, the walk launch writes them itself (the CTA
whose items hold a new row's tile quantizes it and stores it into the
cache before its walk copies it): no launch of its own, the same bytes and
the same outputs as the writer followed by the walk. On any other body
the standalone K11 kernel writes them first, in a launch of its own. Its
plain version is the plain writer followed by the plain attention.

K6 inside K7 alike: `decode_attention_q8` with `k_new` / `v_new`, the
decode step's new rows, writes them as `kv_write.write_kv_rows_q8` would
(K6's rule: a finished slot's overshoot past the cache end lands on row S
- 1, where K11's rule drops a row past S): on the walk by the launch
itself (counted in `launches_write_rows_q8`), on any other body by K6's
own launch first.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from rama_tpu_torch.ops.kernels import build
from rama_tpu_torch.ops.kernels import kv_write as _kvw
from rama_tpu_torch.ops.kernels.build import I, P, require

launches = 0           # K4 launches since the last reset (chip_smoke reads them)
launches_q8 = 0        # K7 launches since the last reset
launches_chunk = 0     # K10 launches on a bf16 / f32 cache
launches_chunk_q8 = 0  # K10 launches on an int8 cache
launches_flat = 0      # K9 launches on a bf16 / f32 cache (one layer)
launches_flat_q8 = 0   # K9 launches on an int8 cache (one layer)
launches_by_body = {"mma": 0, "walk": 0, "simt": 0}   # every launch above (K4, K7, K9, K10) by body
launches_write_q8 = 0  # K10 int8 launches that also wrote the chunk's rows (K11 fused)
launches_write_rows_q8 = 0   # K7 launches that also wrote the decode step's rows (K6 fused)
CHUNK = 64     # cache rows per tile (csrc/decode_attention.cu kMaxChunk, the most it takes)
FORMS = (8, 16, 32, 64)   # query rows a CTA of the tensor-core bodies (csrc dattn_mma.cuh)
# the tensor-core bodies' launches by the row form the C entry reports it ran
launches_by_form = {body: dict.fromkeys(FORMS, 0) for body in ("mma", "walk")}

MMA_HEAD_DIMS = (48, 64, 128)      # the tensor-core bodies' instantiations
DA_THREADS = 128   # threads a split CTA (csrc kDaThreads)
BODIES = {"simt": 0, "mma": 1, "walk": 2}   # body codes of the C entries (csrc rama::Body)

# every C entry of csrc/decode_attention.cu, the paged forms (K12, called by
# ops/kernels/paged_attention.py) included: the library is loaded once
_SIGNATURES = {
    "rama_decode_attention": [P] * 7 + [I] * 9 + [P, P],
    "rama_decode_attention_q8": [P] * 11 + [I] * 12 + [P, P],
    "rama_decode_attention_occupancy": [I] * 8 + [P],
    "rama_paged_attention": [P] * 8 + [I] * 11 + [P, P],
    "rama_paged_attention_q8": [P] * 12 + [I] * 13 + [P, P],
}


def body_for(dtype: torch.dtype, hd: int, q8: bool = False) -> str:
    """The body of the split kernel a CUDA launch runs: bf16 at a head dim
    of MMA_HEAD_DIMS on the tensor cores, "walk" over an int8 cache (q8)
    and "mma" over a bf16 one; "simt" (CUDA cores) else, whatever the
    number of query rows."""
    if dtype != torch.bfloat16 or hd not in MMA_HEAD_DIMS:
        return "simt"
    return "walk" if q8 else "mma"


def split_rows(ps: int) -> int:
    """Cache rows of a tile over pages of ps rows: the largest multiple of 8
    that is <= CHUNK and divides the page size (64 for 128, 16 for 16, 48
    for 96), so that no tile straddles two pages."""
    require(ps > 0 and ps % 8 == 0, f"page size {ps} must be a positive multiple of 8 "
            f"(the paged kernel's splits are whole multiples of 8 rows of one page)")
    return next(c for c in range(min(CHUNK, ps) // 8 * 8, 0, -8) if ps % c == 0)


def walk_tiles(ntiles: int) -> int:
    """G, the tiles of a walk split, for a cache of `ntiles` tiles."""
    return max(1, min(4, ntiles // 16))


class SplitPlan(NamedTuple):
    tile: int     # cache rows a tile, at multiples of which tiles start
    tiles: int    # G: consecutive tiles a split
    nsplit: int   # splits of the cache: ceil(ceil(S / tile) / G)


def split_plan(s: int, ps: int | None = None, walk: bool = False,
               tiles: int | None = None) -> SplitPlan:
    """The splits of a cache of s rows (a pool's mp * ps, pages of ps rows;
    dense when ps is None) on the walk body (walk) or another: tiles of
    CHUNK rows (`split_rows(ps)` for a pool), one a split but G =
    `walk_tiles` on the walk body (`tiles` when given: a sweep or a test
    of another G; no wrapper passes it). A function of the cache alone,
    never of the positions or of the queries a slot, so every form that
    reads one cache walks the same splits."""
    tile = CHUNK if ps is None else split_rows(ps)
    ntiles = -(-s // tile)
    g = (tiles or walk_tiles(ntiles)) if walk else 1
    return SplitPlan(tile, g, -(-ntiles // g))


def scratch(q: torch.Tensor, plan: SplitPlan) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A launch's output and partials for q (B, T, nh, hd) over `plan`'s
    splits: out (B, T, nh * hd) in q's dtype, part_o (B, T, nh, nsplit, hd)
    and part_ml (B, T, nh, nsplit, 2) fp32 (each query row's (m, l, o) of
    every split it sees)."""
    b, t, nh, hd = q.shape
    out = torch.empty((b, t, nh * hd), dtype=q.dtype, device=q.device)
    part_o = torch.empty((b, t, nh, plan.nsplit, hd), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, t, nh, plan.nsplit, 2), dtype=torch.float32, device=q.device)
    return out, part_o, part_ml


def row_form(t: int, rep: int) -> tuple[int, int]:
    """(rows, groups): the form of the tensor-core bodies a launch of T
    queries over a GQA group rep runs — the fewest of FORMS rows that hold
    its T * rep query rows a kv head — and its row groups a kv head (more
    than 64 rows run as groups of 64). csrc dattn_mma.cuh form_rows."""
    rows = t * rep
    form = next((f for f in FORMS if rows <= f), FORMS[-1])
    return form, -(-rows // form)


def form_smem(body: str, form: int, hd: int, b: int = 1) -> int:
    """Dynamic shared memory one split CTA of a tensor-core body asks for,
    in bytes: "mma" (csrc MmaSmem: K, V tiles of CHUNK bf16 rows of hd + 8,
    Q and P tiles of `form` rows, row maxima and sums) or "walk" (csrc
    WalkSmem + walk_smem: int8 K, V tiles of CHUNK rows of hd + 16 or + 32
    bytes, their f32 row scales, Q, P, maxima and sums, and the walk's
    table of 2 b + 1 ints for b slots)."""
    warps = DA_THREADS // 32
    ld, pld = hd + 8, CHUNK + 8
    rows = 2 * form * (ld + pld) + 4 * 2 * warps * form
    if body == "mma":
        return 2 * CHUNK * ld * 2 + rows
    rld = hd + 16 if ((hd + 16) // 16) % 2 else hd + 32
    return 2 * CHUNK * rld + 2 * 4 * CHUNK + rows + 4 * (2 * b + 1)


def walk_ctas(b: int, nkv: int, nsplit: int, wave: int) -> int:
    """CTAs a (kv head, row group) of a walk launch: as many as one wave of
    the card (`wave` resident CTAs of the launched form) holds for each of
    the `nkv` (kv head, row group) pairs, never more than the b * nsplit
    (slot, split) items there can be. They walk the items that hold a
    visible row (csrc dattn_walk), so the grid has no CTA past a slot's
    position."""
    return max(1, min(b * nsplit, wave // nkv))


@functools.lru_cache(maxsize=None)
def walk_wave(device_index: int, hd: int, form: int = FORMS[0]) -> int:
    """Resident dattn_walk CTAs of the `form`-row form on the whole card at
    head dim hd: SMs times CTAs an SM (occupancy API; each form has its own
    register cap and shared memory)."""
    with torch.cuda.device(device_index):
        per_sm = occupancy(form, 1, 1, hd, q8=True)["ctas_per_sm"]
        return torch.cuda.get_device_properties(device_index).multi_processor_count * per_sm


def check_group(nh: int, nkv: int) -> None:
    """Raise unless nh query heads share nkv kv heads in whole GQA groups
    (any T * nh / nkv query rows a kv head run: `row_form`)."""
    require(nkv > 0 and nh % nkv == 0,
            f"GQA group {nh}/{nkv}: {nh} query heads do not divide into {nkv} kv heads")


def check_head_dim(hd: int, q8: bool) -> None:
    """Raise unless the kernel's lanes cover head_dim hd: 16-byte reads of
    8 bf16 / f32 or 16 int8 elements, at most 256."""
    m = 16 if q8 else 8
    require(hd % m == 0 and hd <= 256, f"head_dim {hd} must be a multiple of {m}, <= 256")


def _visible(pos0: torch.Tensor, t: int, s: int) -> torch.Tensor:
    """(B, T, S): cache row s is visible to query t iff s <= pos0[b] + t."""
    qpos = pos0.long()[:, None] + torch.arange(t, device=pos0.device)[None, :]
    return torch.arange(s, device=pos0.device)[None, None, :] <= qpos[:, :, None]


def chunk_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          pos0: torch.Tensor, layer: int) -> torch.Tensor:
    """Plain PyTorch version (the XLA einsum path of rama_tpu's `_attention`):
    q (B, T, nh, hd), fp32 scores, -1e30 mask fill, softmax, probabilities
    cast to the cache dtype before P.V. Returns (B, T, nh * hd) in q's
    dtype."""
    k, v = k_cache[layer], v_cache[layer]            # (B, nkv, S, hd)
    b, t, nh, hd = q.shape
    nkv, s = k.shape[1], k.shape[2]
    qg = q.reshape(b, t, nkv, nh // nkv, hd).float()
    scores = torch.einsum("btkrh,bksh->btkrs", qg, k.float()) / math.sqrt(hd)
    scores = torch.where(_visible(pos0, t, s)[:, :, None, None, :], scores,
                         torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("btkrs,bksh->btkrh", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, t, nh * hd).to(q.dtype)


def chunk_attention_q8_plain(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                             ks: torch.Tensor, vs: torch.Tensor, pos0: torch.Tensor,
                             layer: int, k_new: torch.Tensor | None = None,
                             v_new: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version over the int8 cache: scores (q . k8) * ks /
    sqrt(hd) in fp32, -1e30 mask fill, softmax, then the probabilities
    times the V row scales rounded to q's dtype (the q8 Pallas kernels'
    bf16 cast of probs * vs) before the product with v8. Returns
    (B, T, nh * hd) in q's dtype. With k_new / v_new (B, T, nkv, hd) the
    plain writer (`kv_write.write_kv_chunk_q8_plain`) writes them first."""
    if new_rows(k_new, v_new) is not None:
        _kvw.write_kv_chunk_q8_plain(k8, v8, ks, vs, k_new, v_new, pos0, layer)
    k, v = k8[layer].float(), v8[layer].float()      # (B, nkv, S, hd)
    b, t, nh, hd = q.shape
    nkv, s = k.shape[1], k.shape[2]
    qg = q.reshape(b, t, nkv, nh // nkv, hd).float()
    scores = (torch.einsum("btkrh,bksh->btkrs", qg, k)
              * ks[layer][:, None, :, None, :] / math.sqrt(hd))
    scores = torch.where(_visible(pos0, t, s)[:, :, None, None, :], scores,
                         torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1) * vs[layer][:, None, :, None, :]
    out = torch.einsum("btkrs,bksh->btkrh", probs.to(q.dtype).float(), v)
    return out.reshape(b, t, nh * hd).to(q.dtype)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: torch.Tensor,
                           layer: int) -> torch.Tensor:
    """chunk_attention_plain of one query per slot: q (B, nh, hd) ->
    (B, nh * hd)."""
    return chunk_attention_plain(q[:, None], k_cache, v_cache, pos, layer)[:, 0]


def decode_attention_q8_plain(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                              ks: torch.Tensor, vs: torch.Tensor, pos: torch.Tensor,
                              layer: int, k_new: torch.Tensor | None = None,
                              v_new: torch.Tensor | None = None) -> torch.Tensor:
    """chunk_attention_q8_plain of one query per slot: q (B, nh, hd) ->
    (B, nh * hd). With k_new / v_new (B, nkv, hd) the plain K6 writer
    (`kv_write.write_kv_rows_q8_plain`: pos clamped to [0, S - 1]) writes
    them first."""
    if new_rows(k_new, v_new) is not None:
        _kvw.write_kv_rows_q8_plain(k8, v8, ks, vs, k_new, v_new, pos, layer)
    return chunk_attention_q8_plain(q[:, None], k8, v8, ks, vs, pos, layer)[:, 0]


def check_caches(q: torch.Tensor, caches: tuple) -> str:
    """The operand checks shared by the dense and paged launches: head_dim,
    dtypes, (k, v) or (k8, v8, ks, vs) with scales of k's leading four
    dims, contiguity, one device, 16-byte aligned k / v (and q, on the
    tensor-core bodies). Returns the body the launch takes (`body_for`)."""
    k, v = caches[0], caches[1]
    q8 = len(caches) == 4
    check_head_dim(q.shape[-1], q8)
    if q8:
        ks, vs = caches[2], caches[3]
        require(k.dtype == v.dtype == torch.int8, "k8/v8 must be int8")
        require(ks.shape == vs.shape == k.shape[:4] and ks.dtype == vs.dtype == torch.float32,
                "ks/vs must be float32 of k8's shape without head_dim")
    else:
        require(q.dtype == k.dtype == v.dtype,
                f"q {q.dtype} and cache {k.dtype} dtypes differ")
    require(all(x.is_contiguous() and x.device == q.device for x in (q, *caches)),
            "q and caches must be contiguous, on one device")
    require(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
            "k/v caches must start 16-byte aligned (the kernel copies 16-byte pieces)")
    body = body_for(q.dtype, q.shape[-1], q8)
    require(body == "simt" or q.data_ptr() % 16 == 0,
            "q must start 16-byte aligned (the tensor-core body copies 16-byte pieces)")
    return body


def new_rows(k_new: torch.Tensor | None,
             v_new: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor] | None:
    """(k_new, v_new), the rows an int8 attention call writes first, or
    None when it writes none; raise if only one of the two is given."""
    require((k_new is None) == (v_new is None), "k_new and v_new come together")
    return None if k_new is None else (k_new, v_new)


def walk_writes_rows(q: torch.Tensor) -> bool:
    """Whether an int8 attention launch for q (B, T, nh, hd) writes the new
    rows it is given itself: on the walk body only (bf16 at a head dim of
    MMA_HEAD_DIMS). The _q8 entries run the standalone writer (K11 / K13
    (a), a launch of its own) first on any other body."""
    return body_for(q.dtype, q.shape[-1], q8=True) == "walk"


def rows_ptrs(q: torch.Tensor, rows: tuple | None, nkv: int) -> tuple[int, int]:
    """The addresses of the new rows (k_new, v_new) a walk launch for q (B,
    T, nh, hd) writes, (0, 0) for none, after their checks: (B, T, nkv, hd)
    of q's dtype, contiguous, 16-byte aligned, on q's device (the C entry
    refuses them off the walk body)."""
    if rows is None:
        return 0, 0
    b, t, _, hd = q.shape
    require(all(r.shape == (b, t, nkv, hd) and r.dtype == q.dtype and r.is_contiguous()
                and r.device == q.device and r.data_ptr() % 16 == 0 for r in rows),
            f"new rows must be contiguous, 16-byte aligned ({b}, {t}, {nkv}, {hd}) {q.dtype} "
            f"on q's device, got {[tuple(r.shape) for r in rows]}")
    return rows[0].data_ptr(), rows[1].data_ptr()


def _launch(q: torch.Tensor, caches: tuple, pos0: torch.Tensor, layer: int,
            what: str, tiles: int | None = None, rows: tuple | None = None,
            clamp: bool = False) -> torch.Tensor:
    """Check and launch the kernel for q (B, T, nh, hd) against layer
    `layer` of caches (k, v) or, for an int8 cache, (k8, v8, ks, vs), on
    the body `body_for` picks, over `split_plan`'s splits (G `tiles` on
    the walk body when given); `rows` (k_new, v_new): the int8 cache's new
    rows, which the walk launch writes first (`rows_ptrs`), by K11's rule,
    or by K6's with `clamp` (T = 1: a row past the cache end on row S - 1).
    Returns (B, T, nh * hd) in q's dtype."""
    require(q.device.type == "cuda", f"unsupported device {q.device}")
    k, v = caches[0], caches[1]
    q8 = len(caches) == 4
    require(q.dim() == 4 and k.dim() == 5 and k.shape == v.shape,
            "q (B, T, nh, hd) and caches (L, B, nkv, S, hd) expected")
    b, t, nh, hd = q.shape
    L, bc, nkv, s, hdc = k.shape
    require(bc == b and hdc == hd, f"q {tuple(q.shape)} does not fit cache {tuple(k.shape)}")
    check_group(nh, nkv)
    require(0 <= layer < L, f"layer {layer} out of range for {L} layers")
    body = check_caches(q, caches)
    require(pos0.dtype == torch.int32 and pos0.shape == (b,) and pos0.device == q.device
            and pos0.is_contiguous(), "positions must be a contiguous (B,) int32 CUDA tensor")
    dtype = build.dtype_code(q)
    require(q8 or rows is None, "new rows are written into an int8 cache only")
    require(not clamp or (rows is not None and t == 1),
            "K6's row rule (clamp) is the decode step's: one new row a slot")
    knew, vnew = rows_ptrs(q, rows, nkv)
    lib = build.library("decode_attention", _SIGNATURES)
    plan = split_plan(s, walk=body == "walk", tiles=tiles)
    out, part_o, part_ml = scratch(q, plan)
    tail = (pos0.data_ptr(), out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(), b, t, nh,
            nkv, s, hd)
    ran = ctypes.c_int(0)
    if q8:
        ctas = walk_launch_ctas(q.device.index, b, t, nh, nkv, hd, plan) if body == "walk" else 0
        err = lib.rama_decode_attention_q8(
            q.data_ptr(), *layer_ptrs(caches, layer * b * nkv * s), knew, vnew, *tail,
            plan.tile, plan.tiles, ctas, int(clamp), dtype, BODIES[body], build.stream_ptr(q),
            ctypes.byref(ran))
    else:
        err = lib.rama_decode_attention(q.data_ptr(), *layer_ptrs(caches, layer * b * nkv * s),
                                        *tail, plan.tile, dtype, BODIES[body],
                                        build.stream_ptr(q), ctypes.byref(ran))
    build.check(lib, err, what)
    count_launch(launches_by_body, launches_by_form, body, ran.value, t, nh // nkv)
    return out


def count_launch(by_body: dict, by_form: dict, body: str, ran: int, t: int, rep: int) -> None:
    """Count one launch by body and, on a tensor-core body, by the row form
    `ran` that the C entry reports it launched. Raise if that is not the
    form `row_form` sized the launch for (the walk's wave, `walk_ctas`)."""
    by_body[body] += 1
    if body != "simt":
        require(ran == row_form(t, rep)[0],
                f"the {body} body launched its {ran}-row form for T {t} x GQA group {rep}, "
                f"not the {row_form(t, rep)[0]}-row form the launch was sized for")
        by_form[body][ran] += 1


def walk_launch_ctas(device_index: int, b: int, t: int, nh: int, nkv: int, hd: int,
                     plan: SplitPlan) -> int:
    """The walk body's CTAs a (kv head, row group) for a launch of T
    queries: one wave of the form it runs (`row_form`), shared by its
    nkv * groups (kv head, row group) pairs."""
    form, groups = row_form(t, nh // nkv)
    return walk_ctas(b, nkv * groups, plan.nsplit, walk_wave(device_index, hd, form))


def layer_ptrs(caches: tuple, rows: int) -> list[int]:
    """Addresses of the first of `rows` (S or page) rows into each of k, v
    (and ks, vs): the layer offset of a stacked cache or pool."""
    hd = caches[0].shape[-1]
    return [c.data_ptr() + rows * (hd if c.dim() == 5 else 1) * c.element_size()
            for c in caches]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor, layer: int) -> torch.Tensor:
    """K4: q (B, nh, hd) against layer `layer` of k/v caches (L, B, nkv, S,
    hd), visible rows s <= pos[b] (pos (B,) int32, clamped to [0, S-1] on
    the card). Returns (B, nh * hd) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos, layer)
    global launches
    require(q.dim() == 3, "q (B, nh, hd) expected")
    out = _launch(q[:, None], (k_cache, v_cache), pos, layer, "decode_attention")
    launches += 1
    return out[:, 0]


def decode_attention_q8(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                        ks: torch.Tensor, vs: torch.Tensor, pos: torch.Tensor,
                        layer: int, k_new: torch.Tensor | None = None,
                        v_new: torch.Tensor | None = None) -> torch.Tensor:
    """K7: q (B, nh, hd) against layer `layer` of the int8 caches k8/v8
    (L, B, nkv, S, hd) with f32 row scales ks/vs (L, B, nkv, S), visible
    rows s <= pos[b] (pos (B,) int32, clamped to [0, S-1] on the card).
    With k_new / v_new (B, nkv, hd), the decode step's post-RoPE rows,
    they are first quantized and written at [layer, b, :, clamp(pos[b], 0,
    S - 1)], as write_kv_rows_q8 (K6) would: on the card by the walk
    launch itself where it takes the walk (`walk_writes_rows`; counted in
    launches_write_rows_q8), else by K6's own launch first. Returns (B, nh
    * hd) in q's dtype."""
    rows = new_rows(k_new, v_new)
    if q.device.type == "cpu":
        return decode_attention_q8_plain(q, k8, v8, ks, vs, pos, layer, k_new, v_new)
    require(q.dim() == 3, "q (B, nh, hd) expected")
    if rows is not None and not walk_writes_rows(q[:, None]):
        _kvw.write_kv_rows_q8(k8, v8, ks, vs, *rows, pos, layer)
        rows = None
    global launches_q8, launches_write_rows_q8
    if rows is not None:
        rows = tuple(r[:, None] for r in rows)      # (B, 1, nkv, hd): one row a slot
    out = _launch(q[:, None], (k8, v8, ks, vs), pos, layer, "decode_attention_q8",
                  rows=rows, clamp=rows is not None)
    launches_q8 += 1
    launches_write_rows_q8 += rows is not None
    return out[:, 0]


def decode_attention_flat_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                pos: torch.Tensor) -> torch.Tensor:
    """decode_attention_plain over one layer's cache: k/v (B, nkv, S, hd)."""
    return decode_attention_plain(q, k[None], v[None], pos, 0)


def decode_attention_flat_q8_plain(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                                   ks: torch.Tensor, vs: torch.Tensor,
                                   pos: torch.Tensor) -> torch.Tensor:
    """decode_attention_q8_plain over one layer's int8 cache: k8/v8 (B, nkv,
    S, hd), ks/vs (B, nkv, S)."""
    return decode_attention_q8_plain(q, k8[None], v8[None], ks[None], vs[None], pos, 0)


def decode_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
    """K9: q (B, nh, hd) against one layer's k/v caches (B, nkv, S, hd),
    visible rows s <= pos[b] (pos (B,) int32, clamped to [0, S-1] on the
    card). Returns (B, nh * hd) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_flat_plain(q, k, v, pos)
    global launches_flat
    require(q.dim() == 3 and k.dim() == 4, "q (B, nh, hd) and caches (B, nkv, S, hd) expected")
    out = _launch(q[:, None], (k[None], v[None]), pos, 0, "decode_attention_flat")
    launches_flat += 1
    return out[:, 0]


def decode_attention_flat_q8(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                             ks: torch.Tensor, vs: torch.Tensor,
                             pos: torch.Tensor) -> torch.Tensor:
    """K9 over an int8 cache: k8/v8 (B, nkv, S, hd) int8 with f32 row scales
    ks/vs (B, nkv, S); otherwise as decode_attention_flat."""
    if q.device.type == "cpu":
        return decode_attention_flat_q8_plain(q, k8, v8, ks, vs, pos)
    global launches_flat_q8
    require(q.dim() == 3 and k8.dim() == 4,
            "q (B, nh, hd) and caches (B, nkv, S, hd) expected")
    out = _launch(q[:, None], (k8[None], v8[None], ks[None], vs[None]), pos, 0,
                  "decode_attention_flat_q8")
    launches_flat_q8 += 1
    return out[:, 0]


def chunk_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    pos0: torch.Tensor, layer: int) -> torch.Tensor:
    """K10: q (B, T, nh, hd), T consecutive queries per slot, query t at
    position pos0[b] + t, against layer `layer` of k/v caches (L, B, nkv,
    S, hd); each query's visible rows clamped to [0, S-1] on the card.
    pos0 (B,) int32. Returns (B, T, nh * hd) in q's dtype."""
    if q.device.type == "cpu":
        return chunk_attention_plain(q, k_cache, v_cache, pos0, layer)
    global launches_chunk
    out = _launch(q, (k_cache, v_cache), pos0, layer, "chunk_attention")
    launches_chunk += 1
    return out


def chunk_attention_q8(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                       ks: torch.Tensor, vs: torch.Tensor, pos0: torch.Tensor,
                       layer: int, k_new: torch.Tensor | None = None,
                       v_new: torch.Tensor | None = None) -> torch.Tensor:
    """K10 over an int8 cache: k8/v8 (L, B, nkv, S, hd) int8 with f32 row
    scales ks/vs (L, B, nkv, S); otherwise as chunk_attention. With k_new /
    v_new (B, T, nkv, hd), the chunk's post-RoPE rows, they are first
    quantized and written at [layer, b, :, pos0[b] + t] (rows at or past S
    dropped), as write_kv_chunk_q8 would: on the card by the walk launch
    itself where it takes the walk (`walk_writes_rows`; counted in
    launches_write_q8), else by K11's own launch first."""
    rows = new_rows(k_new, v_new)
    if q.device.type == "cpu":
        return chunk_attention_q8_plain(q, k8, v8, ks, vs, pos0, layer, k_new, v_new)
    if rows is not None and not walk_writes_rows(q):
        _kvw.write_kv_chunk_q8(k8, v8, ks, vs, *rows, pos0, layer)
        rows = None
    global launches_chunk_q8, launches_write_q8
    out = _launch(q, (k8, v8, ks, vs), pos0, layer, "chunk_attention_q8", rows=rows)
    launches_chunk_q8 += 1
    launches_write_q8 += rows is not None
    return out


def occupancy(t: int, nh: int, nkv: int, hd: int, q8: bool,
              dtype: torch.dtype = torch.bfloat16, chunk: int | None = None) -> dict:
    """The split kernel a launch of T queries would run (int8 cache if q8,
    tiles of `chunk` cache rows, CHUNK by default, on the body `body_for`
    picks, in the form `row_form` picks): its body, resident CTAs per SM,
    registers per thread and shared bytes per CTA (the walk's at one slot),
    as the CUDA occupancy API reports them on the current card."""
    check_group(nh, nkv)
    body = body_for(dtype, hd, q8)
    out = (ctypes.c_int * 3)()
    lib = build.library("decode_attention", _SIGNATURES)
    build.check(lib, lib.rama_decode_attention_occupancy(
        t, nh, nkv, hd, chunk or CHUNK, int(q8), build.DTYPE_CODES[dtype], BODIES[body], out),
        "occupancy")
    return {"body": body, "ctas_per_sm": out[0], "registers": out[1], "smem_bytes": out[2]}
