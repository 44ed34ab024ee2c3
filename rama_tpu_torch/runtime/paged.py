"""Paged KV cache: a shared page pool and per-slot page tables — the port of
rama_tpu/runtime/paged.py.

A dense cache reserves max_batch_size x max_seq_len rows whatever the
requests need; here storage is a pool of fixed-size pages (L, P, nkv, ps,
hd) and each slot maps its positions to pages through a page table, so the
memory a server needs scales with its live tokens. Two pools, as the dense
caches: `PagedKVCache` in the activation dtype and `QuantPagedKVCache`
(int8 rows with one f32 absmax scale per (token, kv head) row). The pools
are updated in place, where the JAX package donates them and returns new
arrays.

Compute paths:
- **fused** (1 <= T <= 8 consecutive positions a slot: the decode step and
  the speculative verification chunk; `_forward_fused_paged`, the
  counterpart of both `_forward_decode_fused_paged` and
  `_forward_chunk_fused_paged`): the dense fused forward's structure, with
  the chunk's rows written through the page tables (an index write into
  the bf16 / f32 pool; into the int8 pool by K12's int8 entries, which
  quantize and write them first) and attention read in place from the pool by the paged attention
  kernel K12. No dense view is built; each slot streams only the pages it
  uses.
- **gather** (any other T, or a page size the kernel does not take; the
  CPU only): per layer the slots' pages are gathered into a dense view for
  attention and the new rows are written through the tables, as the JAX
  package's `forward_paged` does on the CPU. On the card `forward_paged`
  takes the fused path or raises.

Rows a slot writes past its page table clip into its last table page, as
the JAX package's fused paths do (the engine reserves pages ahead of every
tick, so only a finished slot's discarded overshoot gets there).

`PageAllocator` is the port's own page bookkeeping, with the methods of
`rama_tpu.native.PageAllocator`, in pure Python. Its release order is the
C++ allocator's (`native/rama_native.cpp`, `pages_release`), which the JAX
package loads wherever its native library is built: a released slot's
pages go back onto the free stack in table order, so the next reservation
takes the slot's last page first. (The JAX package's pure-Python fallback
pushes them back reversed; physical page ids never change a stream.)
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from rama_tpu_torch.config import ModelConfig
from rama_tpu_torch.models.llama import (_KERNELS, _attention, _dequant_kv, _embed,
                                         _ffn_block, _ffn_fusable, _linear, _qkv,
                                         apply_rope, rmsnorm)
from rama_tpu_torch.ops.kernels.kv_write import (chunk_positions, kv_quant_rows, paged_rows,
                                                  put_rows_, put_strips_, scatter_rows_)
from rama_tpu_torch.ops.kernels.paged_attention import gather_pages
from rama_tpu_torch.utils.platform import resolve_device


@dataclass
class PagedKVCache:
    """k/v pools: (L, num_pages, n_kv_heads, page_size, head_dim)."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def create(cfg: ModelConfig, num_pages: int, page_size: int = 128,
               dtype=torch.bfloat16, device="cuda") -> "PagedKVCache":
        shape = (cfg.n_layers, num_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
        device = resolve_device(device)
        return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                            v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]


@dataclass
class QuantPagedKVCache:
    """INT8 page pool: k/v (L, P, nkv, ps, hd) int8 with per-row absmax
    scales ks/vs (L, P, nkv, ps) f32 — the paged counterpart of
    QuantKVCache (half the page bytes of a bf16 pool)."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor

    @staticmethod
    def create(cfg: ModelConfig, num_pages: int, page_size: int = 128,
               device="cuda") -> "QuantPagedKVCache":
        shape = (cfg.n_layers, num_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
        device = resolve_device(device)
        return QuantPagedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            ks=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            vs=torch.zeros(shape[:-1], dtype=torch.float32, device=device))

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]


class PageAllocator:
    """Free-stack page allocator and per-slot page tables (the methods of
    rama_tpu.native.PageAllocator; release order of its C++ allocator)."""

    def __init__(self, num_pages: int, page_size: int, max_slots: int):
        self.page_size = page_size
        self._free = list(range(num_pages - 1, -1, -1))   # a stack: page 0 on top
        self._tables: list[list[int]] = [[] for _ in range(max_slots)]

    def available(self) -> int:
        return len(self._free)

    def reserve(self, slot: int, seq_len: int) -> int:
        """Grow slot to >= seq_len positions. Returns its page count, or -1
        (nothing changes) when the free pages do not suffice."""
        need = -(-seq_len // self.page_size)
        table = self._tables[slot]
        if need <= len(table):
            return len(table)
        if len(self._free) < need - len(table):
            return -1
        for _ in range(need - len(table)):
            table.append(self._free.pop())
        return need

    def release(self, slot: int) -> None:
        """Every page of the slot back onto the free stack, in table order."""
        self._free.extend(self._tables[slot])
        self._tables[slot].clear()

    def table(self, slot: int) -> list[int]:
        return list(self._tables[slot])


def _forward_fused_paged(params, cfg: ModelConfig, tokens: torch.Tensor, pos0: torch.Tensor,
                         cache: PagedKVCache | QuantPagedKVCache, tables: torch.Tensor):
    """Forward of T = 1 .. 8 consecutive tokens a slot, column t at pos0[b]
    + t, against the page pool, every read in place (rama_tpu's
    `_forward_decode_fused_paged` for T = 1 and `_forward_chunk_fused_paged`
    for 2 <= T <= 8; the port's `_forward_decode_fused` and
    `_forward_chunk_fused` over pages). Per layer: rmsnorm, wqkv, RoPE, the
    chunk's rows written through the tables before attention (into an int8
    pool by K12's int8 entry, given the rows), K12's decode
    (T = 1) or chunk form, wo, the FFN (fused at any B * T where
    `_ffn_fusable` holds). The tables must cover the chunk's positions (the
    engine reserves pages before each tick)."""
    ops = _KERNELS
    b, t = tokens.shape
    dtype = params["final_norm"].dtype
    x = _embed(params["tok_embedding"], tokens, dtype)              # (B, T, D)
    p0 = pos0.to(torch.int32).contiguous()
    pos_index = chunk_positions(p0, t)
    idx = pos_index.clamp(0, params["rope_cos"].shape[0] - 1)
    cos, sin = params["rope_cos"][idx], params["rope_sin"][idx]     # (B, T, hd/2)
    tables = tables.to(torch.int32).contiguous()
    quant = isinstance(cache, QuantPagedKVCache)
    if quant:
        pools = (cache.k, cache.v, cache.ks, cache.vs)
        attend = ops.paged_decode_attention_q8 if t == 1 else ops.paged_chunk_attention_q8
    else:
        pools = (cache.k, cache.v)
        attend = ops.paged_decode_attention if t == 1 else ops.paged_chunk_attention
        pages, offs = paged_rows(tables, pos_index, cache.k)
    fused_ffn = _ffn_fusable(params, b * t)
    for l in range(cfg.n_layers):
        xb = rmsnorm(x, params["attn_norm"][l], cfg.norm_eps)
        q, k, v = _qkv(xb, params, cfg, l, ops)
        q = apply_rope(q, cos, sin).contiguous()
        k = apply_rope(k, cos, sin)
        rows = {}
        if quant:
            k, v = k.contiguous(), v.contiguous()
            rows = dict(k_new=k[:, 0], v_new=v[:, 0]) if t == 1 else dict(k_new=k, v_new=v)
        else:
            put_rows_(cache.k[l], k, pages, offs)
            put_rows_(cache.v[l], v, pages, offs)
        att = attend(q[:, 0] if t == 1 else q, *pools, p0, tables, l, **rows).view(b, t, -1)
        x = x + _linear(att, params["wo"], ops, l)
        xb = rmsnorm(x, params["ffn_norm"][l], cfg.norm_eps)
        x = x + _ffn_block(xb, params, l, ops, fused_kernel=fused_ffn)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _linear(x, params["wcls"], ops).float(), cache


def _forward_gather_paged(params, cfg: ModelConfig, tokens: torch.Tensor,
                          pos_index: torch.Tensor, cache: PagedKVCache | QuantPagedKVCache,
                          tables: torch.Tensor):
    """The generic path of rama_tpu's `forward_paged` (any T, any positions;
    the CPU only): per layer each slot's pages are gathered into a dense
    view — an int8 pool dequantized to bf16, as the JAX package's
    `_dequant_kv` default does — the chunk's rows are written into the view
    (in the view's dtype) and attended in fp32 with the masked einsum
    attention, then written through the tables into the pool (quantized
    from the view's rows for an int8 pool)."""
    if tokens.device.type != "cpu":
        raise ValueError(
            f"forward_paged: the gather path runs on the CPU only; on {tokens.device} "
            f"chunks of 1 <= T <= 8 tokens and pages of a multiple of 8 rows take the "
            f"fused path (got T={tokens.shape[1]}, page size {cache.page_size})")
    ops = _KERNELS
    b, t = tokens.shape
    s_max = tables.shape[1] * cache.page_size
    x = _embed(params["tok_embedding"], tokens, params["final_norm"].dtype)
    idx = pos_index.long().clamp(0, params["rope_cos"].shape[0] - 1)
    cos, sin = params["rope_cos"][idx], params["rope_sin"][idx]
    pos_mask = (torch.arange(s_max, device=tokens.device)[None, None, :]
                <= pos_index.long()[:, :, None])                    # (B, T, S)
    pages, offs = paged_rows(tables, pos_index, cache.k)
    quant = isinstance(cache, QuantPagedKVCache)
    for l in range(cfg.n_layers):
        xb = rmsnorm(x, params["attn_norm"][l], cfg.norm_eps)
        q, k, v = _qkv(xb, params, cfg, l, ops)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if quant:
            kd, vd = _dequant_kv(*(gather_pages(p[l], tables)
                                   for p in (cache.k, cache.v, cache.ks, cache.vs)),
                                 torch.bfloat16)
        else:
            kd, vd = gather_pages(cache.k[l], tables), gather_pages(cache.v[l], tables)
        scatter_rows_(kd, k, pos_index)
        scatter_rows_(vd, v, pos_index)
        # a bf16 view is attended in fp32, as the JAX package's CPU path does
        att = _attention(q, kd.float(), vd.float(), pos_mask)
        k, v = k.to(kd.dtype), v.to(vd.dtype)
        if quant:
            for rows, q8, sc in ((k, cache.k, cache.ks), (v, cache.v, cache.vs)):
                rq, rs = kv_quant_rows(rows)
                put_rows_(q8[l], rq, pages, offs)
                put_rows_(sc[l], rs, pages, offs)
        else:
            put_rows_(cache.k[l], k, pages, offs)
            put_rows_(cache.v[l], v, pages, offs)
        x = x + _linear(att, params["wo"], ops, l)
        xb = rmsnorm(x, params["ffn_norm"][l], cfg.norm_eps)
        x = x + _ffn_block(xb, params, l, ops, fused_kernel=False)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _linear(x, params["wcls"], ops).float(), cache


def forward_paged(params, cfg: ModelConfig, tokens: torch.Tensor, pos_index: torch.Tensor,
                  cache: PagedKVCache | QuantPagedKVCache, page_tables: torch.Tensor):
    """Forward a (B, T) chunk against the page pool.

    page_tables (B, mp) int32 page ids (entries past a slot's last used page
    may hold any id). Position s of slot b is visible to column t iff s <=
    pos_index[b, t]. 1 <= T <= 8 takes the fused path, which needs each
    slot's columns at CONSECUTIVE positions (pos_index[b] = pos_index[b, 0]
    + arange(T), as at every engine call site) and pages of whole 8-row
    stripes (rama_tpu's paged_attn_supported; whole GQA groups ModelConfig
    guarantees, and the kernels' own limits their wrappers check); any
    other T or page size the gather path (the CPU only). Returns (logits
    (B, T, V) fp32, cache) with the pool updated in place."""
    t = tokens.shape[1]
    if 1 <= t <= 8 and cache.page_size % 8 == 0:
        return _forward_fused_paged(params, cfg, tokens, pos_index[:, 0], cache, page_tables)
    return _forward_gather_paged(params, cfg, tokens, pos_index, cache, page_tables)


def decode_step_paged(params, cfg: ModelConfig, token: torch.Tensor, pos: torch.Tensor,
                      cache: PagedKVCache | QuantPagedKVCache, page_tables: torch.Tensor):
    """One decode step against the pool: token (B,), pos (B,). Returns
    (logits (B, V) fp32, cache)."""
    logits, cache = forward_paged(params, cfg, token[:, None], pos[:, None], cache,
                                  page_tables)
    return logits[:, 0], cache


def insert_prefill_paged(cache: PagedKVCache | QuantPagedKVCache, k_strips: torch.Tensor,
                         v_strips: torch.Tensor, tables: torch.Tensor, t_ins: int):
    """Write rows 0:t_ins of the prefilled strips j < len(tables) of an
    admission group's scratch, k/v (L, K, nkv, T, hd), into the pages of
    table row j (tables (n, mp) int32, t_ins <= mp * ps): row i at page
    tables[j, i // ps], in-page row i % ps (rama_tpu's
    `insert_prefill_paged`, one slot a call there). The int8 pool takes
    K13's strip writer, every slot and layer in one launch; the bf16 / f32
    pool index writes."""
    tables = tables.to(torch.int32).contiguous()
    if isinstance(cache, QuantPagedKVCache):
        _KERNELS.write_kv_prefill_paged_q8(cache.k, cache.v, cache.ks, cache.vs,
                                      k_strips.contiguous(), v_strips.contiguous(), tables, t_ins)
    else:
        put_strips_(cache.k, k_strips, tables, t_ins)
        put_strips_(cache.v, v_strips, tables, t_ins)
    return cache
