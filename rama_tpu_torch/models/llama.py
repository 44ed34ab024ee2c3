"""Llama-2 forward pass in PyTorch — the port of rama_tpu/models/llama.py.

Loaders and caches default to device="cuda" (raising without a GPU);
pass device="cpu" to run on the CPU. Parameters are a plain dict of tensors: dense weights in the canonical
(in, out) layout (forward is x @ W), or `QuantizedTensor` /
`QuantizedEmbedding` leaves (ops/quant.py); per-layer weights are stacked
(L, K, N). Math parity with the JAX package and the reference CPU path:
interleaved-pair RoPE with fp32 tables (cpu.rs:87-96), fp32 rmsnorm with
eps 1e-5 (cpu.rs:110-118), SiLU-gated FFN, 1/sqrt(head_dim) attention.

Where the JAX package's `_layer` / `_forward_decode_fused` call a Pallas
kernel on the TPU, this module calls the port's kernel wrappers
(ops/kernels/*): on CUDA tensors they launch the hand-written Hopper
kernels, on CPU tensors they run each kernel's plain PyTorch version.
`plain=True` runs those plain versions on any device — the reference the
kernels are held against on the card (chip_smoke.py).

RAMA_ATTN_BLOCK (read at import into `ATTN_BLOCK`, as rama_tpu reads its
`_ATTN_BLOCK`) selects the decode step's attention block on a dense cache:
0 (the default) the unfused RoPE, row write and decode-attention kernel, 1
the fused RoPE + row write + attention kernel with wo separate, 2 the fused
kernel with wo too (kernel 14, ops/kernels/attn_block.py).

The KV cache is updated IN PLACE (`index_put_` on the stacked cache, or
the int8 cache's row writer), where the JAX package donates the cache
buffer and returns a new one. Two caches: `KVCache` (dense, in the
activation dtype) and `QuantKVCache` (int8 rows with one f32 absmax scale
per (token, kv head) row).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from rama_tpu_torch.checkpoint import QuantParams, compute_freqs
from rama_tpu_torch.config import ModelConfig
from rama_tpu_torch.ops.kernels import attn_block as _ab
from rama_tpu_torch.ops.kernels import decode_attention as _da
from rama_tpu_torch.ops.kernels import ffn as _ffn
from rama_tpu_torch.ops.kernels import kv_write as _kvw
from rama_tpu_torch.ops.kernels import paged_attention as _pga
from rama_tpu_torch.ops.kernels import prefill_attention as _pa
from rama_tpu_torch.ops.kernels import quant_matmul as _qm
from rama_tpu_torch.ops.kernels.ffn import split_h13
from rama_tpu_torch.ops.kernels.kv_write import (chunk_positions, kv_quant_rows,
                                                  scatter_rows_)
from rama_tpu_torch.ops.quant import (QuantizedEmbedding, QuantizedTensor,
                                      from_q80_file_layout, quantize_embedding,
                                      quantize_int4, quantize_int8)
from rama_tpu_torch.utils.platform import resolve_device

Params = dict[str, Any]

__all__ = ["KVCache", "QuantKVCache", "kv_quant_rows", "load_params",
           "load_params_quantized", "quantize_params", "fuse_params", "rmsnorm",
           "apply_rope", "forward", "forward_chunk", "prefill", "decode_step", "split_h13"]


class _Ops:
    """The kernel entry points the forward and the engine call: the
    device-dispatching wrappers, or (plain=True) their plain PyTorch
    versions."""

    def __init__(self, plain: bool):
        self.quant_matmul = _qm.quant_matmul_plain if plain else _qm.quant_matmul
        self.ffn = _ffn.ffn_plain if plain else _ffn.ffn
        self.decode_attention = (_da.decode_attention_plain if plain
                                 else _da.decode_attention)
        self.prefill_attention = (_pa.prefill_attention_plain if plain
                                  else _pa.prefill_attention)
        self.decode_attention_q8 = (_da.decode_attention_q8_plain if plain
                                    else _da.decode_attention_q8)
        # kernel 9: T = 1 attention over one layer's cache (the generic _layer)
        for name in ("decode_attention_flat", "decode_attention_flat_q8"):
            setattr(self, name, getattr(_da, name + "_plain" if plain else name))
        # kernel 14: the fused attention block (ATTN_BLOCK 1 / 2)
        for name in ("attn_rope_write_layered", "attn_block_layered"):
            setattr(self, name, getattr(_ab, name + "_plain" if plain else name))
        self.write_kv_strips_q8 = (_kvw.write_kv_strips_q8_plain if plain
                                   else _kvw.write_kv_strips_q8)
        self.chunk_attention = (_da.chunk_attention_plain if plain
                                else _da.chunk_attention)
        self.chunk_attention_q8 = (_da.chunk_attention_q8_plain if plain
                                   else _da.chunk_attention_q8)
        self.write_kv_chunk_q8 = (_kvw.write_kv_chunk_q8_plain if plain
                                  else _kvw.write_kv_chunk_q8)
        # the paged cache (runtime/paged.py): K12 and K13
        for name in ("paged_decode_attention", "paged_decode_attention_q8",
                     "paged_chunk_attention", "paged_chunk_attention_q8"):
            setattr(self, name, getattr(_pga, name + "_plain" if plain else name))
        for name in ("write_kv_paged_q8", "write_kv_prefill_paged_q8"):
            setattr(self, name, getattr(_kvw, name + "_plain" if plain else name))


_KERNELS, _PLAIN = _Ops(False), _Ops(True)


@dataclass
class KVCache:
    """Dense KV cache: k/v are (L, B, n_kv_heads, S, head_dim), head-major so
    each (slot, head) stripe (S, hd) is contiguous — the unit the decode
    attention kernel streams."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def create(cfg: ModelConfig, batch: int, max_len: int | None = None,
               dtype=torch.bfloat16, device="cuda") -> "KVCache":
        s = max_len or cfg.seq_len
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, s, cfg.head_dim)
        device = resolve_device(device)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


@dataclass
class QuantKVCache:
    """INT8 KV cache (rama_tpu's QuantKVCache): k/v int8 (L, B, nkv, S, hd)
    and ks/vs f32 per-row scales (L, B, nkv, S), one absmax scale per
    (token, kv head) row (`kv_quant_rows`). Half the bytes of a bf16 cache;
    attention applies the scales after its products."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor

    @staticmethod
    def create(cfg: ModelConfig, batch: int, max_len: int | None = None,
               device="cuda") -> "QuantKVCache":
        s = max_len or cfg.seq_len
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, s, cfg.head_dim)
        device = resolve_device(device)
        return QuantKVCache(k=torch.zeros(shape, dtype=torch.int8, device=device),
                            v=torch.zeros(shape, dtype=torch.int8, device=device),
                            ks=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                            vs=torch.zeros(shape[:-1], dtype=torch.float32, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def _dequant_kv(k8, v8, ks, vs, dtype: torch.dtype):
    """Dense dequantization of int8 cache rows to `dtype` (the plain-PyTorch
    chunk path; rama_tpu's _dequant_kv)."""
    k = (k8.float() * ks[..., None]).to(dtype)
    v = (v8.float() * vs[..., None]).to(dtype)
    return k, v


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _rope_tables(cfg: ModelConfig, device, seq_len: int | None = None):
    # RoPE tables stay fp32: rotation error compounds over positions
    cos, sin = compute_freqs(cfg, seq_len=seq_len)
    return (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))


def _dense(a, dtype, device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.array(a, order="C", copy=True))
    return a.to(device=device, dtype=dtype)


def load_params(cfg: ModelConfig, np_params: dict, dtype=torch.bfloat16,
                device="cuda") -> Params:
    """numpy canonical params -> device tensors + precomputed RoPE tables."""
    device = resolve_device(device)
    p = {k: _dense(v, dtype, device) for k, v in np_params.items()}
    p["rope_cos"], p["rope_sin"] = _rope_tables(cfg, device)
    return p


_QUANT_LAYER_NAMES = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def load_params_quantized(cfg: ModelConfig, qp: QuantParams, dtype=torch.bfloat16,
                          device="cuda") -> Params:
    """v2 (Q8_0) checkpoint -> quantized params keeping the file's int8 bytes
    (no requantization anywhere, including the shared classifier)."""
    device = resolve_device(device)
    p: Params = {name: _dense(qp.norms[name], dtype, device)
                 for name in ("attn_norm", "ffn_norm", "final_norm")}
    eq, es = qp.quant["tok_embedding"]  # (V, D) int8, (V, D//gs) f32
    emb = QuantizedEmbedding(q=torch.from_numpy(np.ascontiguousarray(eq)),
                             scales=torch.from_numpy(np.ascontiguousarray(es)),
                             group_size=qp.group_size).to(device)
    p["tok_embedding"] = emb
    for name in _QUANT_LAYER_NAMES:
        q, s = qp.quant[name]  # (L, out, in) + (L, out, in//gs)
        p[name] = from_q80_file_layout(q, s, qp.group_size).to(device)
    if cfg.shared_classifier:
        p["wcls"] = emb.as_classifier()
    else:
        q, s = qp.quant["wcls"]
        p["wcls"] = from_q80_file_layout(q, s, qp.group_size).to(device)
    p["rope_cos"], p["rope_sin"] = _rope_tables(cfg, device)
    return p


def quantize_params(cfg: ModelConfig, np_params: dict, bits: int = 8,
                    group_size: int = 64, dtype=torch.bfloat16,
                    device="cuda") -> Params:
    """Quantize canonical fp32 params at load time (weight-only INT8, or INT4
    in the block-local split packing). The embedding and the classifier,
    shared or not, stay INT8, as in the JAX package: the lookup reads one
    row per token, so int4 there would cost accuracy for no bandwidth."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    quant = quantize_int8 if bits == 8 else quantize_int4
    device = resolve_device(device)
    p: Params = {name: _dense(np_params[name], dtype, device)
                 for name in ("attn_norm", "ffn_norm", "final_norm")}
    for name in _QUANT_LAYER_NAMES:
        p[name] = quant(np.asarray(np_params[name]), group_size).to(device)
    emb = quantize_embedding(np.asarray(np_params["tok_embedding"]), group_size)
    p["tok_embedding"] = emb.to(device)
    p["wcls"] = (p["tok_embedding"].as_classifier() if cfg.shared_classifier
                 else quantize_int8(np.asarray(np_params["wcls"]), group_size).to(device))
    p["rope_cos"], p["rope_sin"] = _rope_tables(cfg, device)
    return p


def _pick_tile(dim: int, target: int, multiple: int) -> int | None:
    best = None
    b = multiple
    while b <= min(dim, target):
        if dim % b == 0:
            best = b
        b += multiple
    return best


def phase_a_tile(h: int, bits: int, gs2: int) -> int | None:
    """The w13 interleave tile the JAX package picks
    (rama_tpu/ops/pallas/ffn.py:59-63): a multiple of w2's scale group (of
    its packing block, 2*gs2, for int4) and of 128, so both packages lay
    fused w13 out identically."""
    mult = 2 * gs2 if bits == 4 else gs2
    return _pick_tile(h, 256, int(np.lcm(mult, 128)))


def _concat_weights(ws):
    if isinstance(ws[0], QuantizedTensor):
        return QuantizedTensor(q=torch.cat([w.q for w in ws], dim=-1).contiguous(),
                               scales=torch.cat([w.scales for w in ws], dim=-1).contiguous(),
                               group_size=ws[0].group_size, bits=ws[0].bits)
    return torch.cat(ws, dim=-1).contiguous()


def _interleave_w13(qt: QuantizedTensor, h: int, bh: int) -> QuantizedTensor:
    """[W1 | W3] columns -> alternating bh-wide tiles [W1_0 W3_0 W1_1 W3_1
    ...] (rama_tpu/models/llama.py:314-329). A pure column permutation;
    split_h13 inverts it on matmul outputs."""
    def rearr(a):
        *lead, k, n = a.shape
        t = a.reshape(*lead, k, 2, h // bh, bh).transpose(-3, -2)
        return t.reshape(*lead, k, n).contiguous()

    return QuantizedTensor(q=rearr(qt.q), scales=rearr(qt.scales),
                           group_size=qt.group_size, bits=qt.bits, il=bh)


def fuse_params(params: Params, cfg: ModelConfig) -> Params:
    """Fuse wq/wk/wv into wqkv and w1/w3 into w13 (4 weight streams per
    layer instead of 7). Quantized w13 gets the JAX package's interleaved
    column layout when w13 and w2 have the same bits and the phase-A tile
    exists for these shapes."""
    if "wqkv" in params:
        return params
    p = dict(params)
    p["wqkv"] = _concat_weights([p.pop("wq"), p.pop("wk"), p.pop("wv")])
    p["w13"] = _concat_weights([p.pop("w1"), p.pop("w3")])
    w13, w2 = p["w13"], p.get("w2")
    if (isinstance(w13, QuantizedTensor) and isinstance(w2, QuantizedTensor)
            and w13.bits == w2.bits):
        bh = phase_a_tile(cfg.hidden_dim, w13.bits, w2.group_size)
        if bh:
            p["w13"] = _interleave_w13(w13, cfg.hidden_dim, bh)
    return p


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32-accumulated RMS norm (cpu.rs:110-118 semantics)."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (w.float() * (xf * inv)).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved (even, odd) lanes of the last dim.

    x: (..., T, n_heads, head_dim); cos/sin: (..., T, head_dim//2). llama2.c
    convention — pairs are adjacent lanes (2i, 2i+1), not HF's split halves."""
    xf = x.float()
    xp = xf.reshape(*xf.shape[:-1], xf.shape[-1] // 2, 2)
    xr, xi = xp[..., 0], xp[..., 1]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    out = torch.stack([xr * c - xi * s, xr * s + xi * c], dim=-1)
    return out.reshape(xf.shape).to(x.dtype)


def _embed(tok_embedding, tokens: torch.Tensor, dtype) -> torch.Tensor:
    if isinstance(tok_embedding, QuantizedEmbedding):
        return tok_embedding.lookup(tokens, dtype=dtype)
    return tok_embedding[tokens]


def _linear(x: torch.Tensor, w, ops: _Ops, layer: int | None = None) -> torch.Tensor:
    """x (..., K) @ w[layer]: quantized weights through the quant_matmul
    kernel (layer as a pointer offset), dense weights through torch."""
    if isinstance(w, QuantizedTensor):
        *lead, k = x.shape
        out = ops.quant_matmul(x.reshape(-1, k).contiguous(), w, layer)
        return out.reshape(*lead, w.shape[-1])
    return x @ (w if layer is None else w[layer])


def _qkv(xb: torch.Tensor, params: Params, cfg: ModelConfig, l: int, ops: _Ops):
    b, t, _ = xb.shape
    hd = cfg.head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    if "wqkv" in params:
        qkv = _linear(xb, params["wqkv"], ops, l)
        q = qkv[..., : nh * hd].reshape(b, t, nh, hd)
        k = qkv[..., nh * hd : (nh + nkv) * hd].reshape(b, t, nkv, hd)
        v = qkv[..., (nh + nkv) * hd :].reshape(b, t, nkv, hd)
    else:
        q = _linear(xb, params["wq"], ops, l).reshape(b, t, nh, hd)
        k = _linear(xb, params["wk"], ops, l).reshape(b, t, nkv, hd)
        v = _linear(xb, params["wv"], ops, l).reshape(b, t, nkv, hd)
    return q, k, v


def _write_kv(cache: KVCache | QuantKVCache, l: int, k: torch.Tensor, v: torch.Tensor,
              pos_index: torch.Tensor) -> None:
    """cache[l, b, :, pos_index[b, t]] = k[b, t] (in place; the JAX package's
    .at[].set with a donated buffer), quantized row by row for an int8
    cache. Duplicate positions (padded prefill rows) write rows that are
    never attended. Rows of a multi-row write past the cache end are
    dropped, as JAX's scatter drops them; a decode step's position past the
    end (a finished slot's overshoot inside a tick) writes the last row
    instead — a single cheap index write on the decode path — where JAX
    drops it; that slot's output is discarded either way."""
    if k.shape[1] == 1:
        pos_index = pos_index.clamp(0, cache.max_len - 1)
    arrays = [(cache.k[l], k), (cache.v[l], v)]
    if isinstance(cache, QuantKVCache):
        (k, ksc), (v, vsc) = kv_quant_rows(k), kv_quant_rows(v)
        arrays = [(cache.k[l], k), (cache.v[l], v), (cache.ks[l], ksc), (cache.vs[l], vsc)]
    for dst, rows in arrays:
        if k.shape[1] == 1:
            b, _, nkv = rows.shape[:3]
            bi = torch.arange(b, device=rows.device)[:, None, None]
            hi = torch.arange(nkv, device=rows.device)[None, None, :]
            dst.index_put_((bi, hi, pos_index.long()[:, :, None]), rows.to(dst.dtype))
        else:
            scatter_rows_(dst, rows, pos_index)


def _attention(q, k_cache, v_cache, pos_mask):
    """Masked GQA attention over the whole cache (rama_tpu's `_attention`):
    the path for chunk forwards that are neither T=1 decode nor a prefill
    from position 0. q (B, T, nh, hd); caches (B, nkv, S, hd)."""
    b, t, nh, hd = q.shape
    nkv = k_cache.shape[1]
    qg = q.reshape(b, t, nkv, nh // nkv, hd).float()
    scores = torch.einsum("btkrh,bksh->btkrs", qg, k_cache.float()) / math.sqrt(hd)
    # a fill, not a host scalar copied up: no stream sync on the card
    scores = scores.masked_fill(~pos_mask[:, :, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("btkrs,bksh->btkrh", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, t, nh * hd).to(q.dtype)


def _ffn_block(xb: torch.Tensor, params: Params, l: int, ops: _Ops,
               fused_kernel: bool) -> torch.Tensor:
    b, t, d = xb.shape
    if fused_kernel:
        return ops.ffn(xb.reshape(b * t, d).contiguous(), params["w13"],
                       params["w2"], l).reshape(b, t, -1)
    if "w13" in params:
        h1, h3 = split_h13(_linear(xb, params["w13"], ops, l), params["w13"])
    else:
        h1 = _linear(xb, params["w1"], ops, l)
        h3 = _linear(xb, params["w3"], ops, l)
    return _linear(F.silu(h1) * h3, params["w2"], ops, l)


def _layer(x, params, cache: KVCache | QuantKVCache, l: int, cos, sin, pos_index, pos_mask,
           cfg: ModelConfig, plen, ops: _Ops):
    """One transformer block over a (B, T) chunk (rama_tpu's `_layer`)."""
    b, t, _ = x.shape
    xb = rmsnorm(x, params["attn_norm"][l], cfg.norm_eps)
    q, k, v = _qkv(xb, params, cfg, l, ops)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    _write_kv(cache, l, k, v, pos_index)
    quant = isinstance(cache, QuantKVCache)
    # rama_tpu's branch order: T = 1 on an int8 cache, the int8 cache, T = 1,
    # a prefill chunk, then the masked einsum
    if t == 1:
        # one query a slot (forward with logit_rows, a one-token prefill):
        # kernel 9 over layer l's cache, visible rows s <= pos
        pos = pos_index[:, 0].to(torch.int32).contiguous()
        q1 = q[:, 0].contiguous()
        if quant:
            att = ops.decode_attention_flat_q8(q1, cache.k[l], cache.v[l], cache.ks[l],
                                               cache.vs[l], pos)[:, None]
        else:
            att = ops.decode_attention_flat(q1, cache.k[l], cache.v[l], pos)[:, None]
    elif quant:
        # int8 cache, T > 1: dequantized attention in plain PyTorch, ahead of
        # the prefill kernel, as rama_tpu's kv_quant branch comes first
        kd, vd = _dequant_kv(cache.k[l], cache.v[l], cache.ks[l], cache.vs[l], q.dtype)
        att = _attention(q, kd, vd, pos_mask)
    elif plen is not None:
        # flash-style prefill: tiles above the causal diagonal and past the
        # prompt are never read (JAX: prefill_attention on the TPU)
        att = ops.prefill_attention(q.contiguous(), cache.k[l], cache.v[l],
                                    plen).reshape(b, t, -1)
    else:
        att = _attention(q, cache.k[l], cache.v[l], pos_mask)
    x = x + _linear(att, params["wo"], ops, l)
    xb = rmsnorm(x, params["ffn_norm"][l], cfg.norm_eps)
    return x + _ffn_block(xb, params, l, ops, fused_kernel=False)


def _ffn_fusable(params: Params, m: int) -> bool:
    """Whether a decode step or verify round of m rows takes the fused FFN
    kernel: quantized w13 / w2 of the same bits, at any m (the kernel runs
    every m, in row blocks of 64 above 64). Other params take the split w13
    / w2 matmuls. This is the port's own rule, not rama_tpu's: there
    `ffn_tileable` fuses only where x and the weight tiles fit its 12 MB
    VMEM budget (Llama-2-7B int8 up to M 70, int4 58; TinyLlama-1.1B 474 /
    460; Yi-34B never), so the two packages route some shapes differently
    (ROADMAP §3). Prefill never fuses, in either package."""
    w13, w2 = params.get("w13"), params.get("w2")
    return (isinstance(w13, QuantizedTensor) and isinstance(w2, QuantizedTensor)
            and w13.bits == w2.bits and m >= 1)


ATTN_BLOCK = int(os.environ.get("RAMA_ATTN_BLOCK", "0"))


def attn_block_mode(params: Params, cfg: ModelConfig, cache, b: int) -> int:
    """The decode step's attention block (rama_tpu's conditions,
    models/llama.py:588-599): ATTN_BLOCK (2 the full fused block, any other
    non-zero value the light one) on a dense KVCache with head_dim 128, a
    quantized wo and `attn_block_supported`; 0 (unfused) otherwise. Like
    rama_tpu's, the conditions have no GQA-group term: kernel 14 takes any
    whole group (its row form, `attn_block.form_for`), so every mode chosen
    here launches on the card."""
    if (not ATTN_BLOCK or type(cache) is not KVCache or cfg.head_dim != _ab.HEAD_DIM
            or not _ab.attn_block_supported(params.get("wo"), cache.max_len, b)):
        return 0
    return ATTN_BLOCK


def _forward_decode_fused(params: Params, cfg: ModelConfig, tokens, pos_index,
                          cache: KVCache | QuantKVCache, ops: _Ops):
    """T=1 decode step (rama_tpu's `_forward_decode_fused`): layer-indexed
    quant_matmul for wqkv/wo, the cache row write in place, layer-indexed
    decode attention, the fused quantized FFN. An int8 cache hands the
    step's rows to the int8 decode attention, which quantizes and writes
    them (inside its walk launch, or by K6's own launch first).
    Under `attn_block_mode` 1 / 2 the un-roped q / k / v go to kernel 14,
    which ropes, writes the row and attends in one launch (and applies wo
    in mode 2)."""
    b = tokens.shape[0]
    dtype = params["final_norm"].dtype
    x = _embed(params["tok_embedding"], tokens, dtype)            # (B, 1, D)
    idx = pos_index.long().clamp(0, params["rope_cos"].shape[0] - 1)
    cos, sin = params["rope_cos"][idx], params["rope_sin"][idx]
    pos = pos_index[:, 0].to(torch.int32).contiguous()
    fused_ffn = _ffn_fusable(params, b)
    mode = attn_block_mode(params, cfg, cache, b)
    for l in range(cfg.n_layers):
        xb = rmsnorm(x, params["attn_norm"][l], cfg.norm_eps)
        q, k, v = _qkv(xb, params, cfg, l, ops)
        if mode == 2:
            attn_out = ops.attn_block_layered(q[:, 0], k[:, 0], v[:, 0], cos[:, 0], sin[:, 0],
                                              cache.k, cache.v, params["wo"], pos, l)
        else:
            if mode:
                att = ops.attn_rope_write_layered(q[:, 0], k[:, 0], v[:, 0], cos[:, 0],
                                                  sin[:, 0], cache.k, cache.v, pos, l)
            elif isinstance(cache, QuantKVCache):
                q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
                att = ops.decode_attention_q8(q[:, 0].contiguous(), cache.k, cache.v,
                                              cache.ks, cache.vs, pos, l,
                                              k_new=k[:, 0].contiguous(),
                                              v_new=v[:, 0].contiguous())
            else:
                q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
                _write_kv(cache, l, k, v, pos_index)
                att = ops.decode_attention(q[:, 0].contiguous(), cache.k, cache.v, pos, l)
            attn_out = _linear(att, params["wo"], ops, l)
        x = x + attn_out[:, None]
        xb = rmsnorm(x, params["ffn_norm"][l], cfg.norm_eps)
        x = x + _ffn_block(xb, params, l, ops, fused_kernel=fused_ffn)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _linear(x, params["wcls"], ops).float(), cache


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            pos_index: torch.Tensor, cache: KVCache | QuantKVCache,
            plen: torch.Tensor | None = None, logit_rows: torch.Tensor | None = None,
            plain: bool = False):
    """Forward a (B, T) token chunk at per-slot positions pos_index (B, T).

    Causal over the cache: position s of slot b is visible to query t iff
    s <= pos_index[b, t]. Returns (logits (B, T, V) fp32, cache) with the
    cache updated in place.

    `plen` (B,) int32, prefill only: this chunk is a from-position-0 prompt
    of per-slot length plen[b] (rows >= plen[b] padding) — the causal
    prefill attention kernel applies. `logit_rows` (B,): compute the
    classifier only at column logit_rows[b] of each slot, returning
    (B, 1, V). T=1 without logit_rows takes the fused decode path.
    `plain=True` uses the kernels' plain PyTorch versions on any device.
    """
    ops = _PLAIN if plain else _KERNELS
    b, t = tokens.shape
    if logit_rows is None and t == 1:
        return _forward_decode_fused(params, cfg, tokens, pos_index, cache, ops)
    dtype = params["final_norm"].dtype
    x = _embed(params["tok_embedding"], tokens, dtype)
    idx = pos_index.long().clamp(0, params["rope_cos"].shape[0] - 1)
    cos, sin = params["rope_cos"][idx], params["rope_sin"][idx]     # (B, T, hd/2)
    s = cache.max_len
    pos_mask = (torch.arange(s, device=tokens.device)[None, None, :]
                <= pos_index.long()[:, :, None])                     # (B, T, S)
    if plen is not None:
        plen = plen.to(torch.int32).contiguous()
    for l in range(cfg.n_layers):
        x = _layer(x, params, cache, l, cos, sin, pos_index, pos_mask, cfg, plen, ops)
    if logit_rows is not None:
        rows = logit_rows.long()[:, None, None].expand(b, 1, x.shape[-1])
        x = torch.gather(x, 1, rows)                                 # (B, 1, D)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _linear(x, params["wcls"], ops).float(), cache


def _forward_chunk_fused(params: Params, cfg: ModelConfig, tokens, pos0,
                         cache: KVCache | QuantKVCache, ops: _Ops):
    """Chunk forward of T consecutive tokens per slot at pos0[b] + t — the
    speculative-verification path (rama_tpu's `_forward_chunk_fused`).

    The decode step's structure with T queries a slot: per layer rmsnorm,
    wqkv, RoPE at pos0 + t, the chunk's rows written into the cache in
    place (rows at or past the cache end dropped, as JAX's scatter drops
    them; on an int8 cache handed to the chunk attention, which quantizes
    and writes them first), the chunk attention kernel over the stacked
    cache, wo,
    then the FFN — fused for
    quantized w13 / w2 of the same bits at any B * T (`_ffn_fusable`),
    split w13 / w2 otherwise."""
    b, t = tokens.shape
    dtype = params["final_norm"].dtype
    x = _embed(params["tok_embedding"], tokens, dtype)            # (B, T, D)
    p0 = pos0.to(torch.int32).contiguous()
    pos_index = chunk_positions(p0, t)
    idx = pos_index.clamp(0, params["rope_cos"].shape[0] - 1)
    cos, sin = params["rope_cos"][idx], params["rope_sin"][idx]   # (B, T, hd/2)
    fused_ffn = _ffn_fusable(params, b * t)
    for l in range(cfg.n_layers):
        xb = rmsnorm(x, params["attn_norm"][l], cfg.norm_eps)
        q, k, v = _qkv(xb, params, cfg, l, ops)
        q = apply_rope(q, cos, sin).contiguous()
        k = apply_rope(k, cos, sin)
        if isinstance(cache, QuantKVCache):
            att = ops.chunk_attention_q8(q, cache.k, cache.v, cache.ks, cache.vs, p0, l,
                                         k_new=k.contiguous(), v_new=v.contiguous())
        else:
            scatter_rows_(cache.k[l], k, pos_index)
            scatter_rows_(cache.v[l], v, pos_index)
            att = ops.chunk_attention(q, cache.k, cache.v, p0, l)
        x = x + _linear(att, params["wo"], ops, l)
        xb = rmsnorm(x, params["ffn_norm"][l], cfg.norm_eps)
        x = x + _ffn_block(xb, params, l, ops, fused_kernel=fused_ffn)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _linear(x, params["wcls"], ops).float(), cache


def check_chunk(cfg: ModelConfig, t: int, device: torch.device) -> None:
    """Raise (naming the limit) unless forward_chunk serves chunks of T
    tokens a slot on `device`: on the card its fused path (2 <= T <= 8)
    runs the chunk attention kernel, which takes any T * n_heads /
    n_kv_heads query rows a kv head of whole GQA groups."""
    if torch.device(device).type == "cuda" and 2 <= t <= 8:
        _da.check_group(cfg.n_heads, cfg.n_kv_heads)


def forward_chunk(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  pos0: torch.Tensor, cache: KVCache | QuantKVCache, plain: bool = False):
    """Forward a (B, T) chunk of CONSECUTIVE tokens per slot: column t of
    slot b sits at position pos0[b] + t (pos0 (B,), within the cache). The
    speculative-verification entry point (runtime.engine spec ticks,
    runtime.speculative): 2 <= T <= 8 takes the fused chunk path (any GQA
    group: `check_chunk`), any other T the generic `forward`, as rama_tpu's
    forward_chunk does. Returns (logits (B, T, V) fp32, cache)."""
    t = tokens.shape[1]
    if 2 <= t <= 8:
        return _forward_chunk_fused(params, cfg, tokens, pos0, cache,
                                    _PLAIN if plain else _KERNELS)
    return forward(params, cfg, tokens, chunk_positions(pos0, t), cache, plain=plain)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: KVCache | QuantKVCache, last_only: bool = False, plain: bool = False):
    """Process a whole (B, T) prompt in one batched pass from position 0.
    last_only=True returns (B, 1, V) logits for the final position only."""
    b, t = tokens.shape
    dev = tokens.device
    pos = torch.arange(t, device=dev)[None, :].expand(b, t)
    rows = torch.full((b,), t - 1, dtype=torch.int64, device=dev) if last_only else None
    return forward(params, cfg, tokens, pos, cache,
                   plen=torch.full((b,), t, dtype=torch.int32, device=dev),
                   logit_rows=rows, plain=plain)


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                pos: torch.Tensor, cache: KVCache | QuantKVCache, plain: bool = False):
    """One decode step for a batch of slots at ragged positions.
    token: (B,) int; pos: (B,) int. Returns (logits (B, V) fp32, cache)."""
    logits, cache = forward(params, cfg, token[:, None], pos[:, None], cache,
                            plain=plain)
    return logits[:, 0], cache
