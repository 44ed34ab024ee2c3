"""Tensor + data parallelism over the (data, model) grid of ranks — the port of
rama_tpu/parallel/tp.py.

The Megatron layout of the Llama block, for dense and group-quantized
weights alike (int8 / int4 values and their scales shard together):

    wq/wk/wv/w1/w3 : column-sharded  (L, K, N/tp)   -> no collective
    wo/w2          : row-sharded     (L, K/tp, N)   -> all-reduce after each
    wcls           : vocab-sharded   (D, V/tp)      -> all-gather of the logits
    KV cache       : (L, B/dp, n_kv/tp, S, hd)     -> heads follow wk/wv
                     (each rank makes its own: runtime.engine _create_cache)
    norms, rope, embedding : replicated

Activations are replicated over the model group (x is full-width on every
rank); the slots split over the data groups. JAX hands shard_map's local
shards to its kernels; here each rank holds only its own shard
(`shard_params`) and runs the kernels on its shapes, with the forward's two
all-reduces a layer and its logits all-gather over the model group
(models/llama.py `tp_group`).

Shard, then fuse: each rank fuses its own local shard (models.llama
`fuse_params` under `shard_config`), which is JAX's per-shard column order
of `fuse_params(params, cfg, tp)` (rama_tpu/models/llama.py:278-344) with
no tp term in the port's `_concat_weights`.

Constraints (validate_tp): tp divides n_heads, n_kv_heads, hidden_dim,
vocab_size and dim; dp divides the engine's slots.
"""

from __future__ import annotations

import math

import torch

from rama_tpu_torch.config import ModelConfig
from rama_tpu_torch.ops.quant import QuantizedEmbedding, QuantizedTensor, split_groups
from rama_tpu_torch.parallel.mesh import Mesh

# column-sharded: output dim over the model axis
_COL = ("wq", "wk", "wv", "w1", "w3")
# row-sharded: input dim over the model axis (an all-reduce restores the sum)
_ROW = ("wo", "w2")


def validate_tp(cfg: ModelConfig, tp: int) -> None:
    """A tp that does not divide these dims would drop columns or fail deep
    inside a kernel with a shape error (rama_tpu's validate_tp)."""
    for label, n in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                     ("hidden_dim", cfg.hidden_dim), ("vocab_size", cfg.vocab_size),
                     ("dim", cfg.dim)):
        if n % tp != 0:
            raise ValueError(f"tp_size {tp} does not divide {label}={n}")


def shard_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The config a rank's forward and caches run under: its heads, kv
    heads and hidden dim (n / tp each), and dim / tp with them so head_dim
    stays the model's. The residual width and the vocabulary are read off
    the weights and the gathered logits, never off this dim."""
    if tp == 1:
        return cfg
    return cfg.replace(dim=cfg.dim // tp, n_heads=cfg.n_heads // tp,
                       n_kv_heads=cfg.n_kv_heads // tp, hidden_dim=cfg.hidden_dim // tp)


def _cols(x: torch.Tensor, t: int, tp: int) -> torch.Tensor:
    n = x.shape[-1] // tp
    return x[..., t * n:(t + 1) * n]


def _rows(x: torch.Tensor, t: int, tp: int) -> torch.Tensor:
    k = x.shape[-2] // tp
    return x[..., t * k:(t + 1) * k, :]


def _put(x: torch.Tensor, device) -> torch.Tensor:
    """The slice, alone, on the rank's device (a host checkpoint never lands
    whole on a card)."""
    return x.contiguous().to(device)


def _row_aligned(name: str, p: QuantizedTensor, tp: int) -> QuantizedTensor:
    """A row-sharded quantized weight whose tp shards split whole scale
    groups: int8 exactly regrouped to a finer group size where they would
    not, misaligned int4 refused (rama_tpu/parallel/tp.py:137-149)."""
    if p.k_dim % tp:
        raise ValueError(f"{name}: K={p.k_dim} not divisible by tp={tp}")
    k_local = p.k_dim // tp
    if k_local % p.group_size:
        if p.bits == 4:
            raise ValueError(f"{name}: int4 packing blocks (2*{p.group_size}) do not "
                             f"align with tp={tp} shards of K={p.k_dim}")
        return split_groups(p, math.gcd(p.group_size, k_local))
    if p.bits == 4 and k_local % (2 * p.group_size):
        raise ValueError(f"{name}: int4 shard K={k_local} not a multiple of the "
                         f"2*gs={2 * p.group_size} packing block")
    return p


def _shard_leaf(name: str, p, mesh: Mesh):
    tp, t, dev = mesh.tp, mesh.model_index, mesh.device
    if isinstance(p, QuantizedTensor):
        if name in _COL or name == "wcls":
            return QuantizedTensor(q=_put(_cols(p.q, t, tp), dev),
                                   scales=_put(_cols(p.scales, t, tp), dev),
                                   group_size=p.group_size, bits=p.bits, il=p.il)
        if name in _ROW:
            p = _row_aligned(name, p, tp)
            return QuantizedTensor(q=_put(_rows(p.q, t, tp), dev),
                                   scales=_put(_rows(p.scales, t, tp), dev),
                                   group_size=p.group_size, bits=p.bits, il=p.il)
        return p.to(dev)
    if isinstance(p, QuantizedEmbedding):
        return p.to(dev)
    if name in _COL or name == "wcls":
        return _put(_cols(p, t, tp), dev)
    if name in _ROW:
        return _put(_rows(p, t, tp), dev)
    return p.to(dev)


def shard_params(params: dict, cfg: ModelConfig, mesh: Mesh) -> dict:
    """This rank's leaves of the full (unfused) params, by JAX's specs
    (rama_tpu/parallel/tp.py:38-55), each copied alone to the rank's device:
    column shards of wq / wk / wv / w1 / w3, row shards of wo / w2 (int8
    regrouped where a shard would cut a scale group, misaligned int4
    refused), the vocab shard of wcls, everything else replicated. A tied
    classifier is sliced from the embedding (its shard of the vocabulary's
    rows, in the kernel layout). Fused params are refused under tp > 1:
    each rank fuses its own shard."""
    tp = mesh.tp
    if tp > 1 and ("wqkv" in params or "w13" in params):
        raise ValueError("pass unfused params to a tensor-parallel Engine; each rank "
                         "fuses its own shard")
    out = {}
    for name, p in params.items():
        if name == "wcls" and tp > 1 and cfg.shared_classifier:
            out[name] = _tied_classifier(params["tok_embedding"], mesh)
        else:
            out[name] = _shard_leaf(name, p, mesh)
    return out


def _tied_classifier(emb, mesh: Mesh):
    """The tied classifier's vocab shard from the embedding's rows: the
    quantized embedding's bytes in the kernel's (D, V/tp) layout, or the
    dense table's rows transposed."""
    tp, t, dev = mesh.tp, mesh.model_index, mesh.device
    v = (emb.q if isinstance(emb, QuantizedEmbedding) else emb).shape[0] // tp
    rows = slice(t * v, (t + 1) * v)
    if isinstance(emb, QuantizedEmbedding):
        return QuantizedEmbedding(q=_put(emb.q[rows], dev), scales=_put(emb.scales[rows], dev),
                                  group_size=emb.group_size).as_classifier()
    return _put(emb[rows].t(), dev)


def replicate_params(params: dict, device) -> dict:
    """Every leaf whole on the rank's device: the draft model, which runs
    replicated on every rank (small next to the target; sharding it would
    trade an all-reduce a draft step for little)."""
    return {name: p.to(device) for name, p in params.items()}

