"""Shared helpers of the rama_tpu_torch tests: the JAX-pytree -> numpy
adapter that feeds both packages the same parameters, and config/tokenizer
conversions. Test modules import both packages; the port itself never
imports JAX."""

from __future__ import annotations

import numpy as np
import torch

from rama_tpu.ops.quant import QuantizedEmbedding as JQE
from rama_tpu.ops.quant import QuantizedTensor as JQT
from rama_tpu_torch.config import ModelConfig

CONFIG_FIELDS = ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads",
                 "vocab_size", "seq_len", "shared_classifier", "norm_eps",
                 "rope_theta")


def torch_cfg(jcfg) -> ModelConfig:
    """rama_tpu ModelConfig -> rama_tpu_torch ModelConfig (same fields)."""
    return ModelConfig(**{f: getattr(jcfg, f) for f in CONFIG_FIELDS})


def _np(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype not in (np.float32, np.float64, np.int8, np.int32, np.int64):
        a = a.astype(np.float32)  # bf16 (ml_dtypes) -> fp32 for torch.from_numpy
    return np.ascontiguousarray(a)


def jax_tree_to_numpy(params: dict) -> dict:
    """JAX params pytree -> the numpy tree rama_tpu_torch.convert takes."""
    out = {}
    for name, leaf in params.items():
        if isinstance(leaf, JQT):
            out[name] = {"q": _np(leaf.q), "scales": _np(leaf.scales),
                         "group_size": leaf.group_size, "bits": leaf.bits,
                         "il": leaf.il}
        elif isinstance(leaf, JQE):
            out[name] = {"q": _np(leaf.q), "scales": _np(leaf.scales),
                         "group_size": leaf.group_size}
        else:
            out[name] = _np(leaf)
    return out


def jax_params_to_torch(jcfg, params: dict, dtype=torch.float32) -> dict:
    from rama_tpu_torch.convert import params_from_numpy

    return params_from_numpy(torch_cfg(jcfg), jax_tree_to_numpy(params), "cpu",
                             dtype=dtype)


def jax_uniform_stream(key_seed: int):
    """The uniforms rama_tpu's generate loops draw: key, sub = split(key)
    once per sampled position, u = uniform(sub, (1,)). Returns a callable
    that yields them in order (the port's `next_u`)."""
    import jax

    state = {"key": jax.random.PRNGKey(key_seed)}

    def next_u() -> float:
        state["key"], sub = jax.random.split(state["key"])
        return float(np.asarray(jax.random.uniform(sub, (1,)))[0])

    return next_u
