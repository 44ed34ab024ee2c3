"""The weight carrier between the two packages: parameters given as numpy
become the port's parameters, so both packages compute the same function.

`params_from_numpy(cfg, tree, device)` takes a dict name -> leaf where a
dense leaf is an `np.ndarray` and a quantized leaf is a dict
{"q", "scales", "group_size", "bits", "il"} (int8 (.., K, N) values, or
for bits 4 int8 (.., K//2, N) bytes of packed nibbles, and fp32
(.., K//gs, N) scales in the kernel layout). The quantized
`tok_embedding` is {"q", "scales", "group_size"} in the (V, D) row layout.
Adapting a JAX pytree to this form is left to the caller (the tests do it),
so this package never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from rama_tpu_torch.config import ModelConfig
from rama_tpu_torch.ops.kernels.quant_matmul import check_weight
from rama_tpu_torch.ops.quant import QuantizedEmbedding, QuantizedTensor
from rama_tpu_torch.utils.platform import resolve_device


def _tensor(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, order="C", copy=True))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda",
                      dtype: torch.dtype | None = None) -> dict:
    """numpy tree -> port params on `device` (cuda by default; raises without
    a GPU). Dense float leaves are cast to `dtype` when given; RoPE tables
    (rope_cos/rope_sin) stay fp32."""
    device = resolve_device(device)
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            q = _tensor(leaf["q"], device)
            s = _tensor(leaf["scales"], device, torch.float32)
            if q.dtype != torch.int8:
                raise TypeError(f"{name}: int8 q expected, got {q.dtype}")
            if name == "tok_embedding":
                out[name] = QuantizedEmbedding(q=q, scales=s,
                                               group_size=int(leaf["group_size"]))
            else:
                out[name] = qt = QuantizedTensor(q=q, scales=s,
                                                 group_size=int(leaf["group_size"]),
                                                 bits=int(leaf.get("bits", 8)),
                                                 il=int(leaf.get("il", 0)))
                check_weight(qt, q.device)  # bits, K a whole number of K blocks, scales
        elif name in ("rope_cos", "rope_sin"):
            out[name] = _tensor(leaf, device, torch.float32)
        else:
            out[name] = _tensor(leaf, device, dtype)
    w13 = out.get("w13")
    if isinstance(w13, QuantizedTensor) and w13.il and cfg.hidden_dim % w13.il:
        raise ValueError(f"w13 interleave tile {w13.il} does not divide "
                         f"hidden_dim {cfg.hidden_dim}")
    return out
