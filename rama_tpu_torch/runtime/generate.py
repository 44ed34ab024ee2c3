"""Generation loops: token-at-a-time parity loop and prefill + decode.

The port of rama_tpu/runtime/generate.py. Emission semantics match the
reference loop (engine/src/transformer/mod.rs:182-204): generation starts
from BOS=1 at position 0; while pos < len(prompt) the "sampled" token is
forced to prompt[pos]; every next token (the re-echoed prompt included) is
emitted.

The decode loop is a Python loop over decode steps; the sampled token
stays on the device and feeds the next step (a CUDA graph of the loop is
later work). The uniforms of nucleus sampling come from `next_u`, a
callable returning one float in [0, 1) per sampled token, consumed in the
order the JAX package splits its key (one draw per sampled position); the
default is a torch.Generator seeded with `seed`.
"""

from __future__ import annotations

from typing import Callable

import torch

from rama_tpu_torch.config import ModelConfig
from rama_tpu_torch.models.llama import KVCache, decode_step, prefill
from rama_tpu_torch.runtime.sampler import _top_p_from_u, sample_greedy
from rama_tpu_torch.tokenizer import BOS_ID, Tokenizer

UniformSource = Callable[[], float]


def _generator_source(seed: int) -> UniformSource:
    g = torch.Generator().manual_seed(seed)
    return lambda: float(torch.rand((), generator=g))


def _sample(logits_1v: torch.Tensor, temperature: float, top_p: float,
            next_u: UniformSource) -> torch.Tensor:
    """(1, V) logits -> (1,) id on the logits' device."""
    if temperature == 0.0:
        return sample_greedy(logits_1v)
    u = torch.tensor([next_u()], dtype=torch.float32)
    return _top_p_from_u(logits_1v, u, temperature, top_p)


@torch.no_grad()
def generate_scan(params, cfg: ModelConfig, prompt_ids: list[int], steps: int,
                  temperature: float, top_p: float, next_u: UniformSource,
                  cache: KVCache) -> list[int]:
    """Token-at-a-time generation with exact reference loop semantics: every
    position (prompt included) runs one decode step (mod.rs:187-193)."""
    dev = cache.k.device
    prompt = torch.tensor(prompt_ids or [0], dtype=torch.int64, device=dev)
    token = torch.tensor([BOS_ID], dtype=torch.int64, device=dev)
    out = []
    for pos in range(steps):
        logits, cache = decode_step(params, cfg, token,
                                    torch.tensor([pos], device=dev), cache)
        sampled = _sample(logits, temperature, top_p, next_u)
        token = prompt[pos : pos + 1] if pos < len(prompt_ids) else sampled
        out.append(token)
    return torch.cat(out).tolist()


@torch.no_grad()
def generate_prefill_decode(params, cfg: ModelConfig, prompt_ids: list[int],
                            steps: int, temperature: float, top_p: float,
                            next_u: UniformSource, cache: KVCache) -> list[int]:
    """Batched prefill over [BOS, prompt...] at positions 0..len(prompt),
    then decode steps (1 <= len(prompt) < steps). The last prefill position
    samples the first post-prompt token."""
    dev = cache.k.device
    inputs = torch.tensor([[BOS_ID] + list(prompt_ids)], dtype=torch.int64, device=dev)
    logits, cache = prefill(params, cfg, inputs, cache, last_only=True)
    token = _sample(logits[:, -1], temperature, top_p, next_u)
    out = [token]
    for pos in range(len(prompt_ids) + 1, steps):
        logits, cache = decode_step(params, cfg, token,
                                    torch.tensor([pos], device=dev), cache)
        token = _sample(logits, temperature, top_p, next_u)
        out.append(token)
    return list(prompt_ids) + torch.cat(out).tolist()


def generate_text(params, cfg: ModelConfig, tokenizer: Tokenizer, prompt: str,
                  steps: int | None = None, temperature: float = 1.0,
                  top_p: float = 0.9, seed: int = 100, cache_dtype=None,
                  fast: bool = True, next_u: UniformSource | None = None,
                  ) -> tuple[str, list[int]]:
    """Encode, generate, decode on the device the params live on.
    Returns (text, emitted token ids). The cache takes the params' dtype
    unless `cache_dtype` is given: the card's attention kernels take one
    dtype for q and the cache (the JAX package defaults to a bf16 cache)."""
    steps = min(steps or 255, cfg.seq_len)
    prompt_ids = tokenizer.encode(prompt) if prompt else []
    if len(prompt_ids) >= steps:
        prompt_ids = prompt_ids[: steps - 1]
    next_u = next_u or _generator_source(seed)
    dev = params["final_norm"].device
    cache = KVCache.create(cfg, batch=1, dtype=cache_dtype or params["final_norm"].dtype,
                           device=dev)
    if fast and prompt_ids:
        ids = generate_prefill_decode(params, cfg, prompt_ids, steps, temperature,
                                      top_p, next_u, cache)
    else:
        ids = generate_scan(params, cfg, prompt_ids, steps, temperature, top_p,
                            next_u, cache)
    return tokenizer.decode_ids(ids), ids
