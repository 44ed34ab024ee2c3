"""Speculative decoding: n-gram (prompt-lookup) and draft-model drafting —
the port of rama_tpu/runtime/speculative.py.

Each round drafts tokens after the current one, runs the chunk [current,
drafts] through the target in one chunked forward (`forward_chunk`, the
chunk attention kernel on the card) and accepts drafts while they equal
the target's own samples at those positions (**sample-then-compare**).
Every sample is a pure function of the logits and its stream position (the
keyed uniforms of runtime.sampler), so the emitted stream is the one
sequential decoding with the same position-keyed draws emits: speculation
changes latency, never the output (exact in fp32; under bf16 a chunked
forward may reduce in another order than a T=1 step and flip an argmax
near-tie).

Cache discipline (write-before-attend): the chunk forward writes K/V rows
pos..pos+T-1; rows past the accepted prefix hold rejected drafts, but every
later query at position p attends row r <= p only after the step that
processes position r has rewritten it. The draft model's cache follows the
same rule — each round's draft steps start by re-processing the last
emitted token at its true position — and, unlike the reference, the draft
takes one step more than it proposes, so that after a full accept the row
of its last proposal is written too (ROADMAP.md, deliberate differences).

The single-stream loop here fetches the accept count once per round; the
serving engine keeps its rounds on the device (runtime.engine).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from rama_tpu_torch.config import ModelConfig
from rama_tpu_torch.models.llama import KVCache, decode_step, forward_chunk, prefill
from rama_tpu_torch.runtime.sampler import sample_batched_keyed, sample_greedy
from rama_tpu_torch.tokenizer import BOS_ID, Tokenizer


def ngram_propose(toks: torch.Tensor, n: torch.Tensor, k: int, gram: int = 2) -> torch.Tensor:
    """Draft k tokens per row by prompt lookup: find the most recent earlier
    occurrence of the trailing `gram`-gram of toks[b, :n[b]] and propose the
    tokens that followed it; fall back to repeating the last token.

    toks (B, cap) int stream buffers (index p = input token at position p);
    n (B,) counts of valid tokens. Returns (B, k). Row for row the rules of
    rama_tpu's ngram_propose: the window [j, j+gram) lies strictly before
    the tail, its continuation toks[j+gram] is a real token (< n), the
    match is the largest j, and n <= gram finds nothing."""
    b, cap = toks.shape
    dev = toks.device
    n = n.long()
    start = (n - gram).clamp(0, cap - gram)
    tail = toks.gather(1, start[:, None] + torch.arange(gram, device=dev)[None, :])
    match = torch.ones((b, cap), dtype=torch.bool, device=dev)
    for i in range(gram):
        # toks[j + i] aligned at j; wrapped columns fall outside the window
        match &= torch.roll(toks, -i, dims=1) == tail[:, i:i + 1]
    idx = torch.arange(cap, device=dev)
    match &= (idx + gram)[None, :] < n[:, None]
    found = match.any(dim=1) & (n > gram)
    j = torch.where(match, idx[None, :], torch.full_like(idx, -1)[None, :]).amax(dim=1)
    first = torch.where(found, j + gram, torch.zeros_like(j)).clamp(0, cap)
    padded = torch.cat([toks, toks.new_zeros((b, k))], dim=1)
    cont = padded.gather(1, first[:, None] + torch.arange(k, device=dev)[None, :])
    last = toks.gather(1, (n - 1).clamp(min=0)[:, None])
    return torch.where(found[:, None], cont, last.expand(b, k))


def stream_key(seed: int) -> torch.Tensor:
    """(1, 2) uint32 values in int64: the single stream's sampling key."""
    key = np.random.default_rng(seed).integers(0, 1 << 32, size=2, dtype=np.uint32)
    return torch.from_numpy(key.astype(np.int64))[None, :]


def _sample_positions(logits: torch.Tensor, pos_first: int, key: torch.Tensor,
                      temperature: float, top_p: float) -> torch.Tensor:
    """Target token for each chunk row i (logits (T, V)), keyed only by the
    stream position pos_first + i of the token it produces."""
    if temperature == 0.0:
        return sample_greedy(logits)
    t = logits.shape[0]
    dev = logits.device
    pos = pos_first + torch.arange(t, device=dev)
    return sample_batched_keyed(logits, key.to(dev).expand(t, 2), pos,
                                torch.full((t,), temperature, device=dev),
                                torch.full((t,), top_p, device=dev))


Proposer = Callable[[torch.Tensor, int, torch.Tensor, int], torch.Tensor]


@torch.no_grad()
def _spec_generate(params, cfg: ModelConfig, prompt_ids: list[int], steps: int,
                   temperature: float, top_p: float, key: torch.Tensor, cache,
                   propose: Proposer, k: int) -> tuple[list[int], int, int]:
    """Prefill [BOS, prompt], then verification rounds of chunk size k (the
    current token and k - 1 drafts) until `steps` tokens stand. Returns
    (ids: the prompt then the generated tokens, steps in all; rounds;
    accepted drafts)."""
    dev = cache.k.device
    plen = len(prompt_ids)
    inputs = torch.tensor([[BOS_ID] + list(prompt_ids)], dtype=torch.int64, device=dev)
    logits, cache = prefill(params, cfg, inputs, cache, last_only=True)
    first = _sample_positions(logits[0, -1:], plen + 1, key, temperature, top_p)
    toks = torch.zeros(steps + k + 2, dtype=torch.int64, device=dev)
    toks[: plen + 1] = inputs[0]
    toks[plen + 1] = first[0]
    n, rounds, accepted = plen + 2, 0, 0
    while n - 1 < steps:
        pos = n - 1                                  # position of the current token
        drafts = propose(toks, n, toks[pos:pos + 1], pos)            # (k-1,)
        chunk = torch.cat([toks[pos:pos + 1], drafts])               # (k,)
        logits, cache = forward_chunk(params, cfg, chunk[None],
                                      torch.tensor([pos], device=dev), cache)
        t = _sample_positions(logits[0], pos + 1, key, temperature, top_p)
        a = int(torch.cumprod((drafts == t[:-1]).long(), 0).sum())   # leading accepts
        toks[n:n + a + 1] = t[:a + 1]
        n += a + 1
        rounds += 1
        accepted += a
    return toks[1:steps + 1].tolist(), rounds, accepted


def generate_speculative_ngram(params, cfg: ModelConfig, prompt_ids: list[int], steps: int,
                               temperature: float, top_p: float, key: torch.Tensor,
                               cache: KVCache, *, k: int = 8, gram: int = 2):
    """Prompt-lookup speculative generation. Returns (ids, rounds, accepted):
    ids as generate_prefill_decode's (the prompt echoed first, steps in
    all); k = chunk size (1 current + k - 1 drafted); gram = match length
    for the lookup."""

    def propose(toks, n, cur, pos):
        return ngram_propose(toks[None], torch.tensor([n], device=toks.device), k - 1, gram)[0]

    return _spec_generate(params, cfg, prompt_ids, steps, temperature, top_p, key, cache,
                          propose, k)


def generate_speculative_draft(params, cfg: ModelConfig, dparams, dcfg: ModelConfig,
                               prompt_ids: list[int], steps: int, temperature: float,
                               top_p: float, key: torch.Tensor, cache: KVCache,
                               dcache: KVCache, *, k: int = 8):
    """Draft-model speculative generation: a small model proposes k - 1
    greedy tokens per round over its own cache of the same stream; the
    target verifies them in one chunked forward. Returns (ids, rounds,
    accepted)."""
    dev = dcache.k.device
    inputs = torch.tensor([[BOS_ID] + list(prompt_ids)], dtype=torch.int64, device=dev)
    with torch.no_grad():
        _, dcache = prefill(dparams, dcfg, inputs, dcache, last_only=True)

    def propose(toks, n, cur, pos):
        tok, outs = cur, []
        for i in range(k):      # k - 1 proposals, then the last one's row
            lg, _ = decode_step(dparams, dcfg, tok, torch.tensor([pos + i], device=dev),
                                dcache)
            tok = sample_greedy(lg)
            outs.append(tok)
        return torch.cat(outs[:k - 1])

    return _spec_generate(params, cfg, prompt_ids, steps, temperature, top_p, key, cache,
                          propose, k)


def generate_text_speculative(params, cfg: ModelConfig, tokenizer: Tokenizer, prompt: str,
                              steps: int | None = None, temperature: float = 1.0,
                              top_p: float = 0.9, seed: int = 100, cache_dtype=None,
                              k: int = 8, gram: int = 2, draft=None
                              ) -> tuple[str, list[int], dict]:
    """Encode, speculatively generate, decode, on the device the params live
    on. draft: (draft_params, draft_cfg) for draft-model mode; None uses
    n-gram prompt lookup. The caches take the params' dtype unless
    `cache_dtype` is given. Returns (text, ids, stats)."""
    steps = min(steps or 255, cfg.seq_len)
    prompt_ids = tokenizer.encode(prompt) if prompt else [BOS_ID]
    if len(prompt_ids) >= steps:
        prompt_ids = prompt_ids[: steps - 1]
    key = stream_key(seed)
    dev = params["final_norm"].device
    cache = KVCache.create(cfg, batch=1, dtype=cache_dtype or params["final_norm"].dtype,
                           device=dev)
    if draft is None:
        ids, rounds, accepted = generate_speculative_ngram(
            params, cfg, prompt_ids, steps, temperature, top_p, key, cache, k=k, gram=gram)
    else:
        dparams, dcfg = draft
        dcache = KVCache.create(dcfg, batch=1,
                                dtype=cache_dtype or dparams["final_norm"].dtype, device=dev)
        ids, rounds, accepted = generate_speculative_draft(
            params, cfg, dparams, dcfg, prompt_ids, steps, temperature, top_p, key, cache,
            dcache, k=k)
    stats = {"rounds": rounds, "accepted_drafts": accepted, "tokens": steps,
             "tokens_per_round": steps / max(rounds, 1)}
    return tokenizer.decode_ids(ids), ids, stats
