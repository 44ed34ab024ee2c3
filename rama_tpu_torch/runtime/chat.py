"""Interactive chat — the port of rama_tpu/runtime/chat.py (the `-o chat`
mode the reference parses but never implements, engine/src/main.rs:46-49).

The llama2.c `run.c` chat convention for llama-2-chat models: each user
turn is wrapped in `[INST] ... [/INST]` (the first may carry a
`<<SYS>> ... <</SYS>>` system prompt) and opened by BOS, the assistant
reply runs until EOS, `max_new` tokens or the context end, and the whole
conversation shares one KV cache on the device the params live on: each
turn's template is prefilled mid-sequence at the running position, so the
history is never processed again.

A turn's template is padded to a power-of-two bucket whose pad columns sit
at the last real position. rama_tpu pads with token 0, so its pad rows
write other keys and values onto that row (the scatter's last write wins
on the CPU) before the real query reads it; here the pad columns repeat the
last real token, so every write to that row carries the same values and
the turn equals the unpadded token-at-a-time one. The template's chunk is
not from position 0: its attention is `forward`'s masked one over the
cache. Sampled turns draw their uniforms from a torch.Generator seeded with
`seed` (runtime/generate.py), not JAX's threefry splits.
"""

from __future__ import annotations

import sys
from typing import Iterator

import torch

from rama_tpu_torch.config import ModelConfig
from rama_tpu_torch.models.llama import KVCache, decode_step, forward
from rama_tpu_torch.runtime.generate import _generator_source, _sample
from rama_tpu_torch.tokenizer import BOS_ID, EOS_ID, Tokenizer


class ChatContextFull(Exception):
    """The conversation no longer fits in the model's context window."""


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class ChatSession:
    """One conversation: a KV cache and a running position. `turn(text)`
    streams the assistant reply as decoded text pieces. `plain=True` runs
    the kernels' plain PyTorch versions (the card's reference)."""

    def __init__(self, params, cfg: ModelConfig, tokenizer: Tokenizer,
                 temperature: float = 1.0, top_p: float = 0.9, seed: int = 100,
                 system: str | None = None, cache_dtype=None, plain: bool = False):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.temperature = temperature
        self.top_p = top_p
        self.system = system
        self.plain = plain
        self.device = params["final_norm"].device
        self.cache = KVCache.create(cfg, batch=1,
                                    dtype=cache_dtype or params["final_norm"].dtype,
                                    device=self.device)
        self.pos = 0          # next cache row to write
        self.turns = 0
        self.next_u = _generator_source(seed)

    def _template(self, user_text: str) -> list[int]:
        if self.turns == 0 and self.system:
            prompt = f"[INST] <<SYS>> {self.system} <</SYS>> {user_text} [/INST]"
        else:
            prompt = f"[INST] {user_text} [/INST]"
        # BOS opens every user turn (the run.c chat loop)
        return [BOS_ID] + self.tokenizer.encode(prompt, strict=False)

    def _chunk(self, ids: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """The padded (1, t_pad) template and its positions pos.. : pad
        columns repeat the last real token at the last real position."""
        true = len(ids)
        idx = torch.arange(_bucket(true), device=self.device)
        ids_t = torch.tensor(ids, dtype=torch.int64, device=self.device)
        tokens = ids_t[idx.clamp(max=true - 1)]
        return tokens[None], (self.pos + idx.clamp(max=true - 1))[None]

    @torch.no_grad()
    def _prefill_chunk(self, ids: list[int]) -> torch.Tensor:
        """Forward `ids` at positions pos..pos+len-1; returns the last real
        position's (V,) logits."""
        tokens, pos_index = self._chunk(ids)
        logits, self.cache = forward(self.params, self.cfg, tokens, pos_index, self.cache,
                                     plain=self.plain)
        self.pos += len(ids)
        return logits[0, len(ids) - 1]

    def _sample(self, logits: torch.Tensor) -> int:
        return int(_sample(logits[None], self.temperature, self.top_p, self.next_u)[0])

    @torch.no_grad()
    def turn(self, user_text: str, max_new: int = 256) -> Iterator[str]:
        """Run one user turn; yields decoded assistant text pieces."""
        ids = self._template(user_text)
        if self.pos + len(ids) + 2 > self.cfg.seq_len:
            raise ChatContextFull(f"conversation ({self.pos} tokens) + turn ({len(ids)}) "
                                  f"exceeds context {self.cfg.seq_len}")
        tok = self._sample(self._prefill_chunk(ids))
        self.turns += 1
        emitted = 0
        while tok != EOS_ID and emitted < max_new and self.pos < self.cfg.seq_len - 1:
            yield self.tokenizer.decode_token(tok)
            logits, self.cache = decode_step(
                self.params, self.cfg, torch.tensor([tok], device=self.device),
                torch.tensor([self.pos], device=self.device), self.cache, plain=self.plain)
            self.pos += 1
            tok = self._sample(logits[0])
            emitted += 1


def chat_repl(params, cfg: ModelConfig, tokenizer: Tokenizer, temperature: float = 1.0,
              top_p: float = 0.9, seed: int = 100, system: str | None = None,
              max_new: int = 256, cache_dtype=None, input_fn=input, out=None) -> int:
    """The interactive loop (the CLI's `-o chat`): reads user lines, streams
    the assistant replies; an empty line, `exit`, `quit` or end of input
    ends it. Returns the exit code."""
    out = out or sys.stdout
    session = ChatSession(params, cfg, tokenizer, temperature, top_p, seed, system,
                          cache_dtype)
    while True:
        try:
            user = input_fn("User: ")
        except (EOFError, KeyboardInterrupt):
            print(file=out)
            return 0
        if user.strip() in ("", "exit", "quit"):
            return 0
        print("Assistant: ", end="", file=out, flush=True)
        try:
            for piece in session.turn(user, max_new=max_new):
                print(piece, end="", file=out, flush=True)
        except ChatContextFull as e:
            print(f"\n[context full: {e}]", file=out)
            return 0
        print(file=out, flush=True)
