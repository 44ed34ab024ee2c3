"""Continuous-batching inference engine — the slim port of
rama_tpu/runtime/engine.py.

What it keeps from the JAX engine:
- a fixed pool of **slots** in one batched KV cache;
- **continuous batching**: requests join mid-flight at their own position
  (the forward takes a per-slot position vector), finished slots free
  immediately for the bounded admission queue;
- **bucketed prefill**: a burst of admissions prefills in one padded (k, T)
  forward into a scratch cache whose rows are copied into the slots
  (`_bucket`, `_bucket_k`, `_prefill_k_cap`, padded positions clamped to
  t_pad-1 as engine.py:420-422);
- **n-step decode ticks**: n decode steps per host round trip, each
  sampled token fed to the next step on the device, with per-slot keyed
  sampling (`sampler.uniform_from_key(slot_key, pos)`) so a slot's stream
  does not depend on tick size;
- EOS / length / cancel / max_len handling, error recovery that fails the
  in-flight requests and rebuilds the cache, `stats()` and PhaseTimer.

Not ported yet (ROADMAP.md): pipelined/chained ticks, async-firsts
admission, chunked prefill, speculation, the paged and int8 caches,
tensor/data/sequence parallelism, multi-host. Their EngineConfig fields
raise NotImplementedError when set.

Threading: one engine thread owns the device loop; request queues bridge to
the async server. Tokens stream per request through `Request.queue`.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from rama_tpu_torch.config import EngineConfig, ModelConfig
from rama_tpu_torch.models.llama import (KVCache, _rope_tables, decode_step,
                                         forward, fuse_params)
from rama_tpu_torch.runtime.sampler import sample_batched_keyed, sample_greedy
from rama_tpu_torch.tokenizer import BOS_ID, EOS_ID, Tokenizer
from rama_tpu_torch.utils.profiling import PhaseTimer


@dataclass
class Request:
    prompt: str
    steps: int
    temperature: float = 1.0
    top_p: float = 0.9
    stop_at_eos: bool = True
    echo_prompt: bool = False
    queue: "queue.Queue[Optional[str]]" = field(default_factory=lambda: queue.Queue())
    cancelled: bool = False  # set by the server on client disconnect
    error: str | None = None  # set when the stream ended due to a failure
    truncated: int = 0  # prompt tokens dropped to fit the cache (0 = none)
    submitted_at: float = field(default_factory=time.time)
    first_token_at: float | None = None
    tokens_out: int = 0
    prompt_ids: list[int] = field(default_factory=list)  # filled by the engine


class _Slot:
    __slots__ = ("request", "pos", "generated", "last_token")

    def __init__(self):
        self.request: Request | None = None
        self.pos = 0
        self.generated = 0
        self.last_token = 0

    @property
    def free(self) -> bool:
        return self.request is None


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _bucket_k(n: int, dp: int = 1, b: int = 1, t_pad: int = 16) -> int:
    """Prefill batch bucket for n admitted requests (b slots, T bucket t_pad):
    the full slot count while k*T is small, else dp * 2^j >= n under the
    area cap (engine.py:103-115)."""
    if b * t_pad <= 4096:
        return max(b, n)
    return min(_bucket(n, lo=max(dp, 1)), _prefill_k_cap(t_pad, dp))


# Prefill bucket AREA cap (k_pad * t_pad tokens): bounds the scratch cache
# of one admission dispatch; bigger bursts split into sequential groups.
_PREFILL_AREA = 4096


def _prefill_k_cap(t_pad: int, dp: int = 1) -> int:
    dp = max(dp, 1)
    per_replica = max(1, _PREFILL_AREA // max(t_pad, 1) // dp)
    return dp * (1 << (per_replica.bit_length() - 1))


_UNPORTED = (
    # (field, value when off, ROADMAP item)
    ("paged_kv", False, "paged KV cache"),
    ("kv_quant", None, "int8 KV cache"),
    ("spec_tick", 0, "speculative serving"),
    ("prefill_chunk", 0, "chunked prefill"),
    ("scale_dtype", None, "bf16-stored weight scales"),
    ("tp_size", 1, "tensor/data/sequence parallelism"),
    ("dp_size", 1, "tensor/data/sequence parallelism"),
    ("seq_par", False, "tensor/data/sequence parallelism"),
    ("compile_cache", None, "compile cache (no counterpart yet)"),
)


def check_ported(ecfg: EngineConfig) -> None:
    for name, off, item in _UNPORTED:
        if getattr(ecfg, name) != off:
            raise NotImplementedError(
                f"EngineConfig.{name}={getattr(ecfg, name)!r}: {item} is not "
                f"ported to rama_tpu_torch yet (ROADMAP.md)")


class Engine:
    """Owns the model, the slot pool and the device loop thread. Runs on the
    device the params live on."""

    def __init__(self, cfg: ModelConfig, params, tokenizer: Tokenizer,
                 engine_config: EngineConfig | None = None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.ecfg = engine_config or EngineConfig()
        check_ported(self.ecfg)
        b = self.ecfg.max_batch_size
        self.max_len = self.ecfg.max_seq_len or cfg.seq_len
        self.device = params["final_norm"].device
        # activations and the cache share the params' float dtype (the JAX
        # engine keeps a bf16 cache under fp32 params; the kernels here
        # take one dtype per call)
        self.dtype = params["final_norm"].dtype
        params = dict(params)
        if params["rope_cos"].shape[0] < self.max_len:
            # long-context serving: retabulate RoPE out to the cache length
            params["rope_cos"], params["rope_sin"] = _rope_tables(
                cfg, self.device, seq_len=self.max_len)
        self.params = fuse_params(params, cfg)
        self.cache = self._create_cache(b)
        self.slots = [_Slot() for _ in range(b)]
        # bounded admission queue — reference uses bounded(30), main.rs:68
        self.admission: "queue.Queue[Request]" = queue.Queue(maxsize=30)
        # per-slot stream keys (two uint32 from (seed, request counter))
        self.slot_keys = np.zeros((b, 2), np.int64)
        self.req_counter = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        self.phases = PhaseTimer()
        self.metrics = {
            "tokens_generated": 0,
            "tick_tokens": 0,       # emitted by decode ticks only
            "requests_completed": 0,
            "engine_errors": 0,
            "ttft_ms": [],          # recent TTFTs
            "decode_ticks": 0,
            "decode_s": 0.0,
        }

    def _create_cache(self, batch: int) -> KVCache:
        return KVCache.create(self.cfg, batch=batch, max_len=self.max_len,
                              dtype=self.dtype, device=self.device)

    # -- public API ---------------------------------------------------------

    def submit(self, req: Request, timeout: float | None = None) -> Request:
        req.prompt_ids = (self.tokenizer.encode(req.prompt, strict=False)
                          if req.prompt else [])
        # leave room for BOS and at least one generated token; record how
        # many tokens were dropped so the server can tell the client
        req.truncated = max(0, len(req.prompt_ids) - (self.max_len - 2))
        req.prompt_ids = req.prompt_ids[: self.max_len - 2]
        max_new = self.max_len - len(req.prompt_ids) - 1
        req.steps = max(1, min(req.steps, max_new))
        self.admission.put(req, timeout=timeout)
        self._wake.set()
        return req

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rama-torch-engine")
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=30)

    # -- admission ------------------------------------------------------------

    def _admit(self):
        """Admit every queued request a free slot exists for, prefilling the
        burst in one padded (k, T) forward per area-capped group."""
        batch: list[tuple[int, _Slot, Request]] = []
        for i, slot in enumerate(self.slots):
            if not slot.free:
                continue
            try:
                req = self.admission.get_nowait()
            except queue.Empty:
                break
            batch.append((i, slot, req))
        if not batch:
            return
        try:
            self._start_requests(batch)
        except Exception:  # noqa: BLE001 — a failed admit must not lose the client
            traceback.print_exc()
            self.metrics["engine_errors"] += 1
            for _, slot, req in batch:
                slot.request = None
                if req.error is None:
                    req.error = "engine error during prefill"
                    req.queue.put(None)

    def _start_requests(self, batch):
        entries = []
        for slot_idx, slot, req in batch:
            ids = [BOS_ID] + req.prompt_ids
            key = np.random.default_rng((self.ecfg.seed, self.req_counter)).integers(
                0, 1 << 32, size=2, dtype=np.uint32)
            self.req_counter += 1
            entries.append((slot_idx, slot, req, ids, key))
        t_all = min(_bucket(max(len(e[3]) for e in entries)), self.max_len)
        c = _prefill_k_cap(t_all)
        for i in range(0, len(entries), c):
            self._prefill_group(entries[i:i + c])

    def _pad_entries(self, entries):
        """Pad entries to one (k_pad, t_pad) bucket; pad rows duplicate the
        last real request."""
        n_real = len(entries)
        t_pad = min(_bucket(max(len(e[3]) for e in entries)), self.max_len)
        k_pad = _bucket_k(n_real, 1, len(self.slots), t_pad)
        tokens = np.zeros((k_pad, t_pad), np.int64)
        true_lens = np.ones(k_pad, np.int32)
        temps = np.zeros(k_pad, np.float32)
        top_ps = np.full(k_pad, 0.9, np.float32)
        keys = np.zeros((k_pad, 2), np.int64)
        for j in range(k_pad):
            _, _, req, ids, key = entries[min(j, n_real - 1)]
            tokens[j, : len(ids)] = ids
            true_lens[j] = len(ids)
            temps[j] = req.temperature
            top_ps[j] = req.top_p
            keys[j] = key
        return tokens, true_lens, temps, top_ps, keys

    def _prefill_group(self, entries):
        tokens, true_lens, temps, top_ps, keys = self._pad_entries(entries)
        with self.phases.phase("prefill"):
            firsts = self._dev_prefill_insert(tokens, true_lens, temps, top_ps, keys,
                                              [e[0] for e in entries])
        for j, (slot_idx, slot, req, ids, key) in enumerate(entries):
            self.slot_keys[slot_idx] = key
            slot.request = req
            slot.pos = len(ids)            # next decode position
            slot.generated = 0
            slot.last_token = int(firsts[j])
            if req.echo_prompt:
                # the reference stream re-emits prompt tokens while forcing
                # them (mod.rs:227-241)
                for t in req.prompt_ids:
                    req.queue.put(self.tokenizer.decode_token(t))
            self._emit(slot, slot.last_token)

    @torch.no_grad()
    def _dev_prefill_insert(self, tokens, true_lens, temps, top_ps, keys,
                            slots: list[int]) -> np.ndarray:
        """Batched (k, T) prefill into a scratch cache, first-token sampling
        at each row's last real query (position true_lens-1, keyed like the
        decode ticks), then the scratch rows copied into the slots."""
        dev = self.device
        k, t_pad = tokens.shape
        tok = torch.from_numpy(tokens).to(dev)
        lens = torch.from_numpy(true_lens).to(dev)
        scratch = KVCache.create(self.cfg, batch=k, max_len=t_pad, dtype=self.dtype,
                                 device=dev)
        idx = torch.arange(t_pad, device=dev)[None, :]
        # padded positions write the last scratch row; no real query sees it
        pos_index = torch.where(idx < lens[:, None], idx, t_pad - 1)
        last, scratch = forward(self.params, self.cfg, tok, pos_index, scratch,
                                plen=lens, logit_rows=lens.long() - 1)
        if (temps > 0).any():
            firsts = sample_batched_keyed(
                last[:, 0], torch.from_numpy(keys).to(dev), lens.long() - 1,
                torch.from_numpy(temps).to(dev), torch.from_numpy(top_ps).to(dev))
        else:
            firsts = sample_greedy(last[:, 0])
        t_ins = min(t_pad, self.max_len)
        for j, slot_idx in enumerate(slots):
            self.cache.k[:, slot_idx, :, :t_ins].copy_(scratch.k[:, j, :, :t_ins])
            self.cache.v[:, slot_idx, :, :t_ins].copy_(scratch.v[:, j, :, :t_ins])
        return firsts.cpu().numpy()

    # -- decode -----------------------------------------------------------------

    @torch.no_grad()
    def _dev_tick(self, tokens, pos, temps, tps, n: int) -> np.ndarray:
        """n sampled decode steps for all slots; the sampled tokens feed the
        next step on the device and are fetched once, as (n, B)."""
        dev = self.device
        tok = torch.from_numpy(tokens).to(dev)
        p = torch.from_numpy(pos).to(dev)
        sampled = bool((temps > 0).any())
        if sampled:
            keys = torch.from_numpy(self.slot_keys).to(dev)
            t = torch.from_numpy(temps).to(dev)
            tp = torch.from_numpy(tps).to(dev)
        outs = []
        for _ in range(n):
            logits, self.cache = decode_step(self.params, self.cfg, tok, p, self.cache)
            tok = (sample_batched_keyed(logits, keys, p, t, tp) if sampled
                   else sample_greedy(logits))
            outs.append(tok)
            p = p + 1
        return torch.stack(outs).cpu().numpy()

    def _emit(self, slot: _Slot, token: int):
        req = slot.request
        if req.first_token_at is None:
            req.first_token_at = time.time()
            self.metrics["ttft_ms"].append(
                (req.first_token_at - req.submitted_at) * 1000.0)
            del self.metrics["ttft_ms"][:-256]
        slot.generated += 1
        req.tokens_out += 1
        self.metrics["tokens_generated"] += 1
        req.queue.put(self.tokenizer.decode_token(token))
        if (req.cancelled
                or (req.stop_at_eos and token == EOS_ID)
                or slot.generated >= req.steps
                or slot.pos >= self.max_len):
            self._finish(slot)

    def _finish(self, slot: _Slot):
        slot.request.queue.put(None)  # end-of-stream sentinel
        slot.request = None
        self.metrics["requests_completed"] += 1

    def _loop(self):
        # a device-loop error fails the in-flight requests, rebuilds the
        # (possibly half-written) cache, and keeps serving
        while not self._stop.is_set():
            try:
                self._loop_once()
            except Exception:  # noqa: BLE001 — engine thread must survive
                traceback.print_exc()
                self.metrics["engine_errors"] += 1
                for s in self.slots:
                    if not s.free:
                        s.request.error = "engine error during decode"
                        self._finish(s)
                self.cache = self._create_cache(len(self.slots))

    def _loop_once(self):
        with self.phases.phase("admit"):
            self._admit()
        active = [s for s in self.slots if not s.free]
        if not active:
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            return
        b = len(self.slots)
        tokens = np.zeros(b, np.int64)
        pos = np.zeros(b, np.int64)
        temps = np.zeros(b, np.float32)
        tps = np.full(b, 0.9, np.float32)
        for i, s in enumerate(self.slots):
            if s.free:
                continue
            tokens[i] = s.last_token
            pos[i] = s.pos
            temps[i] = s.request.temperature
            tps[i] = s.request.top_p
        # shrink the tick so no slot overshoots its remaining budget by much
        n = self.ecfg.decode_tick
        remaining = min(s.request.steps - s.generated for s in active)
        while n > 1 and n // 2 >= remaining:
            n //= 2
        t0 = time.time()
        with self.phases.phase("decode"):
            out = self._dev_tick(tokens, pos, temps, tps, n)
        self.metrics["decode_ticks"] += 1
        self.metrics["decode_s"] += time.time() - t0
        with self.phases.phase("emit"):
            for i, s in enumerate(self.slots):
                if s.free:
                    continue
                for j in range(n):
                    s.pos += 1
                    s.last_token = int(out[j, i])
                    self.metrics["tick_tokens"] += 1
                    self._emit(s, s.last_token)
                    if s.free:  # finished mid-tick; drop the overshoot
                        break

    # -- observability ------------------------------------------------------

    def stats(self) -> dict:
        m = self.metrics
        ttfts = sorted(m["ttft_ms"])
        return {
            "tokens_generated": m["tokens_generated"],
            "requests_completed": m["requests_completed"],
            "engine_errors": m["engine_errors"],
            "active_slots": sum(1 for s in self.slots if not s.free),
            "max_slots": len(self.slots),
            "queue_depth": self.admission.qsize(),
            "decode_ticks": m["decode_ticks"],
            # tick-emitted tokens over tick time (host clock around work
            # that ends in a device sync); prefill-sampled firsts excluded
            "decode_tok_per_s": (m["tick_tokens"] / m["decode_s"]
                                 if m["decode_s"] else 0.0),
            "spec_accept_rate": None,
            "spec_dormant_ticks": None,
            "ttft_p50_ms": ttfts[len(ttfts) // 2] if ttfts else None,
            "ttft_p95_ms": ttfts[int(len(ttfts) * 0.95)] if ttfts else None,
            "phases": self.phases.stats(),
            "device": str(self.device),
        }
