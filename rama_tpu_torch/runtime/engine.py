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
  in-flight requests and rebuilds the cache, `stats()` and PhaseTimer;
- the **int8 KV cache** (`kv_quant="int8"`): a `QuantKVCache` of int8 rows
  with per-row f32 scales; admission quantizes the dense prefill scratch
  into the slots with the strip writer (one launch per admission group),
  decode quantizes and writes each step's rows and attends over the int8
  cache (models/llama.py);
- **speculative serving** (`spec_tick` = k > 0): a spec tick runs m rounds
  (`spec_rounds`, shrunk near token budgets and the cache end) on the
  device with no host sync inside — each drafts k tokens per slot (n-gram
  lookup over the per-slot history, or k greedy steps of a resident draft
  model), verifies the (B, k+1) chunk in one `forward_chunk`, and accepts
  by sample-then-compare keyed by (slot key, position), so the stream is
  the plain ticks' stream — then fetches samples and accepts once. Adaptive
  dormancy (`spec_min_accept`) serves plain ticks while drafts do not land;
  draft mode replays the dormant gap through the draft model before the
  next probe;
- the **paged KV cache** (`paged_kv`, runtime/paged.py): one shared page
  pool (bf16 / f32, or int8 with `kv_quant="int8"`) of `kv_num_pages`
  pages of `kv_page_size` rows (default: the dense worst case) plus one
  trash page that free slots' table rows point at, so their unconditional
  writes never touch a live page; pages are reserved at admission
  (min(bucket(len), max_len) rows; "out of KV cache pages" ends a request
  that does not fit) and before every plain tick (n rows a slot) and spec
  tick (m (k + 1) rows), and released when a request ends. Admission
  prefills into the dense scratch as before and inserts the strips through
  the tables (K13's strip writer for the int8 pool); decode ticks and spec
  rounds (n-gram or draft; the draft model keeps its dense cache) run the
  fused paged forward;
- **bf16-stored weight scales** (`scale_dtype="bf16"`): the target's
  params are fused, then `cast_scales` stores every quantized leaf's scales
  in bf16 (the draft's stay as loaded, as in the JAX engine); the kernels
  read them as they are;
- **warmup and the compile cache**: `warmup()` builds and loads every
  kernel library, then runs every tick, spec and prefill bucket the loop
  can dispatch once, so no nvcc run, library load, shared-memory opt-in or
  allocator growth lands inside a request; `compile_cache` names the
  directory the kernels are built into and loaded from (a later process
  reuses its libraries: the counterpart of JAX's persistent compilation
  cache);
- the **pipelined loop** (rama_tpu's `_loop_once`, engine.py:1729-1862): up
  to `_PIPELINE_DEPTH` plain or spec ticks in flight, each successor
  dispatched from the device-resident tokens (`_dispatch_chained`) or
  (tokens, pos, hist) carries (`_dispatch_spec_chained`) of the tick before
  it, and each tick's results fetched one tick behind (`_process_inflight`,
  `_process_spec_inflight`); **async-firsts admission**: a queued request's
  prefill is dispatched behind the in-flight ticks (`_admit_dispatch`, its
  slot marked `prefilling`) and its first token fetched and emitted once
  they drain (`_complete_admit_jobs`). No dispatch waits for the device: on
  the card every host array goes up through pinned memory without a stream
  sync (`_upload`), every fetch is a copy into pinned memory behind a
  recorded event that the processing step waits on (`_start_fetch`,
  `_fetched`), and the sampler picks its walk on the device.

Not ported yet (ROADMAP.md): chunked prefill, tensor/data/sequence
parallelism (the paged pool's dp sharding with it), multi-host. Their
EngineConfig fields raise NotImplementedError when set.

Threading: one engine thread owns the device loop; request queues bridge to
the async server. Tokens stream per request through `Request.queue`.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field, fields
from typing import Optional

import numpy as np
import torch

from rama_tpu_torch.config import EngineConfig, ModelConfig
from rama_tpu_torch.models.llama import (KVCache, QuantKVCache, _rope_tables, check_chunk,
                                         decode_step, forward, forward_chunk, fuse_params)
from rama_tpu_torch.ops.kernels import build, paged_attention
from rama_tpu_torch.ops.kernels.kv_write import write_kv_strips_q8
from rama_tpu_torch.ops.quant import cast_scales
from rama_tpu_torch.runtime.paged import (PageAllocator, PagedKVCache, QuantPagedKVCache,
                                          decode_step_paged, forward_paged,
                                          insert_prefill_paged)
from rama_tpu_torch.runtime.sampler import sample_batched_keyed, sample_greedy
from rama_tpu_torch.runtime.speculative import ngram_propose
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
    __slots__ = ("request", "pos", "generated", "last_token", "hist", "draft_pos",
                 "prefilling")

    def __init__(self):
        self.request: Request | None = None
        # assigned at admission dispatch, until its first token is fetched
        # (_complete_admit_jobs): no tick runs it meanwhile
        self.prefilling = False
        self.pos = 0
        self.generated = 0
        self.last_token = 0
        # token history (prompt + emitted; index p = input token at position
        # p, written up to pos), the n-gram drafter's source and the
        # draft-cache resync's
        self.hist: np.ndarray | None = None
        # draft mode: positions < draft_pos have their rows in the draft
        # model's cache; dormant plain ticks advance pos without it
        self.draft_pos = 0

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


# adaptive speculation (EngineConfig.spec_min_accept): plain ticks served
# while spec is dormant, and the minimum rolling-window size before a
# dormancy decision (rama_tpu/runtime/engine.py:143-147)
_SPEC_DORMANT_TICKS = 64
_SPEC_PROBE_ROUNDS = 8

# Dispatched-but-unfetched ticks kept in flight (the chain depth;
# rama_tpu/runtime/engine.py:149-155). One tick in flight only hides the
# ~25 ms host round-trip when a dispatch's device time exceeds it; short
# ticks / small batches starve the device in the dispatch gap (measured:
# b=1 int4 spec dispatches at ~33 ms device lost to plain, b=8 plain at
# ~87 ms did not). Three keeps the device fed through one full round-trip
# of jitter either side.
_PIPELINE_DEPTH = 3

_UNPORTED = (
    # (field, value when off, ROADMAP item)
    ("prefill_chunk", 0, "chunked prefill"),
    ("tp_size", 1, "tensor/data/sequence parallelism"),
    ("dp_size", 1, "tensor/data/sequence parallelism"),
    ("seq_par", False, "tensor/data/sequence parallelism"),
)


def _copy_strips(cache: KVCache, scratch: KVCache, slots: list[int], t_ins: int) -> None:
    """Rows 0:t_ins of scratch strip j -> slot slots[j] of a dense cache."""
    for j, slot_idx in enumerate(slots):
        cache.k[:, slot_idx, :, :t_ins].copy_(scratch.k[:, j, :, :t_ins])
        cache.v[:, slot_idx, :, :t_ins].copy_(scratch.v[:, j, :, :t_ins])


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
                 engine_config: EngineConfig | None = None, draft=None):
        """draft: (draft_cfg, draft_params) for spec_mode "draft" — a small
        resident model that proposes the spec tick's tokens instead of the
        n-gram lookup."""
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.ecfg = engine_config or EngineConfig()
        check_ported(self.ecfg)
        if self.ecfg.compile_cache:
            # the kernels' build directory, as JAX's engine enables its
            # persistent compilation cache (engine.py:603-606)
            build.set_build_dir(self.ecfg.compile_cache)
        self.kv_quant = self.ecfg.kv_quant
        if self.kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant {self.kv_quant!r}")
        b = self.ecfg.max_batch_size
        self.max_len = self.ecfg.max_seq_len or cfg.seq_len
        self.device = params["final_norm"].device
        # activations and the cache share the params' float dtype (the JAX
        # engine keeps a bf16 cache under fp32 params; the kernels here
        # take one dtype per call)
        self.dtype = params["final_norm"].dtype
        self.spec = self.ecfg.spec_tick
        # rounds per spec tick, clamped down to a power of two
        r = max(1, self.ecfg.spec_rounds)
        self.spec_rounds = 1 << (r.bit_length() - 1)
        self.spec_mode = self.ecfg.spec_mode
        if self.spec_mode not in ("ngram", "draft"):
            raise ValueError(f"unknown spec_mode {self.spec_mode!r}")
        self.draft_mode = bool(self.spec) and self.spec_mode == "draft"
        if self.draft_mode and draft is None:
            raise ValueError("spec_mode='draft' requires draft=(draft_cfg, draft_params)")
        if self.spec:
            check_chunk(cfg, self.spec + 1, self.device)   # the verification chunk
        self.paged = self.ecfg.paged_kv
        if self.paged:
            ps = self.ecfg.kv_page_size
            self.pages_per_slot = -(-self.max_len // ps)
            # one extra "trash" page absorbs the unconditional KV writes of
            # free slots, so stale table rows never touch a live page
            self.trash_page = self.ecfg.kv_num_pages or b * self.pages_per_slot
            self._check_paged(cfg, ps)
        # the target's stored weight scales in scale_dtype; the draft's stay
        # as loaded, as in the JAX engine (engine.py:693-699)
        self.params = self._serving_params(cfg, params, self.ecfg.scale_dtype)
        self.cache = self._create_cache(b)
        self.dcfg = self.dparams = self.dcache = None
        if self.draft_mode:
            self.dcfg = draft[0]
            self.dparams = self._serving_params(self.dcfg, draft[1])
            self.dcache = self._create_draft_cache(b)
        self.slots = [_Slot() for _ in range(b)]
        # per-slot history capacity: sized so spec-round writes (<= max_len)
        # always fit
        self._hist_cap = self.max_len + max(self.spec, 1) + 1
        # bounded admission queue — reference uses bounded(30), main.rs:68
        self.admission: "queue.Queue[Request]" = queue.Queue(maxsize=30)
        # per-slot stream keys (two uint32 from (seed, request counter))
        self.slot_keys = np.zeros((b, 2), np.int64)
        self.req_counter = 0
        # adaptive speculation: rolling per-round accept fractions; below
        # spec_min_accept, spec goes dormant for _SPEC_DORMANT_TICKS plain
        # ticks, then probes again
        self._spec_window: "deque[float]" = deque(maxlen=64)
        self._spec_dormant = 0
        # the pipeline: dispatched-but-unfetched plain and spec ticks, the
        # admissions whose first tokens are not fetched yet, and the last
        # spec tick's device carries (tokens, pos, hist)
        self._inflight_q: deque = deque()
        self._spec_inflight_q: deque = deque()
        self._admit_jobs: list = []
        self._last_spec = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        self.phases = PhaseTimer()
        self.metrics = {
            "tokens_generated": 0,
            "tick_tokens": 0,       # emitted by decode / spec ticks only
            "requests_completed": 0,
            "engine_errors": 0,
            "ttft_ms": [],          # recent TTFTs
            "decode_ticks": 0,
            "decode_s": 0.0,
            "spec_drafted": 0,
            "spec_accepted": 0,
            "spec_dormancies": 0,   # times spec went dormant
            "draft_resyncs": 0,     # draft-cache gap replays
        }

    def _serving_params(self, cfg: ModelConfig, params, scale_dtype: str | None = None):
        """Fused params with RoPE tabulated out to the cache length
        (long-context serving), and with scale_dtype "bf16" every quantized
        leaf's scales stored in bf16 (cast after fusing, as
        rama_tpu/runtime/engine.py:693-699 does)."""
        params = dict(params)
        if params["rope_cos"].shape[0] < self.max_len:
            params["rope_cos"], params["rope_sin"] = _rope_tables(
                cfg, self.device, seq_len=self.max_len)
        params = fuse_params(params, cfg)
        if scale_dtype:
            if scale_dtype != "bf16":
                raise ValueError(f"unsupported scale_dtype {scale_dtype!r}")
            params = cast_scales(params, torch.bfloat16)
        return params

    def _create_draft_cache(self, batch: int) -> KVCache:
        return KVCache.create(self.dcfg, batch=batch, max_len=self.max_len,
                              dtype=self.dparams["final_norm"].dtype, device=self.device)

    def _check_paged(self, cfg: ModelConfig, ps: int) -> None:
        """On the card every paged tick runs the fused path through K12 /
        K13: raise here, naming the limit, for a page size, head_dim or GQA
        group the kernels do not take (they take any verification chunk)."""
        if self.device.type == "cpu":
            return
        paged_attention.check(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, ps,
                              self.kv_quant == "int8")

    def _create_cache(self, batch: int):
        """The slot cache, or the page pool (and a fresh allocator and
        all-trash page tables) in paged mode."""
        if self.paged:
            ps = self.ecfg.kv_page_size
            self.allocator = PageAllocator(self.trash_page, ps, batch)
            self.page_tables = np.full((batch, self.pages_per_slot), self.trash_page, np.int32)
            if self.kv_quant == "int8":
                return QuantPagedKVCache.create(self.cfg, self.trash_page + 1, ps,
                                                device=self.device)
            return PagedKVCache.create(self.cfg, self.trash_page + 1, ps, dtype=self.dtype,
                                       device=self.device)
        if self.kv_quant == "int8":
            return QuantKVCache.create(self.cfg, batch=batch, max_len=self.max_len,
                                       device=self.device)
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

    @torch.no_grad()
    def warmup(self, max_prompt: int | None = None) -> dict:
        """Run once every device path the serving loop can dispatch, before
        any traffic (rama_tpu's Engine.warmup, engine.py:936-1060). On the
        card it first builds and loads every kernel library
        (`build.load_all`: no nvcc run and no library load after it). Then
        the decode ticks at n = decode_tick halved down to 1, the spec
        ticks at m = spec_rounds halved down to 1, and every (k_pad, t_pad)
        prefill bucket `_start_requests` can emit (t_pad from 16 doubling
        up to min(max_prompt + 1, max_len), capped at max_len; max_prompt
        None: up to max_len), each through `_dev_prefill_insert` and, in
        draft mode, `_dev_draft_prefill`. Each runs greedy, then sampled at
        temperature 1 and top_p 1 (which takes the top-k, the full sort and
        the nucleus walk): the port's two sampling routes are separate
        code, where JAX's one program covers both. Each dispatch pays the
        one-time costs of its launches (a launcher's shared-memory opt-in,
        the split-K ticket buffer, the caching allocator's growth to the
        bucket's peak, each PyTorch kernel's first load) and ends in a
        device sync.

        Dummy traffic from position 0: the ticks write every slot's
        first rows (as free slots' rows are written while serving), the
        prefill buckets slot 0's; warmup then zeroes the dense caches (the
        target's and the draft's), so serving starts on a fresh cache. On a
        page pool every page-table row points at the trash page, which
        takes every write, and no page is reserved. The draft resync is not
        warmed, as in JAX: after warmup it builds and loads no library.
        Call it on an idle engine, before start(). Returns {"programs": the
        dispatches, counted as JAX counts its programs, "seconds": wall}."""
        if self._thread is not None or not all(s.free for s in self.slots):
            raise RuntimeError("warmup runs on an idle engine, before start()")
        t0 = time.time()
        if self.device.type == "cuda":
            build.load_all()
        b = len(self.slots)
        zi = np.zeros(b, np.int64)

        def routes(rows: int):
            """(temperatures, top_ps) of the greedy and the sampled route."""
            return ((np.zeros(rows, np.float32), np.full(rows, 0.9, np.float32)),
                    (np.ones(rows, np.float32), np.ones(rows, np.float32)))

        count = 0
        n = max(1, self.ecfg.decode_tick)   # the budget shrink: powers of two <= the tick
        while True:
            for temps, tps in routes(b):
                self._dev_tick(zi, zi, temps, tps, n)
            count += 1
            if n == 1:
                break
            n //= 2
        if self.spec:
            m = self.spec_rounds            # the m-shrink ladder
            while True:
                for temps, tps in routes(b):
                    self._dev_spec_tick(zi, zi, temps, tps, self._hist_matrix(), self.spec, m)
                    self._sync()
                count += 1
                if m == 1:
                    break
                m //= 2
        hi = min((max_prompt or self.max_len) + 1, self.max_len)
        ts, t = [], 16
        while True:
            ts.append(min(t, self.max_len))
            if t >= hi:
                break
            t *= 2
        for t_pad in ts:
            for k_pad in sorted({_bucket_k(nn, 1, b, t_pad) for nn in range(1, b + 1)}):
                tokens = np.zeros((k_pad, t_pad), np.int64)
                lens = np.ones(k_pad, np.int32)
                for temps, tps in routes(k_pad):
                    self._dev_prefill_insert(tokens, lens, temps, tps,
                                             np.zeros((k_pad, 2), np.int64), [0])
                    self._sync()
                count += 1
                if self.draft_mode:
                    self._dev_draft_prefill(tokens, lens, [0])
                    self._sync()
                    count += 1
        for cache in (self.cache, self.dcache):
            if isinstance(cache, (KVCache, QuantKVCache)):
                for f in fields(cache):
                    getattr(cache, f.name).zero_()
        self._last_spec = None
        self._sync()
        return {"programs": count, "seconds": time.time() - t0}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- host <-> device without a stream sync ---------------------------------

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On the card the copy goes
        from pinned memory with non_blocking, so the dispatch never waits
        for the stream (a pageable copy ends in a stream sync); PyTorch's
        caching host allocator keeps the pinned block until the copy ran,
        and the copy is a snapshot of the array as it is now (the page
        tables change while ticks are in flight)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _start_fetch(self, t: torch.Tensor):
        """Queue the copy of device tensor t into pinned host memory behind
        the work that makes it, and an event after it: (host tensor, event
        or None on the CPU). `_fetched` waits for the event."""
        if t.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _fetched(fetch) -> np.ndarray:
        """The host copy of a `_start_fetch`, once the device has made it."""
        host, done = fetch
        if done is not None:
            done.synchronize()
        return host.numpy()

    # -- admission ------------------------------------------------------------

    def _admit(self):
        """Admit every queued request a free slot exists for, prefilling the
        burst in one padded (k, T) forward per area-capped group, and emit
        the first tokens."""
        self._admit_dispatch()
        self._complete_admit_jobs()

    def _admit_dispatch(self):
        """Dispatch-side half of admission (rama_tpu's _admit_dispatch):
        grab free slots and dispatch the batched prefill(s). The first
        tokens stay on the device in self._admit_jobs until
        _complete_admit_jobs fetches and emits them, so the dispatch can
        queue behind in-flight ticks (async-firsts admission)."""
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
            for i, slot, req in batch:
                self._release_pages(i)
                slot.request = None
                slot.prefilling = False
                if req.error is None:
                    req.error = "engine error during prefill"
                    req.queue.put(None)

    def _complete_admit_jobs(self):
        """Fetch the first tokens of every dispatched-but-unfetched prefill
        group (waits until the device has made them) and emit them. Entries
        whose slot was reassigned or failed since dispatch are skipped."""
        while self._admit_jobs:
            job = self._admit_jobs.pop(0)
            firsts = self._fetched(job["firsts"])
            for j, (slot_idx, slot, req, ids, key) in enumerate(job["entries"]):
                if slot.request is not req:
                    continue
                slot.prefilling = False
                slot.last_token = int(firsts[j])
                if req.echo_prompt:
                    # the reference stream re-emits prompt tokens while forcing
                    # them (mod.rs:227-241)
                    for t in req.prompt_ids:
                        req.queue.put(self.tokenizer.decode_token(t))
                self._emit(slot, slot.last_token)

    def _start_requests(self, batch):
        entries = []
        for slot_idx, slot, req in batch:
            ids = [BOS_ID] + req.prompt_ids
            key = np.random.default_rng((self.ecfg.seed, self.req_counter)).integers(
                0, 1 << 32, size=2, dtype=np.uint32)
            self.req_counter += 1
            if self.paged and not self._reserve(slot_idx, min(_bucket(len(ids)),
                                                              self.max_len)):
                # out of pages: an error event for this request alone, not
                # a silent empty stream
                req.error = "out of KV cache pages"
                req.queue.put(None)
                continue
            entries.append((slot_idx, slot, req, ids, key))
        if not entries:
            return
        t_all = min(_bucket(max(len(e[3]) for e in entries)), self.max_len)
        c = _prefill_k_cap(t_all)
        for i in range(0, len(entries), c):
            self._dispatch_prefill_group(entries[i:i + c])

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

    def _dispatch_prefill_group(self, entries):
        tokens, true_lens, temps, top_ps, keys = self._pad_entries(entries)
        slots = [e[0] for e in entries]
        with self.phases.phase("prefill"):
            firsts = self._start_fetch(
                self._dev_prefill_insert(tokens, true_lens, temps, top_ps, keys, slots))
            if self.draft_mode:
                self._dev_draft_prefill(tokens, true_lens, slots)
        for slot_idx, slot, req, ids, key in entries:
            self.slot_keys[slot_idx] = key
            # the slot is assigned at dispatch (prefilling until its first
            # token is fetched), so a second dispatch cannot take it
            slot.request = req
            slot.prefilling = True
            slot.pos = len(ids)            # next decode position
            slot.draft_pos = len(ids)      # draft cache rows 0..len-1 written
            slot.generated = 0
            # _emit writes every emitted token at its position, `first` included
            slot.hist = np.zeros(self._hist_cap, np.int64)
            slot.hist[: len(ids)] = ids
        self._admit_jobs.append({"entries": entries, "firsts": firsts})

    @torch.no_grad()
    def _dev_prefill_insert(self, tokens, true_lens, temps, top_ps, keys,
                            slots: list[int]) -> torch.Tensor:
        """Batched (k, T) prefill into a scratch cache, first-token sampling
        at each row's last real query (position true_lens-1, keyed like the
        decode ticks), then the scratch rows copied into the slots — for an
        int8 cache quantized and inserted by the strip writer, every slot
        and layer in one launch. The scratch is in the activation dtype
        (the JAX engine's is bf16 whatever the params). Returns the (k,)
        first tokens on the device, unfetched."""
        t_pad = tokens.shape[1]
        lens = self._upload(true_lens)
        last, scratch = self._prefill_scratch(self.params, self.cfg, tokens, lens)
        if (temps > 0).any():
            firsts = sample_batched_keyed(last[:, 0], self._upload(keys), lens.long() - 1,
                                          self._upload(temps), self._upload(top_ps))
        else:
            firsts = sample_greedy(last[:, 0])
        if self.paged:
            # the group's real entries only: pad rows duplicate the last one
            insert_prefill_paged(self.cache, scratch.k, scratch.v,
                                 self._upload(self.page_tables[slots]),
                                 min(t_pad, self.pages_per_slot * self.cache.page_size))
            return firsts
        t_ins = min(t_pad, self.max_len)
        if isinstance(self.cache, QuantKVCache):
            c = self.cache
            write_kv_strips_q8(c.k, c.v, c.ks, c.vs, scratch.k, scratch.v,
                               self._upload(np.asarray(slots, np.int32)), t_ins)
        else:
            _copy_strips(self.cache, scratch, slots, t_ins)
        return firsts

    def _prefill_scratch(self, params, cfg: ModelConfig, tokens: np.ndarray,
                         lens: torch.Tensor):
        """Prefill the padded (k, T) prompts into a scratch cache of the
        params' dtype. Returns (logits at each row's last real query
        (k, 1, V), scratch)."""
        dev = self.device
        k, t_pad = tokens.shape
        scratch = KVCache.create(cfg, batch=k, max_len=t_pad,
                                 dtype=params["final_norm"].dtype, device=dev)
        idx = torch.arange(t_pad, device=dev)[None, :]
        # padded positions write the last scratch row; no real query sees it
        pos_index = torch.where(idx < lens[:, None], idx, t_pad - 1)
        return forward(params, cfg, self._upload(tokens), pos_index, scratch,
                       plen=lens, logit_rows=lens.long() - 1)

    @torch.no_grad()
    def _dev_draft_prefill(self, tokens, true_lens, slots: list[int]) -> None:
        """Draft mode: prefill the DRAFT model over the same padded prompts
        and copy its rows into the slots of the draft cache (the draft must
        see the prompt before it can propose; rama_tpu's
        _draft_prefill_insert)."""
        t_ins = min(tokens.shape[1], self.max_len)
        _, scratch = self._prefill_scratch(self.dparams, self.dcfg, tokens,
                                           self._upload(true_lens))
        _copy_strips(self.dcache, scratch, slots, t_ins)

    # -- decode -----------------------------------------------------------------

    def _dev_tick(self, tokens, pos, temps, tps, n: int) -> np.ndarray:
        """Blocking decode tick (fetches the sampled tokens); warmup's."""
        return self._fetched(self._start_fetch(self._dev_tick_async(tokens, pos, temps, tps, n)))

    @torch.no_grad()
    def _dev_tick_async(self, tokens, pos, temps, tps, n: int) -> torch.Tensor:
        """n sampled decode steps for all slots; the sampled tokens feed the
        next step on the device. Returns the DEVICE (n, B) tokens without
        waiting for them: the last row feeds a chained successor tick.
        `tokens` may be a host array or a device row of an earlier tick's
        output; the page tables go up as they are now."""
        tok = tokens if isinstance(tokens, torch.Tensor) else self._upload(tokens)
        p = self._upload(pos)
        sampled = bool((temps > 0).any())
        if sampled:
            keys = self._upload(self.slot_keys)
            t = self._upload(temps)
            tp = self._upload(tps)
        tables = self._device_tables()
        outs = []
        for _ in range(n):
            if self.paged:
                logits, self.cache = decode_step_paged(self.params, self.cfg, tok, p, self.cache,
                                                       tables)
            else:
                logits, self.cache = decode_step(self.params, self.cfg, tok, p, self.cache)
            tok = (sample_batched_keyed(logits, keys, p, t, tp) if sampled
                   else sample_greedy(logits))
            outs.append(tok)
            p = p + 1
        return torch.stack(outs)

    def _emit(self, slot: _Slot, token: int):
        req = slot.request
        if req.first_token_at is None:
            req.first_token_at = time.time()
            self.metrics["ttft_ms"].append(
                (req.first_token_at - req.submitted_at) * 1000.0)
            del self.metrics["ttft_ms"][:-256]
        slot.generated += 1
        req.tokens_out += 1
        if slot.pos < len(slot.hist):
            slot.hist[slot.pos] = token
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
        slot.prefilling = False
        self._release_pages(self.slots.index(slot))
        self.metrics["requests_completed"] += 1

    # -- the page pool ------------------------------------------------------------

    def _reserve(self, i: int, rows: int) -> bool:
        """Grow slot i's pages to cover `rows` positions and copy its table
        into the page tables; False (nothing reserved) if the pool is out of
        pages."""
        if self.allocator.reserve(i, rows) < 0:
            return False
        table = self.allocator.table(i)
        self.page_tables[i, : len(table)] = table
        return True

    def _release_pages(self, i: int) -> None:
        """Slot i's pages back to the pool, its table row onto the trash page."""
        if self.paged:
            self.allocator.release(i)
            self.page_tables[i, :] = self.trash_page

    def _reserve_tick_pages(self, pos: np.ndarray, n: int, finish_on_fail: bool) -> bool:
        """Grow every active slot's table to cover the n positions a tick
        writes (rama_tpu's _reserve_tick_pages, engine.py:2060). False if a
        slot cannot be grown: with finish_on_fail that slot's request ends
        with "out of KV cache pages" (a fresh dispatch), otherwise the
        caller declines to chain and the next fresh dispatch handles it."""
        if not self.paged:
            return True
        ok = True
        for i, s in enumerate(self.slots):
            if not s.free and not self._reserve(i, min(int(pos[i]) + n, self.max_len)):
                ok = False
                if finish_on_fail:
                    s.request.error = "out of KV cache pages"
                    self._finish(s)
        return ok

    def _device_tables(self) -> torch.Tensor | None:
        """This dispatch's snapshot of the page tables (None: dense)."""
        return self._upload(self.page_tables) if self.paged else None

    @contextlib.contextmanager
    def _tick_phase(self, name: str):
        """A tick's "dispatch" or "fetch" phase, its host time also counted
        in decode_s. rama_tpu counts the fetch alone (engine.py:2040-2045),
        its dispatch being asynchronous; the port's dispatch launches the
        tick's kernels from the host, so decode_s counts both, and
        decode_tok_per_s stays tick tokens over the host time of ticks."""
        t0 = time.time()
        with self.phases.phase(name):
            yield
        self.metrics["decode_s"] += time.time() - t0

    def _reqs(self) -> list:
        """Each slot's request as a dispatch sees it (None: free or
        prefilling); processing discards the rows of a slot whose request
        changed since."""
        return [None if s.prefilling else s.request for s in self.slots]

    def _loop(self):
        # a device-loop error fails the in-flight requests, rebuilds the
        # (possibly half-written) cache, and keeps serving
        while not self._stop.is_set():
            try:
                self._loop_once()
            except Exception:  # noqa: BLE001 — engine thread must survive
                traceback.print_exc()
                self.metrics["engine_errors"] += 1
                self._inflight_q.clear()
                self._spec_inflight_q.clear()
                self._admit_jobs.clear()  # their slots finish below
                self._last_spec = None
                for s in self.slots:
                    if not s.free:
                        s.prefilling = False
                        s.request.error = "engine error during decode"
                        self._finish(s)
                self.cache = self._create_cache(len(self.slots))
                if self.draft_mode:
                    self.dcache = self._create_draft_cache(len(self.slots))
        # graceful stop: the in-flight ticks' tokens and the async-admitted
        # first tokens reach their streams instead of vanishing with the
        # thread (engine.py:1654-1697)
        while self._inflight_q:
            try:
                self._process_inflight(self._inflight_q.popleft())
            except Exception:  # noqa: BLE001
                self._inflight_q.clear()
        while self._spec_inflight_q:
            try:
                self._process_spec_inflight(self._spec_inflight_q.popleft())
            except Exception:  # noqa: BLE001
                self._spec_inflight_q.clear()
        try:
            self._complete_admit_jobs()
        except Exception:  # noqa: BLE001
            self._admit_jobs.clear()

    def _loop_once(self):
        """One iteration of rama_tpu's pipelined loop (engine.py:1729-1862):
        while tick k's tokens are still on the device, ticks k+1.. are
        dispatched from its device output (up to _PIPELINE_DEPTH in
        flight), then k's tokens are fetched and emitted, so the host's
        fetch, emit and next dispatch overlap device work. The chain breaks
        whenever host state must reach the next tick (a queued admission,
        engine stop)."""
        if self._inflight_q or self._spec_inflight_q:
            # async-firsts admission: the prefill queues behind the in-flight
            # ticks; its first tokens stay on the device until the drain, and
            # no tick chains meanwhile (_chain_ok) so none lands after the
            # insert with stale rows
            if (self.admission.qsize() > 0 and not self._admit_jobs
                    and not self._stop.is_set()):
                with self.phases.phase("admit"):
                    self._admit_dispatch()
        if self._inflight_q:
            while len(self._inflight_q) < _PIPELINE_DEPTH and self._chain_ok():
                nxt = self._dispatch_chained(self._inflight_q[-1])
                if nxt is None:
                    break
                self._inflight_q.append(nxt)
            self._process_inflight(self._inflight_q.popleft())
            if self._inflight_q:
                return
        if self._spec_inflight_q:
            while len(self._spec_inflight_q) < _PIPELINE_DEPTH and self._spec_chain_ok():
                nxt = self._dispatch_spec_chained(self._spec_inflight_q[-1])
                if nxt is None:
                    break
                self._spec_inflight_q.append(nxt)
            self._process_spec_inflight(self._spec_inflight_q.popleft())
            if self._spec_inflight_q:
                return
        with self.phases.phase("admit"):
            self._admit()
        active = [s for s in self.slots if not s.free and not s.prefilling]
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
            if s.free or s.prefilling:
                continue
            tokens[i] = s.last_token
            pos[i] = s.pos
            temps[i] = s.request.temperature
            tps[i] = s.request.top_p
        # a spec tick of m rounds (engine.py:1815-1828): every chunk position
        # stays < max_len (pos + m(k+1) <= max_len), and m halves while half
        # of it still covers the tightest remaining budget (each round emits
        # at least one token); m = 0 (dormant, or no room) serves a plain tick
        k = self.spec
        m = self.spec_rounds if (k and not self._spec_dormant) else 0
        if m:
            worst = max(s.pos for s in active)
            while m and worst + m * (k + 1) > self.max_len:
                m //= 2
            remaining = min(s.request.steps - s.generated for s in active)
            while m > 1 and m // 2 >= remaining:
                m //= 2
        if m:
            self._reserve_tick_pages(pos, m * (k + 1), finish_on_fail=True)
            if self.draft_mode:
                with self.phases.phase("draft_resync"):
                    self._maybe_draft_resync()
            with self._tick_phase("dispatch"):
                out = self._dev_spec_tick(tokens, pos, temps, tps, self._hist_matrix(), k, m)
            self._spec_inflight_q.append(
                {"fetch": self._start_fetch(out), "pos": pos, "m": m, "k": k, "temps": temps,
                 "tps": tps, "carry": self._last_spec, "gen_ahead": m * (k + 1),
                 "reqs": self._reqs()})
            return
        # shrink the tick so no slot overshoots its remaining budget by much
        n = self.ecfg.decode_tick
        remaining = min(s.request.steps - s.generated for s in active)
        while n > 1 and n // 2 >= remaining:
            n //= 2
        self._reserve_tick_pages(pos, n, finish_on_fail=True)
        with self._tick_phase("dispatch"):
            out = self._dev_tick_async(tokens, pos, temps, tps, n)
        self._inflight_q.append(
            {"out": out, "fetch": self._start_fetch(out), "n": n, "pos": pos, "temps": temps,
             "tps": tps, "gen_ahead": n, "reqs": self._reqs()})

    def _chain_ok(self) -> bool:
        """Dispatch plain tick k+1 from tick k's device tokens? Only when no
        host state change is pending (rama_tpu's _chain_ok): the admission
        queue is empty and no async-admitted prefill is unfetched (a chained
        tick after the insert would overwrite the new slot's rows),
        speculation is off or dormant (spec ticks chain through
        _dispatch_spec_chained), and the engine is not stopping."""
        return ((not self.spec or self._spec_dormant > 0)
                and self.admission.qsize() == 0
                and not self._admit_jobs
                and not self._stop.is_set())

    def _dispatch_chained(self, inf):
        """Dispatch the successor of in-flight tick `inf` (the newest)
        before fetching it. Tokens come from its device output (out[-1]),
        positions are its positions + n for the slots still serving the
        request they served then (0 for the rest), temperatures and top-ps
        its own. Slots that finish inside an in-flight tick waste their
        chained rows (discarded at emit; their KV writes land above any
        attended position). None: nothing worth chaining."""
        b = len(self.slots)
        pos = np.zeros(b, np.int64)
        act = []
        for i, s in enumerate(self.slots):
            if not s.free and s.request is inf["reqs"][i]:
                pos[i] = inf["pos"][i] + inf["n"]
                act.append(s)
        if not act:
            return None
        # assume every in-flight tick emits fully: gen_ahead counts the
        # whole unfetched pipeline, not just the newest tick
        remaining = min(s.request.steps - (s.generated + inf["gen_ahead"]) for s in act)
        if remaining <= 0:
            return None
        n = self.ecfg.decode_tick
        while n > 1 and n // 2 >= remaining:
            n //= 2
        if not self._reserve_tick_pages(pos, n, finish_on_fail=False):
            return None
        with self._tick_phase("dispatch"):
            out = self._dev_tick_async(inf["out"][-1], pos, inf["temps"], inf["tps"], n)
        return {"out": out, "fetch": self._start_fetch(out), "n": n, "pos": pos,
                "temps": inf["temps"], "tps": inf["tps"], "reqs": inf["reqs"],
                "gen_ahead": inf["gen_ahead"] + n}

    def _process_inflight(self, inf):
        """Fetch in-flight tick `inf`'s tokens (waits until the device has
        made them) and emit them. Slots whose request changed since
        dispatch discard their rows."""
        with self._tick_phase("fetch"):
            out = self._fetched(inf["fetch"])                   # (n, B)
        self.metrics["decode_ticks"] += 1
        if self._spec_dormant > 0:
            self._spec_dormant -= 1  # count down to the next spec probe
        with self.phases.phase("emit"):
            for i, s in enumerate(self.slots):
                if s.free or s.request is not inf["reqs"][i]:
                    continue
                for j in range(out.shape[0]):
                    s.pos += 1
                    s.last_token = int(out[j, i])
                    self.metrics["tick_tokens"] += 1
                    self._emit(s, s.last_token)
                    if s.free:  # finished mid-tick; drop the overshoot
                        break

    # -- speculation --------------------------------------------------------

    def _spec_chain_ok(self) -> bool:
        """Dispatch spec tick k+1 from tick k's device carries? The host
        conditions of _chain_ok without the speculation one (rama_tpu's
        _spec_chain_ok)."""
        return bool(self.spec and self.admission.qsize() == 0
                    and not self._admit_jobs
                    and not self._stop.is_set())

    def _dispatch_spec_chained(self, inf):
        """Dispatch the successor of in-flight spec tick `inf` (the newest)
        from its device carries (tokens, pos, hist). The host knows only
        the worst-case positions (every round fully accepted), so the
        m-shrink and the page reservation use those: conservative, never
        unsafe. A slot no longer serving its request restarts at position
        0, as a free slot does in a fresh dispatch. None: nothing worth
        chaining."""
        if inf["carry"] is None:
            return None
        k = inf["k"]
        b = len(self.slots)
        act = [(i, s) for i, s in enumerate(self.slots)
               if not s.free and s.request is inf["reqs"][i]]
        if not act:
            return None
        pos_wc = np.zeros(b, np.int64)
        for i, _ in act:
            pos_wc[i] = inf["pos"][i] + inf["m"] * (k + 1)
        m = self.spec_rounds
        worst = max(pos_wc[i] for i, _ in act)
        while m and worst + m * (k + 1) > self.max_len:
            m //= 2
        if not m:
            return None
        remaining = min(s.request.steps - (s.generated + inf["gen_ahead"]) for _, s in act)
        if remaining <= 0:
            return None
        while m > 1 and m // 2 >= remaining:
            m //= 2
        if not self._reserve_tick_pages(pos_wc, m * (k + 1), finish_on_fail=False):
            return None
        toks_d, pos_d, hist_d = inf["carry"]
        live = np.zeros(b, np.int64)
        live[[i for i, _ in act]] = 1
        with self._tick_phase("dispatch"):
            out = self._dev_spec_tick(toks_d, pos_d * self._upload(live), inf["temps"],
                                      inf["tps"], hist_d, k, m)
        return {"fetch": self._start_fetch(out), "pos": pos_wc, "m": m, "k": k,
                "temps": inf["temps"], "tps": inf["tps"], "carry": self._last_spec,
                "reqs": inf["reqs"], "gen_ahead": inf["gen_ahead"] + m * (k + 1)}

    def _process_spec_inflight(self, inf):
        """Fetch in-flight spec tick `inf`'s samples and accepts (waits until
        the device has made them) and emit, round by round, each round's
        accepted drafts plus the token after them; a slot that finishes
        drops the rest, and slots whose request changed since dispatch
        discard their rows. Then the accept-rate bookkeeping and adaptive
        dormancy (rama_tpu's _process_spec_inflight): below
        spec_min_accept over the last rounds plain ticks serve faster, so
        spec sleeps for _SPEC_DORMANT_TICKS."""
        k = inf["k"]
        with self._tick_phase("fetch"):
            out = self._fetched(inf["fetch"])                   # (m, B, k + 2)
        self.metrics["decode_ticks"] += 1
        samples, accepts = out[..., :k + 1], out[..., k + 1]
        with self.phases.phase("emit"):
            for r in range(inf["m"]):
                drafted = accepted = 0
                for i, s in enumerate(self.slots):
                    if s.free or s.request is not inf["reqs"][i]:
                        continue
                    a = int(accepts[r, i])
                    drafted += k
                    accepted += a
                    for j in range(a + 1):
                        s.pos += 1
                        s.last_token = int(samples[r, i, j])
                        self.metrics["tick_tokens"] += 1
                        self._emit(s, s.last_token)
                        if s.free:
                            break
                self.metrics["spec_drafted"] += drafted
                self.metrics["spec_accepted"] += accepted
                if drafted:
                    self._spec_window.append(accepted / drafted)
        if self.draft_mode:
            # the rounds' draft steps wrote rows through each slot's position
            # (engine.py:2016-2021)
            for i, s in enumerate(self.slots):
                if not s.free and s.request is inf["reqs"][i]:
                    s.draft_pos = s.pos
        thr = self.ecfg.spec_min_accept
        if (thr > 0 and len(self._spec_window) >= _SPEC_PROBE_ROUNDS
                and sum(self._spec_window) / len(self._spec_window) < thr):
            self._spec_dormant = _SPEC_DORMANT_TICKS
            self._spec_window.clear()
            self.metrics["spec_dormancies"] += 1

    def _hist_matrix(self) -> np.ndarray:
        """(B, cap + 1) token histories by position (zeros for free slots);
        the last column takes the round's writes past a history's end."""
        h = np.zeros((len(self.slots), self._hist_cap + 1), np.int64)
        for i, s in enumerate(self.slots):
            if not s.free:
                h[i, : self._hist_cap] = s.hist
        return h

    @torch.no_grad()
    def _dev_spec_tick(self, tokens, pos, temps, tps, hist, k: int, m: int) -> torch.Tensor:
        """m speculative rounds for all slots on the device; tokens, positions
        and histories stay tensors between rounds. Returns the DEVICE (m, B,
        k + 2) samples and accepts without waiting for them (columns 0..k
        the round's samples, column k + 1 its accept count) and keeps the
        final (tokens, pos, hist) carries in self._last_spec, from which a
        chained successor dispatches. `tokens` / `pos` / `hist` may be host
        arrays or an earlier tick's carries."""
        def dev(a):
            return a if isinstance(a, torch.Tensor) else self._upload(a)

        tok, p, h = dev(tokens), dev(pos), dev(hist)
        keys = t = tp = None
        if (temps > 0).any():
            keys = self._upload(self.slot_keys)
            t = self._upload(temps)
            tp = self._upload(tps)
        tables = self._device_tables()
        outs = []
        for _ in range(m):
            tok, p, samples, accept = self._spec_round(tok, p, h, keys, t, tp, k, tables)
            outs.append(torch.cat([samples, accept[:, None]], dim=1))
        self._last_spec = (tok, p, h)
        return torch.stack(outs)

    def _spec_round(self, tok, pos, hist, keys, temps, tps, k: int, tables=None):
        """One round (rama_tpu's _spec_round): draft k tokens per slot,
        verify the (B, k+1) chunk in one forward_chunk, sample every chunk
        position in one batched keyed call (rows repeated per slot, each
        position its own key), accept the drafts that equal the samples.
        Over the page pool (`tables`, paged mode) the chunk goes through
        forward_paged's fused path. The samples are written into the
        histories optimistically: rows past the accepted prefix lie above
        the proposer's window and are rewritten by the next round. Returns
        (next tokens, next positions, samples (B, k+1), accepts (B,))."""
        b = tok.shape[0]
        dev = tok.device
        drafts = (self._draft_propose(tok, pos, k) if self.draft_mode
                  else ngram_propose(hist, pos + 1, k))
        chunk = torch.cat([tok[:, None], drafts], dim=1)                # (B, k+1)
        cols = pos[:, None] + torch.arange(k + 1, device=dev)[None, :]  # chunk positions
        if tables is None:
            logits, self.cache = forward_chunk(self.params, self.cfg, chunk, pos, self.cache)
        else:
            logits, self.cache = forward_paged(self.params, self.cfg, chunk, cols, self.cache,
                                               tables)
        flat = logits.reshape(b * (k + 1), -1)
        if keys is None:
            samples = sample_greedy(flat)
        else:
            samples = sample_batched_keyed(
                flat, keys.repeat_interleave(k + 1, dim=0), cols.reshape(-1),
                temps.repeat_interleave(k + 1), tps.repeat_interleave(k + 1))
        samples = samples.reshape(b, k + 1)
        accept = (chunk[:, 1:] == samples[:, :k]).long().cumprod(dim=1).sum(dim=1)
        hist.scatter_(1, (cols + 1).clamp(max=hist.shape[1] - 1), samples)
        nxt = samples.gather(1, accept[:, None])[:, 0]
        return nxt, pos + accept + 1, samples, accept

    def _draft_propose(self, tok, pos, k: int) -> torch.Tensor:
        """k greedy proposals per slot from the draft model over its own
        cache, starting by re-processing the current token at its position.
        One step more than the proposals writes the last proposal's row, so
        after a full accept the draft cache has no hole at pos + k (the
        reference scans k steps and leaves one; the stream is the same
        either way, as the target verifies every draft)."""
        outs = []
        for i in range(k + 1):
            logits, self.dcache = decode_step(self.dparams, self.dcfg, tok, pos + i,
                                              self.dcache)
            tok = sample_greedy(logits)
            outs.append(tok)
        return torch.stack(outs[:k], dim=1)

    @torch.no_grad()
    def _maybe_draft_resync(self) -> None:
        """Replay every stale slot's emitted gap (positions draft_pos ..
        pos-1, left by dormant plain ticks) through the draft model in one
        padded (B, T) forward over its cache (rama_tpu's
        _maybe_draft_resync / _draft_resync). Padding repeats each slot's
        last position: identical rows, a harmless duplicate write."""
        stale = [s for s in self.slots if not s.free and s.draft_pos < s.pos]
        if not stale:
            return
        b = len(self.slots)
        span = max(s.pos - s.draft_pos for s in stale)
        t_pad = min(_bucket(span), self.max_len)
        tokens = np.zeros((b, t_pad), np.int64)
        pos_index = np.zeros((b, t_pad), np.int64)
        for i, s in enumerate(self.slots):
            if s.free:
                continue
            idx = np.minimum(s.draft_pos + np.arange(t_pad), s.pos - 1)
            tokens[i] = s.hist[idx]
            pos_index[i] = idx
            s.draft_pos = s.pos
        _, self.dcache = forward(self.dparams, self.dcfg, self._upload(tokens),
                                 self._upload(pos_index), self.dcache,
                                 logit_rows=torch.zeros(b, dtype=torch.int64, device=self.device))
        self.metrics["draft_resyncs"] += 1

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
            # tick-emitted tokens over the ticks' dispatch and fetch time
            # (host clock, _tick_phase); prefill-sampled firsts excluded
            "decode_tok_per_s": (m["tick_tokens"] / m["decode_s"]
                                 if m["decode_s"] else 0.0),
            "spec_accept_rate": (m["spec_accepted"] / m["spec_drafted"]
                                 if m["spec_drafted"] else None),
            "spec_dormant_ticks": self._spec_dormant if self.spec else None,
            "spec_dormancies": m["spec_dormancies"],
            "draft_resyncs": m["draft_resyncs"],
            "ttft_p50_ms": ttfts[len(ttfts) // 2] if ttfts else None,
            "ttft_p95_ms": ttfts[int(len(ttfts) * 0.95)] if ttfts else None,
            "phases": self.phases.stats(),
            "device": str(self.device),
        }
