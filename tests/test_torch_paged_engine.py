"""rama_tpu_torch's engine on the paged KV cache, on the CPU (fp32 tiny
model, page size 16, as tests/test_paged.py runs the JAX engine): greedy
streams equal the JAX paged engine's and the port's dense engine's on a
bf16 / f32 and an int8 pool; sampled streams equal the dense engine's;
n-gram and draft-model speculation over the pool give the spec-off
streams; page exhaustion ends a request with "out of KV cache pages";
free slots write only the trash page; every page returns to the free list;
a loop error rebuilds the pool and the allocator; the server wires
--paged / --page-size. Streams are compared exactly."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import torch_cfg, write_tokenizer_bin
from rama_tpu.config import EngineConfig as JEcfg
from rama_tpu.models import llama as jl
from rama_tpu.runtime.engine import Engine as JEngine
from rama_tpu.runtime.engine import Request as JRequest
from rama_tpu.testing.ref_model import random_params, tiny_config
from rama_tpu.tokenizer import Tokenizer as JTok
from rama_tpu_torch.config import EngineConfig
from rama_tpu_torch.models import llama as tl
from rama_tpu_torch.runtime.engine import Engine, Request
from rama_tpu_torch.runtime.paged import PagedKVCache, QuantPagedKVCache
from rama_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

PROMPTS = (("abc", 10), ("zq", 7), ("hello", 12))
PAGED = dict(paged_kv=True, kv_page_size=16)


def _vocab(n):
    return ["<unk>", "<s>", "</s>"] + [chr(ord("a") + i % 26) + ("" if i < 26 else str(i // 26))
                                      for i in range(n - 3)]


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_config(seq_len=64)
    np_params = random_params(jcfg, seed=61)
    cfg = torch_cfg(jcfg)
    params = tl.load_params(cfg, np_params, dtype=torch.float32, device="cpu")
    dj = tiny_config(dim=32, hidden_dim=96, n_layers=2, n_heads=2, n_kv_heads=2, seq_len=64)
    dparams = tl.load_params(torch_cfg(dj), random_params(dj, seed=77), dtype=torch.float32,
                             device="cpu")
    tok = Tokenizer(_vocab(cfg.vocab_size), [0.0] * cfg.vocab_size, max_token_length=4)
    return jcfg, np_params, cfg, params, (torch_cfg(dj), dparams), tok


def collect(req, timeout=120.0):
    out, deadline = [], time.time() + timeout
    while (t := req.queue.get(timeout=max(0.1, deadline - time.time()))) is not None:
        out.append(t)
    return out


def serve(engine, specs, temperature=0.0, cls=Request):
    engine.start()
    try:
        reqs = [cls(prompt=p, steps=n, temperature=temperature) for p, n in specs]
        for r in reqs:
            engine.submit(r)
        outs = [collect(r) for r in reqs]
    finally:
        engine.stop()
    return outs, reqs


def run(setup, ecfg, specs=PROMPTS, temperature=0.0, draft=None):
    _, _, cfg, params, _, tok = setup
    eng = Engine(cfg, params, tok, ecfg, draft=draft)
    outs, reqs = serve(eng, specs, temperature)
    assert all(r.error is None for r in reqs) and eng.stats()["engine_errors"] == 0
    return outs, eng


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_paged_greedy_equals_jax_paged_engine_and_dense(setup, kv_quant):
    """Greedy streams: port paged == JAX paged == port dense; the engine
    holds the pool the config asks for, with one trash page, and every
    page is free again after the last request."""
    jcfg, np_params, *_ = setup
    jeng = JEngine(jcfg, jl.load_params(jcfg, np_params, dtype=jnp.float32),
                   JTok(_vocab(jcfg.vocab_size), [0.0] * jcfg.vocab_size, max_token_length=4),
                   JEcfg(max_batch_size=3, kv_quant=kv_quant, **PAGED))
    want, _ = serve(jeng, PROMPTS, cls=JRequest)
    dense, _ = run(setup, EngineConfig(max_batch_size=3, kv_quant=kv_quant))
    got, eng = run(setup, EngineConfig(max_batch_size=3, kv_quant=kv_quant, **PAGED))
    assert got == want == dense
    assert isinstance(eng.cache, QuantPagedKVCache if kv_quant else PagedKVCache)
    assert eng.pages_per_slot == 4 and eng.trash_page == 12 and eng.cache.num_pages == 13
    assert eng.allocator.available() == 12
    assert (eng.page_tables == eng.trash_page).all()


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_paged_sampled_stream_equals_dense(setup, kv_quant):
    """Position-keyed sampling at temperature 0.9: the pool changes no
    token of the dense engine's sampled streams."""
    dense, _ = run(setup, EngineConfig(max_batch_size=3, kv_quant=kv_quant), temperature=0.9)
    got, _ = run(setup, EngineConfig(max_batch_size=3, kv_quant=kv_quant, **PAGED),
                 temperature=0.9)
    assert got == dense


@pytest.mark.parametrize("kv_quant,mode,temperature", [(None, "ngram", 0.0), ("int8", "ngram", 0.9),
                                                       (None, "draft", 0.7),
                                                       ("int8", "draft", 0.0)])
def test_speculation_over_the_pool_keeps_the_stream(setup, kv_quant, mode, temperature):
    """n-gram and draft-model speculation (spec_tick 3) over the pool emit
    the spec-off paged streams; the draft keeps its dense cache."""
    ecfg = dict(max_batch_size=3, kv_quant=kv_quant, **PAGED)
    off, _ = run(setup, EngineConfig(**ecfg), temperature=temperature)
    on, eng = run(setup, EngineConfig(**ecfg, spec_tick=3, spec_mode=mode),
                  temperature=temperature, draft=setup[4] if mode == "draft" else None)
    assert on == off and eng.metrics["spec_drafted"] > 0
    assert eng.allocator.available() == 12
    assert mode == "ngram" or isinstance(eng.dcache, tl.KVCache)


def test_paged_spec_greedy_equals_jax_paged_spec_engine(setup):
    jcfg, np_params, *_ = setup
    jeng = JEngine(jcfg, jl.load_params(jcfg, np_params, dtype=jnp.float32),
                   JTok(_vocab(jcfg.vocab_size), [0.0] * jcfg.vocab_size, max_token_length=4),
                   JEcfg(max_batch_size=3, spec_tick=3, **PAGED))
    want, _ = serve(jeng, PROMPTS, cls=JRequest)
    got, _ = run(setup, EngineConfig(max_batch_size=3, spec_tick=3, **PAGED))
    assert got == want


def test_page_exhaustion_ends_a_request_cleanly(setup):
    """A pool of one slot's pages for two slots: a request that cannot get
    its next tick's pages ends with "out of KV cache pages"; the engine
    keeps serving and every page is free again."""
    _, _, cfg, params, _, tok = setup
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=2, kv_num_pages=4, **PAGED))
    outs, reqs = serve(eng, [("abc", 60), ("zq", 30)])
    assert [r.error for r in reqs].count("out of KV cache pages") >= 1
    assert all(r.error in (None, "out of KV cache pages") for r in reqs)
    assert len(outs[0]) >= 1 and eng.stats()["engine_errors"] == 0
    assert eng.allocator.available() == 4


def test_admission_without_pages_is_refused(setup):
    """A pool smaller than one admission's bucket: the request ends at
    admission with "out of KV cache pages" and an empty stream."""
    _, _, cfg, params, _, tok = setup
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=2, kv_num_pages=1,
                                                kv_page_size=8, paged_kv=True))
    outs, reqs = serve(eng, [("abcdefghijklmnopq", 4), ("ab", 3)])
    assert outs[0] == [] and reqs[0].error == "out of KV cache pages"
    assert reqs[1].error in (None, "out of KV cache pages")
    assert eng.allocator.available() == 1


def test_free_slot_writes_land_on_the_trash_page(setup):
    """A short request finishing while a long one decodes leaves the long
    stream equal to a solo run (tests/test_paged.py:120-151); the finished
    slot's later writes land on the trash page, which is no live page."""
    solo, _ = run(setup, EngineConfig(max_batch_size=2, **PAGED), specs=[("abc", 20)])
    _, _, cfg, params, _, tok = setup
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=2, decode_tick=2, **PAGED))
    trash_before = eng.cache.k[:, eng.trash_page].clone()
    chained = _count_chained(eng, "_dispatch_chained")
    outs, _ = serve(eng, [("abc", 20), ("zq", 2)])
    assert outs[0] == solo[0]
    assert not torch.equal(eng.cache.k[:, eng.trash_page], trash_before)
    assert chained                        # ticks ran chained from device tokens too


def _count_chained(eng, name: str) -> list:
    """Record the successors `name` (the engine's chained dispatch) made."""
    orig, made = getattr(eng, name), []

    def call(inf):
        nxt = orig(inf)
        if nxt is not None:
            made.append(nxt)
        return nxt

    setattr(eng, name, call)
    return made


@pytest.mark.parametrize("spec_tick", [0, 3])
def test_no_live_query_reads_a_page_another_slot_writes(setup, monkeypatch, spec_tick):
    """What lets the int8 walk write a paged step's or chunk's rows inside
    the attention launch and still equal the standalone writer followed by
    the attention (every write, then every read; ROADMAP.md §3): in every
    paged forward an engine on an int8 pool runs (plain ticks or verify
    rounds of 4, requests ending mid-batch and one running into max_len),
    every table entry is a page of the pool (none clamped into another
    slot's page), no slot holds a page twice among the pages it reads and
    writes, a page that one slot's rows are written to is written or read
    by no other slot unless it is the trash page, and no live slot's query
    below max_len reads the trash page."""
    from rama_tpu_torch.runtime import paged as paged_mod

    _, _, cfg, params, _, tok = setup
    seen = []

    class Record:
        def __getattr__(self, name):
            fn = getattr(tl._KERNELS, name)
            if not name.startswith("paged_") or not name.endswith("_q8"):
                return fn

            def call(q, *a, **kw):
                if a[-1] == 0:                        # layer 0: one record a forward
                    seen.append((a[-3].tolist(), a[-2].tolist(), 1 if q.dim() == 3 else q.shape[1]))
                return fn(q, *a, **kw)

            return call

    monkeypatch.setattr(paged_mod, "_KERNELS", Record())
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=3, kv_quant="int8",
                                                spec_tick=spec_tick, **PAGED))
    chained = _count_chained(eng, "_dispatch_spec_chained" if spec_tick else "_dispatch_chained")
    outs, reqs = serve(eng, [("abc", 70), ("zq", 5), ("hello", 20)])
    assert all(r.error is None for r in reqs) and len(outs[0]) >= 1
    assert chained                        # forwards of chained ticks are among those checked
    ps, npages, trash = eng.ecfg.kv_page_size, eng.cache.num_pages, eng.trash_page
    assert len(seen) > 10
    for pos0, tables, tq in seen:
        mp = len(tables[0])
        assert all(0 <= e < npages for row in tables for e in row)
        wrote = [{min(max(p + i, 0) // ps, mp - 1) for i in range(tq)} for p in pos0]
        reads = [range(min(p + tq - 1, mp * ps - 1) // ps + 1) for p in pos0]
        for row, w, r in zip(tables, wrote, reads):
            held = [row[g] for g in sorted(w | set(r)) if row[g] != trash]
            assert len(held) == len(set(held)), (row, w, r)
        written = [{row[g] for g in w} for row, w in zip(tables, wrote)]
        read = [{row[g] for g in r} for row, r in zip(tables, reads)]
        for b, w in enumerate(written):
            for o in range(len(tables)):
                if o != b:
                    assert w & (written[o] | read[o]) <= {trash}, (b, o, pos0, tables)
        for p, row in zip(pos0, tables):
            if set(row) != {trash}:                   # a live slot
                last = min(p + tq, eng.max_len) - 1   # its last query below max_len
                assert trash not in row[: last // ps + 1], (p, row)


def test_loop_error_rebuilds_the_pool_and_the_allocator(setup):
    """An injected device failure mid-stream fails the in-flight request,
    returns its pages, rebuilds a zeroed pool with a fresh allocator and
    all-trash tables, and the next request streams as a fresh engine's."""
    _, _, cfg, params, _, tok = setup
    want, _ = run(setup, EngineConfig(max_batch_size=2, **PAGED), specs=[("abc", 8)])
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=2, decode_tick=1, **PAGED))
    original, state = eng._loop_once, {"bombs": 1}
    pools = []

    def flaky():
        if state["bombs"] and any(not s.free for s in eng.slots):
            state["bombs"] -= 1
            pools.append((eng.cache, eng.allocator))
            raise RuntimeError("injected device failure")
        original()

    eng._loop_once = flaky
    eng.start()
    try:
        r1 = Request(prompt="abc", steps=8, temperature=0.0)
        eng.submit(r1)
        collect(r1)
        assert r1.error == "engine error during decode"
        deadline = time.time() + 30
        while eng.cache is pools[0][0] and time.time() < deadline:
            time.sleep(0.01)                    # the handler rebuilds after failing r1
        assert eng.cache is not pools[0][0] and eng.allocator is not pools[0][1]
        assert eng.allocator.available() == 8 and (eng.page_tables == eng.trash_page).all()
        assert not eng.cache.k.any()
        r2 = Request(prompt="abc", steps=8, temperature=0.0)
        eng.submit(r2)
        assert collect(r2) == want[0] and r2.error is None
    finally:
        eng.stop()


def test_failed_admission_returns_its_pages(setup):
    _, _, cfg, params, _, tok = setup
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=2, **PAGED))
    original, state = eng._dev_prefill_insert, {"bombs": 1}

    def flaky(*a):
        if state["bombs"]:
            state["bombs"] -= 1
            assert eng.allocator.available() == 7            # one page reserved
            raise RuntimeError("injected prefill failure")
        return original(*a)

    eng._dev_prefill_insert = flaky
    eng.start()
    try:
        r1 = Request(prompt="ab", steps=4, temperature=0.0)
        eng.submit(r1)
        assert collect(r1) == [] and r1.error == "engine error during prefill"
        r2 = Request(prompt="ab", steps=4, temperature=0.0)
        eng.submit(r2)
        assert len(collect(r2)) == 4 and r2.error is None
    finally:
        eng.stop()
    assert eng.allocator.available() == 8 and (eng.page_tables == eng.trash_page).all()


def test_load_engine_wires_paged_and_page_size(setup, tmp_path):
    """--paged / --page-size reach the engine through load_engine, and the
    stream equals the dense engine's."""
    from rama_tpu_torch.checkpoint import save_v0
    from rama_tpu_torch.server.app import load_engine

    jcfg, np_params, cfg, *_ = setup
    model = str(tmp_path / "m.bin")
    save_v0(model, cfg, np_params)
    tok_path = write_tokenizer_bin(tmp_path / "tok.bin", cfg.vocab_size)
    outs = []
    for kw in ({}, {"paged": True, "page_size": 16}, {"paged": True, "page_size": 32,
                                                      "kv_quant": "int8"}):
        eng = load_engine(model, tok_path, quant="none", dtype="float32", batch=2,
                          device="cpu", **kw)
        assert eng.paged == kw.get("paged", False)
        assert not eng.paged or eng.cache.page_size == kw["page_size"]
        outs.append(serve(eng, [("abab", 10)])[0])
    assert outs[0] == outs[1]
