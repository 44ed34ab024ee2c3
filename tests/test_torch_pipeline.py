"""rama_tpu_torch's pipelined engine loop on the CPU (tiny fp32 model, as
tests/test_engine.py runs the JAX engine): plain ticks chained from the
device tokens of the tick before, spec ticks chained from its carries, and
async-firsts admission behind in-flight ticks. Greedy streams equal the
JAX engine's on the same numpy params in every cache form (dense, int8,
paged, paged int8), with and without n-gram speculation; sampled streams
do not depend on the chain depth; a chained dispatch never runs while an
admission's first tokens are unfetched; a chained page reservation that
fails ends no request; stop() drains the ticks in flight; errors clear
the pipeline. Streams are compared exactly."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import torch_cfg
from rama_tpu.config import EngineConfig as JEcfg
from rama_tpu.models import llama as jl
from rama_tpu.runtime.engine import Engine as JEngine
from rama_tpu.runtime.engine import Request as JRequest
from rama_tpu.testing.ref_model import RefModel, random_params, tiny_config
from rama_tpu.tokenizer import Tokenizer as JTok
from rama_tpu_torch.config import EngineConfig
from rama_tpu_torch.models import llama as tl
from rama_tpu_torch.runtime import engine as eng_mod
from rama_tpu_torch.runtime.engine import Engine, Request
from rama_tpu_torch.tokenizer import BOS_ID, Tokenizer

torch.set_num_threads(1)

SPECS = (("abac", 40), ("zq", 30), ("hello", 36))
FORMS = {"dense": {}, "int8": dict(kv_quant="int8"),
         "paged": dict(paged_kv=True, kv_page_size=16),
         "paged_int8": dict(paged_kv=True, kv_page_size=16, kv_quant="int8")}


def _vocab(n):
    return ["<unk>", "<s>", "</s>"] + [chr(ord("a") + i % 26) + ("" if i < 26 else str(i // 26))
                                      for i in range(n - 3)]


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_config(seq_len=64)
    np_params = random_params(jcfg, seed=31)
    cfg = torch_cfg(jcfg)
    params = tl.load_params(cfg, np_params, dtype=torch.float32, device="cpu")
    tok = Tokenizer(_vocab(cfg.vocab_size), [0.0] * cfg.vocab_size, max_token_length=4)
    return jcfg, np_params, cfg, params, tok


@pytest.fixture(scope="module")
def jax_streams(setup):
    """The JAX engine's greedy streams of SPECS by cache form (made once)."""
    jcfg, np_params, *_ = setup
    made = {}

    def get(form):
        if form not in made:
            jeng = JEngine(jcfg, jl.load_params(jcfg, np_params, dtype=jnp.float32),
                           JTok(_vocab(jcfg.vocab_size), [0.0] * jcfg.vocab_size,
                                max_token_length=4),
                           JEcfg(max_batch_size=3, decode_tick=2, **FORMS[form]))
            made[form] = serve(jeng, SPECS, cls=JRequest)[0]
        return made[form]

    return get


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


def oracle(setup, prompt, steps):
    """Greedy continuation after [BOS]+prompt, stopping at EOS like serving."""
    jcfg, np_params, _, _, tok = setup
    ref = RefModel(jcfg, np_params)
    ids = [BOS_ID] + tok.encode(prompt)
    for pos, t in enumerate(ids):
        logits = ref.step(t, pos)
    out, pos = [], len(ids)
    while len(out) < steps:
        nxt = int(np.argmax(logits))
        out.append(nxt)
        if nxt == 2:
            break
        logits = ref.step(nxt, pos)
        pos += 1
    return [tok.decode_token(i) for i in out]


def counted(eng, name):
    """Wrap engine method `name`: calls whose result is not None count."""
    orig, calls = getattr(eng, name), []

    def call(*a, **kw):
        out = orig(*a, **kw)
        if out is not None:
            calls.append(out)
        return out

    setattr(eng, name, call)
    return calls


@pytest.mark.parametrize("spec_tick", [0, 3])
@pytest.mark.parametrize("form", list(FORMS))
def test_chained_greedy_streams_equal_the_jax_engine(setup, jax_streams, form, spec_tick):
    """Plain ticks chained from out[-1] (spec off) or spec ticks chained
    from the carries (spec_tick 3): the greedy streams are the JAX engine's
    in each cache form, at least one successor was chained, and every page
    is free again."""
    _, _, cfg, params, tok = setup
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=3, decode_tick=2,
                                                spec_tick=spec_tick, spec_min_accept=0.0,
                                                **FORMS[form]))
    chained = counted(eng, "_dispatch_spec_chained" if spec_tick else "_dispatch_chained")
    got, reqs = serve(eng, SPECS)
    assert got == jax_streams(form)
    assert all(r.error is None for r in reqs) and eng.stats()["engine_errors"] == 0
    assert len(chained) >= 1
    assert not (eng._inflight_q or eng._spec_inflight_q or eng._admit_jobs)
    assert not eng.paged or eng.allocator.available() == eng.trash_page


@pytest.mark.parametrize("spec_tick", [0, 3])
@pytest.mark.parametrize("form", ["dense", "paged_int8"])
def test_sampled_streams_do_not_depend_on_the_chain_depth(setup, monkeypatch, form, spec_tick):
    """Sampling is keyed by (slot key, position): the sampled and greedy
    streams at _PIPELINE_DEPTH 1 (nothing chained) equal those at 3."""
    _, _, cfg, params, tok = setup
    specs = [("abac", 30), ("zq", 26), ("hello", 20)]
    outs = {}
    for depth in (1, 3):
        monkeypatch.setattr(eng_mod, "_PIPELINE_DEPTH", depth)
        eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=3, decode_tick=2,
                                                    spec_tick=spec_tick, spec_min_accept=0.0,
                                                    **FORMS[form]))
        chained = counted(eng, "_dispatch_spec_chained" if spec_tick else "_dispatch_chained")
        eng.start()
        try:
            reqs = [Request(prompt=p, steps=n, temperature=0.0 if i == 1 else 0.9, top_p=0.8)
                    for i, (p, n) in enumerate(specs)]
            for r in reqs:
                eng.submit(r)
            outs[depth] = [collect(r) for r in reqs]
        finally:
            eng.stop()
        assert (len(chained) >= 1) == (depth > 1)
    assert outs[1] == outs[3]


def test_mid_stream_admission_breaks_chain_correctly(setup):
    """tests/test_engine.py:339 on the port: a request admitted while
    another is mid-stream still yields oracle-exact streams for both, and
    the early request's tail is not lost."""
    _, _, cfg, params, tok = setup
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=4, decode_tick=2))
    eng.start()
    try:
        r1 = Request(prompt="abc", steps=20, temperature=0.0)
        eng.submit(r1)
        r1.queue.put(r1.queue.get(timeout=60))  # first token back
        r2 = Request(prompt="zq", steps=8, temperature=0.0)
        eng.submit(r2)
        got1, got2 = collect(r1), collect(r2)
    finally:
        eng.stop()
    assert got1 == oracle(setup, "abc", 20)
    assert got2 == oracle(setup, "zq", 8)


@pytest.mark.parametrize("spec_tick", [0, 3])
def test_async_admission_queues_behind_in_flight_ticks(setup, spec_tick):
    """A request that arrives while ticks are in flight (submitted by the
    engine thread as it processes the first tick, so the timing is fixed)
    has its prefill dispatched before they drain (`_admit_dispatch` with a
    tick in flight, its slot prefilling), no successor is chained while its
    first tokens are unfetched, and both streams are the oracle's."""
    _, _, cfg, params, tok = setup
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=4, decode_tick=2,
                                                spec_tick=spec_tick, spec_min_accept=0.0))
    r2 = Request(prompt="zq", steps=8, temperature=0.0)
    events = []
    for name in ("_admit_dispatch", "_dispatch_chained", "_dispatch_spec_chained",
                 "_process_inflight", "_process_spec_inflight"):
        orig = getattr(eng, name)

        def call(*a, _name=name, _orig=orig, **kw):
            in_flight = len(eng._inflight_q) + len(eng._spec_inflight_q)
            if _name.startswith("_dispatch"):
                events.append((_name, in_flight, len(eng._admit_jobs)))
            out = _orig(*a, **kw)
            if _name == "_admit_dispatch":
                prefilling = [s.request is r2 and s.prefilling for s in eng.slots]
                events.append((_name, in_flight, len(eng._admit_jobs), any(prefilling)))
            if _name.startswith("_process") and not r2.prompt_ids:
                eng.submit(r2)            # mid-stream, ticks still in flight
            return out

        setattr(eng, name, call)
    eng.start()
    try:
        r1 = Request(prompt="abc", steps=30, temperature=0.0)
        eng.submit(r1)
        got1, got2 = collect(r1), collect(r2)
    finally:
        eng.stop()
    assert got1 == oracle(setup, "abc", 30) and got2 == oracle(setup, "zq", 8)
    admits = [e for e in events if e[0] == "_admit_dispatch" and e[1] > 0 and e[2] == 1]
    assert admits and all(e[3] for e in admits)       # dispatched behind ticks, prefilling
    chained = [e for e in events if e[0] != "_admit_dispatch"]
    assert chained and all(jobs == 0 for _, _, jobs in chained)


@pytest.mark.parametrize("form", ["dense", "paged"])
def test_spec_chained_ticks_match_oracle(setup, form):
    """tests/test_engine.py:397 on the port: with an idle admission queue
    spec tick k+1 dispatches from tick k's device carries before tick k is
    fetched, and the stream is still the greedy oracle chain."""
    _, _, cfg, params, tok = setup
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=4, spec_tick=3,
                                                **FORMS[form]))
    chained = counted(eng, "_dispatch_spec_chained")
    got, _ = serve(eng, [("abac", 40)])
    assert got[0] == oracle(setup, "abac", 40)
    assert len(chained) >= 1, "no spec tick was chained"


def test_chained_spec_tick_restarts_a_freed_slot_at_position_zero(setup):
    """A chained spec tick runs a slot that no longer serves a request from
    position 0, as a fresh dispatch runs a free slot (its carried position
    would grow by up to m (k + 1) a chained tick, past the cache), and
    every chained position stays inside the cache; the long stream is the
    oracle's."""
    _, _, cfg, params, tok = setup
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=2, spec_tick=3, spec_rounds=1,
                                                spec_min_accept=0.0))
    orig, seen = eng._dev_spec_tick, []

    def spy(tokens, pos, *a, **kw):
        if isinstance(pos, torch.Tensor):          # chained: the carried positions
            seen.append((pos.tolist(), [s.free for s in eng.slots]))
        return orig(tokens, pos, *a, **kw)

    eng._dev_spec_tick = spy
    got, _ = serve(eng, [("abac", 40), ("zq", 4)])
    assert got[0] == oracle(setup, "abac", 40) and len(got[1]) == 4
    freed = [pos for pos, free in seen if free[1]]
    assert freed and all(pos[1] == 0 for pos in freed)
    assert all(0 <= p < eng.max_len for pos, _ in seen for p in pos)


def test_cancel_mid_stream_with_pipelined_chains(setup):
    """tests/test_engine.py:508 on the port: a request cancelled under deep
    chained ticks frees its slot without disturbing a concurrent stream,
    and the freed slot serves again."""
    _, _, cfg, params, tok = setup
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=4, decode_tick=2))
    chained = counted(eng, "_dispatch_chained")
    eng.start()
    try:
        victim = Request(prompt="abc", steps=40, temperature=0.0, stop_at_eos=False)
        bystander = Request(prompt="ba", steps=24, temperature=0.0)
        eng.submit(victim)
        eng.submit(bystander)
        victim.queue.put(victim.queue.get(timeout=60))  # first token back
        victim.cancelled = True
        got_v, got_b = collect(victim), collect(bystander)
        assert len(got_v) < 40, "cancelled stream ran to full budget"
        assert got_b == oracle(setup, "ba", 24)
        r3 = Request(prompt="abc", steps=6, temperature=0.0)
        eng.submit(r3)
        assert collect(r3) == oracle(setup, "abc", 6)
    finally:
        eng.stop()
    assert len(chained) >= 1


def test_engine_error_recovery_with_spec_pipeline(setup):
    """tests/test_engine.py:537 on the port: a device-call failure while
    spec ticks are chained fails the in-flight request, clears the
    pipeline's queues, and the engine serves the next request exactly."""
    _, _, cfg, params, tok = setup
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=2, spec_tick=3))
    orig, state = eng._dev_spec_tick, {}

    def flaky(*a, **kw):
        if eng._spec_inflight_q and "in_flight" not in state:   # a chained dispatch
            state["in_flight"] = len(eng._spec_inflight_q)
            raise RuntimeError("injected device failure")
        return orig(*a, **kw)

    eng._dev_spec_tick = flaky
    eng.start()
    try:
        r1 = Request(prompt="abc", steps=30, temperature=0.0)
        eng.submit(r1)
        collect(r1)
        assert r1.error == "engine error during decode"
        assert state["in_flight"] >= 1 and eng.metrics["engine_errors"] == 1
        r2 = Request(prompt="ba", steps=8, temperature=0.0)
        eng.submit(r2)
        assert collect(r2) == oracle(setup, "ba", 8) and r2.error is None
    finally:
        eng.stop()
    assert eng._last_spec is not None and not eng._spec_inflight_q


def test_loop_error_clears_the_pipeline_and_the_prefilling_slots(setup):
    """An error while an admission is unfetched behind in-flight ticks
    clears the in-flight queues, the admit jobs and the last spec carries,
    fails both requests (the prefilling one too) and leaves no slot
    prefilling; the engine then serves as a fresh one."""
    _, _, cfg, params, tok = setup
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=2, decode_tick=2))
    r2 = Request(prompt="zq", steps=8, temperature=0.0)
    orig, seen = eng._process_inflight, {}

    def flaky(inf):
        if eng._admit_jobs and "jobs" not in seen:
            seen["jobs"] = len(eng._admit_jobs)
            seen["prefilling"] = [s.prefilling for s in eng.slots]
            raise RuntimeError("injected device failure")
        out = orig(inf)
        if not r2.prompt_ids:
            eng.submit(r2)
        return out

    eng._process_inflight = flaky
    eng.start()
    try:
        r1 = Request(prompt="abc", steps=30, temperature=0.0)
        eng.submit(r1)
        collect(r1), collect(r2)
        assert r1.error == r2.error == "engine error during decode"
        assert seen["jobs"] == 1 and any(seen["prefilling"])
        assert not (eng._inflight_q or eng._admit_jobs or eng._last_spec)
        assert not any(s.prefilling for s in eng.slots)
        r3 = Request(prompt="abc", steps=8, temperature=0.0)
        eng.submit(r3)
        assert collect(r3) == oracle(setup, "abc", 8)
    finally:
        eng.stop()


def test_failed_chained_reservation_ends_no_request(setup):
    """A pool too small for both streams: a chained dispatch whose page
    reservation fails declines to chain and ends no request; the next
    fresh dispatch ends the request it cannot grow with "out of KV cache
    pages". Every page is free again."""
    _, _, cfg, params, tok = setup
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=2, decode_tick=2,
                                                kv_num_pages=4, **FORMS["paged"]))
    orig, calls = eng._reserve_tick_pages, []

    def spy(pos, n, finish_on_fail):
        before = [s.request for s in eng.slots]
        ok = orig(pos, n, finish_on_fail)
        ended = [r for r, s in zip(before, eng.slots) if r is not None and s.request is not r]
        calls.append((finish_on_fail, ok, ended))
        return ok

    eng._reserve_tick_pages = spy
    chained = counted(eng, "_dispatch_chained")
    outs, reqs = serve(eng, [("abc", 60), ("zq", 30)])
    failed_chains = [c for c in calls if not c[0] and not c[1]]
    assert failed_chains and all(not ended for _, _, ended in failed_chains)
    ended = [r for f, ok, e in calls if f and not ok for r in e]
    assert ended and all(r.error == "out of KV cache pages" for r in ended)
    assert len(chained) >= 1 and len(outs[0]) >= 1
    assert all(r.error in (None, "out of KV cache pages") for r in reqs)
    assert eng.allocator.available() == 4 and eng.stats()["engine_errors"] == 0


@pytest.mark.parametrize("spec_tick", [0, 3])
def test_stop_drains_the_ticks_in_flight_and_the_admit_jobs(setup, spec_tick):
    """stop() while ticks are in flight and an admission's first token is
    unfetched: the loop exits, and the in-flight ticks' tokens and the
    first token still reach their streams (engine.py:1654-1697)."""
    _, _, cfg, params, tok = setup
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=2, decode_tick=2,
                                                spec_tick=spec_tick, spec_min_accept=0.0))
    r1 = Request(prompt="abc", steps=50, temperature=0.0, stop_at_eos=False)
    r2 = Request(prompt="zq", steps=8, temperature=0.0)
    name = "_process_spec_inflight" if spec_tick else "_process_inflight"
    orig, state = getattr(eng, name), {"calls": 0}

    def hook(inf):
        out = orig(inf)
        state["calls"] += 1
        if state["calls"] == 1:
            eng.submit(r2)               # dispatched behind the in-flight ticks next
        elif eng._admit_jobs and "at_stop" not in state:
            state["at_stop"] = (len(eng._inflight_q) + len(eng._spec_inflight_q),
                                len(eng._admit_jobs), r1.tokens_out)
            eng._stop.set()              # what stop() sets, from the engine thread
        return out

    setattr(eng, name, hook)
    eng.submit(r1)
    eng.start()
    eng._thread.join(timeout=60)
    assert not eng._thread.is_alive()
    in_flight, jobs, emitted = state["at_stop"]
    assert in_flight >= 1 and jobs == 1
    assert r1.tokens_out > emitted                   # the drained ticks' tokens
    assert r2.tokens_out == 1                        # the fetched first token
    assert not (eng._inflight_q or eng._spec_inflight_q or eng._admit_jobs)
    got = []
    while not r1.queue.empty():
        got.append(r1.queue.get_nowait())
    assert got == oracle(setup, "abc", 50)[:len(got)] and len(got) == r1.tokens_out
