"""rama_tpu_torch's chunked prefill on the CPU (tiny fp32 model), the port of
tests/test_chunked_prefill.py: EngineConfig.prefill_chunk routes prompts
longer than prefill_chunk_min through a background job of (k, C) chunk
forwards interleaved with the ticks. Sampling is keyed by (slot key,
position) only, so every chunked stream must equal the port's unchunked
stream bit for bit, greedy and sampled, on a dense, int8 and paged cache
and under n-gram and draft speculation; the greedy chunked streams equal
the JAX engine's chunked ones; the chunk step equals rama_tpu's
_prefill_chunk_step on the same scratch and offset; a bad chunk raises;
warmup covers the job; and in the loop a non-final chunk rides behind
the ticks in flight while the final one waits for them to drain, with no
tick chained while it is pending."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import torch_cfg
from rama_tpu.config import EngineConfig as JEcfg
from rama_tpu.models import llama as jl
from rama_tpu.runtime import engine as j_engine
from rama_tpu.runtime.engine import Engine as JEngine
from rama_tpu.runtime.engine import Request as JRequest
from rama_tpu.testing.ref_model import random_params, tiny_config
from rama_tpu.tokenizer import Tokenizer as JTok
from rama_tpu_torch.config import EngineConfig
from rama_tpu_torch.models import llama as tl
from rama_tpu_torch.runtime import engine as eng_mod
from rama_tpu_torch.runtime.engine import Engine, Request
from rama_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

LONG = "abcdefghij" * 4          # 40 single-char tokens > chunk 16
SHORT = "abc"
CHUNKED = dict(prefill_chunk=16, prefill_chunk_min=16)
# the cases of rama_tpu's test_chunked_prefill.py but its TP / mesh ones
# (parallelism is not ported), and draft speculation: (batch, engine
# settings, prompts)
CASES = {
    "long": (2, {}, [LONG]),
    "mixed": (4, {}, [LONG, SHORT, "zq", LONG[:20]]),
    "paged": (2, dict(paged_kv=True, kv_page_size=16), [LONG, SHORT]),
    "kv_quant": (2, dict(kv_quant="int8"), [LONG]),
    "spec": (2, dict(spec_tick=3), [LONG]),
    "draft": (2, dict(spec_tick=3, spec_mode="draft"), [LONG, SHORT]),
}


def _vocab(n):
    return ["<unk>", "<s>", "</s>"] + [chr(ord("a") + i % 26) + ("" if i < 26 else str(i // 26))
                                      for i in range(n - 3)]


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_config(seq_len=64)
    np_params = random_params(jcfg, seed=23)
    cfg = torch_cfg(jcfg)
    djcfg = tiny_config(dim=32, hidden_dim=96, n_layers=2, n_heads=2, n_kv_heads=2, seq_len=64)
    dnp = random_params(djcfg, seed=77)
    dcfg = torch_cfg(djcfg)
    return dict(jcfg=jcfg, np=np_params, cfg=cfg,
                params=tl.load_params(cfg, np_params, dtype=torch.float32, device="cpu"),
                draft=(dcfg, tl.load_params(dcfg, dnp, dtype=torch.float32, device="cpu")),
                jdraft=(djcfg, jl.load_params(djcfg, dnp, dtype=jnp.float32)),
                tok=Tokenizer(_vocab(cfg.vocab_size), [0.0] * cfg.vocab_size,
                              max_token_length=4))


def collect(req, timeout=120.0):
    out, deadline = [], time.time() + timeout
    while (t := req.queue.get(timeout=max(0.1, deadline - time.time()))) is not None:
        out.append(t)
    return out


def serve(eng, prompts, steps=10, temperature=0.7, cls=Request):
    eng.start()
    try:
        reqs = [eng.submit(cls(prompt=p, steps=steps, temperature=temperature))
                for p in prompts]
        outs = [collect(r) for r in reqs]
    finally:
        eng.stop()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    assert eng.metrics["engine_errors"] == 0
    return outs


def port_engine(setup, batch, kw, chunked: bool):
    draft = setup["draft"] if kw.get("spec_mode") == "draft" else None
    return Engine(setup["cfg"], setup["params"], setup["tok"],
                  EngineConfig(max_batch_size=batch, **kw, **(CHUNKED if chunked else {})),
                  draft=draft)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("case", list(CASES))
def test_chunked_streams_equal_the_unchunked_streams(setup, case, temperature):
    """Every case's chunked streams equal its unchunked ones bit for bit,
    and the chunked run went through the job (chunks of 16 over the long
    prompts, no direct prefill of them)."""
    batch, kw, prompts = CASES[case]
    plain = serve(port_engine(setup, batch, kw, False), prompts, temperature=temperature)
    eng = port_engine(setup, batch, kw, True)
    chunked = serve(eng, prompts, temperature=temperature)
    assert chunked == plain
    assert eng.phases.counts["pf_chunk"] >= 3          # LONG: 41 tokens, 3 chunks
    assert eng._pf_job is None and not eng._pf_pending
    assert not eng.paged or eng.allocator.available() == eng.trash_page


@pytest.mark.parametrize("case", ["long", "mixed", "paged", "kv_quant", "spec"])
def test_greedy_chunked_streams_equal_the_jax_chunked_engine(setup, case):
    batch, kw, prompts = CASES[case]
    jeng = JEngine(setup["jcfg"], jl.load_params(setup["jcfg"], setup["np"], dtype=jnp.float32),
                   JTok(_vocab(setup["jcfg"].vocab_size), [0.0] * setup["jcfg"].vocab_size,
                        max_token_length=4),
                   JEcfg(max_batch_size=batch, **kw, **CHUNKED))
    want = serve(jeng, prompts, temperature=0.0, cls=JRequest)
    assert serve(port_engine(setup, batch, kw, True), prompts, temperature=0.0) == want


def test_draft_chunked_greedy_stream_equals_the_jax_chunked_engine(setup):
    batch, kw, prompts = CASES["draft"]
    djcfg, djparams = setup["jdraft"]
    jeng = JEngine(setup["jcfg"], jl.load_params(setup["jcfg"], setup["np"], dtype=jnp.float32),
                   JTok(_vocab(setup["jcfg"].vocab_size), [0.0] * setup["jcfg"].vocab_size,
                        max_token_length=4),
                   JEcfg(max_batch_size=batch, **kw, **CHUNKED), draft=(djcfg, djparams))
    want = serve(jeng, prompts, temperature=0.0, cls=JRequest)
    assert serve(port_engine(setup, batch, kw, True), prompts, temperature=0.0) == want


@pytest.mark.parametrize("bits", [None, 8])
def test_chunk_step_equals_jax_on_the_same_scratch(setup, bits):
    """Two rows (lengths 40 and 23) of a (2, 64) bucket, chunks of 16 at
    off 0, 16 and 32 on both packages' steps from the same fp32 scratch:
    `last` (each row's logits taken in the chunk holding its last position,
    kept after) and every scratch row within 1e-5."""
    jcfg, cfg, np_params = setup["jcfg"], setup["cfg"], setup["np"]
    if bits:
        jp = jl.quantize_params(jcfg, np_params, bits=bits, group_size=16, dtype=jnp.float32)
        tp = tl.quantize_params(cfg, np_params, bits=bits, group_size=16, dtype=torch.float32,
                                device="cpu")
    else:
        jp = jl.load_params(jcfg, np_params, dtype=jnp.float32)
        tp = setup["params"]
    rng = np.random.default_rng(4)
    lens = np.array([40, 23], np.int32)
    tokens = rng.integers(3, cfg.vocab_size, (2, 64)).astype(np.int64)
    jscratch = jl.KVCache.create(jcfg, batch=2, max_len=64, dtype=jnp.float32)
    jlast = jnp.zeros((2, cfg.vocab_size), jnp.float32)
    scratch = tl.KVCache.create(cfg, batch=2, max_len=64, dtype=torch.float32, device="cpu")
    last = torch.zeros((2, cfg.vocab_size))
    for off in (0, 16, 32):
        chunk = tokens[:, off:off + 16]
        jscratch, jlast = j_engine._prefill_chunk_step(
            jp, jcfg, jnp.asarray(chunk, jnp.int32), jnp.asarray(lens), jnp.int32(off),
            jscratch, jlast)
        scratch, last = eng_mod._prefill_chunk_step(
            tp, cfg, torch.from_numpy(chunk), torch.from_numpy(lens), off, scratch, last)
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(scratch.k.numpy(), np.asarray(jscratch.k), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(scratch.v.numpy(), np.asarray(jscratch.v), rtol=1e-5,
                                   atol=1e-5)
    assert (last.abs().sum(dim=1) > 0).all()           # both rows' last logits taken


@pytest.mark.parametrize("kw", [dict(prefill_chunk=24), dict(prefill_chunk=8),
                                dict(prefill_chunk=16, prefill_chunk_min=8)])
def test_bad_chunk_raises(setup, kw):
    with pytest.raises(ValueError):
        Engine(setup["cfg"], setup["params"], setup["tok"], EngineConfig(**kw))
    with pytest.raises(ValueError):
        JEngine(setup["jcfg"], jl.load_params(setup["jcfg"], setup["np"], dtype=jnp.float32),
                JTok(_vocab(setup["jcfg"].vocab_size), [0.0] * setup["jcfg"].vocab_size),
                JEcfg(**kw))


def test_warmup_covers_the_chunked_job(setup):
    """warmup() with prefill_chunk runs the job's chunk and finisher; a long
    submission afterwards is served by the job with the direct engine's
    greedy stream."""
    eng = port_engine(setup, 2, {}, True)
    assert eng.warmup()["programs"] > 0
    got = serve(eng, [LONG], steps=6, temperature=0.0)
    assert len(got[0]) == 6 and eng.phases.counts["pf_chunk"] == 3
    assert got == serve(port_engine(setup, 2, {}, False), [LONG], steps=6, temperature=0.0)


@pytest.mark.parametrize("spec_tick", [0, 3])
def test_chunks_ride_behind_ticks_and_the_final_one_waits(setup, spec_tick):
    """A long prompt submitted while ticks are in flight (by the engine
    thread as it processes a tick, so the timing is fixed): at least one
    non-final chunk is dispatched with a tick in flight, the final chunk
    (the one that runs the finisher) only with none, neither chain check
    passes while it is pending, and both streams equal the unchunked
    engine's."""
    kw = dict(decode_tick=2, spec_tick=spec_tick, spec_min_accept=0.0)
    eng = port_engine(setup, 2, kw, True)
    long_req = Request(prompt=LONG + "abcdefghij", steps=8, temperature=0.0)  # 4 chunks
    events = []
    for name in ("_pf_step", "_chain_ok", "_spec_chain_ok", "_process_inflight",
                 "_process_spec_inflight"):
        orig = getattr(eng, name)

        def call(*a, _name=name, _orig=orig, **kw):
            in_flight = len(eng._inflight_q) + len(eng._spec_inflight_q)
            pending = eng._pf_final_chunk_pending()
            job = eng._pf_job
            out = _orig(*a, **kw)
            if _name == "_pf_step":
                events.append(("chunk", in_flight, job is not eng._pf_job))
            elif _name.endswith("chain_ok"):
                events.append(("chain", pending, out))
            elif not long_req.prompt_ids:
                eng.submit(long_req)      # mid-stream, ticks still in flight
            return out

        setattr(eng, name, call)
    eng.start()
    try:
        r1 = Request(prompt="abc", steps=40, temperature=0.0)
        eng.submit(r1)
        got = [collect(r1), collect(long_req)]
    finally:
        eng.stop()
    plain = port_engine(setup, 2, kw, False)
    plain.start()
    try:
        want = [collect(plain.submit(Request(prompt="abc", steps=40, temperature=0.0)))]
        want.append(collect(plain.submit(Request(prompt=LONG + "abcdefghij", steps=8,
                                                 temperature=0.0))))
    finally:
        plain.stop()
    assert got == want and eng.metrics["engine_errors"] == 0
    chunks = [e for e in events if e[0] == "chunk"]
    assert len(chunks) == 4
    assert any(in_flight and not finished for _, in_flight, finished in chunks)
    assert [finished for *_, finished in chunks] == [False, False, False, True]
    assert chunks[-1][1] == 0
    assert any(e[1] for e in events if e[0] == "chain")
    assert not any(out for _, pending, out in (e for e in events if e[0] == "chain") if pending)
