"""rama_tpu_torch's slim continuous-batching engine on the CPU: streams
match the greedy numpy oracle (rama_tpu.testing.ref_model), mirroring
tests/test_engine.py for the features this port has."""

import time

import numpy as np
import pytest
import torch

from _torch_port import torch_cfg
from rama_tpu.runtime import engine as j_engine
from rama_tpu.testing.ref_model import RefModel, random_params, tiny_config
from rama_tpu_torch.config import EngineConfig
from rama_tpu_torch.models.llama import load_params
from rama_tpu_torch.runtime import engine as eng_mod
from rama_tpu_torch.runtime.engine import Engine, Request
from rama_tpu_torch.tokenizer import BOS_ID, Tokenizer

torch.set_num_threads(1)


def make_tokenizer(vocab_size: int) -> Tokenizer:
    # single-char vocab so encode() maps 1 char -> 1 token deterministically
    vocab = ["<unk>", "<s>", "</s>"] + [chr(ord("a") + i % 26) + ("" if i < 26 else str(i // 26))
                                        for i in range(vocab_size - 3)]
    return Tokenizer(vocab, [0.0] * vocab_size, max_token_length=4)


@pytest.fixture(scope="module")
def engine_setup():
    jcfg = tiny_config(seq_len=64)
    np_params = random_params(jcfg, seed=31)
    cfg = torch_cfg(jcfg)
    params = load_params(cfg, np_params, dtype=torch.float32, device="cpu")
    return jcfg, cfg, np_params, params, make_tokenizer(cfg.vocab_size)


def collect(req: Request, timeout=60.0):
    out = []
    deadline = time.time() + timeout
    while True:
        tok = req.queue.get(timeout=max(0.1, deadline - time.time()))
        if tok is None:
            return out
        out.append(tok)


def oracle(jcfg, np_params, tok, prompt, steps):
    """Greedy continuation after [BOS]+prompt, stopping at EOS like serving."""
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


def serve(cfg, params, tok, ecfg, reqs):
    eng = Engine(cfg, params, tok, ecfg)
    eng.start()
    try:
        for r in reqs:
            eng.submit(r)
        return eng, [collect(r) for r in reqs]
    finally:
        eng.stop()


def test_single_request_matches_oracle(engine_setup):
    jcfg, cfg, np_params, params, tok = engine_setup
    _, (got,) = serve(cfg, params, tok, EngineConfig(max_batch_size=4),
                      [Request(prompt="abc", steps=10, temperature=0.0)])
    assert got == oracle(jcfg, np_params, tok, "abc", 10)


def test_concurrent_requests_isolated(engine_setup):
    jcfg, cfg, np_params, params, tok = engine_setup
    prompts = ("abc", "zq", "hello")
    _, outs = serve(cfg, params, tok, EngineConfig(max_batch_size=4),
                    [Request(prompt=p, steps=8, temperature=0.0) for p in prompts])
    for p, got in zip(prompts, outs):
        assert got == oracle(jcfg, np_params, tok, p, 8), p


def test_more_requests_than_slots(engine_setup):
    _, cfg, _, params, tok = engine_setup
    eng, outs = serve(cfg, params, tok, EngineConfig(max_batch_size=4),
                      [Request(prompt="ab", steps=4, temperature=0.0) for _ in range(9)])
    assert all(outs[0] == o for o in outs)
    assert eng.stats()["requests_completed"] == 9


def test_echo_prompt(engine_setup):
    _, cfg, _, params, tok = engine_setup
    _, (got,) = serve(cfg, params, tok, EngineConfig(max_batch_size=4),
                      [Request(prompt="abc", steps=3, temperature=0.0, echo_prompt=True)])
    assert got[:3] == ["a", "b", "c"]


def test_long_prompt_truncated(engine_setup):
    _, cfg, _, params, tok = engine_setup
    r = Request(prompt="ab" * 200, steps=5, temperature=0.0)
    _, (got,) = serve(cfg, params, tok, EngineConfig(max_batch_size=4), [r])
    assert r.truncated == 400 - (64 - 2)
    assert len(got) >= 1 and r.error is None


def test_stats_shape(engine_setup):
    _, cfg, _, params, tok = engine_setup
    s = Engine(cfg, params, tok, EngineConfig(max_batch_size=4)).stats()
    assert s["max_slots"] == 4 and s["active_slots"] == 0
    assert s["device"] == "cpu"


def test_multi_token_tick_matches_single(engine_setup):
    """decode_tick=8 emits exactly the stream decode_tick=1 does (mid-tick
    finishes drop the overshoot)."""
    _, cfg, _, params, tok = engine_setup
    outs = []
    for tick in (1, 8):
        reqs = [Request(prompt=p, steps=s, temperature=0.0)
                for p, s in (("abc", 13), ("zz", 3), ("q", 8))]
        outs.append(serve(cfg, params, tok,
                          EngineConfig(max_batch_size=4, decode_tick=tick), reqs)[1])
    assert outs[0] == outs[1]


def test_sampled_stream_invariant_to_tick_shape(engine_setup):
    """Position-keyed sampling: the stream at temperature 0.9 is identical
    across decode_tick sizes."""
    _, cfg, _, params, tok = engine_setup
    outs = []
    for tick in (1, 8):
        reqs = [Request(prompt=p, steps=s, temperature=t)
                for p, s, t in (("abab", 12, 0.9), ("zq", 7, 0.0), ("hello", 10, 0.9))]
        outs.append(serve(cfg, params, tok,
                          EngineConfig(max_batch_size=4, decode_tick=tick), reqs)[1])
    assert outs[0] == outs[1]


def test_engine_recovers_from_device_error(engine_setup):
    jcfg, cfg, np_params, params, tok = engine_setup
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=4, decode_tick=1))
    original = eng._loop_once
    state = {"bombs": 1}

    def flaky():
        if state["bombs"] and any(not s.free for s in eng.slots):
            state["bombs"] -= 1
            raise RuntimeError("injected device failure")
        original()

    eng._loop_once = flaky
    eng.start()
    try:
        r1 = Request(prompt="abc", steps=8, temperature=0.0)
        eng.submit(r1)
        collect(r1)
        assert r1.error is not None
        assert eng.stats()["engine_errors"] == 1
        r2 = Request(prompt="abc", steps=8, temperature=0.0)
        eng.submit(r2)
        assert collect(r2) == oracle(jcfg, np_params, tok, "abc", 8)
        assert r2.error is None
    finally:
        eng.stop()


def test_failed_prefill_fails_only_that_admission(engine_setup):
    jcfg, cfg, np_params, params, tok = engine_setup
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=4))
    original = eng._dev_prefill_insert
    state = {"bombs": 1}

    def flaky(*a):
        if state["bombs"]:
            state["bombs"] -= 1
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
        assert collect(r2) == oracle(jcfg, np_params, tok, "ab", 4)
    finally:
        eng.stop()


def test_cancel_mid_stream_frees_slot(engine_setup):
    jcfg, cfg, np_params, params, tok = engine_setup
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=4, decode_tick=2))
    eng.start()
    try:
        victim = Request(prompt="abc", steps=40, temperature=0.0, stop_at_eos=False)
        bystander = Request(prompt="ba", steps=24, temperature=0.0)
        eng.submit(victim)
        eng.submit(bystander)
        victim.queue.put(victim.queue.get(timeout=60))  # first token is back
        victim.cancelled = True
        assert len(collect(victim)) < 40
        assert collect(bystander) == oracle(jcfg, np_params, tok, "ba", 24)
    finally:
        eng.stop()


def test_burst_admission_prefills_in_one_dispatch(engine_setup):
    jcfg, cfg, np_params, params, tok = engine_setup
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=4))
    prompts = ("abc", "zq", "hello")
    reqs = [Request(prompt=p, steps=6, temperature=0.0) for p in prompts]
    for r in reqs:  # queued before the loop starts: one admission batch
        r.prompt_ids = tok.encode(r.prompt)
        eng.admission.put(r)
    eng.start()
    try:
        outs = [collect(r) for r in reqs]
    finally:
        eng.stop()
    for p, got in zip(prompts, outs):
        assert got == oracle(jcfg, np_params, tok, p, 6), p
    assert eng.phases.counts["prefill"] == 1


def test_prefill_area_cap_splits_bursts(engine_setup, monkeypatch):
    jcfg, cfg, np_params, params, tok = engine_setup
    monkeypatch.setattr(eng_mod, "_PREFILL_AREA", 64)
    prompts = ["abcabcabcabcabcabcabcabcabcabc"[: 24 + i] for i in range(4)]
    reqs = [Request(prompt=p, steps=6, temperature=0.0) for p in prompts]
    for r in reqs:
        r.prompt_ids = tok.encode(r.prompt)
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=4))
    for r in reqs:
        eng.admission.put(r)
    eng.start()
    try:
        outs = [collect(r) for r in reqs]
    finally:
        eng.stop()
    for p, got in zip(prompts, outs):
        assert got == oracle(jcfg, np_params, tok, p, 6)
    assert eng.phases.counts["prefill"] == 2  # (4, 32) bucket, cap 2 rows


def test_long_context_beyond_checkpoint_seq_len():
    """max_seq_len > checkpoint seq_len: RoPE retabulated to the cache length;
    the stream equals an engine whose checkpoint natively has that length."""
    cfg32 = tiny_config(seq_len=32)
    np_params = random_params(cfg32, seed=31)
    tok = make_tokenizer(cfg32.vocab_size)
    outs = {}
    for label, jc, ecfg in (("native96", cfg32.replace(seq_len=96),
                             EngineConfig(max_batch_size=2)),
                            ("extended", cfg32,
                             EngineConfig(max_batch_size=2, max_seq_len=96))):
        cfg = torch_cfg(jc)
        params = load_params(cfg, np_params, dtype=torch.float32, device="cpu")
        r = Request(prompt="abab", steps=80, temperature=0.0, stop_at_eos=False)
        outs[label] = serve(cfg, params, tok, ecfg, [r])[1][0]
    assert len(outs["native96"]) == 80
    assert outs["native96"] == outs["extended"]


@pytest.mark.parametrize("field,value", [
    ("paged_kv", True), ("kv_quant", "int4"), ("spec_tick", 3),
    ("prefill_chunk", 16), ("scale_dtype", "bf16"), ("tp_size", 2),
    ("dp_size", 2), ("seq_par", True),
])
def test_unported_engine_config_raises(engine_setup, field, value):
    """Unported features (seq_par) raise NotImplementedError; tp_size and
    dp_size are ported and, outside a process group of tp * dp ranks, raise
    ValueError naming init_distributed; kv_quant is ported for
    "int8" and refuses any other value with ValueError, as in rama_tpu;
    spec_tick is ported and refuses draft mode without a draft model;
    prefill_chunk is ported: a chunk that is not a power of two >= 16, or a
    prefill_chunk_min below it, raises ValueError, and a 31-token prompt
    (past a prefill_chunk_min of 16) is served in two chunks of 16 with
    the oracle's greedy stream;
    paged_kv is ported: a page pool of pages_per_slot pages a slot plus
    one trash page; scale_dtype is ported for "bf16" (every quantized
    leaf's scales stored in bf16) and refuses any other value with
    rama_tpu's ValueError."""
    jcfg, cfg, np_params, params, tok = engine_setup
    if field == "scale_dtype":
        from rama_tpu_torch.models.llama import quantize_params
        from rama_tpu_torch.ops.quant import QuantizedEmbedding, QuantizedTensor

        qp = quantize_params(cfg, np_params, bits=8, group_size=16, dtype=torch.float32,
                             device="cpu")
        eng = Engine(cfg, qp, tok, EngineConfig(max_batch_size=2, **{field: value}))
        quant = [p for p in eng.params.values()
                 if isinstance(p, (QuantizedTensor, QuantizedEmbedding))]
        assert len(quant) == 6 and all(p.scales.dtype == torch.bfloat16 for p in quant)
        assert qp["wq"].scales.dtype == torch.float32   # the caller's params unchanged
        with pytest.raises(ValueError, match="unsupported scale_dtype 'fp16'"):
            Engine(cfg, qp, tok, EngineConfig(**{field: "fp16"}))
        return
    if field == "paged_kv":
        from rama_tpu_torch.runtime.paged import PagedKVCache

        eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=4, kv_page_size=16,
                                                    **{field: value}))
        assert isinstance(eng.cache, PagedKVCache) and eng.pages_per_slot == 64 // 16
        assert eng.cache.num_pages == eng.trash_page + 1 == 4 * 4 + 1
        assert (eng.page_tables == eng.trash_page).all()
        return
    if field == "spec_tick":
        assert Engine(cfg, params, tok, EngineConfig(spec_tick=value)).spec == value
        with pytest.raises(ValueError, match="requires draft"):
            Engine(cfg, params, tok, EngineConfig(spec_tick=value, spec_mode="draft"))
        return
    if field == "kv_quant":
        with pytest.raises(ValueError, match="unsupported kv_quant 'int4'"):
            Engine(cfg, params, tok, EngineConfig(**{field: value}))
        return
    if field == "prefill_chunk":
        for bad in (dict(prefill_chunk=24), dict(prefill_chunk=8),
                    dict(prefill_chunk=16, prefill_chunk_min=8)):
            with pytest.raises(ValueError):
                Engine(cfg, params, tok, EngineConfig(**bad))
        eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=2, prefill_chunk=value))
        assert (eng.pf_chunk, eng.pf_engage) == (16, 64)
        eng, (got,) = serve(cfg, params, tok,
                            EngineConfig(max_batch_size=2, prefill_chunk=value,
                                         prefill_chunk_min=value),
                            [Request(prompt="abcdefghij" * 3, steps=6, temperature=0.0)])
        assert got == oracle(jcfg, np_params, tok, "abcdefghij" * 3, 6)
        assert eng.phases.counts["pf_chunk"] == 2 and eng.stats()["engine_errors"] == 0
        return
    if field in ("tp_size", "dp_size"):
        # ported: one process a rank, so outside a process group of tp * dp
        # ranks the Engine refuses, naming init_distributed
        with pytest.raises(ValueError, match="init_distributed"):
            Engine(cfg, params, tok, EngineConfig(**{field: value}))
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(cfg, params, tok, EngineConfig(**{field: value}))


@pytest.mark.parametrize("args", [(1, 1, 8, 16), (3, 1, 8, 512), (1, 1, 8, 1024),
                                  (3, 1, 8, 1024), (3, 2, 8, 1024), (8, 1, 8, 2048)])
def test_bucket_k_matches_jax(args):
    assert eng_mod._bucket_k(*args) == j_engine._bucket_k(*args)


@pytest.mark.parametrize("t_pad,dp", [(2048, 1), (1024, 1), (16384, 1), (2048, 8),
                                      (2048, 3), (16, 1)])
def test_prefill_k_cap_matches_jax(t_pad, dp):
    assert eng_mod._prefill_k_cap(t_pad, dp) == j_engine._prefill_k_cap(t_pad, dp)


def _jax_tokenizer(vocab_size: int):
    from rama_tpu.tokenizer import Tokenizer as JTok

    vocab = ["<unk>", "<s>", "</s>"] + [chr(ord("a") + i % 26) + ("" if i < 26 else str(i // 26))
                                        for i in range(vocab_size - 3)]
    return JTok(vocab, [0.0] * vocab_size, max_token_length=4)


@pytest.mark.parametrize("bits", [8, 4])
def test_bf16_scale_engine_streams_match_jax(engine_setup, bits):
    """Greedy streams of a scale_dtype="bf16" engine equal the JAX engine's
    with the same setting, on the same int8 / int4 weights; the port's
    params hold bf16 scales, fused then cast as the JAX engine does."""
    import jax.numpy as jnp

    from rama_tpu.config import EngineConfig as JEcfg
    from rama_tpu.models import llama as jl
    from rama_tpu.runtime.engine import Engine as JEngine
    from rama_tpu.runtime.engine import Request as JRequest
    from rama_tpu_torch.models.llama import quantize_params

    jcfg, cfg, np_params, _, tok = engine_setup
    jp = jl.quantize_params(jcfg, np_params, bits=bits, group_size=16, dtype=jnp.float32)
    tp = quantize_params(cfg, np_params, bits=bits, group_size=16, dtype=torch.float32,
                         device="cpu")
    specs = (("abc", 10), ("zq", 6), ("hello", 8))
    jeng = JEngine(jcfg, jp, _jax_tokenizer(cfg.vocab_size),
                   JEcfg(max_batch_size=4, scale_dtype="bf16"))
    jeng.start()
    try:
        jreqs = [JRequest(prompt=p, steps=n, temperature=0.0) for p, n in specs]
        for r in jreqs:
            jeng.submit(r)
        want = [collect(r) for r in jreqs]
    finally:
        jeng.stop()
    eng, got = serve(cfg, tp, tok, EngineConfig(max_batch_size=4, scale_dtype="bf16"),
                     [Request(prompt=p, steps=n, temperature=0.0) for p, n in specs])
    assert eng.params["wqkv"].scales.dtype == eng.params["w13"].scales.dtype == torch.bfloat16
    assert eng.params["w13"].bits == bits and eng.stats()["engine_errors"] == 0
    assert got == want


def test_bf16_scale_engine_leaves_the_draft_scales_as_loaded(engine_setup):
    """scale_dtype casts the target's scales only; a quantized draft keeps
    its f32 scales, as the JAX engine leaves its draft's."""
    from rama_tpu_torch.models.llama import quantize_params

    _, cfg, np_params, _, tok = engine_setup
    qp = quantize_params(cfg, np_params, bits=8, group_size=16, dtype=torch.float32,
                         device="cpu")
    eng = Engine(cfg, qp, tok, EngineConfig(max_batch_size=2, scale_dtype="bf16",
                                            spec_tick=2, spec_mode="draft"),
                 draft=(cfg, qp))
    assert eng.params["wqkv"].scales.dtype == torch.bfloat16
    assert eng.dparams["wqkv"].scales.dtype == eng.dparams["wo"].scales.dtype == torch.float32
