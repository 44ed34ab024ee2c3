"""Speculative serving in rama_tpu_torch's engine on the CPU (fp32 tiny
model, as the JAX package's speculation tests): with spec_tick 3 the
greedy streams equal the JAX engine's speculative streams and the port's
spec-off streams, on a dense and an int8 KV cache; sampled streams at
temperature 0.9 are identical with speculation on and off; a draft model
equal to the target accepts every draft; forced dormancy (and, in draft
mode, the resync of the draft cache) leaves the streams unchanged; the
draft cache has no hole after a full accept (the reference's has); and the
server's load_engine wires the spec flags; a model of GQA group 8 speculates
at spec_tick 7 and 3 on dense, int8 and paged caches with the JAX engine's
greedy streams. Streams are compared exactly."""

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
from rama_tpu_torch.runtime import engine as eng_mod
from rama_tpu_torch.runtime.engine import Engine, Request
from rama_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

PROMPTS = (("abab", 16), ("zq", 9), ("abcabc", 12))


def _vocab(n):
    return ["<unk>", "<s>", "</s>"] + [chr(ord("a") + i % 26) + ("" if i < 26 else str(i // 26))
                                      for i in range(n - 3)]


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_config(seq_len=64)
    np_params = random_params(jcfg, seed=31)
    cfg = torch_cfg(jcfg)
    dj = tiny_config(dim=32, hidden_dim=96, n_layers=2, n_heads=2, n_kv_heads=2, seq_len=64)
    dparams = tl.load_params(torch_cfg(dj), random_params(dj, seed=77), dtype=torch.float32,
                             device="cpu")
    params = tl.load_params(cfg, np_params, dtype=torch.float32, device="cpu")
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
    assert all(r.error is None for r in reqs)
    return outs


def run(setup, ecfg, specs=PROMPTS, temperature=0.0, draft=None):
    _, _, cfg, params, _, tok = setup
    eng = Engine(cfg, params, tok, ecfg, draft=draft)
    outs = serve(eng, specs, temperature)
    assert eng.stats()["engine_errors"] == 0
    return outs, eng


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_ngram_greedy_equals_jax_engine_and_spec_off(setup, kv_quant):
    jcfg, np_params, *_ = setup
    jeng = JEngine(jcfg, jl.load_params(jcfg, np_params, dtype=jnp.float32),
                   JTok(_vocab(jcfg.vocab_size), [0.0] * jcfg.vocab_size, max_token_length=4),
                   JEcfg(max_batch_size=4, spec_tick=3, kv_quant=kv_quant))
    want = serve(jeng, PROMPTS, cls=JRequest)
    off, _ = run(setup, EngineConfig(max_batch_size=4, kv_quant=kv_quant))
    on, eng = run(setup, EngineConfig(max_batch_size=4, spec_tick=3, kv_quant=kv_quant))
    assert on == want == off
    stats = eng.stats()
    assert isinstance(stats["spec_accept_rate"], float)
    assert stats["spec_dormant_ticks"] is not None and eng.metrics["spec_drafted"] > 0


@pytest.fixture(scope="module")
def gqa8():
    """A tiny model of GQA group 8 (8 query heads over 1 kv head, as
    TinyLlama-1.1B's 32 over 4): a verify round of T 8 is 64 query rows a
    kv head, of T 4 32 rows; the card runs them in the 64- and 32-row
    forms of the chunk attention."""
    jcfg = tiny_config(dim=128, n_heads=8, n_kv_heads=1, seq_len=64)
    np_params = random_params(jcfg, seed=41)
    cfg = torch_cfg(jcfg)
    params = tl.load_params(cfg, np_params, dtype=torch.float32, device="cpu")
    tok = Tokenizer(_vocab(cfg.vocab_size), [0.0] * cfg.vocab_size, max_token_length=4)
    return jcfg, np_params, cfg, params, None, tok


@pytest.mark.parametrize("spec_tick", [7, 3])
@pytest.mark.parametrize("cache", ["bf16", "int8", "paged"])
def test_gqa8_greedy_equals_jax_engine_and_spec_off(gqa8, spec_tick, cache):
    """Group 8 at spec_tick 7 (T 8) and 3 (T 4) on a dense, an int8 and a
    paged (16-row pages) cache: the greedy streams equal the JAX engine's
    speculative streams and the port's spec-off streams ("bf16": the
    params' dtype, fp32 here, as every stream test of this file)."""
    jcfg, np_params, *_ = gqa8
    extra = {"int8": dict(kv_quant="int8"), "paged": dict(paged_kv=True, kv_page_size=16)}.get(
        cache, {})
    jeng = JEngine(jcfg, jl.load_params(jcfg, np_params, dtype=jnp.float32),
                   JTok(_vocab(jcfg.vocab_size), [0.0] * jcfg.vocab_size, max_token_length=4),
                   JEcfg(max_batch_size=4, spec_tick=spec_tick, **extra))
    want = serve(jeng, PROMPTS, cls=JRequest)
    off, _ = run(gqa8, EngineConfig(max_batch_size=4, **extra))
    on, eng = run(gqa8, EngineConfig(max_batch_size=4, spec_tick=spec_tick, **extra))
    assert on == want == off
    assert eng.metrics["spec_drafted"] > 0


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_sampled_stream_identical_with_spec_on_and_off(setup, kv_quant):
    """Position-keyed sampling at temperature 0.9: speculation changes no
    token."""
    off, _ = run(setup, EngineConfig(max_batch_size=4, kv_quant=kv_quant), temperature=0.9)
    on, _ = run(setup, EngineConfig(max_batch_size=4, spec_tick=3, spec_rounds=2,
                                    kv_quant=kv_quant), temperature=0.9)
    assert on == off


def test_draft_mode_streams_equal_spec_off(setup):
    draft = setup[4]
    off, _ = run(setup, EngineConfig(max_batch_size=4), temperature=0.7)
    on, eng = run(setup, EngineConfig(max_batch_size=4, spec_tick=3, spec_mode="draft"),
                  temperature=0.7, draft=draft)
    assert on == off and eng.stats()["spec_accept_rate"] is not None


def test_draft_equal_to_target_accepts_everything(setup):
    _, _, cfg, params, _, _ = setup
    off, _ = run(setup, EngineConfig(max_batch_size=2), specs=[("abab", 20)])
    on, eng = run(setup, EngineConfig(max_batch_size=2, spec_tick=3, spec_mode="draft"),
                  specs=[("abab", 20)], draft=(cfg, params))
    assert on == off
    assert eng.stats()["spec_accept_rate"] == pytest.approx(1.0)


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_forced_dormancy_keeps_the_stream(setup, monkeypatch, mode):
    """A threshold no round reaches: spec probes, sleeps through plain ticks,
    (draft mode: replays the gap through the draft model) and probes again;
    the streams are the plain engine's."""
    monkeypatch.setattr(eng_mod, "_SPEC_DORMANT_TICKS", 2)
    monkeypatch.setattr(eng_mod, "_SPEC_PROBE_ROUNDS", 1)
    specs = [("abab", 40), ("zq", 33)]
    off, _ = run(setup, EngineConfig(max_batch_size=2, decode_tick=2), specs=specs)
    on, eng = run(setup, EngineConfig(max_batch_size=2, decode_tick=2, spec_tick=3,
                                      spec_rounds=1, spec_mode=mode, spec_min_accept=1.01),
                  specs=specs, draft=setup[4] if mode == "draft" else None)
    assert on == off
    stats = eng.stats()
    assert stats["spec_dormancies"] >= 2
    assert mode == "ngram" or stats["draft_resyncs"] >= 1


def test_spec_mode_checks(setup):
    _, _, cfg, params, _, tok = setup
    with pytest.raises(ValueError, match="draft"):
        Engine(cfg, params, tok, EngineConfig(spec_tick=3, spec_mode="draft"))
    with pytest.raises(ValueError, match="spec_mode"):
        Engine(cfg, params, tok, EngineConfig(spec_tick=3, spec_mode="banana"))


def test_draft_cache_has_no_hole_after_a_full_accept(setup):
    """One round of k = 3 with the target as its own draft accepts all three
    drafts and emits pos .. pos + 3; the port's draft cache then holds row
    pos + 3 (the last draft's K, as the target cache holds it), where the
    reference's draft scan of k steps leaves that row unwritten."""
    jcfg, np_params, cfg, params, _, tok = setup
    ecfg = dict(max_batch_size=1, spec_tick=3, spec_rounds=1, spec_mode="draft")
    eng = Engine(cfg, params, tok, EngineConfig(**ecfg), draft=(cfg, params))
    assert len(serve(eng, [("abab", 5)])[0]) == 5
    row = 1 + 4 + 3                    # BOS + prompt, then the round's pos + k
    assert eng.stats()["spec_accept_rate"] == pytest.approx(1.0)
    assert eng.dcache.k[:, 0, :, row].abs().sum() > 0
    torch.testing.assert_close(eng.dcache.k[:, 0, :, row], eng.cache.k[:, 0, :, row],
                               atol=1e-5, rtol=0)
    jp = jl.load_params(jcfg, np_params, dtype=jnp.float32)
    jeng = JEngine(jcfg, jp, JTok(_vocab(jcfg.vocab_size), [0.0] * jcfg.vocab_size,
                                  max_token_length=4), JEcfg(**ecfg), draft=(jcfg, jp))
    serve(jeng, [("abab", 5)], cls=JRequest)
    assert not np.asarray(jeng.dcache.k[:, 0, :, row]).any()
    assert np.asarray(jeng.dcache.k[:, 0, :, row - 1]).any()


def test_load_engine_wires_the_spec_flags(setup, tmp_path):
    """--spec-tick / --spec-mode / --spec-draft-model through load_engine:
    the draft checkpoint loads dense in the server's dtype, and the stream
    equals the plain engine's."""
    from rama_tpu_torch.checkpoint import save_v0
    from rama_tpu_torch.server.app import load_engine

    jcfg, np_params, cfg, *_ = setup
    dj = tiny_config(dim=32, hidden_dim=96, n_layers=2, n_heads=2, n_kv_heads=2, seq_len=64)
    model, dmodel = str(tmp_path / "m.bin"), str(tmp_path / "d.bin")
    save_v0(model, cfg, np_params)
    save_v0(dmodel, torch_cfg(dj), random_params(dj, seed=77))
    tok_path = write_tokenizer_bin(tmp_path / "tok.bin", cfg.vocab_size)
    outs = []
    for kw in ({}, {"spec_tick": 3}, {"spec_tick": 3, "spec_mode": "draft",
                                       "spec_draft_model": dmodel}):
        eng = load_engine(model, tok_path, quant="none", dtype="float32", batch=2,
                          device="cpu", **kw)
        assert eng.spec == kw.get("spec_tick", 0)
        assert (eng.dcfg is not None) == ("spec_draft_model" in kw)
        outs.append(serve(eng, [("abab", 12)]))
    assert outs[0] == outs[1] == outs[2]
