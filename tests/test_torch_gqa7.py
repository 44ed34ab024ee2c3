"""A model of GQA group 7 (7 query heads over 1 kv head, head_dim 64, 2
layers: Yi-34B's group, whose prefill attention on the card runs kernel
5's "gqa" form) through the port against rama_tpu on the CPU: a ragged
prefill's logits and the decode steps after it (fp32, int8 and int4
weights), and the engine's greedy streams on a dense and an int8 cache,
with and without n-gram speculation (spec_tick 3: 28 query rows a kv head
a verify round), equal to the JAX engine's.

Tolerances: logits atol 1e-4 (fp32, same math, other summation order);
streams exact (fp32 params: the caches take the params' dtype)."""

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
from rama_tpu.testing.ref_model import random_params, tiny_config
from rama_tpu.tokenizer import Tokenizer as JTok
from rama_tpu_torch.config import EngineConfig
from rama_tpu_torch.models import llama as tl
from rama_tpu_torch.runtime.engine import Engine, Request
from rama_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

# dim 448 over 7 heads: head_dim 64; one kv head, so the group is 7
JCFG = tiny_config(dim=448, hidden_dim=176, n_layers=2, n_heads=7, n_kv_heads=1, seq_len=64)
PROMPTS = (("abab", 16), ("zq", 9), ("abcabc", 12))


def _vocab(n):
    return ["<unk>", "<s>", "</s>"] + [chr(ord("a") + i % 26) + ("" if i < 26 else str(i // 26))
                                      for i in range(n - 3)]


@pytest.fixture(scope="module")
def np_params():
    return random_params(JCFG, seed=47)


def _both(np_params, quant):
    cfg = torch_cfg(JCFG)
    if quant == "fp32":
        jp = jl.load_params(JCFG, np_params, dtype=jnp.float32)
        tp = tl.load_params(cfg, np_params, dtype=torch.float32, device="cpu")
    else:
        bits = 4 if quant == "int4" else 8
        jp = jl.quantize_params(JCFG, np_params, bits=bits, group_size=16, dtype=jnp.float32)
        tp = tl.quantize_params(cfg, np_params, bits=bits, group_size=16, dtype=torch.float32,
                                device="cpu")
    return cfg, jl.fuse_params(jp, JCFG), tl.fuse_params(tp, cfg)


def close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4, rtol=0)


@pytest.mark.parametrize("quant", ["fp32", "int8", "int4"])
def test_group7_ragged_prefill_and_decode_logits_match_jax(np_params, quant):
    """A padded prefill of 3 prompts (plen 16, 9 and 10: 9 is the "gqa"
    form's positions a q tile at group 7), the logits at each prompt's last
    row and its cache rows, then 3 decode steps at each slot's own
    position."""
    cfg, jp, tp = _both(np_params, quant)
    t_pad = 16
    lens = np.array([16, 9, 10], np.int32)
    toks = np.random.default_rng(7).integers(3, 128, (3, t_pad)).astype(np.int32)
    idx = np.arange(t_pad)[None, :]
    pos_index = np.where(idx < lens[:, None], idx, t_pad - 1).astype(np.int32)
    jc = jl.KVCache.create(JCFG, 3, 32, dtype=jnp.float32)
    tc = tl.KVCache.create(cfg, 3, 32, dtype=torch.float32, device="cpu")
    lj, jc = jl.forward(jp, JCFG, jnp.asarray(toks), jnp.asarray(pos_index), jc,
                        plen=jnp.asarray(lens), logit_rows=jnp.asarray(lens - 1))
    lt, tc = tl.forward(tp, cfg, torch.from_numpy(toks).long(),
                        torch.from_numpy(pos_index).long(), tc,
                        plen=torch.from_numpy(lens), logit_rows=torch.from_numpy(lens - 1))
    assert lt.shape == (3, 1, cfg.vocab_size)
    close(lt, lj)
    for b, n in enumerate(lens):   # the prompt rows (padding lands on row t_pad - 1)
        close(tc.k[:, b, :, :n], jc.k[:, b, :, :n])
        close(tc.v[:, b, :, :n], jc.v[:, b, :, :n])
    pos = lens.copy()
    for step in range(3):
        tok = np.array([11 + step, 5, 40 + step])
        lj, jc = jl.decode_step(jp, JCFG, jnp.asarray(tok, jnp.int32), jnp.asarray(pos), jc)
        lt, tc = tl.decode_step(tp, cfg, torch.from_numpy(tok), torch.from_numpy(pos).long(),
                                tc)
        close(lt, lj)
        pos = pos + 1


def _collect(req, timeout=120.0):
    out, deadline = [], time.time() + timeout
    while (t := req.queue.get(timeout=max(0.1, deadline - time.time()))) is not None:
        out.append(t)
    return out


def _serve(engine, cls):
    engine.start()
    try:
        reqs = [cls(prompt=p, steps=n, temperature=0.0) for p, n in PROMPTS]
        for r in reqs:
            engine.submit(r)
        outs = [_collect(r) for r in reqs]
    finally:
        engine.stop()
    assert all(r.error is None for r in reqs)
    return outs


@pytest.mark.parametrize("spec_tick", [0, 3])
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_group7_greedy_streams_equal_jax_engine(np_params, kv_quant, spec_tick):
    """The port's engine on the group-7 model (fp32 params) streams the
    JAX engine's greedy ids: plain decoding and n-gram speculation, on the
    dense cache and on the int8 cache (whose admission prefills through a
    scratch of the params' dtype, then inserts the strips)."""
    cfg = torch_cfg(JCFG)
    vocab = _vocab(cfg.vocab_size)
    ecfg = dict(max_batch_size=4, spec_tick=spec_tick, kv_quant=kv_quant)
    jeng = JEngine(JCFG, jl.load_params(JCFG, np_params, dtype=jnp.float32),
                   JTok(vocab, [0.0] * cfg.vocab_size, max_token_length=4), JEcfg(**ecfg))
    want = _serve(jeng, JRequest)
    eng = Engine(cfg, tl.load_params(cfg, np_params, dtype=torch.float32, device="cpu"),
                 Tokenizer(vocab, [0.0] * cfg.vocab_size, max_token_length=4),
                 EngineConfig(**ecfg))
    got = _serve(eng, Request)
    assert got == want
    assert all(len(s) == n for s, (_, n) in zip(got, PROMPTS))
    assert eng.stats()["engine_errors"] == 0
    if spec_tick:
        assert eng.metrics["spec_drafted"] > 0
