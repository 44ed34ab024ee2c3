"""rama_tpu_torch's chat loop (runtime/chat.py) against rama_tpu's on the
CPU, on the same numpy weights (a tiny fp32 model of the fixture
tokenizer's 32000 ids): greedy ids and the running position equal over
three turns with a system prompt, each turn's mid-sequence padded prefill
equals rama_tpu's unpadded token-at-a-time decode loop, ChatContextFull
comes at the same turn, chat_repl's transcript equals rama_tpu's for the
same input lines, and a sampled chat depends only on its seed.

rama_tpu's session pads a turn's template with token 0 at the last real
position, so its pad columns overwrite that row's keys and values before
the real query reads them (test_jax_pad_columns_overwrite_the_last_row);
the port's pad columns repeat the last real token. Where these tests run
rama_tpu's session they give it the port's pad columns
(`jax_pad_repeats_the_last_token`), so both compute the unpadded turn.
"""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_prefill_repeating_the_last_token, torch_cfg
from rama_tpu.models import llama as jl
from rama_tpu.runtime import chat as j_chat
from rama_tpu.testing.ref_model import random_params, tiny_config
from rama_tpu.tokenizer import Tokenizer as JTok
from rama_tpu_torch.models import llama as tl
from rama_tpu_torch.runtime.chat import ChatContextFull, ChatSession, chat_repl
from rama_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tokenizer.bin")
TURNS = ("hello there", "how are you today", "tell me a story about a cat")


@pytest.fixture(scope="module")
def models():
    """{seed: (jcfg, JAX params, cfg, port params)} and both tokenizers."""
    out = {}
    for seed in (9, 3):
        jcfg = tiny_config(vocab_size=32000, seq_len=256)
        np_params = random_params(jcfg, seed=seed)
        cfg = torch_cfg(jcfg)
        out[seed] = (jcfg, jl.load_params(jcfg, np_params, dtype=jnp.float32), cfg,
                     tl.load_params(cfg, np_params, dtype=torch.float32, device="cpu"))
    return out, JTok.from_file(FIXTURE, 32000), Tokenizer.from_file(FIXTURE, 32000)


@pytest.fixture
def jax_pad_repeats_the_last_token(monkeypatch):
    monkeypatch.setattr(j_chat.ChatSession, "_prefill_chunk",
                        jax_prefill_repeating_the_last_token)


def jax_token_at_a_time(jcfg, jp, start_cache, start: int, ids: list[int], n: int):
    """rama_tpu's decode_step over `ids` from position `start`, then n
    greedy steps: (the prefill's last logits, the greedy ids, the cache)."""
    cache = start_cache
    for p, t in enumerate(ids):
        last, cache = jl.decode_step(jp, jcfg, jnp.asarray([t], jnp.int32),
                                     jnp.asarray([start + p], jnp.int32), cache)
    first = np.asarray(last[0])
    out, pos = [], start + len(ids)
    for _ in range(n):
        out.append(int(np.argmax(np.asarray(last[0]))))
        last, cache = jl.decode_step(jp, jcfg, jnp.asarray([out[-1]], jnp.int32),
                                     jnp.asarray([pos], jnp.int32), cache)
        pos += 1
    return first, out, cache


def sessions(models, seed, **kw):
    (jcfg, jp, cfg, tp), jtok, tok = models[0][seed], models[1], models[2]
    return (j_chat.ChatSession(jp, jcfg, jtok, cache_dtype=jnp.float32, **kw),
            ChatSession(tp, cfg, tok, **kw))


@pytest.mark.parametrize("seed", [9, 3])
def test_greedy_turns_equal_jax(models, seed, jax_pad_repeats_the_last_token):
    js, ts = sessions(models, seed, temperature=0.0, system="You answer briefly.")
    for text in TURNS:
        want = list(js.turn(text, max_new=12))
        got = list(ts.turn(text, max_new=12))
        assert got == want and len(got) >= 1
        assert (ts.pos, ts.turns) == (js.pos, js.turns)


def test_turn_equals_the_unpadded_token_at_a_time_loop(models):
    """The conversation's ids (templates and replies) stepped one token at
    a time from position 0 through rama_tpu's decode_step: the same greedy
    replies, each turn's last-prefill logits and every cache row written
    within 1e-5 (the pad columns write the last real row's own values)."""
    jcfg, jp, cfg, tp = models[0][9]
    ts = ChatSession(tp, cfg, models[2], temperature=0.0, system="You answer briefly.")
    prefills, prefill = [], ts._prefill_chunk

    def spy(ids):
        prefills.append((ts.pos, list(ids), prefill(ids)))
        return prefills[-1][2]

    ts._prefill_chunk = spy
    replies = [list(ts.turn(text, max_new=8)) for text in TURNS]
    cache = jl.KVCache.create(jcfg, 1, dtype=jnp.float32)
    for (start, ids, logits), reply in zip(prefills, replies):
        first, greedy, cache = jax_token_at_a_time(jcfg, jp, cache, start, ids, len(reply))
        np.testing.assert_allclose(logits.numpy(), first, rtol=1e-5, atol=1e-5)
        assert [models[2].decode_token(i) for i in greedy] == reply
    np.testing.assert_allclose(ts.cache.k[:, :, :, :ts.pos].numpy(),
                               np.asarray(cache.k)[:, :, :, :ts.pos], rtol=1e-5, atol=1e-5)


def test_jax_pad_columns_overwrite_the_last_row(models):
    """The deliberate difference: rama_tpu's padded turn (pad token 0 at the
    last real position) moves that position's logits away from its own
    token-at-a-time loop; the port's stays on it."""
    jcfg, jp, cfg, tp = models[0][9]
    js, ts = sessions(models, 9, temperature=0.0, system="You answer briefly.")
    ids = js._template(TURNS[0])
    assert len(ids) < j_chat._bucket(len(ids))          # the turn has pad columns
    want, _, _ = jax_token_at_a_time(jcfg, jp, jl.KVCache.create(jcfg, 1, dtype=jnp.float32),
                                     0, ids, 0)
    assert np.abs(np.asarray(js._prefill_chunk(ids)) - want).max() > 1e-2
    np.testing.assert_allclose(ts._prefill_chunk(ids).numpy(), want, rtol=1e-5, atol=1e-5)


def test_context_full_at_the_same_turn(models, jax_pad_repeats_the_last_token):
    (jcfg, jp, cfg, tp), jtok, tok = models[0][3], models[1], models[2]
    small = jcfg.replace(seq_len=64)
    js = j_chat.ChatSession(jp, small, jtok, temperature=0.0, cache_dtype=jnp.float32)
    ts = ChatSession(tp, torch_cfg(small), tok, temperature=0.0)

    def turns(s):
        for i in range(20):
            try:
                list(s.turn(TURNS[i % 3], max_new=6))
            except (ChatContextFull, j_chat.ChatContextFull) as e:
                return i, s.pos, type(e).__name__
        return None

    got, want = turns(ts), turns(js)
    assert got == want and got is not None and got[2] == "ChatContextFull"
    late_j, late_t = sessions(models, 3, temperature=0.0)
    late_j.pos = late_t.pos = 256 - 2
    with pytest.raises(j_chat.ChatContextFull):
        list(late_j.turn("way too late", max_new=4))
    with pytest.raises(ChatContextFull):
        list(late_t.turn("way too late", max_new=4))


def test_chat_repl_transcript_equals_jax(models, jax_pad_repeats_the_last_token):
    (jcfg, jp, cfg, tp), jtok, tok = models[0][9], models[1], models[2]
    outs = []
    for repl, params, c, t, kw in ((j_chat.chat_repl, jp, jcfg, jtok,
                                    dict(cache_dtype=jnp.float32)),
                                   (chat_repl, tp, cfg, tok, {})):
        lines = iter(["hello there", "how are you today", "exit"])
        out = io.StringIO()
        assert repl(params, c, t, temperature=0.0, system="You answer briefly.", max_new=10,
                    input_fn=lambda prompt: next(lines), out=out, **kw) == 0
        outs.append(out.getvalue())
    assert outs[1] == outs[0] and outs[1].count("Assistant: ") == 2


def test_sampled_chat_depends_only_on_its_seed(models):
    _, _, cfg, tp = models[0][9]

    def run(seed):
        s = ChatSession(tp, cfg, models[2], temperature=1.0, top_p=0.9, seed=seed)
        return [list(s.turn(text, max_new=12)) for text in TURNS]

    first = run(7)
    assert run(7) == first and run(8) != first
