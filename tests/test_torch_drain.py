"""The graceful stop's drain when fetching an admission's first tokens
fails: rama_tpu's drain (engine.py:1697) clears the unfetched admissions,
so their clients would wait forever; the port ends every such request with
an error and its end-of-stream sentinel and releases its pages (ROADMAP §3,
a deliberate difference). Under a mesh, rank 0's stop broadcast to the
followers comes from the thread that runs the group's collectives."""

import threading
import time

import pytest
import torch

from _torch_port import torch_cfg
from rama_tpu.testing.ref_model import random_params, tiny_config
from rama_tpu_torch.config import EngineConfig
from rama_tpu_torch.models import llama as tl
from rama_tpu_torch.runtime.engine import _OP_STOP, Engine, Request
from rama_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)


def _engine(**kw) -> Engine:
    jcfg = tiny_config(seq_len=64)
    cfg = torch_cfg(jcfg)
    params = tl.load_params(cfg, random_params(jcfg, seed=31), dtype=torch.float32,
                            device="cpu")
    vocab = ["<unk>", "<s>", "</s>"] + [chr(ord("a") + i % 26) + ("" if i < 26 else str(i // 26))
                                        for i in range(cfg.vocab_size - 3)]
    tok = Tokenizer(vocab, [0.0] * cfg.vocab_size, max_token_length=4)
    return Engine(cfg, params, tok, EngineConfig(max_batch_size=4, decode_tick=2, **kw))


@pytest.mark.parametrize("kw", [dict(paged_kv=True, kv_page_size=16), {}])
def test_a_failing_drain_ends_every_admitted_request(monkeypatch, kw):
    """Two admissions dispatched and unfetched (two jobs), then stop: the
    drain's first fetch raises. Every request of both jobs, the one the
    drain was completing included, ends with an error and its sentinel;
    every slot is free and every page back in the pool."""
    eng = _engine(**kw)
    reqs = [Request(prompt=p, steps=8, temperature=0.0) for p in ("abc", "zq", "hello", "ba")]
    for group in (reqs[:2], reqs[2:]):
        for r in group:
            eng.submit(r)
        eng._admit_dispatch()
    assert len(eng._admit_jobs) == 2
    if eng.paged:
        assert eng.allocator.available() < eng.trash_page

    def failing(fetch):
        raise RuntimeError("injected fetch failure")

    monkeypatch.setattr(Engine, "_fetched", staticmethod(failing))
    eng._stop.set()
    eng._loop()                                   # the loop exits at once, then drains
    for r in reqs:
        assert r.error == "engine error during prefill"
        assert r.queue.get_nowait() is None and r.queue.empty()
    assert not eng._admit_jobs and all(s.free and not s.prefilling for s in eng.slots)
    if eng.paged:
        assert eng.allocator.available() == eng.trash_page
        assert (eng.page_tables == eng.trash_page).all()


def test_a_drain_that_emits_keeps_the_streams():
    """Without a failure the drain emits the unfetched first tokens as before."""
    eng = _engine()
    r = Request(prompt="abc", steps=8, temperature=0.0)
    eng.submit(r)
    eng._admit_dispatch()
    eng._stop.set()
    eng._loop()
    assert r.error is None and r.queue.get_nowait() is not None
    assert not eng._admit_jobs and eng.slots[0].request is r


def _announcing_engine(monkeypatch) -> tuple:
    """A one-rank engine that leads as rank 0 of a mesh would, its
    broadcasts recorded as (op, the sending thread's name)."""
    eng = _engine()
    eng.leads = True
    sent = []
    monkeypatch.setattr(eng, "_announce",
                        lambda op, *a: sent.append((op, threading.current_thread().name)))
    return eng, sent


def test_the_loop_thread_sends_the_followers_stop_after_its_drain(monkeypatch):
    """A served request, then stop(): the stop is broadcast once, last, by
    the loop's own thread, so no second thread runs a collective on the
    group while the loop may still be inside one."""
    eng, sent = _announcing_engine(monkeypatch)
    r = Request(prompt="abc", steps=4, temperature=0.0)
    eng.start()
    eng.submit(r)
    deadline = time.time() + 60
    while r.queue.get(timeout=max(0.0, deadline - time.time())) is not None:
        pass
    eng.stop()
    assert not eng._thread.is_alive()
    assert [s for s in sent if s[0] == _OP_STOP] == [(_OP_STOP, "rama-torch-engine")]
    assert sent[-1][0] == _OP_STOP and len(sent) > 1


@pytest.mark.parametrize("loop", ["none", "stuck"])
def test_stop_from_the_caller_only_where_no_loop_runs(monkeypatch, loop):
    """No loop started: stop() broadcasts the stop itself. A loop still
    alive after the join's timeout: no broadcast from the caller (the
    followers end at the group's timeout)."""
    eng, sent = _announcing_engine(monkeypatch)
    if loop == "stuck":
        class Stuck:
            def join(self, timeout=None):
                pass

            def is_alive(self):
                return True

        eng._thread = Stuck()
    eng.stop()
    assert sent == ([(_OP_STOP, threading.current_thread().name)] if loop == "none" else [])
