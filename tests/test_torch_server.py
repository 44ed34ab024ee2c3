"""rama_tpu_torch's HTTP server (server/app.py) around the port's engine on
the CPU: SSE framing vs the greedy oracle, newline escaping, parameter
validation, 503 on a full queue, the truncation comment, error events,
cancel on disconnect, and the auxiliary routes — mirroring
tests/test_server.py."""

import asyncio

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from _torch_port import torch_cfg
from rama_tpu.testing.ref_model import RefModel, random_params, tiny_config
from rama_tpu_torch.config import EngineConfig
from rama_tpu_torch.models.llama import load_params
from rama_tpu_torch.runtime.engine import Engine, Request
from rama_tpu_torch.server.app import build_app, main
from rama_tpu_torch.tokenizer import BOS_ID, Tokenizer

torch.set_num_threads(1)


def make_newline_tokenizer(vocab_size: int) -> Tokenizer:
    """26 single-char tokens and a tail of newline-bearing tokens, so the
    generated streams exercise the \\n escaping."""
    singles = [chr(ord("a") + i) for i in range(26)]
    tail = [chr(ord("a") + i % 26) + str(i) + "\n"
            for i in range(vocab_size - 3 - len(singles))]
    vocab = ["<unk>", "<s>", "</s>"] + singles + tail
    return Tokenizer(vocab, [0.0] * vocab_size, max_token_length=8)


@pytest.fixture(scope="module")
def served_engine():
    jcfg = tiny_config(seq_len=64)
    np_params = random_params(jcfg, seed=77)
    cfg = torch_cfg(jcfg)
    tok = make_newline_tokenizer(cfg.vocab_size)
    eng = Engine(cfg, load_params(cfg, np_params, dtype=torch.float32, device="cpu"), tok,
                 EngineConfig(max_batch_size=4))
    eng.start()
    yield jcfg, np_params, tok, eng
    eng.stop()


def oracle_ids(jcfg, np_params, steps):
    ref = RefModel(jcfg, np_params)
    logits = ref.step(BOS_ID, 0)
    out, pos = [], 1
    while len(out) < steps:
        nxt = int(np.argmax(logits))
        out.append(nxt)
        if nxt == 2:
            break
        logits = ref.step(nxt, pos)
        pos += 1
    return out


def parse_sse(body: str):
    comments, datas, events = [], [], []
    for block in body.split("\n\n"):
        for line in block.split("\n"):
            if line.startswith(": "):
                comments.append(line[2:])
            elif line.startswith("data: "):
                datas.append(line[len("data: "):])
            elif line.startswith("event: "):
                events.append(line[len("event: "):])
    return comments, datas, events


def run_client(engine, fn):
    async def main_():
        client = TestClient(TestServer(build_app(engine)))
        await client.start_server()
        try:
            return await fn(client)
        finally:
            await client.close()

    return asyncio.run(main_())


def test_gen_stream_matches_oracle_and_escapes_newlines(served_engine):
    jcfg, np_params, tok, eng = served_engine

    async def fn(client):
        resp = await client.get("/gen", params={"prompt": "", "steps": "8",
                                                "temperature": "0.0"})
        assert resp.status == 200
        assert resp.headers["Content-Type"] == "text/event-stream"
        return await asyncio.wait_for(resp.text(), timeout=120)

    _, datas, events = parse_sse(run_client(eng, fn))
    assert not events
    want = [tok.decode_token(i) for i in oracle_ids(jcfg, np_params, 8)]
    assert [d.replace("\\n", "\n") for d in datas] == want
    for d, w in zip(datas, want):
        assert "\n" not in d
        if "\n" in w:
            assert "\\n" in d


def test_gen_rejects_bad_params(served_engine):
    eng = served_engine[3]

    async def fn(client):
        for params in ({"prompt": "a", "steps": "0"}, {"prompt": "a", "temperature": "abc"},
                       {"prompt": "a", "topp": "0"}, {"prompt": "a", "temperature": "11"}):
            resp = await client.get("/gen", params=params)
            assert resp.status == 400
            assert "error" in await resp.json()

    run_client(eng, fn)


def test_gen_truncation_comment(served_engine):
    eng = served_engine[3]

    async def fn(client):
        resp = await client.get("/gen", params={"prompt": "abcd" * 80, "steps": "2",
                                                "temperature": "0.0"})
        assert resp.status == 200
        return await asyncio.wait_for(resp.text(), timeout=120)

    comments, datas, _ = parse_sse(run_client(eng, fn))
    assert any("prompt truncated" in c for c in comments)
    assert datas


def test_gen_503_when_admission_full():
    jcfg = tiny_config(seq_len=32)
    cfg = torch_cfg(jcfg)
    params = load_params(cfg, random_params(jcfg, seed=5), dtype=torch.float32, device="cpu")
    # engine built but NOT started: nothing drains the bounded(30) queue
    eng = Engine(cfg, params, make_newline_tokenizer(cfg.vocab_size),
                 EngineConfig(max_batch_size=2))
    for _ in range(30):
        eng.submit(Request(prompt="", steps=1))

    async def fn(client):
        resp = await client.get("/gen", params={"prompt": "", "steps": "1"})
        assert resp.status == 503
        assert (await resp.json())["error"] == "server overloaded"

    run_client(eng, fn)


def test_gen_error_event():
    class FailingEngine:
        def submit(self, req, timeout=None):
            req.error = "injected failure"
            req.queue.put(None)
            return req

    async def fn(client):
        resp = await client.get("/gen", params={"prompt": "", "steps": "1"})
        assert resp.status == 200
        return await asyncio.wait_for(resp.text(), timeout=30)

    _, datas, events = parse_sse(run_client(FailingEngine(), fn))
    assert events == ["error"]
    assert "injected failure" in datas


def test_client_disconnect_cancels_request():
    """Closing the stream mid-generation marks the request cancelled, and
    the engine frees its slot."""
    jcfg = tiny_config(seq_len=64)
    cfg = torch_cfg(jcfg)
    params = load_params(cfg, random_params(jcfg, seed=6), dtype=torch.float32, device="cpu")
    eng = Engine(cfg, params, make_newline_tokenizer(cfg.vocab_size),
                 EngineConfig(max_batch_size=2, decode_tick=1))
    submitted = []
    orig = eng.submit

    def spy(req, timeout=None):
        submitted.append(req)
        return orig(req, timeout=timeout)

    eng.submit = spy
    eng.start()
    try:
        async def fn(client):
            resp = await client.get("/gen", params={"prompt": "ab", "steps": "60",
                                                    "temperature": "0.0"})
            await resp.content.readline()   # first frame arrived
            resp.close()
            for _ in range(200):
                await asyncio.sleep(0.05)
                if submitted and submitted[0].cancelled and eng.stats()["active_slots"] == 0:
                    break

        run_client(eng, fn)
        assert submitted[0].cancelled
        assert submitted[0].tokens_out < 60
        assert eng.stats()["active_slots"] == 0
    finally:
        eng.stop()


def test_home_chat_metrics_healthz(served_engine):
    eng = served_engine[3]

    async def fn(client):
        resp = await client.get("/")
        assert resp.status == 200 and "EventSource" in await resp.text()
        resp = await client.post("/chat", data="hello world")
        assert await resp.text() == "hello world"
        stats = await (await client.get("/metrics")).json()
        for key in ("tokens_generated", "requests_completed", "active_slots",
                    "queue_depth", "decode_tok_per_s", "ttft_p50_ms"):
            assert key in stats
        assert (await (await client.get("/healthz")).json())["ok"] is True

    run_client(eng, fn)


@pytest.mark.parametrize("flag", [["--paged"], ["--kv-quant", "int8"], ["--tp", "2"],
                                  ["--spec-tick", "2"], ["--quant", "int4"]])
def test_main_rejects_unported_flags(flag, capsys):
    assert main(["-m", "x.bin", "-t", "t.bin", *flag]) == 2
    assert "ROADMAP" in capsys.readouterr().err


def test_main_defaults_to_cuda_and_raises_without_gpu(tmp_path):
    """--device defaults to cuda; with no GPU the server refuses to start
    instead of serving from the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    from rama_tpu_torch.checkpoint import save_v0

    jcfg = tiny_config(seq_len=16)
    model = tmp_path / "m.bin"
    save_v0(str(model), torch_cfg(jcfg), random_params(jcfg, seed=1))
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["-m", str(model), "-t", "unused.bin"])
