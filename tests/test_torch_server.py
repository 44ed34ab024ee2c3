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

from _torch_port import torch_cfg, write_tokenizer_bin
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


class _Idle:
    """An engine stand-in for main(): starts and stops."""

    def start(self):
        pass

    def stop(self):
        pass


@pytest.mark.parametrize("flag", [["--paged"], ["--kv-quant", "int4"], ["--tp", "2"],
                                  ["--spec-tick", "2"], ["--scale-dtype", "bf16"]])
def test_main_rejects_unported_flags(flag, capsys, monkeypatch):
    """Unported flags exit 2 naming ROADMAP.md; --kv-quant takes int8 only,
    so argparse refuses int4 (exit 2); --spec-tick, --paged and
    --scale-dtype are ported: main hands them to load_engine (with
    --spec-mode / --spec-draft-model, and --page-size) and serves;
    --scale-dtype takes bf16 only, so argparse refuses fp16 (exit 2)."""
    if flag[0] == "--scale-dtype":
        from rama_tpu_torch.server import app

        seen = {}
        monkeypatch.setattr(app, "load_engine", lambda *a, **kw: seen.update(kw) or _Idle())
        monkeypatch.setattr(app.web, "run_app", lambda *a, **kw: None)
        assert main(["-m", "x.bin", "-t", "t.bin", *flag]) == 0
        assert seen["scale_dtype"] == "bf16"
        assert main(["-m", "x.bin", "-t", "t.bin"]) == 0
        assert seen["scale_dtype"] is None
        with pytest.raises(SystemExit) as exc:
            main(["-m", "x.bin", "-t", "t.bin", "--scale-dtype", "fp16"])
        assert exc.value.code == 2
        assert "invalid choice: 'fp16'" in capsys.readouterr().err
        return
    if flag[0] == "--paged":
        from rama_tpu_torch.server import app

        seen = {}
        monkeypatch.setattr(app, "load_engine", lambda *a, **kw: seen.update(kw) or _Idle())
        monkeypatch.setattr(app.web, "run_app", lambda *a, **kw: None)
        assert main(["-m", "x.bin", "-t", "t.bin", *flag, "--page-size", "16"]) == 0
        assert (seen["paged"], seen["page_size"]) == (True, 16)
        assert main(["-m", "x.bin", "-t", "t.bin"]) == 0
        assert (seen["paged"], seen["page_size"]) == (False, 128)
        return
    if flag[0] == "--spec-tick":
        from rama_tpu_torch.server import app

        seen = {}
        monkeypatch.setattr(app, "load_engine", lambda *a, **kw: seen.update(kw) or _Idle())
        monkeypatch.setattr(app.web, "run_app", lambda *a, **kw: None)
        assert main(["-m", "x.bin", "-t", "t.bin", *flag, "--spec-mode", "draft",
                     "--spec-draft-model", "d.bin"]) == 0
        assert (seen["spec_tick"], seen["spec_mode"], seen["spec_draft_model"]) == \
            (2, "draft", "d.bin")
        return
    if flag[0] == "--kv-quant":
        with pytest.raises(SystemExit) as exc:
            main(["-m", "x.bin", "-t", "t.bin", *flag])
        assert exc.value.code == 2
        assert "invalid choice: 'int4'" in capsys.readouterr().err
        return
    assert main(["-m", "x.bin", "-t", "t.bin", *flag]) == 2
    assert "ROADMAP" in capsys.readouterr().err


def test_load_engine_int4_streams_the_jax_greedy_chain(tmp_path):
    """`--quant int4`: load_engine quantizes a v0 checkpoint to packed int4
    at load (the layers; the classifier stays int8) and the engine streams
    over SSE the greedy chain of the JAX package's int4 model on the same
    checkpoint."""
    import jax.numpy as jnp

    from rama_tpu.models import llama as jl
    from rama_tpu_torch.checkpoint import save_v0
    from rama_tpu_torch.server.app import load_engine

    jcfg = tiny_config(seq_len=32)
    np_params = random_params(jcfg, seed=21)
    model = tmp_path / "m.bin"
    save_v0(str(model), torch_cfg(jcfg), np_params)
    tok_path = write_tokenizer_bin(tmp_path / "tok.bin", jcfg.vocab_size)
    eng = load_engine(str(model), tok_path, quant="int4", dtype="float32", batch=2,
                      device="cpu")
    assert eng.params["w2"].bits == 4 and eng.params["wcls"].bits == 8

    jp = jl.fuse_params(jl.quantize_params(jcfg, np_params, bits=4, dtype=jnp.float32), jcfg)
    cache = jl.KVCache.create(jcfg, 1, jcfg.seq_len, dtype=jnp.float32)
    ids, nxt = [], BOS_ID
    for pos in range(10):
        logits, cache = jl.decode_step(jp, jcfg, jnp.asarray([nxt], jnp.int32),
                                       jnp.asarray([pos], jnp.int32), cache)
        nxt = int(np.argmax(np.asarray(logits)[0]))
        ids.append(nxt)
        if nxt == 2:
            break
    eng.start()
    try:
        async def fn(client):
            resp = await client.get("/gen", params={"prompt": "", "steps": "10",
                                                    "temperature": "0.0"})
            assert resp.status == 200
            return await asyncio.wait_for(resp.text(), timeout=120)

        _, datas, events = parse_sse(run_client(eng, fn))
    finally:
        eng.stop()
    assert not events
    assert datas == [eng.tokenizer.decode_token(i).replace("\n", "\\n") for i in ids]


def test_load_engine_bf16_scales_stream_the_jax_greedy_chain(tmp_path):
    """`--quant int4 --scale-dtype bf16`: load_engine builds an engine whose
    quantized params hold bf16 scales, and it streams over SSE the greedy
    chain of the JAX package's int4 model after cast_scales."""
    import jax.numpy as jnp

    from rama_tpu.models import llama as jl
    from rama_tpu.ops.quant import cast_scales
    from rama_tpu_torch.checkpoint import save_v0
    from rama_tpu_torch.server.app import load_engine

    jcfg = tiny_config(seq_len=32)
    np_params = random_params(jcfg, seed=22)
    model = tmp_path / "m.bin"
    save_v0(str(model), torch_cfg(jcfg), np_params)
    tok_path = write_tokenizer_bin(tmp_path / "tok.bin", jcfg.vocab_size)
    eng = load_engine(str(model), tok_path, quant="int4", dtype="float32", batch=2,
                      device="cpu", scale_dtype="bf16")
    assert eng.params["w2"].bits == 4
    assert all(eng.params[n].scales.dtype == torch.bfloat16
               for n in ("wqkv", "wo", "w13", "w2", "wcls", "tok_embedding"))

    jp = cast_scales(jl.fuse_params(jl.quantize_params(jcfg, np_params, bits=4,
                                                       dtype=jnp.float32), jcfg),
                     jnp.bfloat16)
    cache = jl.KVCache.create(jcfg, 1, jcfg.seq_len, dtype=jnp.float32)
    ids, nxt = [], BOS_ID
    for pos in range(10):
        logits, cache = jl.decode_step(jp, jcfg, jnp.asarray([nxt], jnp.int32),
                                       jnp.asarray([pos], jnp.int32), cache)
        nxt = int(np.argmax(np.asarray(logits)[0]))
        ids.append(nxt)
        if nxt == 2:
            break
    eng.start()
    try:
        async def fn(client):
            resp = await client.get("/gen", params={"prompt": "", "steps": "10",
                                                    "temperature": "0.0"})
            assert resp.status == 200
            return await asyncio.wait_for(resp.text(), timeout=120)

        _, datas, events = parse_sse(run_client(eng, fn))
    finally:
        eng.stop()
    assert not events
    assert datas == [eng.tokenizer.decode_token(i).replace("\n", "\\n") for i in ids]


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
