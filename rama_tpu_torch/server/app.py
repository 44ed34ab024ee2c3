"""HTTP inference server — the port of rama_tpu/server/app.py.

Routes as the reference server (server/src/main.rs:74-143) and the JAX
package's app:
- GET  /       -> HTML page with an EventSource client
- GET  /gen?prompt=...&steps=&temperature=&topp=&echo=  -> SSE token stream
  (newlines escaped as \\n, mod.rs:246), keep-alive comments on idle, an
  SSE comment when the prompt was truncated, `event: error` on failure,
  400 on bad parameters, 503 when the admission queue is full, cancel on
  client disconnect
- POST /chat   -> echo stub (main.rs:115-117)
- GET /metrics -> engine stats JSON;  GET /healthz

Run:  python -m rama_tpu_torch.server.app -m model.bin -t tokenizer.bin \
          [--address 0.0.0.0:3000] [--quant auto] [--batch 8] [--device cuda] \
          [--kv-quant int8] [--paged [--page-size 128]] [--spec-tick 3 \
          [--spec-mode draft --spec-draft-model draft.bin]] \
          [--warmup [--warmup-max-prompt 512]] [--compile-cache DIR]
"""

from __future__ import annotations

import argparse
import asyncio
import queue as queue_mod
import sys

from aiohttp import web

from rama_tpu_torch.config import EngineConfig
from rama_tpu_torch.runtime.engine import Engine, Request

HTML_PAGE = """<!DOCTYPE html>
<html>
<head><title>rama-tpu-torch</title>
<style>
 body { font-family: monospace; margin: 2rem auto; max-width: 46rem; }
 #out { white-space: pre-wrap; border: 1px solid #999; min-height: 8rem;
        padding: 1rem; margin-top: 1rem; }
 input { width: 80%; padding: .4rem; } button { padding: .4rem 1rem; }
</style></head>
<body>
<h2>rama-tpu-torch</h2>
<form id="f"><input id="p" placeholder="prompt..." autofocus>
<button>generate</button></form>
<div id="out"></div>
<script>
const f = document.getElementById('f'), p = document.getElementById('p'),
      out = document.getElementById('out');
let es = null;
f.addEventListener('submit', (e) => {
  e.preventDefault();
  if (es) es.close();
  out.textContent = '';
  es = new EventSource('/gen?prompt=' + encodeURIComponent(p.value));
  es.onmessage = (m) => { out.textContent += m.data.replaceAll('\\\\n', '\\n'); };
  es.onerror = () => es.close();
});
</script>
</body></html>"""


ENGINE_KEY = web.AppKey("engine", Engine)


def build_app(engine: Engine, default_steps: int = 255) -> web.Application:
    app = web.Application()
    app[ENGINE_KEY] = engine

    async def home(_req):
        return web.Response(text=HTML_PAGE, content_type="text/html")

    async def gen(request: web.Request):
        prompt = request.query.get("prompt", "")
        try:
            steps = int(request.query.get("steps", default_steps))
            temperature = float(request.query.get("temperature", 1.0))
            top_p = float(request.query.get("topp", 0.9))
        except ValueError as e:
            return web.json_response({"error": f"bad parameter: {e}"}, status=400)
        if steps < 1 or not (0.0 <= temperature <= 10.0) or not (0.0 < top_p <= 1.0):
            return web.json_response(
                {"error": "steps must be >=1, temperature in [0,10], topp in (0,1]"},
                status=400)
        echo = request.query.get("echo", "0") in ("1", "true")

        req = Request(prompt=prompt, steps=steps, temperature=temperature,
                      top_p=top_p, echo_prompt=echo)
        try:
            engine.submit(req, timeout=0.5)
        except queue_mod.Full:
            return web.json_response({"error": "server overloaded"}, status=503)

        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
        })
        await resp.prepare(request)
        if req.truncated:
            # SSE comment: visible to curious clients, ignored by EventSource
            await resp.write(
                f": prompt truncated ({req.truncated} tokens dropped "
                f"to fit max_seq_len)\n\n".encode())
        loop = asyncio.get_running_loop()
        try:
            while True:
                # bridge the engine thread's queue into asyncio, with a
                # keep-alive comment on idle (server/src/main.rs:109-112)
                try:
                    tok = await asyncio.wait_for(
                        loop.run_in_executor(None, req.queue.get, True, 15.0),
                        timeout=20.0)
                except (asyncio.TimeoutError, queue_mod.Empty):
                    await resp.write(b": keep-alive\n\n")
                    continue
                if tok is None:
                    if req.error:
                        await resp.write(
                            f"event: error\ndata: {req.error}\n\n".encode())
                    break
                data = tok.replace("\n", "\\n")
                await resp.write(f"data: {data}\n\n".encode())
        except (ConnectionResetError, asyncio.CancelledError):
            req.cancelled = True  # the engine frees the slot on its next tick
            raise
        await resp.write_eof()
        return resp

    async def chat(request: web.Request):
        # parity: the reference /chat just echoes the body (main.rs:115-117)
        return web.Response(text=await request.text())

    async def metrics(_req):
        return web.json_response(engine.stats())

    async def healthz(_req):
        return web.json_response({"ok": True})

    app.router.add_get("/", home)
    app.router.add_get("/gen", gen)
    app.router.add_post("/chat", chat)
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/healthz", healthz)
    return app


def load_engine(model_path: str, tokenizer_path: str, quant: str = "auto",
                dtype: str = "bfloat16", batch: int = 8,
                max_seq_len: int | None = None, device: str = "cuda",
                kv_quant: str | None = None, spec_tick: int = 0,
                spec_mode: str = "ngram", spec_draft_model: str | None = None,
                paged: bool = False, page_size: int = 128,
                scale_dtype: str | None = None, compile_cache: str | None = None) -> Engine:
    from rama_tpu_torch.cli import load_model
    from rama_tpu_torch.tokenizer import Tokenizer

    cfg, params, _ = load_model(model_path, quant, dtype, device)
    tokenizer = Tokenizer.from_file(tokenizer_path, cfg.vocab_size)
    draft = None
    if spec_draft_model:
        # dense in the server's dtype: a draft model is small enough that
        # quantizing it buys nothing (rama_tpu's load_engine)
        draft = load_model(spec_draft_model, "none", dtype, device)[:2]
    ecfg = EngineConfig(model_path=model_path, tokenizer_path=tokenizer_path,
                        max_batch_size=batch, max_seq_len=max_seq_len, kv_quant=kv_quant,
                        spec_tick=spec_tick, spec_mode=spec_mode, paged_kv=paged,
                        kv_page_size=page_size, scale_dtype=scale_dtype,
                        compile_cache=compile_cache)
    return Engine(cfg, params, tokenizer, ecfg, draft=draft)


# server flags of the JAX package whose features are not ported yet:
# (flag, attribute, value when unset, ROADMAP item)
_UNPORTED_FLAGS = (
    ("--prefill-chunk", "prefill_chunk", 0, "chunked prefill"),
    ("--tp", "tp", 1, "tensor/data/sequence parallelism"),
    ("--dp", "dp", 1, "tensor/data/sequence parallelism"),
    ("--seq-par", "seq_par", False, "tensor/data/sequence parallelism"),
    ("--coordinator", "coordinator", None, "multi-host serving"),
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rama-tpu-torch-server")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-t", "--tokenizer", required=True)
    ap.add_argument("--address", default="0.0.0.0:3000")  # main.rs default
    ap.add_argument("--quant", default="auto", choices=["auto", "none", "int8", "int4"])
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=255)
    ap.add_argument("--max-seq-len", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: one shared page pool (composes with --kv-quant "
                         "and --spec-tick)")
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--kv-quant", default=None, choices=["int8"])
    ap.add_argument("--scale-dtype", default=None, choices=["bf16"],
                    help="store weight-quant scales in bf16 (fewer weight bytes a "
                         "step for <=2^-9 scale rounding)")
    ap.add_argument("--spec-tick", type=int, default=0,
                    help="speculative serving: drafts per round, verified in one "
                         "chunk forward (0 = off)")
    ap.add_argument("--spec-mode", default="ngram", choices=["ngram", "draft"],
                    help="speculative proposer: n-gram prompt lookup or a resident "
                         "draft model (--spec-draft-model)")
    ap.add_argument("--spec-draft-model", default=None, metavar="BIN",
                    help=".bin checkpoint for --spec-mode draft (same vocab)")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--seq-par", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--warmup", action="store_true",
                    help="before accepting traffic, build and load every kernel and run "
                         "every decode tick and (k, T) prefill bucket once (no build or "
                         "first use inside a request; pair with --compile-cache to build "
                         "once a machine)")
    ap.add_argument("--warmup-max-prompt", type=int, default=None,
                    help="bound the warmed prefill T buckets to this prompt length "
                         "(default: up to --max-seq-len)")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="directory the CUDA kernels are built into and loaded from "
                         "(default build/rama_tpu_torch under the checkout)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for flag, attr, off, item in _UNPORTED_FLAGS:
        if getattr(args, attr) != off:
            print(f"{flag}: {item} is not ported to rama_tpu_torch yet (ROADMAP.md)",
                  file=sys.stderr)
            return 2
    engine = load_engine(args.model, args.tokenizer, args.quant, args.dtype,
                         args.batch, max_seq_len=args.max_seq_len, device=args.device,
                         kv_quant=args.kv_quant, spec_tick=args.spec_tick,
                         spec_mode=args.spec_mode, spec_draft_model=args.spec_draft_model,
                         paged=args.paged, page_size=args.page_size,
                         scale_dtype=args.scale_dtype, compile_cache=args.compile_cache)
    if args.warmup:
        w = engine.warmup(max_prompt=args.warmup_max_prompt)
        print(f"warmup: {w['programs']} programs in {w['seconds']:.1f}s", file=sys.stderr)
    engine.start()
    try:
        host, _, port = args.address.rpartition(":")
        web.run_app(build_app(engine, default_steps=args.steps),
                    host=host or "0.0.0.0", port=int(port))
    finally:
        engine.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
