"""One rank of a rama_tpu_torch tensor / data-parallel group on the CPU (not a
pytest module; tests/test_torch_tp_engine.py spawns tp * dp of them).

Usage: python tests/_torch_tp_worker.py RANK WORLD PORT SPEC.json OUT_PREFIX

The ranks join a gloo process group (parallel.distributed.init_distributed)
and a (dp, tp) mesh of CPU devices, load the same fp32 numpy params from
the spec's npz, and run the spec's jobs in order:
- "logits": three decode steps and a prefill through the model functions on
  this rank's shard (`tp_group`), the slots over the data groups, the
  decode steps under models.llama.ATTN_BLOCK "attn_block" (default 0); the
  replicas' logits are gathered and rank 0 keeps them, with the attention
  block mode the steps took;
- "serve": an Engine of the job's EngineConfig (weights quantized at load
  with "quant"; a draft model with "draft"; rank 0 runs Engine.warmup()
  first with "warmup"; "engine_consts" sets runtime.engine's module
  constants on every rank). Rank 0 serves the requests and keeps their
  greedy streams; the other ranks run Engine.follow(). Every rank keeps
  the tokens of each of its device calls (Engine.outputs);
- "kill_follower": as "serve", but the last rank exits abruptly (os._exit)
  at its third tick: rank 0 keeps each request's error and the seconds it
  took to end.
Each rank writes its results as JSON to OUT_PREFIX.RANK.json.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rama_tpu_torch.config import EngineConfig, ModelConfig  # noqa: E402
from rama_tpu_torch.models import llama as tl  # noqa: E402
from rama_tpu_torch.parallel.distributed import (init_distributed,  # noqa: E402
                                                  shutdown_distributed)
from rama_tpu_torch.parallel.mesh import all_gather, make_mesh  # noqa: E402
from rama_tpu_torch.parallel.tp import shard_config, shard_params  # noqa: E402
from rama_tpu_torch.runtime import engine as eng_mod  # noqa: E402
from rama_tpu_torch.runtime.engine import Engine, Request  # noqa: E402
from rama_tpu_torch.tokenizer import Tokenizer  # noqa: E402

torch.set_num_threads(1)


def vocab(n):
    return ["<unk>", "<s>", "</s>"] + [chr(ord("a") + i % 26) + ("" if i < 26 else str(i // 26))
                                      for i in range(n - 3)]


def load(cfg: ModelConfig, npz: str, quant):
    np_params = dict(np.load(npz))
    if quant:
        return tl.quantize_params(cfg, np_params, bits=8 if quant == "int8" else 4,
                                  group_size=16, dtype=torch.float32, device="cpu")
    return tl.load_params(cfg, np_params, dtype=torch.float32, device="cpu")


def logits_job(cfg, params, mesh, job):
    """Decode steps from position 0 and a prefill of job["prefill"] tokens
    on this rank's shard; the replicas' logits gathered over the data
    group."""
    lcfg = shard_config(cfg, mesh.tp)
    local = tl.fuse_params(shard_params(params, cfg, mesh), lcfg)
    b = job["batch"] // mesh.dp
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    cache = tl.KVCache.create(lcfg, batch=b, dtype=torch.float32, device="cpu")
    logits = None
    tl.ATTN_BLOCK = job.get("attn_block", 0)
    try:
        mode = tl.attn_block_mode(local, lcfg, cache, b)
        for pos, tok in enumerate(job["decode"]):
            logits, cache = tl.decode_step(local, lcfg, torch.full((b,), tok),
                                           torch.full((b,), pos), cache,
                                           tp_group=mesh.model_group)
    finally:
        tl.ATTN_BLOCK = 0
    tokens = torch.tensor(job["prefill"])[rows]
    cache = tl.KVCache.create(lcfg, batch=b, dtype=torch.float32, device="cpu")
    pf, _ = tl.prefill(local, lcfg, tokens, cache, tp_group=mesh.model_group)
    return {"decode": all_gather(logits, mesh.data_group, 0).tolist(),
            "prefill": all_gather(pf, mesh.data_group, 0).tolist(), "mode": mode}


def collect(req, timeout):
    out, deadline = [], time.time() + timeout
    while (t := req.queue.get(timeout=max(0.1, deadline - time.time()))) is not None:
        out.append(t)
    return out


def serve_job(cfg, params, spec, mesh, rank, world, job):
    tok = Tokenizer(vocab(cfg.vocab_size), [0.0] * cfg.vocab_size, max_token_length=4)
    draft = None
    if job.get("draft"):
        dcfg = ModelConfig(**spec["draft_cfg"])
        draft = (dcfg, load(dcfg, spec["draft_npz"], None))
    ecfg = EngineConfig(tp_size=mesh.tp, dp_size=mesh.dp, **job["ecfg"])
    saved = {k: getattr(eng_mod, k) for k in job.get("engine_consts", {})}
    for k, v in job.get("engine_consts", {}).items():
        setattr(eng_mod, k, v)
    try:
        return _serve(cfg, params, tok, ecfg, draft, mesh, rank, world, job)
    finally:
        for k, v in saved.items():
            setattr(eng_mod, k, v)


def _serve(cfg, params, tok, ecfg, draft, mesh, rank, world, job):
    eng = Engine(cfg, params, tok, ecfg, draft=draft, mesh=mesh)
    eng.outputs = []
    kill = job["kind"] == "kill_follower"
    if rank != 0:
        if kill and rank == world - 1:
            ticks = {"n": 0}
            tick = eng._dev_tick_async

            def dying(*a, **kw):
                ticks["n"] += 1
                if ticks["n"] == 3:
                    os._exit(9)          # gone mid-stream, no clean-up
                return tick(*a, **kw)

            eng._dev_tick_async = dying
        try:
            eng.follow()
        except Exception as e:  # noqa: BLE001 — a peer gone ends this rank's part
            if not kill:
                raise
            return {"follower_error": repr(e)}
        return {"outputs": [o.tolist() for o in eng.outputs]}
    warm = eng.warmup(max_prompt=32)["programs"] if job.get("warmup") else None
    eng.start()
    try:
        reqs = [Request(prompt=p, steps=n, temperature=t, stop_at_eos=False)
                for p, n, t in job["requests"]]
        t0 = time.time()
        for r in reqs:
            eng.submit(r)
        streams = [collect(r, job.get("timeout", 120)) for r in reqs]
        ended_s = time.time() - t0
        later = None
        if kill:
            # a request submitted after the follower died ends too
            r = Request(prompt="abc", steps=4, temperature=0.0)
            eng.submit(r)
            later = (collect(r, job.get("timeout", 120)), r.error)
    finally:
        eng.stop()
    out = {"streams": streams, "errors": [r.error for r in reqs], "ended_s": ended_s,
           "outputs": [o.tolist() for o in eng.outputs], "later": later,
           "engine_errors": eng.metrics["engine_errors"], "warmup_programs": warm,
           "draft_resyncs": eng.metrics["draft_resyncs"]}
    if eng.paged:
        out["free_pages"] = [a.available() for a in eng.allocators]
        out["trash_page"] = eng.trash_page
    return out


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    with open(sys.argv[4]) as f:
        spec = json.load(f)
    init_distributed(rank, world, port)
    mesh = make_mesh(spec["tp"], spec["dp"], devices=["cpu"] * world)
    cfg = ModelConfig(**spec["cfg"])
    results = []
    for job in spec["jobs"]:
        params = load(cfg, spec["npz"], job.get("quant"))
        if job["kind"] == "logits":
            results.append(logits_job(cfg, params, mesh, job))
        else:
            results.append(serve_job(cfg, params, spec, mesh, rank, world, job))
    with open(f"{sys.argv[5]}.{rank}.json", "w") as f:
        json.dump(results, f)
    try:
        shutdown_distributed()
    except RuntimeError:                # a peer gone: its barrier raises
        if not any(job["kind"] == "kill_follower" for job in spec["jobs"]):
            raise


main()
