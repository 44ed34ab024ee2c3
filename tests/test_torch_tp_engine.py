"""rama_tpu_torch's tensor and data parallelism as separate processes on the
CPU: gloo groups of 2 or 4 ranks (tests/_torch_tp_worker.py), one process a
rank, held against rama_tpu's single-process mesh programs and engines on
the conftest's 8 CPU devices.

- the decode step's and the prefill's logits at (dp, tp) = (1, 2) and
  (2, 2) against JAX's make_decode_step / make_prefill (rtol / atol 2e-4,
  as tests/test_tp.py:34-54);
- greedy streams exactly equal to JAX's Engine(tp_size=2) in each mode
  (dense, int8 KV, paged, n-gram spec, draft, chunked prefill, int8 and
  int4 weights), and to JAX's Engine(dp_size=2[, tp_size=2]) at dp 2 and
  dp 2 x tp 2; every follower's device calls sampled rank 0's tokens;
- a follower that dies mid-stream ends rank 0's requests with an error
  within the group's timeout, and a later request too.

All the groups start together in one module fixture (torch's import is paid
once a process, in parallel); every subprocess has a timeout."""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rama_tpu.config import EngineConfig as JEcfg
from rama_tpu.models import llama as jl
from rama_tpu.parallel.mesh import make_mesh as jmake_mesh
from rama_tpu.parallel.tp import make_decode_step, make_prefill, shard_cache, shard_params
from rama_tpu.runtime.engine import Engine as JEngine
from rama_tpu.runtime.engine import Request as JRequest
from rama_tpu.testing.ref_model import random_params, tiny_config
from rama_tpu.tokenizer import Tokenizer as JTok

WORKER = Path(__file__).parent / "_torch_tp_worker.py"
CFG = dict(dim=64, hidden_dim=176, n_layers=3, n_heads=4, n_kv_heads=2, vocab_size=128,
           seq_len=64, shared_classifier=True)
DCFG = dict(dim=32, hidden_dim=96, n_layers=2, n_heads=2, n_kv_heads=2, vocab_size=128,
            seq_len=64, shared_classifier=True)
REQUESTS = [["abcdefghij" * 3, 10, 0.0], ["zq", 12, 0.0], ["hello", 10, 0.0]]
BASE = dict(max_batch_size=4, decode_tick=2)
# mode -> (the port's EngineConfig fields, quant, draft); JAX runs the same
MODES = {
    "dense": ({}, None, False),
    "kv8": (dict(kv_quant="int8"), None, False),
    "paged": (dict(paged_kv=True, kv_page_size=16), None, False),
    "ngram": (dict(spec_tick=3), None, False),
    "draft": (dict(spec_tick=3, spec_mode="draft"), None, True),
    "chunked": (dict(prefill_chunk=16, prefill_chunk_min=16), None, False),
    "int8": ({}, "int8", False),
    "int4": ({}, "int4", False),
}
# head_dim 128, one head a rank at tp 2: the fused attention block's shape
AB_CFG = dict(dim=256, hidden_dim=512, n_layers=2, n_heads=2, n_kv_heads=2, vocab_size=128,
              seq_len=64, shared_classifier=True)
DECODE = [1, 5, 9]
PREFILL = np.random.default_rng(0).integers(3, 100, (2, 6)).tolist()
TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _vocab(n):
    return ["<unk>", "<s>", "</s>"] + [chr(ord("a") + i % 26) + ("" if i < 26 else str(i // 26))
                                      for i in range(n - 3)]


def _serve(ecfg: dict, mode: str = "dense") -> dict:
    fields, quant, draft = MODES[mode]
    return dict(kind="serve", ecfg={**BASE, **ecfg, **fields}, quant=quant, draft=draft,
                requests=REQUESTS)


# draft mode that goes dormant after one round and probes again after two
# plain ticks, so the draft cache's gap is replayed (the DRSYNC op)
LONG = [["zq", 40, 0.0], ["hello", 30, 0.0]]
DORMANT = dict(_serve(dict(spec_min_accept=1.1, spec_rounds=1), "draft"), requests=LONG,
               engine_consts=dict(_SPEC_PROBE_ROUNDS=1, _SPEC_DORMANT_TICKS=2))
# group -> (tp, dp, jobs)
GROUPS = {
    "tp2": (2, 1, [dict(kind="logits", batch=2, decode=DECODE, prefill=PREFILL)]
            + [_serve({}, m) for m in MODES]
            + [dict(_serve({}), warmup=True), DORMANT]),
    "dp2": (1, 2, [_serve({})]),
    "dp2tp2": (2, 2, [dict(kind="logits", batch=2, decode=DECODE, prefill=PREFILL),
                      _serve({}), _serve({}, "paged"), _serve({}, "chunked"),
                      _serve({}, "ngram"), dict(_serve({}, "kv8"), warmup=True)]),
    "kill": (2, 1, [dict(kind="kill_follower", ecfg={**BASE, "max_batch_size": 2},
                         requests=[["abc", 40, 0.0]], timeout=120)]),
    # models.llama.ATTN_BLOCK 1 / 2 on int8 weights (kernel 14's plain version)
    "ab": (2, 1, [dict(kind="logits", batch=2, decode=DECODE, prefill=PREFILL, quant="int8",
                       attn_block=m) for m in (1, 2)], AB_CFG),
}


@pytest.fixture(scope="module")
def params(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    np_params = random_params(tiny_config(**CFG), seed=31)
    np.savez(d / "p.npz", **np_params)
    np.savez(d / "ab.npz", **random_params(tiny_config(**AB_CFG), seed=35))
    np_draft = random_params(tiny_config(**DCFG), seed=77)
    np.savez(d / "d.npz", **np_draft)
    return d, np_params, np_draft


@pytest.fixture(scope="module")
def groups(params):
    """Every group's ranks started together; {group: [rank results or None]}."""
    d, _, _ = params
    env = dict(os.environ, OMP_NUM_THREADS="1")
    running = {}
    for name, (tp, dp, jobs, *cfg) in GROUPS.items():
        spec = dict(tp=tp, dp=dp, cfg=cfg[0] if cfg else CFG,
                    npz=str(d / ("ab.npz" if cfg else "p.npz")), draft_cfg=DCFG,
                    draft_npz=str(d / "d.npz"), jobs=jobs)
        (d / f"{name}.json").write_text(json.dumps(spec))
        port, world = _free_port(), tp * dp
        running[name] = [subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world), str(port), str(d / f"{name}.json"),
             str(d / name)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(world)]
    out = {}
    deadline = time.time() + TIMEOUT_S
    for name, procs in running.items():
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(1, deadline - time.time()))[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
        results = []
        for r, (p, log) in enumerate(zip(procs, logs)):
            path = d / f"{name}.{r}.json"
            dead = name == "kill" and r == len(procs) - 1
            if not dead:
                assert p.returncode == 0, f"{name} rank {r} failed:\n{log[-4000:]}"
            results.append(json.loads(path.read_text()) if path.exists() else None)
        out[name] = results
    return out


@pytest.fixture(scope="module")
def jax_streams(params):
    """JAX's single-process greedy streams of REQUESTS by (mode, tp, dp)."""
    _, np_params, np_draft = params
    jcfg, dcfg = tiny_config(**CFG), tiny_config(**DCFG)
    made = {}

    def get(mode="dense", tp=2, dp=1, requests=REQUESTS):
        key = (mode, tp, dp, json.dumps(requests))
        if key not in made:
            fields, quant, draft = MODES[mode]
            if quant:
                p = jl.quantize_params(jcfg, np_params, bits=8 if quant == "int8" else 4,
                                       group_size=16, dtype=jnp.float32)
            else:
                p = jl.load_params(jcfg, np_params, dtype=jnp.float32)
            d = (dcfg, jl.load_params(dcfg, np_draft, dtype=jnp.float32)) if draft else None
            tok = JTok(_vocab(jcfg.vocab_size), [0.0] * jcfg.vocab_size, max_token_length=4)
            eng = JEngine(jcfg, p, tok, JEcfg(**BASE, **fields, tp_size=tp, dp_size=dp),
                          draft=d)
            eng.start()
            try:
                reqs = [JRequest(prompt=pr, steps=n, temperature=t, stop_at_eos=False)
                        for pr, n, t in requests]
                for r in reqs:
                    eng.submit(r)
                streams = []
                for r in reqs:
                    toks = []
                    while (t := r.queue.get(timeout=120)) is not None:
                        toks.append(t)
                    streams.append(toks)
            finally:
                eng.stop()
            made[key] = streams
        return made[key]

    return get


def _jax_logits(np_params, dp: int, tp: int, cfg: dict = CFG, quant: bool = False):
    jcfg = tiny_config(**cfg)
    p = (jl.quantize_params(jcfg, np_params, bits=8, group_size=16, dtype=jnp.float32) if quant
         else jl.load_params(jcfg, np_params, dtype=jnp.float32))
    mesh = jmake_mesh(tp_size=tp, dp_size=dp, devices=jax.devices()[: dp * tp])
    sp = shard_params(p, mesh)
    cache = shard_cache(jl.KVCache.create(jcfg, batch=2, dtype=jnp.float32), mesh)
    step = make_decode_step(jcfg, mesh, sp)
    for pos, tok in enumerate(DECODE):
        _, logits, cache = step(sp, jnp.full((2,), tok, jnp.int32), jnp.full((2,), pos, jnp.int32),
                                jnp.zeros(2), jnp.full(2, 0.9), jax.random.PRNGKey(0), cache)
    cache = shard_cache(jl.KVCache.create(jcfg, batch=2, dtype=jnp.float32), mesh)
    pf, _ = make_prefill(jcfg, mesh, sp)(sp, jnp.asarray(PREFILL, jnp.int32), cache)
    return np.asarray(logits), np.asarray(pf)


@pytest.mark.parametrize("group,dp,tp", [("tp2", 1, 2), ("dp2tp2", 2, 2)])
def test_logits_match_the_jax_mesh_programs(groups, params, group, dp, tp):
    want_decode, want_prefill = _jax_logits(params[1], dp, tp)
    got = groups[group][0][0]
    np.testing.assert_allclose(np.asarray(got["decode"]), want_decode, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(got["prefill"]), want_prefill, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mode", [1, 2])
def test_attn_block_modes_under_tp_match_jax(groups, params, mode):
    """The decode step under RAMA_ATTN_BLOCK 1 / 2 (kernel 14's plain
    version, int8 wo, one head a rank) all-reduces its partial wo output:
    rank 0's logits against JAX's mesh programs (which run the unfused
    attention on the CPU) within atol 1e-3 of the logits' range, as
    tests/test_torch_attn_block.py holds the fused block to JAX."""
    d = params[0]
    want_decode, want_prefill = _jax_logits(dict(np.load(d / "ab.npz")), 1, 2, AB_CFG,
                                            quant=True)
    got = groups["ab"][0][mode - 1]
    assert got["mode"] == mode
    np.testing.assert_allclose(np.asarray(got["decode"]), want_decode,
                               atol=1e-3 * np.abs(want_decode).max(), rtol=0)
    np.testing.assert_allclose(np.asarray(got["prefill"]), want_prefill, rtol=2e-4, atol=2e-4)


def _serve_results(groups, group: str, job: int):
    ranks = groups[group]
    rank0 = ranks[0][job]
    for r, res in enumerate(ranks[1:], 1):
        # every follower's device calls sampled rank 0's tokens, call for call
        assert res[job]["outputs"] == rank0["outputs"], f"rank {r} diverged"
    assert all(e is None for e in rank0["errors"]) and rank0["engine_errors"] == 0
    return rank0


@pytest.mark.parametrize("mode", list(MODES))
def test_tp2_streams_equal_the_jax_tp2_engine(groups, jax_streams, mode):
    rank0 = _serve_results(groups, "tp2", 1 + list(MODES).index(mode))
    assert rank0["streams"] == jax_streams(mode)
    if mode == "paged":
        assert rank0["free_pages"] == [rank0["trash_page"]]   # every page back


@pytest.mark.parametrize("group,dp,tp,job", [("dp2", 2, 1, 0), ("dp2tp2", 2, 2, 1)])
def test_data_parallel_streams_equal_the_jax_engine(groups, jax_streams, group, dp, tp, job):
    assert _serve_results(groups, group, job)["streams"] == jax_streams("dense", tp, dp)


def test_tp2_warmup_then_serves(groups, jax_streams):
    """Engine.warmup on rank 0 replays on the follower (every bucket's
    programs, then the caches zeroed: the RESET op) and the stream is
    JAX's."""
    rank0 = _serve_results(groups, "tp2", 1 + len(MODES))
    assert rank0["warmup_programs"] > 0 and rank0["streams"] == jax_streams("dense")


def test_tp2_draft_resync_replays_on_the_follower(groups, jax_streams):
    """Draft mode going dormant and back: the resync of the draft cache's
    gap runs on every rank (DRSYNC) and the stream stays JAX's draft-mode
    stream."""
    rank0 = _serve_results(groups, "tp2", 2 + len(MODES))
    assert rank0["draft_resyncs"] >= 1
    assert rank0["streams"] == jax_streams("draft", requests=LONG)


@pytest.mark.parametrize("job,mode", [(3, "chunked"), (4, "ngram"), (5, "kv8")])
def test_dp2tp2_modes_equal_the_jax_engine(groups, jax_streams, job, mode):
    """dp 2 x tp 2 with chunked prefill (each replica's rows of a job), n-gram
    speculation and, after warmup, the int8 cache: JAX's dp 2 x tp 2 dense
    stream for the first two (neither changes a greedy stream, as
    tests/test_multihost.py holds for rama_tpu), its tp 2 int8-cache
    stream for the last."""
    rank0 = _serve_results(groups, "dp2tp2", job)
    want = jax_streams("kv8") if mode == "kv8" else jax_streams("dense", 2, 2)
    assert rank0["streams"] == want


def test_dp2tp2_paged_has_a_sub_pool_a_replica(groups, jax_streams):
    rank0 = _serve_results(groups, "dp2tp2", 2)
    assert rank0["streams"] == jax_streams("paged")
    assert rank0["free_pages"] == [rank0["trash_page"]] * 2


def test_a_dead_follower_ends_rank0s_requests_with_an_error(groups):
    rank0 = groups["kill"][0][0]
    assert groups["kill"][1] is None                     # it died without a word
    assert rank0["errors"] == ["engine error during decode"]
    assert len(rank0["streams"][0]) < 40 and rank0["ended_s"] < 60
    later, error = rank0["later"]
    assert error is not None                              # no hang for later clients
