"""Engine.warmup and the compile cache of rama_tpu_torch against rama_tpu on
the CPU: warmup dispatches as many programs as the JAX engine's warmup
counts (dense, int8, paged, n-gram and draft speculation, chunked
prefill; max_prompt None and 20; the tiny model and a stories15M-shaped
one), the greedy streams
after warmup equal the JAX engine's after its warmup, the dense caches are
left as a fresh engine has them and a page pool differs only in its trash
page, every prefill bucket served afterwards was warmed, compile_cache
names the kernels' build directory (one directory a process), and the
server takes --warmup / --warmup-max-prompt / --compile-cache. Streams and
counts are compared exactly."""

import os
import stat
import sys
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
from rama_tpu_torch.ops.kernels import build
from rama_tpu_torch.runtime.engine import Engine, Request
from rama_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

PROMPTS = (("abab", 12), ("zq", 7), ("abcabcabcabcabcabcab", 9))
# the engine settings warmup is compared on (spec: n-gram or draft speculation)
CONFIGS = {"dense": {}, "int8": dict(kv_quant="int8"),
           "paged": dict(paged_kv=True, kv_page_size=16),
           "ngram": dict(spec_tick=3, spec_rounds=4),
           "draft": dict(spec_tick=3, spec_mode="draft"),
           "chunked": dict(prefill_chunk=16, prefill_chunk_min=16)}


def _vocab(n):
    return ["<unk>", "<s>", "</s>"] + [chr(ord("a") + i % 26) + ("" if i < 26 else str(i // 26))
                                      for i in range(n - 3)]


def _model(jcfg, seed):
    np_params = random_params(jcfg, seed=seed)
    cfg = torch_cfg(jcfg)
    return dict(jcfg=jcfg, np=np_params, cfg=cfg,
                params=tl.load_params(cfg, np_params, dtype=torch.float32, device="cpu"),
                jparams=jl.load_params(jcfg, np_params, dtype=jnp.float32),
                tok=Tokenizer(_vocab(cfg.vocab_size), [0.0] * cfg.vocab_size,
                              max_token_length=4),
                jtok=JTok(_vocab(jcfg.vocab_size), [0.0] * jcfg.vocab_size,
                          max_token_length=4))


@pytest.fixture(scope="module")
def models():
    """The tiny model (max_len 64), a stories15M-shaped one (tests/
    test_goldens.py's shape, vocab 32000) and a small draft of the tiny
    model's vocab."""
    draft = tiny_config(dim=32, hidden_dim=96, n_layers=2, n_heads=2, n_kv_heads=2, seq_len=64)
    return {"tiny": _model(tiny_config(seq_len=64), 31),
            "stories15M": _model(tiny_config(dim=288, hidden_dim=768, n_layers=6, n_heads=6,
                                             n_kv_heads=6, vocab_size=32000, seq_len=64), 5),
            "draft": _model(draft, 77)}


def _engines(models, model: str, config: str, batch: int = 4):
    """(the port's engine, the JAX engine) of one model and CONFIGS entry."""
    m, d = models[model], models["draft"]
    ecfg = dict(max_batch_size=batch, **CONFIGS[config])
    draft = jdraft = None
    if config == "draft":
        draft, jdraft = (d["cfg"], d["params"]), (d["jcfg"], d["jparams"])
    return (Engine(m["cfg"], m["params"], m["tok"], EngineConfig(**ecfg), draft=draft),
            JEngine(m["jcfg"], m["jparams"], m["jtok"], JEcfg(**ecfg), draft=jdraft))


def collect(req, timeout=120.0):
    out, deadline = [], time.time() + timeout
    while (t := req.queue.get(timeout=max(0.1, deadline - time.time()))) is not None:
        out.append(t)
    return out


def serve(engine, specs=PROMPTS, cls=Request):
    engine.start()
    try:
        reqs = [cls(prompt=p, steps=n, temperature=0.0) for p, n in specs]
        for r in reqs:
            engine.submit(r)
        outs = [collect(r) for r in reqs]
    finally:
        engine.stop()
    assert all(r.error is None for r in reqs)
    return outs


@pytest.mark.parametrize("max_prompt", [None, 20])
@pytest.mark.parametrize("model,config", [("tiny", c) for c in CONFIGS] + [
    ("stories15M", "dense"), ("stories15M", "int8")])
def test_warmup_counts_the_programs_jax_counts(models, model, config, max_prompt):
    """Decode ticks 8 / 4 / 2 / 1, spec ticks 4 / 2 / 1, every (k_pad,
    t_pad) prefill bucket up to min(max_prompt + 1, max_len) (plus the
    draft's prefill in draft mode; with prefill_chunk 16 the direct ladder
    up to _bucket(16) and a chunk and a finisher from there on): the same
    count as JAX's programs."""
    eng, jeng = _engines(models, model, config)
    got, want = eng.warmup(max_prompt=max_prompt), jeng.warmup(max_prompt=max_prompt)
    assert got["programs"] == want["programs"] > 0
    assert got["seconds"] >= 0.0


@pytest.mark.parametrize("config", list(CONFIGS))
def test_streams_after_warmup_equal_jax_after_its_warmup(models, config):
    eng, jeng = _engines(models, "tiny", config)
    jeng.warmup(max_prompt=20)
    want = serve(jeng, cls=JRequest)
    eng.warmup(max_prompt=20)
    got = serve(eng)
    assert got == want
    assert eng.stats()["engine_errors"] == 0
    assert config not in ("ngram", "draft") or eng.metrics["spec_drafted"] > 0


def _fresh_tensors(cache) -> list:
    from dataclasses import fields

    return [getattr(cache, f.name) for f in fields(cache)]


@pytest.mark.parametrize("config", ["dense", "int8", "draft"])
def test_warmup_leaves_the_dense_caches_fresh(models, config):
    """The ticks' dummy steps write every slot's first rows and the prefill
    buckets slot 0's; warmup zeroes the dense caches after (the draft's
    too), so the cache equals a fresh engine's, slot 0 included, and no
    stream state moved."""
    eng, _ = _engines(models, "tiny", config)
    fresh, _ = _engines(models, "tiny", config)
    writes = []
    orig = eng._dev_prefill_insert

    def spy(*a, **kw):
        out = orig(*a, **kw)
        writes.append(any(bool(t.any()) for t in _fresh_tensors(eng.cache)))
        return out

    eng._dev_prefill_insert = spy
    eng.warmup()
    assert writes and all(writes)        # the dummy traffic did write slot 0
    for a, b in zip(_fresh_tensors(eng.cache), _fresh_tensors(fresh.cache)):
        assert torch.equal(a, b)
    if config == "draft":
        for a, b in zip(_fresh_tensors(eng.dcache), _fresh_tensors(fresh.dcache)):
            assert torch.equal(a, b)
    assert all(s.free for s in eng.slots) and eng.req_counter == 0
    assert eng.metrics == fresh.metrics


@pytest.mark.parametrize("extra", [{}, dict(kv_quant="int8"), dict(spec_tick=3),
                                   dict(spec_tick=3, spec_mode="draft")])
def test_warmup_writes_only_the_trash_page(models, extra):
    """On a page pool every table row points at the trash page during
    warmup: the pool differs from a fresh one only there, no page is
    reserved and the tables are all trash."""
    m, d = models["tiny"], models["draft"]
    ecfg = EngineConfig(max_batch_size=3, paged_kv=True, kv_page_size=16, **extra)
    draft = (d["cfg"], d["params"]) if extra.get("spec_mode") == "draft" else None
    eng = Engine(m["cfg"], m["params"], m["tok"], ecfg, draft=draft)
    fresh = Engine(m["cfg"], m["params"], m["tok"], ecfg, draft=draft)
    free = eng.allocator.available()
    eng.warmup()
    trash = eng.trash_page
    moved = False
    for a, b in zip(_fresh_tensors(eng.cache), _fresh_tensors(fresh.cache)):
        assert torch.equal(a[:, :trash], b[:, :trash])
        moved |= not torch.equal(a[:, trash], b[:, trash])
    assert moved                          # the dummy traffic went to the trash page
    assert eng.allocator.available() == free
    assert (eng.page_tables == trash).all()
    assert serve(eng) == serve(fresh)


@pytest.mark.parametrize("config,max_prompt", [("dense", None), ("int8", 20),
                                               ("paged", 30), ("ngram", None)])
def test_every_served_bucket_was_warmed(models, config, max_prompt):
    """Admissions of prompts up to max_prompt tokens (alone and in bursts)
    run only (k_pad, t_pad) buckets that warmup dispatched."""
    eng, _ = _engines(models, "tiny", config)
    seen = []
    orig = eng._dev_prefill_insert

    def spy(tokens, *a, **kw):
        seen.append(tokens.shape)
        return orig(tokens, *a, **kw)

    eng._dev_prefill_insert = spy
    eng.warmup(max_prompt=max_prompt)
    warmed, seen[:] = set(seen), []
    longest = max_prompt or eng.max_len - 2
    specs = [("ab" * (longest // 2), 3), ("z", 4), ("abc" * 5, 5), ("q" * 16, 3),
             ("x" * 17, 2)]
    assert serve(eng, specs)
    assert seen and set(seen) <= warmed


def test_warmup_runs_both_sampling_routes(models, monkeypatch):
    """Each tick and prefill bucket runs greedy and sampled at top_p 1, so
    the argmax, the keyed draw, the top-k over a 32000-piece vocabulary
    and the full sort behind it all run before the first request."""
    from rama_tpu_torch.runtime import engine as eng_mod
    from rama_tpu_torch.runtime import sampler

    calls = {"greedy": 0, "keyed": 0, "topk": 0, "sort": 0}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(eng_mod, "sample_greedy", counted("greedy", eng_mod.sample_greedy))
    monkeypatch.setattr(eng_mod, "sample_batched_keyed",
                        counted("keyed", eng_mod.sample_batched_keyed))
    monkeypatch.setattr(sampler, "_full_sort", counted("sort", sampler._full_sort))
    monkeypatch.setattr(sampler.torch, "topk", counted("topk", torch.topk))
    eng, _ = _engines(models, "stories15M", "ngram")
    programs = eng.warmup(max_prompt=20)["programs"]
    # ticks 8 / 4 / 2 / 1, spec ticks 4 / 2 / 1, buckets 16 / 32
    assert programs == 4 + 3 + 2
    # per route: a tick of n steps samples n times, a spec tick of m rounds m times
    draws = (8 + 4 + 2 + 1) + (4 + 2 + 1) + 2
    assert calls == {"greedy": draws, "keyed": draws, "topk": draws, "sort": draws}


def test_warmup_runs_on_an_idle_engine_only(models):
    eng, _ = _engines(models, "tiny", "dense")
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="before start"):
            eng.warmup()
    finally:
        eng.stop()


def test_warmup_on_the_cpu_builds_no_kernel(models, monkeypatch):
    """Only an engine on the card builds and loads the kernel libraries."""
    def refuse():
        raise AssertionError("no kernel library is built for a CPU engine")

    monkeypatch.setattr(build, "load_all", refuse)
    eng, _ = _engines(models, "tiny", "int8")
    assert eng.warmup(max_prompt=20)["programs"] == 6


def test_compile_cache_names_the_build_directory(models, tmp_path, monkeypatch):
    """compile_cache sets the directory the kernels are built into and
    loaded from; the same directory again is fine; another one, once a
    library is loaded, raises; without compile_cache the directory stays."""
    monkeypatch.setattr(build, "BUILD_DIR", build.DEFAULT_BUILD_DIR)
    monkeypatch.setattr(build, "_libs", {})
    m = models["tiny"]
    Engine(m["cfg"], m["params"], m["tok"], EngineConfig(max_batch_size=2))
    assert build.BUILD_DIR == build.DEFAULT_BUILD_DIR
    cache = tmp_path / "kernels"
    Engine(m["cfg"], m["params"], m["tok"], EngineConfig(max_batch_size=2,
                                                         compile_cache=str(cache)))
    assert build.BUILD_DIR == cache.resolve()
    assert build._lib_path("kv_write").parent == cache.resolve()
    build._libs["kv_write"] = object()        # as if a kernel had been loaded from there
    Engine(m["cfg"], m["params"], m["tok"], EngineConfig(max_batch_size=2,
                                                         compile_cache=str(cache)))
    with pytest.raises(RuntimeError, match="already loaded"):
        Engine(m["cfg"], m["params"], m["tok"],
               EngineConfig(max_batch_size=2, compile_cache=str(tmp_path / "other")))
    assert build.BUILD_DIR == cache.resolve()


def test_build_all_builds_into_the_named_directory_once(tmp_path, monkeypatch):
    """A missing library is built into the build directory (a stand-in
    nvcc here, which writes its -o file), one nvcc run a source, counted;
    a second build_all, or another process's, finds them and runs none."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n"
                    "print('ptxas info    : Used 1 registers')\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", build.DEFAULT_BUILD_DIR)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "build_logs", {})
    monkeypatch.setattr(build, "counts", {"builds": 0, "loads": 0})
    build.set_build_dir(tmp_path / "cache")
    logs = build.build_all()
    assert build.counts == {"builds": len(build.SOURCES), "loads": 0}
    assert set(logs) == set(build.SOURCES) and "Used 1 registers" in logs["kv_write"]
    assert sorted(p.name for p in (tmp_path / "cache").glob("*.so")) == sorted(
        build._lib_path(n).name for n in build.SOURCES)
    build.build_all()
    assert build.counts["builds"] == len(build.SOURCES)
    assert not [p for p in os.listdir(tmp_path / "cache") if ".tmp" in p]


def test_server_takes_warmup_and_compile_cache(capsys, monkeypatch):
    """--warmup runs engine.warmup(max_prompt=--warmup-max-prompt) before
    start() and prints JAX's line; --compile-cache reaches load_engine."""
    from rama_tpu_torch.server import app

    calls, seen = [], {}

    class Stub:
        def warmup(self, max_prompt=None):
            calls.append(("warmup", max_prompt))
            return {"programs": 7, "seconds": 0.25}

        def start(self):
            calls.append(("start",))

        def stop(self):
            calls.append(("stop",))

    monkeypatch.setattr(app, "load_engine", lambda *a, **kw: seen.update(kw) or Stub())
    monkeypatch.setattr(app.web, "run_app", lambda *a, **kw: calls.append(("serve",)))
    assert app.main(["-m", "x.bin", "-t", "t.bin", "--warmup", "--warmup-max-prompt", "64",
                     "--compile-cache", "/cache/dir"]) == 0
    assert calls == [("warmup", 64), ("start",), ("serve",), ("stop",)]
    assert seen["compile_cache"] == "/cache/dir"
    assert "warmup: 7 programs in 0.2s" in capsys.readouterr().err
    calls.clear()
    assert app.main(["-m", "x.bin", "-t", "t.bin"]) == 0
    assert calls == [("start",), ("serve",), ("stop",)] and seen["compile_cache"] is None
    args = app.build_parser().parse_args(["-m", "m", "-t", "t", "--warmup"])
    assert (args.warmup, args.warmup_max_prompt, args.compile_cache) == (True, None, None)


def test_load_engine_passes_the_compile_cache(models, tmp_path, monkeypatch):
    from rama_tpu_torch.checkpoint import save_v0
    from rama_tpu_torch.server.app import load_engine

    m = models["tiny"]
    model = tmp_path / "m.bin"
    save_v0(str(model), m["cfg"], m["np"])
    tok = write_tokenizer_bin(tmp_path / "tok.bin", m["cfg"].vocab_size)
    monkeypatch.setattr(build, "BUILD_DIR", build.DEFAULT_BUILD_DIR)
    monkeypatch.setattr(build, "_libs", {})         # a fresh process
    eng = load_engine(str(model), str(tok), quant="none", dtype="float32", batch=2,
                      device="cpu", compile_cache=str(tmp_path / "k"))
    assert eng.ecfg.compile_cache == str(tmp_path / "k")
    assert build.BUILD_DIR == (tmp_path / "k").resolve()
    eng.warmup(max_prompt=20)
    assert serve(eng, (("abab", 5),)) and eng.stats()["engine_errors"] == 0
