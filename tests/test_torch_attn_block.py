"""Kernel 14's plain versions (attn_rope_write_layered_plain,
attn_block_layered_plain) against rama_tpu's attn_rope_write_layered /
attn_block_layered in interpret mode on the same numpy inputs (int8 and
int4 wo, GQA rep 1, 2, 12 and 16, positions 0, mid-stripe and S-1, and the
card kernel's 64-row split edges of a 144-row cache), the port's
clamp of positions >= S, the row form of every GQA group the model admits,
and the model's RAMA_ATTN_BLOCK modes: tiny head_dim-128 models' decode
steps under modes 1 and 2 against the JAX package's decode_step (unfused on
the CPU; group 1, 2 and Mistral-Large's 12), an engine stream under mode 2
against mode 0, and a group-12 engine's streams under mode 2 against the
JAX engine's.

Tolerances (fp32): attention / wo outputs atol and rtol 1e-4 (same math,
other summation order); the written cache rows atol 1e-5 (the roped k row:
fp32 RoPE, XLA may contract to FMA); every other cache row exactly
unchanged; model logits rel 1e-3 of max |ref| (the fused block rounds
nothing the unfused path rounds in fp32, but sums in another order through
two layers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import torch_cfg
from rama_tpu.models import llama as jl
from rama_tpu.ops.pallas import attn_block as jab
from rama_tpu.ops.quant import QuantizedTensor as JQT
from rama_tpu.ops.quant import quantize_int4, quantize_int8
from rama_tpu.testing.ref_model import random_params, tiny_config
from rama_tpu_torch.models import llama as tl
from rama_tpu_torch.ops.kernels import attn_block as ab
from rama_tpu_torch.ops.kernels import decode_attention as da
from rama_tpu_torch.ops.quant import QuantizedTensor

torch.set_num_threads(1)

L, HD, S = 2, 128, 64


def make_case(b, nkv, rep, bits, pos, seed, gs=16, s=S):
    """numpy inputs of both packages' attention block (rama_tpu's
    tests/test_attn_block.py make_case, positions given; a cache of s rows)."""
    rng = np.random.default_rng(seed)
    nh = nkv * rep
    d = nh * HD
    f = np.float32
    case = dict(q=rng.normal(size=(b, nh, HD)).astype(f),
                kn=rng.normal(size=(b, nkv, HD)).astype(f),
                vn=rng.normal(size=(b, nkv, HD)).astype(f),
                k=rng.normal(size=(L, b, nkv, s, HD)).astype(f),
                v=rng.normal(size=(L, b, nkv, s, HD)).astype(f),
                pos=np.asarray(pos, np.int32))
    inv = 1.0 / (10000.0 ** (np.arange(HD // 2) * 2.0 / HD))
    ang = np.minimum(case["pos"], s - 1)[:, None] * inv[None, :]
    case["cos"], case["sin"] = np.cos(ang).astype(f), np.sin(ang).astype(f)
    if bits:
        quant = quantize_int8 if bits == 8 else quantize_int4
        case["wo"] = quant(rng.normal(size=(L, d, d)).astype(f) * 0.1, gs)
    return case


# (form, bits, b, nkv, rep, positions[, cache rows]): pos 0 and S-1 in every
# case of S rows; the split-edge cases hold positions on and around the card
# kernel's 64-row split edges (63 / 64 / 65, 127 / 128) and the last row of
# a 144-row cache; at most 11 interpret calls (each a few seconds on the CPU)
S_EDGE = 144
CASES = {
    "light-rep1": ("light", 0, 3, 2, 1, [0, 37, S - 1]),
    "light-rep2": ("light", 0, 3, 2, 2, [S - 1, 0, 16]),
    "full-int8-rep1": ("full", 8, 3, 2, 1, [0, 15, S - 1]),
    "full-int8-rep2-b1": ("full", 8, 1, 2, 2, [S - 1]),
    "full-int4-rep1-b1": ("full", 4, 1, 2, 1, [0]),
    "full-int4-rep2": ("full", 4, 2, 2, 2, [S - 1, 33]),
    "light-split-edges": ("light", 0, 6, 1, 2, [63, 64, 65, 127, 128, S_EDGE - 1], S_EDGE),
    "full-int8-split-edges": ("full", 8, 4, 1, 1, [64, 63, 128, 127], S_EDGE),
    # GQA groups past 8 (the card's 16-row form): Mistral-Large's 12 and 16
    "light-rep12-split-edges": ("light", 0, 3, 1, 12, [63, 64, S_EDGE - 1], S_EDGE),
    "full-int4-rep12": ("full", 4, 2, 1, 12, [0, 37]),
    "full-int4-rep16-split-edges": ("full", 4, 2, 1, 16, [128, 65], S_EDGE),
}


def _torch_wo(wo) -> QuantizedTensor:
    return QuantizedTensor(q=torch.from_numpy(np.array(wo.q)),
                           scales=torch.from_numpy(np.array(wo.scales)),
                           group_size=wo.group_size, bits=wo.bits)


def _t(case):
    return {k: (torch.from_numpy(v.copy()) if isinstance(v, np.ndarray) else v)
            for k, v in case.items()}


@pytest.fixture(scope="module")
def jax_out():
    """rama_tpu's outputs (interpret mode, chunk 16), layer 1, per case."""
    out = {}
    for name, (form, bits, b, nkv, rep, pos, *s) in CASES.items():
        c = make_case(b, nkv, rep, bits, pos, seed=len(out) + 3, s=(s or [S])[0])
        args = [jnp.asarray(c[k]) for k in ("q", "kn", "vn", "cos", "sin", "k", "v")]
        if form == "light":
            res = jab.attn_rope_write_layered(*args, jnp.asarray(c["pos"]), jnp.int32(1),
                                              chunk=16, interpret=True)
        else:
            res = jab.attn_block_layered(*args, c["wo"], jnp.asarray(c["pos"]), jnp.int32(1),
                                         chunk=16, interpret=True)
        out[name] = (c, [np.asarray(r) for r in res])
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas(jax_out, name):
    c, (want, k_want, v_want) = jax_out[name]
    form = CASES[name][0]
    t = _t(c)
    args = (t["q"], t["kn"], t["vn"], t["cos"], t["sin"], t["k"], t["v"])
    if form == "light":
        got = ab.attn_rope_write_layered_plain(*args, t["pos"], 1)
    else:
        got = ab.attn_block_layered_plain(*args, _torch_wo(c["wo"]), t["pos"], 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    rows = np.zeros(c["k"].shape[:4], bool)
    for bi, p in enumerate(c["pos"]):
        rows[1, bi, :, p] = True
    for got_c, want_c, before in ((t["k"], k_want, c["k"]), (t["v"], v_want, c["v"])):
        np.testing.assert_allclose(got_c.numpy()[rows], want_c[rows], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got_c.numpy()[~rows], before[~rows])
    np.testing.assert_array_equal(t["v"].numpy()[rows], c["vn"].reshape(-1, HD))


@pytest.mark.parametrize("bits", [8, 4])
def test_full_form_with_bf16_scale_wo_matches_pallas(bits):
    """The full form with a bf16-scale wo (cast_scales; on the card K1
    applies it, no launch of its own): the plain version against rama_tpu's
    attn_block_layered in interpret mode on the same bf16 scales, int8 and
    int4, layer 1; the wrapper on CPU tensors is the plain version."""
    from rama_tpu.ops.quant import cast_scales as j_cast
    from rama_tpu_torch.ops.quant import cast_scales as t_cast

    c = make_case(2, 2, 2, bits, [0, S - 1], seed=31)
    jwo = j_cast({"wo": c["wo"]}, jnp.bfloat16)["wo"]
    two = t_cast({"wo": _torch_wo(c["wo"])}, torch.bfloat16)["wo"]
    assert two.scales.dtype == torch.bfloat16
    np.testing.assert_array_equal(two.scales.view(torch.int16).numpy(),
                                  np.asarray(jwo.scales).view(np.int16))
    args = [jnp.asarray(c[k]) for k in ("q", "kn", "vn", "cos", "sin", "k", "v")]
    want = np.asarray(jab.attn_block_layered(*args, jwo, jnp.asarray(c["pos"]), jnp.int32(1),
                                             chunk=16, interpret=True)[0])
    outs = []
    for fn in (ab.attn_block_layered_plain, ab.attn_block_layered):
        t = _t(c)
        outs.append(fn(t["q"], t["kn"], t["vn"], t["cos"], t["sin"], t["k"], t["v"], two,
                       t["pos"], 1))
    np.testing.assert_allclose(outs[0].numpy(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)


@pytest.mark.parametrize("form", ["light", "full"])
def test_positions_past_the_cache_clamp_to_the_last_row(form):
    """The port's overshoot rule: pos >= S writes and attends as pos S-1
    (the Pallas kernel is not defined there)."""
    c = make_case(2, 2, 2, 8 if form == "full" else 0, [S + 3, S], seed=21)
    outs, caches = [], []
    for pos in ([S + 3, S], [S - 1, S - 1]):
        t = _t(c)
        args = (t["q"], t["kn"], t["vn"], t["cos"], t["sin"], t["k"], t["v"])
        p = torch.tensor(pos, dtype=torch.int32)
        outs.append(ab.attn_rope_write_layered(*args, p, 0) if form == "light"
                    else ab.attn_block_layered(*args, _torch_wo(c["wo"]), p, 0))
        caches.append((t["k"], t["v"]))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    for a, b in zip(caches[0], caches[1]):
        assert torch.equal(a, b)
    assert torch.equal(caches[0][1][0, :, :, S - 1], torch.from_numpy(c["vn"]))


def test_light_equals_the_unfused_composition():
    """RoPE + row write + attention over rows <= pos: the function of the
    unfused decode path (fp32, atol 1e-5)."""
    c = make_case(3, 2, 2, 0, [0, 30, S - 1], seed=5)
    t = _t(c)
    got = ab.attn_rope_write_layered(t["q"], t["kn"], t["vn"], t["cos"], t["sin"], t["k"],
                                     t["v"], t["pos"], 1)
    u = _t(c)
    cos, sin = u["cos"][:, None], u["sin"][:, None]
    q = tl.apply_rope(u["q"][:, None], cos, sin)
    k = tl.apply_rope(u["kn"][:, None], cos, sin)
    cache = tl.KVCache(k=u["k"], v=u["v"])
    tl._write_kv(cache, 1, k, u["vn"][:, None], u["pos"][:, None].long())
    mask = torch.arange(S)[None, None, :] <= u["pos"][:, None, None]
    want = tl._attention(q, cache.k[1], cache.v[1], mask)[:, 0]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(t["k"], cache.k, atol=1e-6, rtol=0)
    assert torch.equal(t["v"], cache.v)


def test_cpu_wrappers_dispatch_to_plain():
    c = make_case(2, 2, 1, 4, [5, 40], seed=8)
    outs = []
    for fn in (ab.attn_block_layered, ab.attn_block_layered_plain):
        t = _t(c)
        outs.append(fn(t["q"], t["kn"], t["vn"], t["cos"], t["sin"], t["k"], t["v"],
                       _torch_wo(c["wo"]), t["pos"], 0))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_rope_lane_tables_match_jax():
    rng = np.random.default_rng(1)
    cos, sin = rng.normal(size=(3, 64)).astype(np.float32), rng.normal(size=(3, 64)).astype(
        np.float32)
    want = jab.rope_lane_tables(jnp.asarray(cos), jnp.asarray(sin))
    got = ab.rope_lane_tables(torch.from_numpy(cos), torch.from_numpy(sin))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("bits,gs,n,s,b", [(8, 16, 256, 64, 8), (4, 16, 256, 64, 32),
                                           (8, 16, 200, 64, 8), (4, 16, 256, 60, 8),
                                           (8, 16, 256, 64, 33), (4, 128, 256, 64, 4)])
def test_attn_block_supported_matches_jax(bits, gs, n, s, b):
    rng = np.random.default_rng(0)
    quant = quantize_int8 if bits == 8 else quantize_int4
    w = quant(rng.normal(size=(1, 256, n)).astype(np.float32), gs)
    assert ab.attn_block_supported(_torch_wo(w), s, b) == jab.attn_block_supported(
        None, JQT(q=w.q, scales=w.scales, group_size=w.group_size, bits=w.bits), s, b)
    assert not ab.attn_block_supported(torch.zeros(256, n), s, b)


# ---------------------------------------------------------------------------
# the model under RAMA_ATTN_BLOCK 1 / 2


def _hd128(dim, n_heads, n_kv_heads, bits, seed):
    jcfg = tiny_config(dim=dim, n_heads=n_heads, n_kv_heads=n_kv_heads, seq_len=48)
    np_params = random_params(jcfg, seed=seed)
    cfg = torch_cfg(jcfg)
    jp = jl.fuse_params(jl.quantize_params(jcfg, np_params, bits=bits, group_size=16,
                                           dtype=jnp.float32), jcfg)
    tp = tl.fuse_params(tl.quantize_params(cfg, np_params, bits=bits, group_size=16,
                                           dtype=torch.float32, device="cpu"), cfg)
    assert cfg.head_dim == 128
    return jcfg, cfg, jp, tp


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts of the plain K14 forms the CPU wrappers run (the path taken)."""
    calls = {"attn_rope_write_layered": 0, "attn_block_layered": 0}
    for name in calls:
        real = getattr(ab, name + "_plain")

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(ab, name + "_plain", counted)
    return calls


@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("dim,nh,nkv,bits", [(256, 2, 2, 8), (512, 4, 2, 4),
                                             (1536, 12, 1, 4)])
def test_decode_steps_under_attn_block_match_jax(monkeypatch, fused_calls, mode, dim, nh,
                                                 nkv, bits):
    jcfg, cfg, jp, tp = _hd128(dim, nh, nkv, bits, seed=dim + mode)
    monkeypatch.setattr(tl, "ATTN_BLOCK", mode)
    b = 3
    toks = np.random.default_rng(mode).integers(3, jcfg.vocab_size, (b, 8)).astype(np.int32)
    jc = jl.KVCache.create(jcfg, b, 48, dtype=jnp.float32)
    tc = tl.KVCache.create(cfg, b, 48, dtype=torch.float32, device="cpu")
    _, jc = jl.prefill(jp, jcfg, jnp.asarray(toks), jc)
    _, tc = tl.prefill(tp, cfg, torch.from_numpy(toks).long(), tc)
    for step in range(3):
        tok = np.array([11 + step, 4, 9], np.int32)
        pos = np.array([8 + step, 20 + step, 47], np.int32)   # the last row of the cache
        lj, jc = jl.decode_step(jp, jcfg, jnp.asarray(tok), jnp.asarray(pos), jc)
        lt, tc = tl.decode_step(tp, cfg, torch.from_numpy(tok), torch.from_numpy(pos), tc)
        lj = np.asarray(lj)
        np.testing.assert_allclose(lt.numpy(), lj, atol=1e-3 * np.abs(lj).max(), rtol=0)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5, rtol=0)
    name = "attn_block_layered" if mode == 2 else "attn_rope_write_layered"
    assert fused_calls[name] == 3 * cfg.n_layers
    assert sum(fused_calls.values()) == fused_calls[name]


def test_attn_block_mode_follows_jax_conditions(monkeypatch):
    _, cfg, _, tp = _hd128(256, 2, 2, 8, seed=1)
    monkeypatch.setattr(tl, "ATTN_BLOCK", 2)
    dense = tl.KVCache.create(cfg, 2, 48, dtype=torch.float32, device="cpu")
    assert tl.attn_block_mode(tp, cfg, dense, 2) == 2
    assert tl.attn_block_mode(tp, cfg, tl.QuantKVCache.create(cfg, 2, 48, device="cpu"), 2) == 0
    assert tl.attn_block_mode(tp, cfg, dense, 33) == 0
    assert tl.attn_block_mode({**tp, "wo": torch.zeros(2, 256, 256)}, cfg, dense, 2) == 0
    assert tl.attn_block_mode(tp, cfg, tl.KVCache.create(cfg, 2, 44, dtype=torch.float32,
                                                         device="cpu"), 2) == 0
    monkeypatch.setattr(tl, "ATTN_BLOCK", 0)
    assert tl.attn_block_mode(tp, cfg, dense, 2) == 0
    small = torch_cfg(tiny_config())                    # head_dim 16
    assert tl.attn_block_mode(tp, small, dense, 2) == 0


def test_engine_stream_under_mode_2_equals_mode_0(monkeypatch, fused_calls):
    from rama_tpu_torch.config import EngineConfig
    from rama_tpu_torch.runtime.engine import Engine, Request
    from rama_tpu_torch.tokenizer import Tokenizer

    _, cfg, _, tp = _hd128(256, 2, 2, 8, seed=4)
    v = cfg.vocab_size
    vocab = ["<unk>", "<s>", "</s>"] + [chr(97 + i % 26) + str(i // 26) * (i >= 26)
                                        for i in range(v - 3)]
    tok = Tokenizer(vocab, [0.0] * v)
    streams = []
    for mode in (0, 2):
        monkeypatch.setattr(tl, "ATTN_BLOCK", mode)
        eng = Engine(cfg, tp, tok, EngineConfig(max_batch_size=2, decode_tick=4))
        reqs = [Request(prompt="abc", steps=12, temperature=0.0, stop_at_eos=False),
                Request(prompt="zq", steps=7, temperature=0.0, stop_at_eos=False)]
        eng.start()
        try:
            for r in reqs:
                eng.submit(r)
            got = []
            for r in reqs:
                out = []
                while (t := r.queue.get(timeout=120)) is not None:
                    out.append(t)
                got.append(out)
        finally:
            eng.stop()
        assert all(r.error is None for r in reqs)
        streams.append(got)
    assert streams[0] == streams[1]
    assert [len(s) for s in streams[1]] == [12, 7]
    assert fused_calls["attn_block_layered"] > 0 and fused_calls["attn_rope_write_layered"] == 0



def test_every_admitted_group_has_a_kernel_form(monkeypatch):
    """Every GQA group 1..128 that attn_block_mode admits (its conditions,
    like rama_tpu's, have no group term) has a K14 form: on the card's bf16
    body the decode attention's T = 1 row form (8 rows up to a group of 8,
    then 16 / 32 / 64, groups of 64 past 64), on the fp32 body 1 or 8 rows
    in groups of 8; each row group a CTA, every query row covered once.
    No cache length is refused: the split workspace covers every row below
    the last position at S 512 / 4096 / 131072 (the combine keeps split
    weights past the card's shared memory in the workspace)."""
    d = 128
    for rep in range(1, 129):
        jcfg = tiny_config(dim=d * rep, n_heads=rep, n_kv_heads=1, n_layers=1, seq_len=48)
        cfg = torch_cfg(jcfg)
        wo = QuantizedTensor(q=torch.zeros(1, d * rep, 128, dtype=torch.int8),
                             scales=torch.ones(1, d * rep // 64, 128), group_size=64, bits=8)
        cache = tl.KVCache(k=torch.zeros(1, 2, 1, 48, d), v=torch.zeros(1, 2, 1, 48, d))
        monkeypatch.setattr(tl, "ATTN_BLOCK", 2)
        assert tl.attn_block_mode({"wo": wo}, cfg, cache, 2) == 2
        form, groups = ab.form_for(torch.bfloat16, rep)
        assert (form, groups) == da.row_form(1, rep)
        assert form in da.FORMS and (groups == 1 or form == 64)
        assert form * (groups - 1) < rep <= form * groups
        sform, sgroups = ab.form_for(torch.float32, rep)
        assert sform in ab.SIMT_FORMS and sform * (sgroups - 1) < rep <= sform * sgroups
        for s in (512, 4096, 131072):
            row = torch.zeros(1, 1, 1, 1, d).expand(1, 2, 1, s, d)   # no bytes of its own
            big = tl.KVCache(k=row, v=row) if rep in (32, 64) else cache
            assert tl.attn_block_mode({"wo": wo}, cfg, big, 2) == 2
            assert (ab.nsplit(s) - 1) * ab.CHUNK < s - 1 <= ab.nsplit(s) * ab.CHUNK
    assert ab.form_for(torch.bfloat16, 12) == (16, 1)   # Mistral-Large-Instruct-2407
    assert ab.form_for(torch.bfloat16, 7) == (8, 1)     # Yi-34B: the parent's code
    assert ab.form_for(torch.bfloat16, 65) == (64, 2)


def test_group12_engine_streams_under_mode_2_equal_jax_engine(monkeypatch, fused_calls):
    """A group-12 model (dim 1536, 12 heads over 1 kv head, head_dim 128,
    2 layers, int4 gs 16: Mistral-Large-Instruct-2407's group) served by the
    port's engine under RAMA_ATTN_BLOCK 2 streams the JAX engine's greedy
    ids (unfused on the CPU: the same function), every decode step through
    the full form of K14 (its plain version on CPU tensors)."""
    from rama_tpu.config import EngineConfig as JEcfg
    from rama_tpu.runtime.engine import Engine as JEngine
    from rama_tpu.runtime.engine import Request as JRequest
    from rama_tpu.tokenizer import Tokenizer as JTok
    from rama_tpu_torch.config import EngineConfig
    from rama_tpu_torch.runtime.engine import Engine, Request
    from rama_tpu_torch.tokenizer import Tokenizer

    jcfg, cfg, jp, tp = _hd128(1536, 12, 1, 4, seed=12)
    v = cfg.vocab_size
    vocab = ["<unk>", "<s>", "</s>"] + [chr(97 + i % 26) + str(i // 26) * (i >= 26)
                                        for i in range(v - 3)]
    prompts = (("abab", 9), ("zq", 6), ("abcabc", 7))

    def serve(engine, cls):
        engine.start()
        try:
            reqs = [cls(prompt=pr, steps=n, temperature=0.0, stop_at_eos=False)
                    for pr, n in prompts]
            for r in reqs:
                engine.submit(r)
            outs = []
            for r in reqs:
                out = []
                while (t := r.queue.get(timeout=120)) is not None:
                    out.append(t)
                outs.append(out)
        finally:
            engine.stop()
        assert all(r.error is None for r in reqs)
        return outs

    ecfg = dict(max_batch_size=4, decode_tick=4)
    want = serve(JEngine(jcfg, jp, JTok(vocab, [0.0] * v, max_token_length=4), JEcfg(**ecfg)),
                 JRequest)
    monkeypatch.setattr(tl, "ATTN_BLOCK", 2)
    got = serve(Engine(cfg, tp, Tokenizer(vocab, [0.0] * v, max_token_length=4),
                       EngineConfig(**ecfg)), Request)
    assert got == want
    assert [len(s) for s in got] == [n for _, n in prompts]
    assert fused_calls["attn_block_layered"] > 0 and fused_calls["attn_rope_write_layered"] == 0
