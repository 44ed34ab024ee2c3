"""The int8 KV cache of rama_tpu_torch against rama_tpu on the CPU: the row
quantization, the plain versions of kernels 6 (decode row writer), 7 (int8
decode attention) and 8 (admission strip writer) against the JAX functions
(Pallas in interpret mode), a tiny model on a QuantKVCache, and the engine
and server with kv_quant="int8".

Tolerances: the row quantization and both writers exact (int8 bytes and f32
scales, atol 0); K7 with bf16 q within JAX's own (atol 0.03, rtol 0.05,
tests/test_kv_quant.py); K7 with fp32 q against JAX's dequantize-then-attend
path atol 1e-5 (fp32, scales applied at another point); tiny-model logits
atol 1e-4 with greedy chains equal and cache bytes within 1 (fp32 sums in
another order can move a row's value across a rounding edge); engine and
server streams exact."""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_quant_cache_to_torch, torch_cfg, write_tokenizer_bin
from rama_tpu.models import llama as jl
from rama_tpu.ops.pallas import decode_attention as jda
from rama_tpu.ops.pallas import kv_write as jkw
from rama_tpu.testing.ref_model import random_params, tiny_config
from rama_tpu_torch.config import EngineConfig
from rama_tpu_torch.models import llama as tl
from rama_tpu_torch.ops.kernels import decode_attention as da
from rama_tpu_torch.ops.kernels import kv_write as kw
from rama_tpu_torch.runtime import engine as eng_mod
from rama_tpu_torch.runtime.engine import Engine, Request

torch.set_num_threads(1)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def exact(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == {np.dtype(np.int8): torch.int8,
                         np.dtype(np.float32): torch.float32}[want.dtype]
    np.testing.assert_array_equal(got.numpy(), want)


def rows_with_edges(rng, shape) -> np.ndarray:
    """Random rows of mixed magnitude, plus a zero row (scale floor 1e-10)
    and a row whose scale is exactly 1 with .5 ties (round half to even)."""
    x = (rng.standard_normal(shape) * rng.uniform(1e-3, 30, shape[:-1] + (1,))).astype(
        np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    ties = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5, 4.5], np.float32)
    flat[1] = np.resize(ties, shape[-1])
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quant_rows_exact(dtype):
    x = rows_with_edges(np.random.default_rng(0), (3, 5, 4, 128))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    jq, js = jl.kv_quant_rows(jx)
    tq, ts = tl.kv_quant_rows(tx)
    exact(tq, jq)
    exact(ts, js)
    row = tq.reshape(-1, 128)
    assert not row[0].any() and float(ts.reshape(-1)[0]) == np.float32(1e-10)
    assert row[1, :8].tolist() == [127, 2, -4, 0, 0, 2, -126, 4]


def _cache(rng, L, B, nkv, s, hd):
    return (t(rng.integers(-127, 128, (L, B, nkv, s, hd)).astype(np.int8)),
            t(rng.integers(-127, 128, (L, B, nkv, s, hd)).astype(np.int8)),
            t(rng.standard_normal((L, B, nkv, s)).astype(np.float32)),
            t(rng.standard_normal((L, B, nkv, s)).astype(np.float32)))


# pos on the Pallas writer's 32-row and 128-column window edges
@pytest.mark.parametrize("s,pos", [(24, [0, 11, 12, 23]), (64, [0, 31, 32, 63]),
                                   (256, [31, 32, 127, 128, 255])])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_write_kv_rows_q8_plain_equals_jax(s, pos, dtype):
    rng = np.random.default_rng(s)
    L, nkv, hd, B = 3, 2, 128, len(pos)
    cache = _cache(rng, L, B, nkv, s, hd)
    k = rows_with_edges(rng, (B, nkv, hd))
    v = rows_with_edges(rng, (B, nkv, hd))
    jk, jv = jnp.asarray(k, getattr(jnp, dtype)), jnp.asarray(v, getattr(jnp, dtype))
    want = [jnp.asarray(a.numpy()) for a in cache]
    got = [a.clone() for a in cache]
    p = np.asarray(pos, np.int32)
    for layer in (0, L - 1):
        kq, ksc = jl.kv_quant_rows(jk)
        vq, vsc = jl.kv_quant_rows(jv)
        want = jkw.write_kv_rows_q8(*want, kq, vq, ksc, vsc, jnp.asarray(p),
                                    jnp.int32(layer), interpret=True)
        tk = t(np.asarray(jk.astype(jnp.float32))).to(getattr(torch, dtype))
        tv = t(np.asarray(jv.astype(jnp.float32))).to(getattr(torch, dtype))
        kw.write_kv_rows_q8_plain(*got, tk, tv, t(p), layer)
    for g, w in zip(got, want):
        exact(g, w)


def test_write_kv_rows_q8_clamps_overshoot_to_the_last_row():
    """A finished slot's row past the cache end lands on the last row, as
    the dense cache's row write clamps it."""
    rng = np.random.default_rng(1)
    cache = [a.zero_() for a in _cache(rng, 1, 2, 2, 16, 16)]
    k = t(rows_with_edges(rng, (2, 2, 16)))
    kw.write_kv_rows_q8(*cache, k, k, torch.tensor([3, 40], dtype=torch.int32), 0)
    q, s = tl.kv_quant_rows(k)
    exact(cache[0][0, 1, :, 15], q[1].numpy())
    exact(cache[2][0, 0, :, 3], s[0].numpy())
    assert int(cache[0][0, 1, :, :15].abs().sum()) == 0


# the (s, t, k) cases of tests/test_kv_quant.py, duplicate padded slots included
@pytest.mark.parametrize("s,tt,k", [(64, 16, 3), (256, 40, 4), (48, 48, 2)])
def test_write_kv_strips_q8_plain_equals_jax(s, tt, k):
    rng = np.random.default_rng(17)
    L, B, nkv, hd = 3, 6, 2, 128
    cache = _cache(rng, L, B, nkv, s, hd)
    strips = [rows_with_edges(rng, (L, k, nkv, tt, hd)) for _ in range(2)]
    slots = np.arange(k, dtype=np.int32)[::-1].copy()     # out of order
    if k > 1:
        slots[-1] = slots[-2]
        for x in strips:
            x[:, -1] = x[:, -2]
    (kq, ksc), (vq, vsc) = (jl.kv_quant_rows(jnp.asarray(x)) for x in strips)
    want = jkw.write_kv_strips_q8(*(jnp.asarray(a.numpy()) for a in cache), kq, vq, ksc, vsc,
                                  jnp.asarray(slots), interpret=True)
    got = [a.clone() for a in cache]
    kw.write_kv_strips_q8_plain(*got, t(strips[0]), t(strips[1]), t(slots), tt)
    for g, w in zip(got, want):
        exact(g, w)


def test_write_kv_strips_q8_takes_a_prefix_of_rows_and_strips():
    """The engine's use: rows 0:t_ins of the first len(slots) strips of a
    padded scratch batch; nothing else of the cache moves."""
    rng = np.random.default_rng(5)
    cache = _cache(rng, 2, 4, 2, 32, 16)
    before = [a.clone() for a in cache]
    k, v = (t(rows_with_edges(rng, (2, 3, 2, 16, 16))) for _ in range(2))
    kw.write_kv_strips_q8(*cache, k, v, torch.tensor([2, 0], dtype=torch.int32), 9)
    for strip, q8, sc in ((k, cache[0], cache[2]), (v, cache[1], cache[3])):
        q, s = tl.kv_quant_rows(strip[:, :2, :, :9])
        exact(q8[:, [2, 0], :, :9], q.numpy())
        exact(sc[:, [2, 0], :, :9], s.numpy())
    for now, was in zip(cache, before):
        now[:, [2, 0], :, :9] = was[:, [2, 0], :, :9]
        assert torch.equal(now, was)


@pytest.mark.parametrize("dtype,hd,body", [
    (torch.bfloat16, 48, "stream"), (torch.bfloat16, 64, "stream"),
    (torch.bfloat16, 128, "stream"), (torch.float32, 128, "rows"),
    (torch.float32, 64, "rows"), (torch.bfloat16, 96, "rows"), (torch.bfloat16, 16, "rows")])
def test_strip_writers_pick_their_body_by_dtype_and_head_dim(dtype, hd, body):
    """K8 and K13 (b) launch the streaming body for bf16 strips at head dim
    48 / 64 / 128 and the warp-a-row body for anything else; the choice
    depends on nothing but the dtype and the head dim."""
    assert kw.prefill_body_for(dtype, hd) == body
    assert (hd in kw.STREAM_HEAD_DIMS and dtype == torch.bfloat16) == (body == "stream")
    assert kw.PREFILL_BODIES == {"rows": 0, "stream": 1}


# (head_dim, t_ins of a 20-row strip, slots with a duplicate carrying an
# identical strip): the streaming body's head dims
@pytest.mark.parametrize("hd", [48, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_write_kv_strips_q8_plain_equals_jax_at_stream_head_dims(hd, dtype):
    rng = np.random.default_rng(hd)
    L, B, nkv, s, tt = 2, 5, 3, 40, 20
    cache = _cache(rng, L, B, nkv, s, hd)
    strips = [rows_with_edges(rng, (L, 4, nkv, tt, hd)) for _ in range(2)]
    slots = np.array([3, 0, 4, 4], np.int32)
    for x in strips:
        x[:, 3] = x[:, 2]
    js = [jnp.asarray(x, getattr(jnp, dtype)) for x in strips]
    (kq, ksc), (vq, vsc) = (jl.kv_quant_rows(x) for x in js)
    want = jkw.write_kv_strips_q8(*(jnp.asarray(a.numpy()) for a in cache), kq, vq, ksc, vsc,
                                  jnp.asarray(slots), interpret=True)
    got = [a.clone() for a in cache]
    tk, tv = (t(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype)) for x in js)
    kw.write_kv_strips_q8(*got, tk, tv, t(slots), tt)
    for g, w in zip(got, want):
        exact(g, w)


@pytest.mark.parametrize("slots", [[-1, 1], [1, 5], [-3, 2, 6, 0], [7, -1]])
def test_write_kv_strips_q8_writes_an_out_of_range_slot_nowhere(slots):
    """A strip whose slot lies outside [0, B) is written nowhere, as the
    kernel leaves it: the JAX kernel does not define that case, so the
    port's own rule holds (the plain version used to wrap -1 onto slot B -
    1 and raise on B); the strips of slots in range land as usual."""
    rng = np.random.default_rng(len(slots))
    B = 5
    cache = _cache(rng, 2, B, 2, 24, 64)
    before = [a.clone() for a in cache]
    k, v = (t(rows_with_edges(rng, (2, len(slots), 2, 16, 64))) for _ in range(2))
    kw.write_kv_strips_q8_plain(*cache, k, v, torch.tensor(slots, dtype=torch.int32), 16)
    kept = [j for j, s in enumerate(slots) if 0 <= s < B]
    for strip, q8, sc, q8_0, sc_0 in ((k, cache[0], cache[2], before[0], before[2]),
                                      (v, cache[1], cache[3], before[1], before[3])):
        q, s = tl.kv_quant_rows(strip[:, kept, :, :16])
        idx = [slots[j] for j in kept]
        exact(q8[:, idx, :, :16], q.numpy())
        exact(sc[:, idx, :, :16], s.numpy())
        q8_0[:, idx, :, :16], sc_0[:, idx, :, :16] = q, s
    for now, was in zip(cache, before):
        assert torch.equal(now, was)


def _q8_inputs(rng, L, B, nkv, s, hd, rep):
    k = rng.standard_normal((L, B, nkv, s, hd)).astype(np.float32)
    v = rng.standard_normal((L, B, nkv, s, hd)).astype(np.float32)
    (k8, ks), (v8, vs) = jl.kv_quant_rows(jnp.asarray(k)), jl.kv_quant_rows(jnp.asarray(v))
    q = rng.standard_normal((B, nkv * rep, hd)).astype(np.float32)
    return q, k8, v8, ks, vs


@pytest.mark.parametrize("s", [64, 1024])
@pytest.mark.parametrize("rep", [1, 2])
def test_decode_attention_q8_plain_matches_pallas(s, rep):
    rng = np.random.default_rng(s + rep)
    L, B, nkv, hd = 2, 2, 2, 128
    q, k8, v8, ks, vs = _q8_inputs(rng, L, B, nkv, s, hd, rep)
    jq = jnp.asarray(q, jnp.bfloat16)
    tq = t(np.asarray(jq.astype(jnp.float32))).to(torch.bfloat16)
    pos = np.array([s - 1, s // 3], np.int32)
    for layer in range(L):
        got = da.decode_attention_q8_plain(tq, t(k8), t(v8), t(ks), t(vs), t(pos),
                                           layer).float().numpy()
        for fn in (jda.decode_attention_layer_q8, jda.decode_attention_layer_tiled_q8):
            want = fn(jq, k8, v8, ks, vs, jnp.asarray(pos), jnp.int32(layer), interpret=True)
            np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=0.03,
                                       rtol=0.05)


# (L, hd, S, pos): 1-3 layers, hd 64 / 128, the step's row at 0, on the
# walk's 64-row tile edges (63 / 64, 127 / 128) and at S - 1
@pytest.mark.parametrize("L,hd,s,pos", [(1, 64, 128, [0, 63, 64, 127]),
                                        (2, 128, 256, [0, 63, 64, 255]),
                                        (3, 64, 192, [127, 128, 191, 5])])
def test_decode_attention_q8_writes_its_rows_as_jax_writes_them(L, hd, s, pos):
    """K6 inside K7: decode_attention_q8 given the decode step's rows
    (k_new / v_new; on the CPU the plain K6 writer, then the plain
    attention) against rama_tpu's kv_quant_rows + write_kv_rows_q8, then
    decode_attention_layer_q8 / _tiled_q8, in interpret mode, a layer at a
    time: the cache's int8 bytes and f32 scales exact, the outputs within
    JAX's tolerance (atol 0.03, rtol 0.05)."""
    rng = np.random.default_rng(100 * L + hd + s)
    B, nkv, rep = len(pos), 2, 2
    q, k8, v8, ks, vs = _q8_inputs(rng, L, B, nkv, s, hd, rep)
    jq = jnp.asarray(q, jnp.bfloat16)
    tq = t(np.asarray(jq.astype(jnp.float32))).to(torch.bfloat16)
    want_c = [k8, v8, ks, vs]
    got_c = [t(np.asarray(a)).clone() for a in want_c]
    p = np.asarray(pos, np.int32)
    for layer in range(L):
        jk, jv = (jnp.asarray(rows_with_edges(rng, (B, nkv, hd)), jnp.bfloat16) for _ in "kv")
        (kq, ksc), (vq, vsc) = jl.kv_quant_rows(jk), jl.kv_quant_rows(jv)
        want_c = jkw.write_kv_rows_q8(*want_c, kq, vq, ksc, vsc, jnp.asarray(p),
                                      jnp.int32(layer), interpret=True)
        tk, tv = (t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16) for x in (jk, jv))
        got = da.decode_attention_q8(tq, *got_c, t(p), layer, k_new=tk, v_new=tv)
        for g, w in zip(got_c, want_c):
            exact(g, w)
        for fn in (jda.decode_attention_layer_q8, jda.decode_attention_layer_tiled_q8):
            want = fn(jq, *want_c, jnp.asarray(p), jnp.int32(layer), interpret=True)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       atol=0.03, rtol=0.05)


@pytest.mark.parametrize("over", [0, 1, 5])
def test_decode_attention_q8_puts_a_finished_slots_row_on_the_last(over):
    """A decode step's row at pos S + over (a finished slot's overshoot)
    lands on row S - 1 by K6's rule, where JAX drops it (a deliberate
    difference, ROADMAP §3), and that slot attends over rows 0 .. S - 1
    with it; the other slot's row lands at its pos. Against the rows put
    into the cache by hand, then the int8 attention without rows: bytes
    exact, outputs equal."""
    rng = np.random.default_rng(over)
    L, B, nkv, s, hd = 2, 2, 2, 64, 64
    q, k8, v8, ks, vs = _q8_inputs(rng, L, B, nkv, s, hd, 2)
    tq = t(q).to(torch.bfloat16)
    got_c = [t(np.asarray(a)).clone() for a in (k8, v8, ks, vs)]
    want_c = [a.clone() for a in got_c]
    k, v = (t(rows_with_edges(rng, (B, nkv, hd))).to(torch.bfloat16) for _ in "kv")
    pos = torch.tensor([s + over, 17], dtype=torch.int32)
    got = da.decode_attention_q8(tq, *got_c, pos, 1, k_new=k, v_new=v)
    for rows, q8, sc in ((k, want_c[0], want_c[2]), (v, want_c[1], want_c[3])):
        r8, rs = kw.kv_quant_rows(rows)
        for b, p in enumerate([s - 1, 17]):
            q8[1, b, :, p], sc[1, b, :, p] = r8[b], rs[b]
    for g, w in zip(got_c, want_c):
        assert torch.equal(g, w)
    assert torch.equal(got, da.decode_attention_q8_plain(tq, *want_c, pos, 1))


@pytest.mark.parametrize("rep", [1, 2])
def test_decode_attention_q8_plain_fp32_follows_the_dequant_path(rep):
    """fp32 q: the JAX package's CPU path (_dequant_kv + _attention)."""
    rng = np.random.default_rng(9)
    L, B, nkv, s, hd = 2, 3, 2, 48, 16
    q, k8, v8, ks, vs = _q8_inputs(rng, L, B, nkv, s, hd, rep)
    pos = np.array([0, 17, 47], np.int32)
    mask = jnp.arange(s)[None, None, :] <= jnp.asarray(pos)[:, None, None]
    for layer in range(L):
        kd, vd = jl._dequant_kv(k8[layer], v8[layer], ks[layer], vs[layer], jnp.float32)
        want = jl._attention(jnp.asarray(q)[:, None], kd, vd, mask)[:, 0]
        got = da.decode_attention_q8(t(q), t(k8), t(v8), t(ks), t(vs), t(pos), layer)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _tiny(seq_len=48, seed=11):
    jcfg = tiny_config(seq_len=seq_len)
    np_params = random_params(jcfg, seed=seed)
    cfg = torch_cfg(jcfg)
    jp = jl.fuse_params(jl.quantize_params(jcfg, np_params, bits=8, group_size=16,
                                           dtype=jnp.float32), jcfg)
    tp = tl.fuse_params(tl.quantize_params(cfg, np_params, bits=8, group_size=16,
                                           dtype=torch.float32, device="cpu"), cfg)
    return jcfg, cfg, np_params, jp, tp


def test_tiny_model_on_int8_cache_matches_jax():
    """Prefill and 8 decode steps on a QuantKVCache: the port's decode runs
    K6 + K7 (plain here), the JAX package's CPU path quantize + scatter +
    dequantize + attend."""
    jcfg, cfg, _, jp, tp = _tiny()
    prompt = np.array([[1, 7, 3, 9, 2, 4, 8, 5]], np.int32)
    jc = jl.QuantKVCache.create(jcfg, batch=1, max_len=32)
    tc = tl.QuantKVCache.create(cfg, 1, 32, device="cpu")
    lj, jc = jl.prefill(jp, jcfg, jnp.asarray(prompt), jc)
    lt, tc = tl.prefill(tp, cfg, torch.from_numpy(prompt).long(), tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)
    tok_j = tok_t = int(np.argmax(np.asarray(lj)[0, -1]))
    chain_j, chain_t = [tok_j], [tok_t]
    for pos in range(8, 16):
        lj, jc = jl.decode_step(jp, jcfg, jnp.asarray([tok_j], jnp.int32),
                                jnp.asarray([pos], jnp.int32), jc)
        lt, tc = tl.decode_step(tp, cfg, torch.tensor([tok_t]), torch.tensor([pos]), tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)
        tok_j, tok_t = int(np.argmax(np.asarray(lj))), int(torch.argmax(lt))
        chain_j.append(tok_j)
        chain_t.append(tok_t)
    assert chain_t == chain_j
    conv = jax_quant_cache_to_torch(jc)
    for a, b in ((tc.k, conv.k), (tc.v, conv.v)):
        assert int((a.int() - b.int()).abs().max()) <= 1
    torch.testing.assert_close(tc.ks, conv.ks, rtol=1e-5, atol=0)


def _tokenizers(vocab_size):
    from rama_tpu.tokenizer import Tokenizer as JTok
    from rama_tpu_torch.tokenizer import Tokenizer

    vocab = ["<unk>", "<s>", "</s>"] + [chr(ord("a") + i % 26) + ("" if i < 26 else str(i // 26))
                                        for i in range(vocab_size - 3)]
    return (JTok(vocab, [0.0] * vocab_size, max_token_length=4),
            Tokenizer(vocab, [0.0] * vocab_size, max_token_length=4))


def _serve(engine, reqs):
    engine.start()
    try:
        for r in reqs:
            engine.submit(r)
        out = []
        for r in reqs:
            toks = []
            while (tok := r.queue.get(timeout=120)) is not None:
                toks.append(tok)
            out.append(toks)
        return out
    finally:
        engine.stop()


def test_engine_int8_cache_streams_match_jax_and_dense(monkeypatch):
    """Greedy streams of the port's engine on an int8 cache equal the JAX
    engine's on its int8 cache and the port's dense engine's; admission
    inserts through the strip writer, once per admission group."""
    from rama_tpu.config import EngineConfig as JEcfg
    from rama_tpu.runtime.engine import Engine as JEngine
    from rama_tpu.runtime.engine import Request as JRequest

    jcfg, cfg, _, jp, tp = _tiny(seq_len=64, seed=21)
    jtok, ttok = _tokenizers(cfg.vocab_size)
    specs = (("ab", 12), ("ba", 6), ("hello", 9))
    want = _serve(JEngine(jcfg, jp, jtok, JEcfg(max_batch_size=4, kv_quant="int8")),
                  [JRequest(prompt=p, steps=n, temperature=0.0) for p, n in specs])
    inserts = []
    orig = eng_mod.write_kv_strips_q8
    monkeypatch.setattr(eng_mod, "write_kv_strips_q8",
                        lambda *a: inserts.append(a[-1]) or orig(*a))
    outs = {}
    for kvq in ("int8", None):
        eng = Engine(cfg, tp, ttok, EngineConfig(max_batch_size=4, decode_tick=4,
                                                 kv_quant=kvq))
        assert isinstance(eng.cache, tl.QuantKVCache if kvq else tl.KVCache)
        outs[kvq] = _serve(eng, [Request(prompt=p, steps=n, temperature=0.0)
                                 for p, n in specs])
        assert eng.stats()["engine_errors"] == 0
    assert outs["int8"] == want
    assert outs[None] == want
    assert inserts and all(n == 16 for n in inserts)   # t_ins: the 16-row bucket


def test_engine_int8_cache_recovers_with_an_int8_cache():
    _, cfg, _, _, tp = _tiny(seq_len=32)
    eng = Engine(cfg, tp, _tokenizers(cfg.vocab_size)[1],
                 EngineConfig(max_batch_size=2, kv_quant="int8"))
    eng.cache.k.fill_(5)
    eng.cache = eng._create_cache(2)
    assert isinstance(eng.cache, tl.QuantKVCache) and not eng.cache.k.any()
    assert eng.cache.k.shape == (cfg.n_layers, 2, cfg.n_kv_heads, 32, cfg.head_dim)


def test_load_engine_int8_cache_streams_over_sse(tmp_path):
    """`--kv-quant int8`: load_engine builds the int8-cache engine, which
    streams over SSE the JAX package's greedy chain on a QuantKVCache."""
    from aiohttp.test_utils import TestClient, TestServer

    from rama_tpu_torch.checkpoint import save_v0
    from rama_tpu_torch.server.app import build_app, load_engine

    jcfg = tiny_config(seq_len=32)
    np_params = random_params(jcfg, seed=23)
    model = tmp_path / "m.bin"
    save_v0(str(model), torch_cfg(jcfg), np_params)
    tok_path = write_tokenizer_bin(tmp_path / "tok.bin", jcfg.vocab_size)
    eng = load_engine(str(model), tok_path, quant="int8", dtype="float32", batch=2,
                      device="cpu", kv_quant="int8")
    assert isinstance(eng.cache, tl.QuantKVCache)
    jp = jl.fuse_params(jl.quantize_params(jcfg, np_params, bits=8, dtype=jnp.float32), jcfg)
    cache = jl.QuantKVCache.create(jcfg, 1, jcfg.seq_len)
    ids, nxt = [], 1
    for pos in range(10):
        logits, cache = jl.decode_step(jp, jcfg, jnp.asarray([nxt], jnp.int32),
                                       jnp.asarray([pos], jnp.int32), cache)
        nxt = int(np.argmax(np.asarray(logits)[0]))
        ids.append(nxt)
        if nxt == 2:
            break

    async def run():
        client = TestClient(TestServer(build_app(eng)))
        await client.start_server()
        try:
            resp = await client.get("/gen", params={"prompt": "", "steps": "10",
                                                    "temperature": "0.0"})
            assert resp.status == 200
            return await asyncio.wait_for(resp.text(), timeout=120)
        finally:
            await client.close()

    eng.start()
    try:
        body = asyncio.run(run())
    finally:
        eng.stop()
    datas = [ln[len("data: "):] for ln in body.split("\n") if ln.startswith("data: ")]
    assert "event: error" not in body
    assert datas == [eng.tokenizer.decode_token(i).replace("\n", "\\n") for i in ids]


def test_cpu_wrappers_dispatch_to_plain():
    rng = np.random.default_rng(3)
    q, k8, v8, ks, vs = _q8_inputs(rng, 2, 2, 2, 32, 16, 2)
    args = (t(q), t(k8), t(v8), t(ks), t(vs), torch.tensor([3, 31], dtype=torch.int32), 1)
    torch.testing.assert_close(da.decode_attention_q8(*args),
                               da.decode_attention_q8_plain(*args), rtol=0, atol=0)
    # the decode step's row write (K6) goes through the int8 attention entry
    assert tl._KERNELS.decode_attention_q8 is da.decode_attention_q8
    assert not hasattr(tl._KERNELS, "write_kv_rows_q8")
    assert tl._PLAIN.decode_attention_q8 is da.decode_attention_q8_plain
    assert tl._PLAIN.write_kv_strips_q8 is kw.write_kv_strips_q8_plain


class _Recorder:
    """Kernel entry points that forward every call to `ops` and record it:
    (name, whether it was given the new rows k_new / v_new)."""

    def __init__(self, ops):
        self._ops, self.calls = ops, []

    def __getattr__(self, name):
        fn = getattr(self._ops, name)

        def call(*a, **kw):
            self.calls.append((name, kw.get("k_new") is not None))
            return fn(*a, **kw)

        return call


@pytest.mark.parametrize("dtype,hd,fused", [(torch.bfloat16, 64, True), (torch.bfloat16, 48, True),
                                            (torch.float32, 64, False),
                                            (torch.bfloat16, 16, False)])
def test_int8_chunk_and_paged_steps_route_their_row_write(monkeypatch, dtype, hd, fused):
    """Through a recording `_KERNELS` (the non-plain route): a dense decode
    step and a verify chunk over an int8 cache and a paged decode step and
    chunk over an int8 pool hand their new rows to the attention entry,
    once a layer, and never call the standalone writer (K6, K11, K13 (a))
    themselves, and the logits equal plain=True's exactly (the same plain
    functions on the CPU) and the dense cache its bytes. Off the CPU the
    entry picks the writer: where the launch takes the int8 walk (bf16 at
    head_dim 48 / 64 / 128, `walk_writes_rows`) the launch gets the rows
    and no writer runs; fp32 and another head dim run the standalone
    writer first, then the launch without rows (meta tensors, the launch
    and the writers recorded)."""
    from rama_tpu_torch.ops.kernels import paged_attention as pa
    from rama_tpu_torch.runtime import paged

    jcfg = tiny_config(dim=2 * hd, hidden_dim=64, n_layers=2, n_heads=2, n_kv_heads=1,
                       vocab_size=32, seq_len=32)
    cfg = torch_cfg(jcfg)
    params = tl.load_params(cfg, random_params(jcfg, seed=3), dtype=dtype, device="cpu")
    toks = torch.tensor([[5, 9, 3, 7], [2, 8, 4, 1]])
    pos0 = torch.tensor([3, 9])
    rec = _Recorder(tl._KERNELS)
    monkeypatch.setattr(tl, "_KERNELS", rec)
    monkeypatch.setattr(paged, "_KERNELS", rec)
    n = cfg.n_layers

    def calls(run) -> list:
        rec.calls.clear()
        run()
        return [c for c in rec.calls if "attention" in c[0] or "write" in c[0]]

    caches = [tl.QuantKVCache.create(cfg, 2, 32, device="cpu") for _ in range(2)]
    out = {}
    got = calls(lambda: out.setdefault(0, tl.forward_chunk(params, cfg, toks, pos0,
                                                           caches[0])[0]))
    want, _ = tl.forward_chunk(params, cfg, toks, pos0, caches[1], plain=True)
    assert torch.equal(out[0], want)
    assert all(torch.equal(a, b) for a, b in zip(vars(caches[0]).values(),
                                                 vars(caches[1]).values()))
    assert got == [("chunk_attention_q8", True)] * n
    # the dense decode step (T = 1), one slot past the cache end (K6's rule)
    step = toks[:, :1], torch.tensor([[31], [40]])
    got = calls(lambda: out.setdefault(1, tl.forward(params, cfg, *step, caches[0])[0]))
    want, _ = tl.forward(params, cfg, *step, caches[1], plain=True)
    assert torch.equal(out[1], want)
    assert all(torch.equal(a, b) for a, b in zip(vars(caches[0]).values(),
                                                 vars(caches[1]).values()))
    assert got == [("decode_attention_q8", True)] * n
    tables = torch.tensor([[0, 2], [1, 3]], dtype=torch.int32)
    for tq, name in ((1, "paged_decode_attention_q8"), (3, "paged_chunk_attention_q8")):
        pool = paged.QuantPagedKVCache.create(cfg, 5, 16, device="cpu")
        pos = pos0[:, None] + torch.arange(tq)[None, :]
        got = calls(lambda: paged.forward_paged(params, cfg, toks[:, :tq], pos, pool, tables))
        assert got == [(name, True)] * n

    seen = []
    for mod, launch in ((da, "_launch"), (pa, "_launch")):
        monkeypatch.setattr(mod, launch, lambda q, *a, rows=None, **kw: seen.append(
            ("launch", rows is not None)) or torch.empty(2, 1, 2, device="meta"))
    for writer in ("write_kv_rows_q8", "write_kv_chunk_q8", "write_kv_paged_q8"):
        monkeypatch.setattr(kw, writer, lambda *a, w=writer: seen.append((w, a[4].dim())))
    monkeypatch.setattr(da, "launches_chunk_q8", 0)
    monkeypatch.setattr(da, "launches_write_q8", 0)
    monkeypatch.setattr(da, "launches_q8", 0)
    monkeypatch.setattr(da, "launches_write_rows_q8", 0)
    meta = dict(device="meta", dtype=dtype)
    q, k8 = torch.empty(2, 3, 2, hd, **meta), torch.empty(2, 2, 1, 32, hd, device="meta")
    rows, s8 = torch.empty(2, 3, 1, hd, **meta), torch.empty(2, 2, 1, 32, device="meta")
    p = torch.zeros(2, dtype=torch.int32, device="meta")
    tab = torch.zeros(2, 2, dtype=torch.int32, device="meta")
    da.chunk_attention_q8(q, k8, k8, s8, s8, p, 1, k_new=rows, v_new=rows)
    pa.paged_chunk_attention_q8(q, k8, k8, s8, s8, p, tab, 1, k_new=rows, v_new=rows)
    pa.paged_decode_attention_q8(q[:, 0], k8, k8, s8, s8, p, tab, 1, k_new=rows[:, 0],
                                 v_new=rows[:, 0])
    da.decode_attention_q8(q[:, 0], k8, k8, s8, s8, p, 1, k_new=rows[:, 0], v_new=rows[:, 0])
    writers = [("write_kv_chunk_q8", 4), ("write_kv_paged_q8", 4), ("write_kv_paged_q8", 4),
               ("write_kv_rows_q8", 3)]
    assert seen == ([("launch", True)] * 4 if fused else
                    [x for w in writers for x in (w, ("launch", False))])
    assert da.walk_writes_rows(q) == fused
    assert (da.launches_q8, da.launches_write_rows_q8) == (1, int(fused))
