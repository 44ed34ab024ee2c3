"""Kernels 10 and 11 on the CPU, and the port's forward_chunk: the plain
versions against rama_tpu's Pallas functions in interpret mode, and
forward_chunk against rama_tpu's _forward_chunk_fused.

K10: chunk_attention_plain / chunk_attention_q8_plain against
chunk_attention_layer, _tiled (chunk 128, chunks straddling a 128-row
tile), _q8 and _tiled_q8, T in {2, 4, 8}, MHA and GQA, S in {64, 256, 512}.
Tolerance: fp32 atol 1e-5 (the Pallas kernels divide by the softmax sum
before P.V, or after it per tile, where the plain version divides once);
bf16 atol 0.03 / rtol 0.05, as K7's tests state (probabilities rounded to
bf16 at other points); the q8 Pallas kernels cast q to bf16 whatever its
dtype, so their fp32-q cases are held to the bf16 tolerance too.
K11: write_kv_chunk_q8_plain byte for byte against write_kv_chunk_q8 after
kv_quant_rows (atol 0); rows at or past S are dropped as XLA's scatter
drops them (the Pallas kernel wraps them into the cache's last window, see
ROADMAP.md). K11 inside K10 (chunk_attention_q8 with k_new / v_new, the
route of bf16 verify rounds on the card): its plain version against the
Pallas writer followed by chunk_attention_layer_q8, outputs at the bf16
tolerance and the cache exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_params_to_torch, jax_quant_cache_to_torch, torch_cfg
from rama_tpu.models import llama as jl
from rama_tpu.ops.pallas import decode_attention as jda
from rama_tpu.ops.pallas.kv_write import write_kv_chunk_q8 as j_write_chunk
from rama_tpu.testing.ref_model import random_params, tiny_config
from rama_tpu_torch.models import llama as tl
from rama_tpu_torch.ops.kernels import decode_attention as da
from rama_tpu_torch.ops.kernels import kv_write as kw

torch.set_num_threads(1)


def t(a) -> torch.Tensor:
    """A writable CPU tensor of a numpy or JAX array (bf16 as fp32)."""
    a = np.asarray(a)
    return torch.from_numpy(np.array(a if a.dtype in (np.int8, np.int32) else
                                     a.astype(np.float32)))


def make(L, b, tq, nh, nkv, s, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, nh, hd)).astype(np.float32)
    k = (rng.standard_normal((L, b, nkv, s, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((L, b, nkv, s, hd)) * 0.5).astype(np.float32)
    return q, k, v


def positions(s, tq):
    """Ragged chunk starts: 0, a 64-row split straddle (61), a 128-row tile
    straddle (126), and the last chunk that fits."""
    return np.array([0, min(61, s - tq), min(126, s - tq), s - tq], np.int32)


# (tq, nh, nkv, s): T 2 / 4 / 8, MHA and GQA rep 2, S 64 / 256 / 512
CASES = [(2, 4, 4, 64), (4, 4, 2, 256), (8, 4, 4, 512), (4, 4, 4, 64), (2, 4, 2, 512),
         (8, 4, 2, 256)]


def _close(got, want, fp32):
    if fp32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=0.03, rtol=0.05)


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq,nh,nkv,s", CASES)
def test_chunk_attention_plain_matches_pallas(tq, nh, nkv, s, dtype, tiled):
    L, b, hd = 2, 4, 16
    q, k, v = make(L, b, tq, nh, nkv, s, hd, seed=tq * s + nh + nkv)
    pos0 = positions(s, tq)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    fn = jda.chunk_attention_layer_tiled if tiled else jda.chunk_attention_layer
    kwargs = {"chunk": 128} if tiled else {}
    for layer in (0, L - 1):
        want = np.asarray(fn(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                             jnp.asarray(pos0), jnp.int32(layer), interpret=True, **kwargs)
                          .astype(jnp.float32))
        got = da.chunk_attention_plain(t(q).to(td), t(k).to(td), t(v).to(td), t(pos0),
                                       layer).float().numpy()
        _close(got, want, dtype == "float32")


def _q8(k, v):
    (k8, ks), (v8, vs) = jl.kv_quant_rows(jnp.asarray(k)), jl.kv_quant_rows(jnp.asarray(v))
    return k8, v8, ks, vs


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq,nh,nkv,s", CASES[:4])
def test_chunk_attention_q8_plain_matches_pallas(tq, nh, nkv, s, dtype, tiled):
    L, b, hd = 2, 4, 16
    q, k, v = make(L, b, tq, nh, nkv, s, hd, seed=tq * s + nh + 7)
    k8, v8, ks, vs = _q8(k, v)
    pos0 = positions(s, tq)
    jq = jnp.asarray(q, getattr(jnp, dtype))
    tq_ = t(np.asarray(jq.astype(jnp.float32))).to(getattr(torch, dtype))
    fn = jda.chunk_attention_layer_tiled_q8 if tiled else jda.chunk_attention_layer_q8
    kwargs = {"chunk": 128} if tiled else {}
    for layer in (0, L - 1):
        want = np.asarray(fn(jq, k8, v8, ks, vs, jnp.asarray(pos0), jnp.int32(layer),
                             interpret=True, **kwargs).astype(jnp.float32))
        got = da.chunk_attention_q8_plain(tq_, t(k8), t(v8), t(ks), t(vs), t(pos0),
                                          layer).float().numpy()
        _close(got, want, fp32=False)


# (tq, nh, nkv): GQA groups past the card's 8-row form: rep 8 x T 8 (64
# query rows a kv head), rep 3 x T 3 (9), rep 16 x T 1 (16)
GQA_CASES = [(8, 8, 1), (3, 6, 2), (1, 16, 1)]


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("tq,nh,nkv", GQA_CASES)
def test_gqa_chunk_plain_matches_pallas(tq, nh, nkv, q8):
    """K10's plain versions at the GQA groups the card runs in its 16 / 32
    / 64-row forms and row groups, against chunk_attention_layer / _q8 in
    interpret mode on bf16 q (hd 16, S 128, chunks straddling a 64-row
    split and the last that fits): the bf16 tolerance of this file (atol
    0.03, rtol 0.05)."""
    L, b, s, hd = 2, 4, 128, 16
    q, k, v = make(L, b, tq, nh, nkv, s, hd, seed=tq * nh + nkv)
    pos0 = positions(s, tq)
    jq = jnp.asarray(q, jnp.bfloat16)
    tq_ = t(np.asarray(jq.astype(jnp.float32))).bfloat16()
    for layer in (0, L - 1):
        if q8:
            k8, v8, ks, vs = _q8(k, v)
            want = jda.chunk_attention_layer_q8(jq, k8, v8, ks, vs, jnp.asarray(pos0),
                                                jnp.int32(layer), interpret=True)
            got = da.chunk_attention_q8_plain(tq_, t(k8), t(v8), t(ks), t(vs), t(pos0), layer)
        else:
            jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
            want = jda.chunk_attention_layer(jq, jk, jv, jnp.asarray(pos0), jnp.int32(layer),
                                             interpret=True)
            got = da.chunk_attention_plain(tq_, t(np.asarray(jk.astype(jnp.float32))).bfloat16(),
                                           t(np.asarray(jv.astype(jnp.float32))).bfloat16(),
                                           t(pos0), layer)
        _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), fp32=False)


@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2)])
def test_chunk_attention_q8_plain_fp32_follows_the_dequant_path(nh, nkv):
    """fp32 q: the JAX package's CPU path (_dequant_kv + _attention) at
    fp32 tolerance."""
    L, b, tq, s, hd = 2, 4, 4, 64, 16
    q, k, v = make(L, b, tq, nh, nkv, s, hd, seed=5)
    k8, v8, ks, vs = _q8(k, v)
    pos0 = positions(s, tq)
    qpos = jnp.asarray(pos0)[:, None] + jnp.arange(tq)[None, :]
    mask = jnp.arange(s)[None, None, :] <= qpos[:, :, None]
    for layer in range(L):
        kd, vd = jl._dequant_kv(k8[layer], v8[layer], ks[layer], vs[layer], jnp.float32)
        want = np.asarray(jl._attention(jnp.asarray(q), kd, vd, mask))
        got = da.chunk_attention_q8(t(q), t(k8), t(v8), t(ks), t(vs), t(pos0), layer)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_chunk_attention_one_query_is_decode_attention():
    """T = 1 is the decode step: K4's and K7's plain versions are the chunk
    versions of one query, and each query of a chunk equals a decode query
    at its own position."""
    q, k, v = make(2, 3, 4, 4, 2, 64, 16, seed=9)
    pos0 = np.array([0, 30, 60], np.int32)
    full = da.chunk_attention_plain(t(q), t(k), t(v), t(pos0), 1)
    for i in range(4):
        one = da.decode_attention_plain(t(q[:, i]), t(k), t(v), t(pos0 + i), 1)
        torch.testing.assert_close(full[:, i], one, rtol=0, atol=1e-6)


def test_cpu_wrappers_dispatch_to_plain():
    q, k, v = make(2, 2, 3, 4, 2, 32, 16, seed=3)
    k8, v8, ks, vs = (t(a) for a in _q8(k, v))
    pos0 = torch.tensor([3, 29], dtype=torch.int32)
    torch.testing.assert_close(da.chunk_attention(t(q), t(k), t(v), pos0, 1),
                               da.chunk_attention_plain(t(q), t(k), t(v), pos0, 1),
                               rtol=0, atol=0)
    torch.testing.assert_close(da.chunk_attention_q8(t(q), k8, v8, ks, vs, pos0, 1),
                               da.chunk_attention_q8_plain(t(q), k8, v8, ks, vs, pos0, 1),
                               rtol=0, atol=0)
    assert tl._KERNELS.chunk_attention is da.chunk_attention
    assert tl._PLAIN.chunk_attention_q8 is da.chunk_attention_q8_plain
    assert tl._PLAIN.write_kv_chunk_q8 is kw.write_kv_chunk_q8_plain


# -- K11 ----------------------------------------------------------------------


def _random_q8_cache(rng, L, B, nkv, s, hd):
    return (rng.integers(-127, 128, (L, B, nkv, s, hd)).astype(np.int8),
            rng.integers(-127, 128, (L, B, nkv, s, hd)).astype(np.int8),
            rng.standard_normal((L, B, nkv, s)).astype(np.float32),
            rng.standard_normal((L, B, nkv, s)).astype(np.float32))


def _xla_scatter(cache, kq, vq, ksc, vsc, pos0, layer, tq):
    """rama_tpu's XLA scatter of a chunk (.at[].set drops rows past S)."""
    b, nkv = kq.shape[0], kq.shape[2]
    bi = jnp.arange(b)[:, None, None]
    hi = jnp.arange(nkv)[None, None, :]
    pi = (jnp.asarray(pos0)[:, None] + jnp.arange(tq)[None, :])[:, :, None]
    return tuple(jnp.asarray(c).at[layer, bi, hi, pi].set(x)
                 for c, x in zip(cache, (kq, vq, ksc, vsc)))


@pytest.mark.parametrize("s,tq", [(24, 3), (64, 4), (256, 8), (256, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_write_kv_chunk_q8_plain_equals_jax(s, tq, dtype):
    """Byte for byte against the Pallas chunk writer after kv_quant_rows,
    with chunks straddling a 32-row window (pos0 30, or 10 at S 24) and the
    128-column scale tile (126 at S 256), and the last chunk that fits."""
    rng = np.random.default_rng(s + tq)
    L, B, nkv, hd = 3, 4, 2, 16
    cache = _random_q8_cache(rng, L, B, nkv, s, hd)
    jd = getattr(jnp, dtype)
    k = jnp.asarray(rng.standard_normal((B, tq, nkv, hd)) * 3, jd)
    v = jnp.asarray(rng.standard_normal((B, tq, nkv, hd)) * 3, jd)
    (kq, ksc), (vq, vsc) = jl.kv_quant_rows(k), jl.kv_quant_rows(v)
    pos0 = np.array([0, 30 if s >= 64 else 10, 126 if s >= 256 else 1, s - tq], np.int32)
    td = getattr(torch, dtype)
    got = [torch.from_numpy(c.copy()) for c in cache]
    for layer in (0, L - 1):
        want = j_write_chunk(*(jnp.asarray(c) for c in cache), kq, vq, ksc, vsc,
                             jnp.asarray(pos0), jnp.int32(layer), interpret=True)
        mine = [c.clone() for c in got]
        kw.write_kv_chunk_q8_plain(*mine, t(np.asarray(k.astype(jnp.float32))).to(td),
                                   t(np.asarray(v.astype(jnp.float32))).to(td),
                                   t(pos0), layer)
        for a, w in zip(mine, want):
            assert np.array_equal(a.numpy(), np.asarray(w))


def test_write_kv_chunk_q8_drops_rows_past_the_end():
    """Chunks reaching S (pos0 S-2 with T 4) and lying wholly past it: rows
    at or past S are dropped, as XLA's scatter drops them; row S-1 and the
    rest of the cache equal the scatter's."""
    rng = np.random.default_rng(4)
    L, B, nkv, s, hd, tq = 2, 4, 2, 64, 16, 4
    cache = _random_q8_cache(rng, L, B, nkv, s, hd)
    k = rng.standard_normal((B, tq, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, tq, nkv, hd)).astype(np.float32)
    (kq, ksc), (vq, vsc) = jl.kv_quant_rows(jnp.asarray(k)), jl.kv_quant_rows(jnp.asarray(v))
    pos0 = np.array([s - 2, s - 1, s, 5], np.int32)
    want = _xla_scatter(cache, kq, vq, ksc, vsc, pos0, 1, tq)
    got = [torch.from_numpy(c.copy()) for c in cache]
    kw.write_kv_chunk_q8(*got, t(k), t(v), t(pos0), 1)   # the CPU wrapper: plain
    for a, w in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("pos", [[[14, 15, 16, 17], [16, 17, 18, 19], [3, 4, 5, 6]],
                                 [[15, 2, 30, 9], [20, 21, 1, 0], [15, 15, 16, 3]]])
def test_scatter_rows_drops_rows_past_the_end(pos):
    """The dense cache's multi-row write against XLA's scatter: rows at or
    past S dropped, row S-1 keeps the chunk's own row (or its old content
    when a slot's rows all lie past the end); consecutive and scattered
    positions."""
    rng = np.random.default_rng(6)
    b, tq, nkv, s, hd = 3, 4, 2, 16, 8
    dst = rng.standard_normal((b, nkv, s, hd)).astype(np.float32)
    rows = rng.standard_normal((b, tq, nkv, hd)).astype(np.float32)
    pos = np.array(pos, np.int32)
    rows[2, 1] = rows[2, 0]                 # a repeated position carries one value
    want = jnp.asarray(dst).at[jnp.arange(b)[:, None, None], jnp.arange(nkv)[None, None, :],
                               jnp.asarray(pos)[:, :, None]].set(jnp.asarray(rows))
    got = torch.from_numpy(dst.copy())
    kw.scatter_rows_(got, t(rows), t(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- K11 inside K10: the chunk's rows written by the attention call ----------------

# (T, GQA rep): T 1 .. 8, rep 1 / 4 / 8 (8 to 64 query rows a kv head)
WRITE_CASES = [(1, 1), (2, 4), (3, 8), (4, 1), (5, 4), (6, 8), (7, 1), (8, 8), (8, 4), (4, 8)]


def _write_inputs(rng, L, B, tq, nh, nkv, s, hd):
    """bf16 q and new rows (as JAX arrays and bf16 tensors of the same
    values) and an int8 cache of kv_quant_rows'd N(0, 0.5) rows."""
    q = jnp.asarray(rng.standard_normal((B, tq, nh, hd)), jnp.bfloat16)
    k, v = (jnp.asarray(rng.standard_normal((B, tq, nkv, hd)) * 3, jnp.bfloat16)
            for _ in range(2))
    _, kc, vc = make(L, B, 1, 1, nkv, s, hd, seed=int(rng.integers(1 << 30)))
    cache = tuple(np.asarray(a) for a in _q8(kc, vc))
    bf = [t(np.asarray(a.astype(jnp.float32))).bfloat16() for a in (q, k, v)]
    return (q, k, v), bf, cache


@pytest.mark.parametrize("tq,rep", WRITE_CASES)
def test_chunk_write_in_attention_plain_matches_pallas(tq, rep):
    """chunk_attention_q8 given the chunk's rows (k_new / v_new: on the
    CPU the plain writer, then the plain attention) against rama_tpu's
    write_kv_chunk_q8 after kv_quant_rows followed by
    chunk_attention_layer_q8, both in interpret mode: bf16, S 128, chunks
    from a 64-row tile's start, across its edge (63 - T / 2), from the
    edge and the last that fits, GQA rep 1 / 4 / 8. Outputs within this
    file's bf16 tolerance; the cache, int8 bytes and f32 scales, exactly."""
    L, B, nkv, s, hd = 2, 4, 2, 128, 16
    rng = np.random.default_rng(100 + 10 * tq + rep)
    (q, k, v), (tq_, tk, tv), cache = _write_inputs(rng, L, B, tq, nkv * rep, nkv, s, hd)
    pos0 = np.array([0, 64 - max(tq // 2, 1), 64, s - tq], np.int32)
    (kq, ksc), (vq, vsc) = jl.kv_quant_rows(k), jl.kv_quant_rows(v)
    jc = j_write_chunk(*(jnp.asarray(c) for c in cache), kq, vq, ksc, vsc, jnp.asarray(pos0),
                       jnp.int32(1), interpret=True)
    want = jda.chunk_attention_layer_q8(q, *jc, jnp.asarray(pos0), jnp.int32(1),
                                        interpret=True)
    mine = [t(c) for c in cache]
    got = da.chunk_attention_q8(tq_, *mine, t(pos0), 1, k_new=tk, v_new=tv)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), fp32=False)
    for a, w in zip(mine, jc):
        assert np.array_equal(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("rep", [1, 4])
def test_chunk_write_in_attention_drops_rows_past_the_end(rep):
    """Chunks reaching S (pos0 S - 2, S - 1), wholly past it (S) and inside
    it: the rows at or past S are dropped, as the JAX package's XLA scatter
    drops them (its Pallas writer wraps them: ROADMAP.md), and the queries
    that see past S see row S - 1 at most. The attention against
    chunk_attention_layer_q8 in interpret mode over the scattered cache,
    the cache exactly."""
    L, B, nkv, s, hd, tq = 2, 4, 2, 64, 16, 4
    rng = np.random.default_rng(40 + rep)
    (q, k, v), (tq_, tk, tv), cache = _write_inputs(rng, L, B, tq, nkv * rep, nkv, s, hd)
    pos0 = np.array([s - 2, s - 1, s, 5], np.int32)
    (kq, ksc), (vq, vsc) = jl.kv_quant_rows(k), jl.kv_quant_rows(v)
    jc = _xla_scatter(cache, kq, vq, ksc, vsc, pos0, 0, tq)
    want = jda.chunk_attention_layer_q8(q, *jc, jnp.asarray(pos0), jnp.int32(0),
                                        interpret=True)
    mine = [t(c) for c in cache]
    got = da.chunk_attention_q8(tq_, *mine, t(pos0), 0, k_new=tk, v_new=tv)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), fp32=False)
    for a, w in zip(mine, jc):
        assert np.array_equal(a.numpy(), np.asarray(w))


def test_chunk_write_in_attention_is_the_writer_then_the_attention():
    """On the CPU the call with rows is exactly write_kv_chunk_q8 followed
    by chunk_attention_q8 without them (outputs and cache bytes, atol 0);
    a lone k_new or v_new is refused."""
    rng = np.random.default_rng(8)
    _, (tq_, tk, tv), cache = _write_inputs(rng, 2, 3, 4, 8, 2, 96, 16)
    pos0 = torch.tensor([0, 61, 92], dtype=torch.int32)
    fused, split = [t(c) for c in cache], [t(c) for c in cache]
    got = da.chunk_attention_q8(tq_, *fused, pos0, 1, k_new=tk, v_new=tv)
    kw.write_kv_chunk_q8(*split, tk, tv, pos0, 1)
    want = da.chunk_attention_q8(tq_, *split, pos0, 1)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(fused, split))
    with pytest.raises(ValueError, match="k_new and v_new come together"):
        da.chunk_attention_q8(tq_, *fused, pos0, 1, k_new=tk)


# -- forward_chunk --------------------------------------------------------------


@pytest.mark.parametrize("kv_quant,max_len", [(False, 64), (False, 512), (True, 64),
                                              (True, 512)])
def test_forward_chunk_matches_jax_fused(kv_quant, max_len):
    """The port's forward_chunk (K10 / K11 plain on the CPU) against
    rama_tpu's _forward_chunk_fused with its kernels in interpret mode, on
    the int8 tiny model in fp32: logits at every chunk column (atol 1e-4,
    int8 cache 5e-2 as the JAX test's: JAX casts q to bf16 in the q8
    kernels) and the cache rows written."""
    jcfg = tiny_config()
    np_params = random_params(jcfg, seed=7)
    jp = jl.fuse_params(jl.quantize_params(jcfg, np_params, bits=8, group_size=16,
                                           dtype=jnp.float32), jcfg)
    cfg = torch_cfg(jcfg)
    tp = jax_params_to_torch(jcfg, jp)
    b, tq, p = 2, 4, 9
    rng = np.random.default_rng(11)
    prompt = rng.integers(1, cfg.vocab_size, (b, p)).astype(np.int32)
    chunk = rng.integers(1, cfg.vocab_size, (b, tq)).astype(np.int32)
    pos0 = np.array([p, p - 3], np.int32)
    if kv_quant:
        jc = jl.QuantKVCache.create(jcfg, batch=b, max_len=max_len)
    else:
        jc = jl.KVCache.create(jcfg, batch=b, max_len=max_len, dtype=jnp.float32)
    _, jc = jl.forward(jp, jcfg, jnp.asarray(prompt),
                       jnp.arange(p, dtype=jnp.int32)[None, :].repeat(b, 0), jc)
    if kv_quant:
        tc = tl.QuantKVCache(*(t(a) for a in (jc.k, jc.v, jc.ks, jc.vs)))
    else:
        tc = tl.KVCache(t(jc.k), t(jc.v))
    want, jc = jl._forward_chunk_fused(jp, jcfg, jnp.asarray(chunk), jnp.asarray(pos0), jc,
                                       _interpret=True)
    got, tc = tl.forward_chunk(tp, cfg, torch.from_numpy(chunk).long(), t(pos0), tc)
    assert got.shape == (b, tq, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-2 if kv_quant else 1e-4,
                               rtol=0)
    if kv_quant:
        conv = jax_quant_cache_to_torch(jc)
        assert int((tc.k.int() - conv.k.int()).abs().max()) <= 1
        # layers past the first see JAX's bf16-cast q: 5e-3, as the JAX test
        torch.testing.assert_close(tc.ks, conv.ks, rtol=5e-3, atol=0)
    else:
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5, rtol=0)


# dim 128, hidden 512 (w13 / w2 group 64): a shape rama_tpu's ffn_tileable
# takes up to M = 64 and past it, so both packages run the fused FFN
_FFN_CFG = dict(dim=128, hidden_dim=512, n_layers=2, n_heads=2, n_kv_heads=2, vocab_size=64,
                seq_len=64)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("b,tq", [(8, 8), (10, 8), (16, 5)])
def test_forward_chunk_matches_jax_fused_past_one_cta(monkeypatch, bits, b, tq):
    """Verify rounds of b * t = 64 and 80 rows: the port's forward_chunk
    runs its fused FFN (one K3 call a layer, at any M) and rama_tpu's
    _forward_chunk_fused its Pallas FFN in interpret mode (ffn_tileable
    holds there), on the int8 / int4 dim-128 model in fp32. Logits at
    every chunk column within 2e-2 of max |ref| (the Pallas FFN rounds h to
    bf16, ffn.py:170; the port's plain FFN keeps fp32: test_torch_ffn's
    tolerance)."""
    from rama_tpu.config import ModelConfig as JCfg
    from rama_tpu.ops.pallas.ffn import ffn_tileable

    jcfg = JCfg(**_FFN_CFG)
    np_params = random_params(jcfg, seed=5, scale=0.1)
    jp = jl.fuse_params(jl.quantize_params(jcfg, np_params, bits=bits, group_size=64,
                                           dtype=jnp.float32), jcfg)
    assert ffn_tileable(jp["w13"], jp["w2"], max_m=b * tq)
    cfg = torch_cfg(jcfg)
    tp = jax_params_to_torch(jcfg, jp)
    assert tl._ffn_fusable(tp, b * tq)
    calls = []
    monkeypatch.setattr(tl._KERNELS, "ffn", lambda *a: calls.append(a[0].shape) or
                        tl._ffn.ffn(*a))
    rng = np.random.default_rng(13)
    p = 9
    prompt = rng.integers(1, cfg.vocab_size, (b, p)).astype(np.int32)
    chunk = rng.integers(1, cfg.vocab_size, (b, tq)).astype(np.int32)
    pos0 = (p - np.arange(b) % 4).astype(np.int32)
    jc = jl.KVCache.create(jcfg, batch=b, max_len=32, dtype=jnp.float32)
    _, jc = jl.forward(jp, jcfg, jnp.asarray(prompt),
                       jnp.arange(p, dtype=jnp.int32)[None, :].repeat(b, 0), jc)
    tc = tl.KVCache(t(jc.k), t(jc.v))
    want, _ = jl._forward_chunk_fused(jp, jcfg, jnp.asarray(chunk), jnp.asarray(pos0), jc,
                                      _interpret=True)
    got, _ = tl.forward_chunk(tp, cfg, torch.from_numpy(chunk).long(), t(pos0), tc)
    assert calls == [(b * tq, cfg.dim)] * cfg.n_layers
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2 * np.abs(want).max(), rtol=0)


def test_forward_chunk_routes_by_chunk_length():
    """2 <= T <= 8 takes the fused path; T = 1 and T > 8 the generic
    forward; both agree with the plain fused path at every column."""
    jcfg = tiny_config()
    cfg = torch_cfg(jcfg)
    tp = tl.fuse_params(tl.load_params(cfg, random_params(jcfg, seed=2), dtype=torch.float32,
                                       device="cpu"), cfg)
    toks = torch.tensor([[5, 9, 3, 7, 2, 8, 4, 1, 6, 11]])
    pos0 = torch.tensor([3])
    outs = {}
    for tq in (1, 8, 10):
        cache = tl.KVCache.create(cfg, 1, 32, dtype=torch.float32, device="cpu")
        outs[tq], _ = tl.forward_chunk(tp, cfg, toks[:, :tq], pos0, cache)
    np.testing.assert_allclose(outs[8].numpy(), outs[10][:, :8].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(outs[1].numpy(), outs[10][:, :1].numpy(), atol=1e-5, rtol=0)


def test_check_chunk_names_the_chunk_kernel_limit():
    """forward_chunk's support check, which the engine calls for its
    verification chunk: on the card the chunk attention kernel takes any
    T * n_heads / n_kv_heads query rows a kv head (12, 64 and 128 rows:
    the 16-row form, the 64-row form, two row groups of 64), so only a
    GQA group that does not divide the heads is refused, by name; the
    CPU's plain path and T outside 2..8 (the generic forward) take any
    shape."""
    from types import SimpleNamespace

    from rama_tpu_torch.config import ModelConfig

    for nh, nkv, tq, rows in ((8, 2, 3, 12), (32, 4, 8, 64), (16, 1, 8, 128)):
        cfg = ModelConfig(dim=16 * nh, hidden_dim=128, n_layers=1, n_heads=nh,
                          n_kv_heads=nkv, vocab_size=32, seq_len=16)
        tl.check_chunk(cfg, tq, torch.device("cuda"))
        assert tq * cfg.n_rep == rows
    odd = SimpleNamespace(n_heads=6, n_kv_heads=4)
    with pytest.raises(ValueError, match="GQA group 6/4"):
        tl.check_chunk(odd, 3, torch.device("cuda"))
    tl.check_chunk(odd, 3, torch.device("cpu"))
    tl.check_chunk(odd, 9, torch.device("cuda"))


# -- the tensor-core body (csrc/decode_attention.cu dattn_mma) ----------------


@pytest.mark.parametrize("dtype,hd,body", [
    (torch.bfloat16, 48, "mma"), (torch.bfloat16, 64, "mma"), (torch.bfloat16, 128, "mma"),
    (torch.float32, 128, "simt"), (torch.float32, 64, "simt"), (torch.float32, 48, "simt"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 96, "simt"), (torch.bfloat16, 256, "simt")])
def test_body_for_routes_by_dtype_and_head_dim(dtype, hd, body):
    """bf16 at hd 48 / 64 / 128 takes the tensor-core body, whatever the
    query rows (a decode step's one or a chunk's T * rep); fp32 and any
    other head dim the SIMT body."""
    assert da.body_for(dtype, hd) == body
    assert da.BODIES[body] in (0, 1)


@pytest.mark.parametrize("dtype,hd,body", [
    (torch.bfloat16, 48, "walk"), (torch.bfloat16, 64, "walk"), (torch.bfloat16, 128, "walk"),
    (torch.float32, 128, "simt"), (torch.bfloat16, 16, "simt"), (torch.bfloat16, 256, "simt")])
def test_body_for_takes_the_walk_body_over_an_int8_cache(dtype, hd, body):
    """Over an int8 cache bf16 at hd 48 / 64 / 128 takes the walk body
    (csrc dattn_walk, C body code 2) for decode steps and chunks alike;
    fp32 and other head dims the SIMT body, as over a bf16 cache."""
    assert da.body_for(dtype, hd, q8=True) == body
    assert da.BODIES["walk"] == 2


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to nearest even through bfloat16, as fp32."""
    return x.to(torch.bfloat16).float()


def emulate_mma_body(q, k, v, pos0, layer, ks=None, vs=None, chunk=64, round_p=_bf16):
    """The tensor-core body's arithmetic, written out: for each (slot, kv
    head) 64-row splits of the cache rows up to the chunk's last limit;
    within a split fp32 scores (q . k) * scale (int8: (q . k8) * ks * scale)
    masked to each query's limit, the split's max and sum of e = exp(s - m),
    P = round_p(e) (int8: round_p(e * vs)) and fp32 P . V; a query that
    sees no row of a split contributes nothing; then the combine over the
    splits each query saw. q (B, T, nh, hd), k/v (L, B, nkv, S, hd) as
    fp32 values. Returns (B, T, nh * hd) fp32."""
    b, tq, nh, hd = q.shape
    nkv, s = k.shape[2], k.shape[3]
    rep = nh // nkv
    scale = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32)
    out = torch.zeros(b, tq, nh, hd)
    r_t = torch.arange(tq * rep) // rep                     # query of each row (t-major)
    for bi in range(b):
        lims = (int(pos0[bi]) + torch.arange(tq)).clamp(0, s - 1)
        lim_r = lims[r_t]
        for j in range(nkv):
            qr = q[bi, :, j * rep:(j + 1) * rep].reshape(tq * rep, hd)
            parts = []
            for s0 in range(0, int(lims[-1]) + 1, chunk):
                n = min(s0 + chunk, int(lims[-1]) + 1) - s0
                sc = qr @ k[layer, bi, j, s0:s0 + n].T
                sc = sc * ks[layer, bi, j, s0:s0 + n] * scale if ks is not None else sc * scale
                sc = torch.where((s0 + torch.arange(n))[None] <= lim_r[:, None], sc,
                                 torch.tensor(-np.inf))
                sees = s0 <= lim_r
                m = sc.amax(1)
                e = torch.where(sees[:, None], torch.exp(sc - torch.where(sees, m, 0)[:, None]),
                                torch.tensor(0.0))
                p = e * vs[layer, bi, j, s0:s0 + n] if vs is not None else e
                parts.append((m, e.sum(1), round_p(p) @ v[layer, bi, j, s0:s0 + n], sees))
            for r in range(tq * rep):
                seen = [(m[r], l[r], o[r]) for m, l, o, sees in parts if sees[r]]
                big = max(m for m, _, _ in seen)
                num = sum(torch.exp(m - big) * o for m, _, o in seen)
                den = sum(torch.exp(m - big) * l for m, l, _ in seen)
                out[bi, int(r_t[r]), j * rep + r % rep] = num / den
    return out.reshape(b, tq, nh * hd)


# (tq, nh, nkv, s, pos0): a chunk straddling the 64-row split (60 + T 8:
# queries 0..3 see no row of split 1), one running past S, the last that
# fits, a ragged last split (S 136, 200)
MMA_CASES = [(8, 4, 4, 136, [60, 0, 134, 128]), (4, 4, 2, 256, [61, 126, 254, 252]),
             (2, 8, 2, 200, [63, 0, 199, 150]), (8, 4, 4, 256, [60, 121, 250, 248])]


def _sees_nothing_somewhere(tq, pos0, s, chunk=64):
    """Whether some query of the case sees no row of a split its CTA reads."""
    return any(p0 + tq - 1 >= (p0 // chunk + 1) * chunk and (p0 // chunk + 1) * chunk < s
               for p0 in pos0)


@pytest.mark.parametrize("tq,nh,nkv,s,pos0", MMA_CASES)
def test_mma_body_emulation_equals_the_plain_version_in_fp32(tq, nh, nkv, s, pos0):
    """Without the bf16 rounding of P, the split / combine arithmetic equals
    the plain version (one softmax over every visible row) in fp32: atol
    1e-5 (other summation order)."""
    assert _sees_nothing_somewhere(tq, pos0, s)
    q, k, v = make(2, 4, tq, nh, nkv, s, 64, seed=tq + s)
    p0 = torch.tensor(pos0, dtype=torch.int32)
    for layer in (0, 1):
        want = da.chunk_attention_plain(t(q), t(k), t(v), p0, layer)
        got = emulate_mma_body(t(q), t(k), t(v), p0, layer, round_p=lambda x: x)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("tq,nh,nkv,s,pos0", MMA_CASES)
def test_mma_body_emulation_matches_pallas_tiled(tq, nh, nkv, s, pos0):
    """The body's arithmetic on bf16 values (P rounded to bf16, fp32 sums,
    64-row splits and the combine) against chunk_attention_layer_tiled in
    interpret mode on the same bf16 inputs: the bf16 tolerance of this
    file (atol 0.03 / rtol 0.05: the Pallas kernel rounds its normalized
    probabilities per 128-row tile, the body its unnormalized ones per
    split)."""
    q, k, v = make(2, 4, tq, nh, nkv, s, 64, seed=2 * tq + s)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    fq, fk, fv = (t(np.asarray(a.astype(jnp.float32))) for a in (jq, jk, jv))
    p0 = np.array(pos0, np.int32)
    for layer in (0, 1):
        want = np.asarray(jda.chunk_attention_layer_tiled(
            jq, jk, jv, jnp.asarray(p0), jnp.int32(layer), chunk=128, interpret=True)
            .astype(jnp.float32))
        got = _bf16(emulate_mma_body(fq, fk, fv, torch.from_numpy(p0), layer)).numpy()
        _close(got, want, fp32=False)


@pytest.mark.parametrize("tq,nh,nkv,s,pos0", MMA_CASES)
def test_mma_body_emulation_q8_matches_pallas_tiled(tq, nh, nkv, s, pos0):
    """The int8 form: scores (q . k8) * ks * scale, P = bf16(e * vs), fp32
    P . v8, against chunk_attention_layer_tiled_q8 in interpret mode (bf16
    q): the bf16 tolerance of this file."""
    q, k, v = make(2, 4, tq, nh, nkv, s, 64, seed=3 * tq + s)
    k8, v8, ks, vs = _q8(k, v)
    jq = jnp.asarray(q, jnp.bfloat16)
    p0 = np.array(pos0, np.int32)
    for layer in (0, 1):
        want = np.asarray(jda.chunk_attention_layer_tiled_q8(
            jq, k8, v8, ks, vs, jnp.asarray(p0), jnp.int32(layer), chunk=128,
            interpret=True).astype(jnp.float32))
        got = _bf16(emulate_mma_body(t(np.asarray(jq.astype(jnp.float32))), t(k8).float(),
                                     t(v8).float(), torch.from_numpy(p0), layer, ks=t(ks),
                                     vs=t(vs))).numpy()
        _close(got, want, fp32=False)


# -- the int8 walk body (csrc/decode_attention.cu dattn_walk) ------------------


def emulate_walk_body(q, k8, v8, ks, vs, pos0, layer, tiles, tile=64, round_p=_bf16):
    """The walk body's arithmetic, written out, one query row at a time: the
    cache's splits of `tiles` tiles of `tile` rows (split_plan); for each
    (slot, kv head) the splits up to the chunk's last limit, of which a
    query row takes those that start at or below its own limit; within a
    split, tile by tile, fp32 scores (q . k8) * ks * scale masked to the
    row's limit, the running max m_new = max(m_run, the tile's max), alpha
    = e^(m_run - m_new) (exactly 1 where m_new == m_run), e = exp(s -
    m_new), l = l alpha + sum e, o = o alpha + round_p(e * vs) . v8; then
    the combine over the splits the row saw. q (B, T, nh, hd) fp32 values,
    k8 / v8 (L, B, nkv, S, hd) as fp32, ks / vs (L, B, nkv, S). Returns (B,
    T, nh * hd) fp32."""
    b, tq, nh, hd = q.shape
    nkv, s = k8.shape[2], k8.shape[3]
    rep = nh // nkv
    scale = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32)
    inf = torch.tensor(-np.inf)
    out = torch.zeros(b, tq, nh, hd)
    for bi in range(b):
        last = max(0, min(int(pos0[bi]) + tq - 1, s - 1))
        for h in range(nh):
            j = h // rep
            for ti in range(tq):
                lim = max(0, min(int(pos0[bi]) + ti, s - 1))
                parts = []
                for s0 in range(0, lim + 1, tile * tiles):
                    m, l, o = inf, torch.tensor(0.0), torch.zeros(hd)
                    for t0 in range(s0, min(s0 + tile * tiles, last + 1), tile):
                        rows = slice(t0, min(t0 + tile, last + 1))
                        sc = (k8[layer, bi, j, rows] * q[bi, ti, h]).sum(-1)
                        sc = sc * ks[layer, bi, j, rows] * scale
                        sc = torch.where(torch.arange(t0, rows.stop) <= lim, sc, inf)
                        m_new = torch.maximum(m, sc.max())
                        mref = m_new if torch.isfinite(m_new) else torch.tensor(0.0)
                        alpha = torch.tensor(1.0) if m_new == m else torch.exp(m - mref)
                        e = torch.exp(sc - mref)
                        l = l * alpha + e.sum()
                        o = o * alpha + round_p(e * vs[layer, bi, j, rows]) @ v8[layer, bi, j, rows]
                        m = m_new
                    parts.append((m, l, o))
                big = max(m for m, _, _ in parts)
                num = sum(torch.exp(m - big) * o for m, _, o in parts)
                den = sum(torch.exp(m - big) * l for m, l, _ in parts)
                out[bi, ti, h] = num / den
    return out.reshape(b, tq, nh * hd)


# (tq, nh, nkv, s, pos0, tiles): chunks straddling a tile (60 + T) and a split
# of G tiles (189 + T at G 3, 253 + T at G 2 / 4), a row that sees no tile of
# the chunk's last split, one running past S, a ragged last tile and split
WALK_CASES = [(8, 4, 4, 200, [60, 0, 198, 128], 2), (4, 4, 2, 448, [189, 61, 446, 383], 3),
              (2, 8, 2, 520, [253, 0, 519, 255], 4), (1, 4, 4, 300, [0, 63, 64, 299], 2),
              (4, 4, 4, 256, [60, 121, 250, 252], 1)]


@pytest.mark.parametrize("tq,nh,nkv,s,pos0,tiles", WALK_CASES)
def test_walk_body_emulation_equals_the_plain_version_in_fp32(tq, nh, nkv, s, pos0, tiles):
    """Without the bf16 rounding of P, the walk's online softmax over the
    tiles of each split, then the combine, equals the plain version (one
    softmax over every visible row) on fp32 q: atol 1e-5 (other summation
    order)."""
    q, k, v = make(2, len(pos0), tq, nh, nkv, s, 32, seed=tq + s + tiles)
    k8, v8, ks, vs = (t(a) for a in _q8(k, v))
    p0 = torch.tensor(pos0, dtype=torch.int32)
    for layer in (0, 1):
        want = da.chunk_attention_q8_plain(t(q), k8, v8, ks, vs, p0, layer)
        got = emulate_walk_body(t(q), k8.float(), v8.float(), ks, vs, p0, layer, tiles,
                                round_p=lambda x: x)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("tq,nh,nkv,s,pos0,tiles", WALK_CASES)
def test_walk_body_emulation_q8_matches_pallas_tiled(tq, nh, nkv, s, pos0, tiles):
    """The walk's arithmetic on bf16 q (P = bf16(e * vs) against the running
    max, fp32 sums, splits of G tiles, the combine) against
    chunk_attention_layer_tiled_q8 in interpret mode on the same int8
    cache: the bf16 tolerance of this file."""
    q, k, v = make(2, len(pos0), tq, nh, nkv, s, 32, seed=5 * tq + s + tiles)
    k8, v8, ks, vs = _q8(k, v)
    jq = jnp.asarray(q, jnp.bfloat16)
    p0 = np.array(pos0, np.int32)
    for layer in (0, 1):
        want = np.asarray(jda.chunk_attention_layer_tiled_q8(
            jq, k8, v8, ks, vs, jnp.asarray(p0), jnp.int32(layer), chunk=128,
            interpret=True).astype(jnp.float32))
        got = _bf16(emulate_walk_body(t(np.asarray(jq.astype(jnp.float32))), t(k8).float(),
                                      t(v8).float(), t(ks), t(vs), torch.from_numpy(p0), layer,
                                      tiles)).numpy()
        _close(got, want, fp32=False)
