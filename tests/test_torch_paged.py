"""The paged KV cache of rama_tpu_torch against rama_tpu on the CPU: the page
allocator, the plain versions of kernel 12 (paged attention, four forms)
and kernel 13 (the paged int8 writers) against the JAX package's Pallas
functions in interpret mode, and the paged forwards (decode step, fused
chunk, generic gather path, prefill insert) against the JAX package's and
against the port's own dense forwards.

Tolerances: the allocator, both K13 writers and the bf16 / f32 pool writes
exact (int8 bytes and f32 scales at atol 0, on bf16-exact rows as the K6 /
K8 tests use). K12 over an fp32 pool within 2e-5 of Pallas (the JAX
package's own bar in tests/test_paged.py); with bf16 q within 1e-2 (rtol
1e-2), probabilities rounded to bf16 at other points; the q8 Pallas
kernels cast q to bf16 whatever its dtype, so fp32 q over an int8 pool is
held at 2e-5 to the JAX package's dequantize-gather-attend path instead.
Forwards in fp32 within rtol 1e-5 of the JAX package's generic path (as
tests/test_paged.py:23-64); the fused chunk against rama_tpu's
`_forward_chunk_fused_paged` in interpret mode within 1e-4 on an fp32 pool
(as the dense chunk test) and 5e-2 on an int8 pool (the JAX q8 kernels'
bf16 q); port-paged against port-dense on the same rows within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_params_to_torch, torch_cfg
from rama_tpu.models import llama as jl
from rama_tpu.native import PageAllocator as JPageAllocator
from rama_tpu.ops.pallas import kv_write as jkw
from rama_tpu.ops.pallas import paged_attention as jpa
from rama_tpu.runtime import paged as jpaged
from rama_tpu.testing.ref_model import random_params, tiny_config
from rama_tpu_torch.models import llama as tl
from rama_tpu_torch.ops.kernels import kv_write as kw
from rama_tpu_torch.ops.kernels import paged_attention as pa
from rama_tpu_torch.runtime import paged

torch.set_num_threads(1)


def t(a) -> torch.Tensor:
    """A writable CPU tensor of a numpy or JAX array (bf16 as fp32)."""
    a = np.asarray(a)
    return torch.from_numpy(np.array(a if a.dtype in (np.int8, np.int32) else
                                     a.astype(np.float32)))


# -- the allocator ---------------------------------------------------------------


def test_page_allocator_matches_rama_tpu_native():
    """A seeded run of reserve / release / table / available against the
    allocator the JAX package loads here (its C++ library): equal page
    counts, tables (page ids and order), -1 on exhaustion."""
    rng = np.random.default_rng(5)
    mine, ref = paged.PageAllocator(23, 16, 4), JPageAllocator(23, 16, 4)
    exhausted = 0
    for _ in range(400):
        slot = int(rng.integers(4))
        if rng.random() < 0.3:
            mine.release(slot)
            ref.release(slot)
        else:
            n = int(rng.integers(1, 200))
            got, want = mine.reserve(slot, n), ref.reserve(slot, n)
            assert got == want
            exhausted += got < 0
        assert mine.available() == ref.available()
        assert all(mine.table(s) == ref.table(s) for s in range(4))
    assert exhausted > 0


# -- K12 --------------------------------------------------------------------------


def _pools(rng, L, P, nkv, ps, hd):
    return [rng.standard_normal((L, P, nkv, ps, hd)).astype(np.float32) for _ in range(2)]


# interleaved tables, -1 past the used pages; positions spanning 1..3 pages
TABLES = np.array([[4, 1, 7], [2, 5, -1], [8, -1, -1]], np.int32)


def _pos(ps, tq):
    return np.array([2 * ps + 3, ps - tq + 2 if tq > 1 else ps, 0], np.int32)


def _j_view(pool, tables, layer, mp, ps):
    b, nkv = tables.shape[0], pool.shape[2]
    g = jnp.take(jnp.asarray(pool[layer]), jnp.maximum(jnp.asarray(tables), 0), axis=0)
    return g.transpose(0, 2, 1, 3, 4).reshape(b, nkv, mp * ps, -1)


@pytest.mark.parametrize("ps", [16, 32])
@pytest.mark.parametrize("tq", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_plain_matches_pallas(ps, tq, dtype):
    """K12 bf16 / f32 forms: paged_decode_attention_plain (T = 1) and
    paged_chunk_attention_plain (T = 2, 4, 8) against the Pallas
    functions in interpret mode, MHA and GQA rep 2."""
    rng = np.random.default_rng(ps + tq)
    L, P, hd = 2, 9, 128
    for nh, nkv in ((2, 2), (4, 2)) if tq < 8 else ((2, 2),):
        k, v = _pools(rng, L, P, nkv, ps, hd)
        q = rng.standard_normal((3, tq, nh, hd)).astype(np.float32)
        pos = _pos(ps, tq)
        jd, td = getattr(jnp, dtype), getattr(torch, dtype)
        jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
        tq_, tk, tv = (t(np.asarray(a.astype(jnp.float32))).to(td) for a in (jq, jk, jv))
        for layer in range(L):
            if tq == 1:
                want = jpa.paged_decode_attention_layer(
                    jq[:, 0], jk, jv, jnp.asarray(pos), jnp.asarray(TABLES), jnp.int32(layer),
                    interpret=True)
                got = pa.paged_decode_attention_plain(tq_[:, 0], tk, tv, t(pos), t(TABLES), layer)
            else:
                want = jpa.paged_chunk_attention_layer(
                    jq, jk, jv, jnp.asarray(pos), jnp.asarray(TABLES), jnp.int32(layer),
                    interpret=True)
                got = pa.paged_chunk_attention_plain(tq_, tk, tv, t(pos), t(TABLES), layer)
            want = np.asarray(want.astype(jnp.float32))
            if dtype == "float32":
                np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
            else:
                np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("ps", [16, 32])
@pytest.mark.parametrize("tq", [1, 3, 4])
def test_paged_attention_q8_plain_matches_pallas(ps, tq):
    """K12 int8 forms with bf16 q against the q8 Pallas functions in
    interpret mode (1e-2), and with fp32 q against the JAX package's
    dequantize-gather-attend path (2e-5)."""
    rng = np.random.default_rng(3 * ps + tq)
    L, P, nh, nkv, hd = 2, 9, 4, 2, 128
    (k8, ks), (v8, vs) = (jl.kv_quant_rows(jnp.asarray(a)) for a in _pools(rng, L, P, nkv, ps, hd))
    q = rng.standard_normal((3, tq, nh, hd)).astype(np.float32)
    jq = jnp.asarray(q, jnp.bfloat16)
    pos, mp = _pos(ps, tq), TABLES.shape[1]
    pools = [t(a) for a in (k8, v8, ks, vs)]
    for layer in range(L):
        if tq == 1:
            want = jpa.paged_decode_attention_layer_q8(
                jq[:, 0], k8, v8, ks, vs, jnp.asarray(pos), jnp.asarray(TABLES),
                jnp.int32(layer), interpret=True)[:, None]
            got = pa.paged_decode_attention_q8_plain(
                t(np.asarray(jq[:, 0].astype(jnp.float32))).bfloat16(), *pools, t(pos),
                t(TABLES), layer)[:, None]
            fp32 = pa.paged_decode_attention_q8_plain(t(q[:, 0]), *pools, t(pos), t(TABLES),
                                                      layer)[:, None]
        else:
            want = jpa.paged_chunk_attention_layer_q8(
                jq, k8, v8, ks, vs, jnp.asarray(pos), jnp.asarray(TABLES), jnp.int32(layer),
                interpret=True)
            got = pa.paged_chunk_attention_q8_plain(
                t(np.asarray(jq.astype(jnp.float32))).bfloat16(), *pools, t(pos), t(TABLES),
                layer)
            fp32 = pa.paged_chunk_attention_q8_plain(t(q), *pools, t(pos), t(TABLES), layer)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   atol=1e-2, rtol=1e-2)
        kd, vd = jl._dequant_kv(k8[layer], v8[layer], ks[layer], vs[layer], jnp.float32)
        view = lambda pool: (jnp.take(pool, jnp.maximum(jnp.asarray(TABLES), 0), axis=0)
                             .transpose(0, 2, 1, 3, 4).reshape(3, nkv, mp * ps, hd))
        qpos = jnp.asarray(pos)[:, None] + jnp.arange(tq)[None, :]
        mask = jnp.arange(mp * ps)[None, None, :] <= qpos[:, :, None]
        ref = jl._attention(jnp.asarray(q), view(kd), view(vd), mask)
        np.testing.assert_allclose(fp32.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("tq,nh,nkv", [(8, 8, 1), (3, 6, 2), (1, 16, 1)])
def test_gqa_paged_chunk_plain_matches_pallas(tq, nh, nkv, q8):
    """K12's chunk (T 8, 3) and decode (T 1) plain versions at GQA groups 8,
    3 and 16 (64, 9 and 16 query rows a kv head: the card's 64- and
    16-row forms) against the Pallas functions in interpret mode on bf16
    q, hd 64 over 16-row pages (S = 48): 1e-2, as the tests above."""
    rng = np.random.default_rng(nh + tq)
    L, P, ps, hd = 2, 9, 16, 64
    k, v = _pools(rng, L, P, nkv, ps, hd)
    q = rng.standard_normal((3, tq, nh, hd)).astype(np.float32)
    pos, tables = _pos(ps, tq), jnp.asarray(TABLES)
    jq = jnp.asarray(q, jnp.bfloat16)
    tq_ = t(np.asarray(jq.astype(jnp.float32))).bfloat16()
    if q8:
        (k8, ks), (v8, vs) = (jl.kv_quant_rows(jnp.asarray(a)) for a in (k, v))
        jpools, pools = (k8, v8, ks, vs), [t(a) for a in (k8, v8, ks, vs)]
    else:
        jpools = tuple(jnp.asarray(a, jnp.bfloat16) for a in (k, v))
        pools = [t(np.asarray(a.astype(jnp.float32))).bfloat16() for a in jpools]
    sfx = "_q8" if q8 else ""
    for layer in range(L):
        if tq == 1:
            want = getattr(jpa, f"paged_decode_attention_layer{sfx}")(
                jq[:, 0], *jpools, jnp.asarray(pos), tables, jnp.int32(layer), interpret=True)
            got = getattr(pa, f"paged_decode_attention{sfx}_plain")(
                tq_[:, 0], *pools, t(pos), t(TABLES), layer)
        else:
            want = getattr(jpa, f"paged_chunk_attention_layer{sfx}")(
                jq, *jpools, jnp.asarray(pos), tables, jnp.int32(layer), interpret=True)
            got = getattr(pa, f"paged_chunk_attention{sfx}_plain")(
                tq_, *pools, t(pos), t(TABLES), layer)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   atol=1e-2, rtol=1e-2)


def test_paged_attention_equals_dense_over_the_gathered_view():
    """The plain paged forms are the dense forms over the view, and the
    table's entries past a slot's pages change nothing."""
    rng = np.random.default_rng(1)
    k, v = (t(a) for a in _pools(rng, 2, 9, 2, 16, 16))
    q = t(rng.standard_normal((3, 4, 2, 16)).astype(np.float32))
    pos = t(_pos(16, 4))
    got = pa.paged_chunk_attention_plain(q, k, v, pos, t(TABLES), 1)
    stale = t(np.where(TABLES < 0, 6, TABLES))
    torch.testing.assert_close(pa.paged_chunk_attention_plain(q, k, v, pos, stale, 1), got,
                               rtol=0, atol=0)
    dense = [torch.stack([pa.gather_pages(x[l], t(TABLES)) for l in range(2)]) for x in (k, v)]
    torch.testing.assert_close(got, tl._da.chunk_attention_plain(q, *dense, pos, 1),
                               rtol=0, atol=0)


def test_split_rows_divide_the_page():
    assert [pa.split_rows(ps) for ps in (8, 16, 24, 48, 96, 128, 256, 40)] == \
        [8, 16, 24, 48, 48, 64, 64, 40]
    with pytest.raises(ValueError, match="multiple of 8"):
        pa.split_rows(12)
    pa.check(8, 2, 128, 16, False)               # any T x group 4: T 3 is 12 rows a kv head
    with pytest.raises(ValueError, match="GQA group 6/4"):
        pa.check(6, 4, 128, 16, False)
    with pytest.raises(ValueError, match="multiple of 16"):
        pa.check(4, 4, 40, 16, True)


# -- K13 --------------------------------------------------------------------------


def _rows(rng, shape):
    """bf16-exact rows of mixed magnitude (the K6 / K8 tests' inputs)."""
    x = rng.standard_normal(shape) * rng.uniform(1e-3, 30, shape[:-1] + (1,))
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _q8_pool(rng, L, P, nkv, ps, hd):
    return (rng.integers(-127, 128, (L, P, nkv, ps, hd)).astype(np.int8),
            rng.integers(-127, 128, (L, P, nkv, ps, hd)).astype(np.int8),
            rng.standard_normal((L, P, nkv, ps)).astype(np.float32),
            rng.standard_normal((L, P, nkv, ps)).astype(np.float32))


def _j_paged_scatter(pool, kq, vq, ksc, vsc, pos0, tables, layer, ps):
    """The JAX package's XLA pool write of a chunk with its fused paths'
    clip (rama_tpu/runtime/paged.py:244-246, the bf16 pool's scatter)."""
    mp = tables.shape[1]
    pidx = jnp.asarray(pos0)[:, None] + jnp.arange(kq.shape[1])[None, :]
    pg = jnp.take_along_axis(jnp.asarray(tables), jnp.minimum(pidx // ps, mp - 1),
                             axis=1)[:, :, None]
    off = (pidx % ps)[:, :, None]
    hi = jnp.arange(kq.shape[2])[None, None, :]
    return tuple(jnp.asarray(c).at[layer, pg, hi, off].set(x)
                 for c, x in zip(pool, (kq, vq, ksc, vsc)))


@pytest.mark.parametrize("ps,tq", [(16, 1), (16, 8), (32, 3), (64, 8), (128, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_write_kv_paged_q8_plain_equals_jax(ps, tq, dtype):
    """K13 (a) byte for byte against the Pallas writer after kv_quant_rows,
    on tests/test_kv_quant.py's (ps, t) grid and positions: a page start, a
    chunk straddling a page (or, ps >= 32, a 32-row stripe), the end of a
    page; and a chunk running past the slot's two table pages, clipped into
    page 1, against the JAX package's fused-path pool scatter (its Pallas
    writer rewrites that page's stripe from the unwritten input for the
    second anchor and so keeps the old row 2 ps - 1: ROADMAP.md §4)."""
    rng = np.random.default_rng(13 + ps + tq)
    L, P, B, nkv, hd = 3, 10, 4, 2, 128
    pool = _q8_pool(rng, L, P, nkv, ps, hd)
    tables = rng.permutation(8).reshape(B, 2).astype(np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    for clip in (False, True):
        pos0 = np.array([0, max(ps - tq + 1, 0), min(30, ps - tq),
                         2 * ps - 1 if clip else ps - tq], np.int32)
        k, v = _rows(rng, (B, tq, nkv, hd)), _rows(rng, (B, tq, nkv, hd))
        (kq, ksc), (vq, vsc) = (jl.kv_quant_rows(jnp.asarray(x, jd)) for x in (k, v))
        got = [t(a) for a in pool]
        want = [jnp.asarray(a) for a in pool]
        for layer in (0, L - 1):
            if clip:
                want = _j_paged_scatter(want, kq, vq, ksc, vsc, pos0, tables, layer, ps)
            else:
                want = jkw.write_kv_paged_q8(*want, kq, vq, ksc, vsc, jnp.asarray(pos0),
                                             jnp.asarray(tables), jnp.int32(layer),
                                             interpret=True)
            kw.write_kv_paged_q8(*got, t(k).to(td), t(v).to(td), t(pos0), t(tables), layer)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


def test_write_kv_paged_q8_clips_rows_past_the_table():
    """Rows past a slot's table land in its page mp - 1 at p % ps (as the
    JAX package's fused paths write them), never dropped."""
    rng = np.random.default_rng(2)
    pool = [torch.zeros_like(x) for x in (t(a) for a in _q8_pool(rng, 1, 6, 2, 16, 16))]
    k = t(_rows(rng, (1, 4, 2, 16)))
    kw.write_kv_paged_q8_plain(*pool, k, k, torch.tensor([30], dtype=torch.int32),
                               torch.tensor([[4, 2]], dtype=torch.int32), 0)
    q, s = kw.kv_quant_rows(k)
    assert torch.equal(pool[0][0, 2, :, 14], q[0, 0]) and torch.equal(pool[0][0, 2, :, 15], q[0, 1])
    assert torch.equal(pool[0][0, 2, :, 0], q[0, 2]) and torch.equal(pool[2][0, 2, :, 1], s[0, 3])
    assert int(pool[0][0, 4].abs().sum()) == 0


# (page rows, t_ins): partial last pages (t_ins not a multiple of the page:
# 40, 130, 13, 21), 8-row pages
@pytest.mark.parametrize("ps,tt", [(16, 40), (128, 130), (32, 32), (8, 13), (8, 64), (16, 21)])
def test_write_kv_prefill_paged_q8_plain_equals_jax(ps, tt):
    """K13 (b) byte for byte against the Pallas strip writer (one slot a
    call there; two strips of a group in one call here), partial last
    pages included, from strips 3 rows longer than t_ins (rows past t_ins
    never written)."""
    rng = np.random.default_rng(19 + ps + tt)
    L, nkv, hd = 2, 2, 128
    npg = -(-tt // ps)
    P = max(8, 2 * npg + 2)
    pool = _q8_pool(rng, L, P, nkv, ps, hd)
    strips = [_rows(rng, (L, 3, nkv, tt + 3, hd)) for _ in range(2)]
    rows = rng.permutation(P)[: 2 * npg].reshape(2, npg).astype(np.int32)
    want = [jnp.asarray(a) for a in pool]
    for j in range(2):
        (kq, ksc), (vq, vsc) = (jl.kv_quant_rows(jnp.asarray(x[:, j, :, :tt])) for x in strips)
        want = jkw.write_kv_prefill_paged_q8(*want, kq, vq, ksc, vsc, jnp.asarray(rows[j]),
                                             interpret=True)
    got = [t(a) for a in pool]
    kw.write_kv_prefill_paged_q8(*got, t(strips[0]), t(strips[1]), t(rows), tt)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


# (page size, T, GQA rep): T 1 .. 8, rep 1 / 4 / 8, pages of 16 / 32 / 64 / 128 rows
PAGED_WRITE_CASES = [(16, 1, 1), (16, 8, 4), (32, 3, 8), (64, 8, 1), (64, 5, 8), (128, 2, 4),
                     (16, 4, 1), (32, 6, 4), (128, 7, 8)]


def _paged_write_inputs(rng, L, P, B, tq, nh, nkv, ps, hd):
    """bf16 q and N(0, 1) new rows (JAX arrays and bf16 tensors of the same
    values: the K12 tests' inputs) and an int8 pool of kv_quant_rows'd
    N(0, 1) rows."""
    q = jnp.asarray(rng.standard_normal((B, tq, nh, hd)), jnp.bfloat16)
    k, v = (jnp.asarray(rng.standard_normal((B, tq, nkv, hd)), jnp.bfloat16) for _ in range(2))
    (k8, ks), (v8, vs) = (jl.kv_quant_rows(jnp.asarray(a))
                          for a in _pools(rng, L, P, nkv, ps, hd))
    bf = [t(np.asarray(a.astype(jnp.float32))).bfloat16() for a in (q, k, v)]
    return (q, k, v), bf, [np.asarray(a) for a in (k8, v8, ks, vs)]


@pytest.mark.parametrize("ps,tq,rep", PAGED_WRITE_CASES)
def test_paged_write_in_attention_plain_matches_pallas(ps, tq, rep):
    """paged_decode_attention_q8 (T 1) and paged_chunk_attention_q8 given
    the rows (k_new / v_new: on the CPU the plain paged writer, then the
    plain attention) against rama_tpu's write_kv_paged_q8 after
    kv_quant_rows followed by paged_decode_attention_layer_q8 /
    paged_chunk_attention_layer_q8, in interpret mode: bf16, tables of
    two shuffled pages a slot, chunks from a page's start, across a page
    edge (and, at 128-row pages, a 64-row tile edge), inside a page and
    the last that fits. Outputs within 1e-2 (this file's bf16 tolerance),
    the pool exactly."""
    L, P, B, nkv, hd = 2, 10, 4, 2, 128
    rng = np.random.default_rng(7 * ps + 3 * tq + rep)
    (q, k, v), (tq_, tk, tv), pool = _paged_write_inputs(rng, L, P, B, tq, nkv * rep, nkv, ps,
                                                         hd)
    tables = rng.permutation(8).reshape(B, 2).astype(np.int32)
    edge = 64 if ps == 128 else ps
    pos0 = np.array([ps, edge - max(tq // 2, 1), min(5, ps - tq), 2 * ps - tq], np.int32)
    (kq, ksc), (vq, vsc) = jl.kv_quant_rows(k), jl.kv_quant_rows(v)
    jp = jkw.write_kv_paged_q8(*(jnp.asarray(a) for a in pool), kq, vq, ksc, vsc,
                               jnp.asarray(pos0), jnp.asarray(tables), jnp.int32(1),
                               interpret=True)
    args = (jnp.asarray(pos0), jnp.asarray(tables), jnp.int32(1))
    mine = [t(a) for a in pool]
    if tq == 1:
        want = jpa.paged_decode_attention_layer_q8(q[:, 0], *jp, *args, interpret=True)
        got = pa.paged_decode_attention_q8(tq_[:, 0], *mine, t(pos0), t(tables), 1,
                                           k_new=tk[:, 0], v_new=tv[:, 0])
    else:
        want = jpa.paged_chunk_attention_layer_q8(q, *jp, *args, interpret=True)
        got = pa.paged_chunk_attention_q8(tq_, *mine, t(pos0), t(tables), 1, k_new=tk,
                                          v_new=tv)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)
    for g, w in zip(mine, jp):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("tq,rep", [(1, 1), (4, 4), (8, 8)])
def test_paged_write_in_attention_clips_rows_past_the_table(tq, rep):
    """Chunks running past a slot's two table pages (pos0 2 ps - 1, and a
    slot wholly past them): the rows past the table land in the slot's
    page mp - 1 at p % ps, as the JAX package's fused paths write them
    (its XLA pool scatter; its Pallas writer keeps an old row there:
    ROADMAP.md §4), and the queries read them there (every write first,
    then every read). The attention against the Pallas q8 functions in
    interpret mode over the scattered pool, the pool exactly."""
    L, P, B, nkv, hd, ps = 2, 10, 4, 2, 128, 16
    rng = np.random.default_rng(90 + tq + rep)
    (q, k, v), (tq_, tk, tv), pool = _paged_write_inputs(rng, L, P, B, tq, nkv * rep, nkv, ps,
                                                         hd)
    tables = rng.permutation(8).reshape(B, 2).astype(np.int32)
    pos0 = np.array([2 * ps - 1, 2 * ps + 3, 0, ps + 2], np.int32)
    (kq, ksc), (vq, vsc) = jl.kv_quant_rows(k), jl.kv_quant_rows(v)
    jp = _j_paged_scatter([jnp.asarray(a) for a in pool], kq, vq, ksc, vsc, pos0, tables, 0, ps)
    args = (jnp.asarray(pos0), jnp.asarray(tables), jnp.int32(0))
    mine = [t(a) for a in pool]
    if tq == 1:
        want = jpa.paged_decode_attention_layer_q8(q[:, 0], *jp, *args, interpret=True)[:, None]
        got = pa.paged_decode_attention_q8(tq_[:, 0], *mine, t(pos0), t(tables), 0,
                                           k_new=tk[:, 0], v_new=tv[:, 0])[:, None]
    else:
        want = jpa.paged_chunk_attention_layer_q8(q, *jp, *args, interpret=True)
        got = pa.paged_chunk_attention_q8(tq_, *mine, t(pos0), t(tables), 0, k_new=tk,
                                          v_new=tv)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)
    for g, w in zip(mine, jp):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_paged_write_in_attention_is_the_writer_then_the_attention():
    """On the CPU the int8 entries given rows are exactly write_kv_paged_q8
    followed by the entry without them (outputs and pool bytes, atol 0),
    decode (rows (B, nkv, hd)) and chunk alike."""
    rng = np.random.default_rng(12)
    _, (tq_, tk, tv), pool = _paged_write_inputs(rng, 2, 10, 4, 3, 4, 2, 16, 128)
    tables = t(rng.permutation(8).reshape(4, 2).astype(np.int32))
    pos0 = torch.tensor([0, 14, 29, 31], dtype=torch.int32)
    for tq in (1, 3):
        fused, split = [t(a) for a in pool], [t(a) for a in pool]
        kn, vn = tk[:, :tq], tv[:, :tq]
        kw.write_kv_paged_q8(*split, kn, vn, pos0, tables, 1)
        if tq == 1:
            got = pa.paged_decode_attention_q8(tq_[:, 0], *fused, pos0, tables, 1,
                                               k_new=kn[:, 0], v_new=vn[:, 0])
            want = pa.paged_decode_attention_q8(tq_[:, 0], *split, pos0, tables, 1)
        else:
            got = pa.paged_chunk_attention_q8(tq_, *fused, pos0, tables, 1, k_new=kn, v_new=vn)
            want = pa.paged_chunk_attention_q8(tq_, *split, pos0, tables, 1)
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(fused, split))


def test_kernel_wrappers_refuse_other_devices(monkeypatch):
    """K12 / K13 on a tensor that is neither on the CPU nor on the card
    raise and never reach their plain versions."""
    def boom(*a, **k):
        raise AssertionError("reached a plain version")

    for name in ("paged_decode_attention_plain", "paged_decode_attention_q8_plain",
                 "paged_chunk_attention_plain", "paged_chunk_attention_q8_plain"):
        monkeypatch.setattr(pa, name, boom)
    for name in ("write_kv_paged_q8_plain", "write_kv_prefill_paged_q8_plain"):
        monkeypatch.setattr(kw, name, boom)
    m = lambda *s, dtype=torch.float32: torch.zeros(*s, dtype=dtype, device="meta")
    q, pool, i32 = m(2, 4, 16), m(1, 3, 4, 8, 16), torch.int32
    pos, tables = m(2, dtype=i32), m(2, 2, dtype=i32)
    calls = [lambda: pa.paged_decode_attention(q, pool, pool, pos, tables, 0),
             lambda: pa.paged_decode_attention_q8(q, pool, pool, pool, pool, pos, tables, 0),
             lambda: pa.paged_chunk_attention(q[:, None], pool, pool, pos, tables, 0),
             lambda: pa.paged_chunk_attention_q8(q[:, None], pool, pool, pool, pool, pos,
                                                 tables, 0),
             lambda: kw.write_kv_paged_q8(pool, pool, pool, pool, q[:, None], q[:, None], pos,
                                          tables, 0),
             lambda: kw.write_kv_prefill_paged_q8(pool, pool, pool, pool, pool, pool, tables, 4)]
    for call in calls:
        with pytest.raises(ValueError, match="unsupported device"):
            call()


# -- forwards ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = tiny_config(seq_len=64)
    np_params = random_params(jcfg, seed=61)
    jp = jl.load_params(jcfg, np_params, dtype=jnp.float32)
    tp = tl.load_params(torch_cfg(jcfg), np_params, dtype=torch.float32, device="cpu")
    return jcfg, jp, torch_cfg(jcfg), tp


PS, MP = 16, 4
JTABLES = np.array([[0, 2, 4, 6], [1, 3, 5, 7]], np.int32)      # interleaved slots


def _j_pool(jcfg, quant):
    if quant:
        return jpaged.QuantPagedKVCache.create(jcfg, 2 * MP, PS)
    return jpaged.PagedKVCache.create(jcfg, 2 * MP, PS, dtype=jnp.float32)


def _t_pool(jpool):
    if isinstance(jpool, jpaged.QuantPagedKVCache):
        return paged.QuantPagedKVCache(*(t(a) for a in (jpool.k, jpool.v, jpool.ks, jpool.vs)))
    return paged.PagedKVCache(t(jpool.k), t(jpool.v))


def _same_pool(tpool, jpool, atol, scale_rtol=0.0):
    """Pool rows within atol (int8 bytes or fp32 values), row scales within
    scale_rtol."""
    for name in ("k", "v", "ks", "vs"):
        if hasattr(tpool, name):
            tol = dict(atol=0, rtol=scale_rtol) if name in ("ks", "vs") else dict(atol=atol,
                                                                                 rtol=0)
            np.testing.assert_allclose(getattr(tpool, name).float().numpy(),
                                       np.asarray(getattr(jpool, name)).astype(np.float32),
                                       **tol)


@pytest.mark.parametrize("quant", [False, True])
def test_decode_step_paged_matches_jax(model, quant):
    """A token chain through decode_step_paged (the fused path, K12 / K13
    plain) against rama_tpu's decode_step_paged (its gather path on the
    CPU): logits within rtol 1e-5 on an fp32 pool (an int8 pool: against
    the port's dense int8 decode over the same rows, since JAX's CPU path
    attends to the step's own row unquantized), and the pool rows."""
    jcfg, jp, cfg, tp = model
    jpool = _j_pool(jcfg, quant)
    tpool = _t_pool(jpool)
    dense = (tl.QuantKVCache if quant else tl.KVCache).create(
        cfg, 2, MP * PS, **({} if quant else {"dtype": torch.float32}), device="cpu")
    for pos, tk in enumerate([[1, 1], [5, 9], [9, 3], [20, 7], [3, 2], [11, 4]]):
        p = 11 * pos                                   # across page edges: 0, 11, 22, ...
        token, pv = np.asarray(tk, np.int32), np.full(2, p, np.int32)
        jl_, jpool = jpaged.decode_step_paged(jp, jcfg, jnp.asarray(token), jnp.asarray(pv),
                                              jpool, jnp.asarray(JTABLES))
        got, tpool = paged.decode_step_paged(tp, cfg, t(token).long(), t(pv), tpool,
                                             t(JTABLES))
        dl, dense = tl.decode_step(tp, cfg, t(token).long(), t(pv).long(), dense)
        if quant:
            np.testing.assert_allclose(got.numpy(), dl.numpy(), rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(jl_), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got.numpy(), dl.numpy(), rtol=1e-5, atol=1e-5)
    if not quant:
        _same_pool(tpool, jpool, atol=1e-6)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("tq", [1, 4, 10])
def test_forward_paged_matches_jax(model, quant, tq):
    """forward_paged after a prefill insert: T = 1 and 4 (fused) and 10
    (the generic gather path) against rama_tpu's forward_paged (generic on
    the CPU) at rtol 1e-5 and the pool rows written; an int8 pool's fused
    chunks against the port's dense int8 forward over the same rows."""
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(tq)
    prompt = rng.integers(1, cfg.vocab_size, (2, 13)).astype(np.int32)
    dense_j = jl.KVCache.create(jcfg, 2, 16, dtype=jnp.float32)
    _, dense_j = jl.prefill(jp, jcfg, jnp.asarray(prompt), dense_j)
    jpool = _j_pool(jcfg, quant)
    for j in range(2):
        jpool = jpaged._insert_prefill_paged_impl(jpool, dense_j.k[:, j, :, :13],
                                                  dense_j.v[:, j, :, :13],
                                                  jnp.asarray(JTABLES[j]), _interpret=True)
    tpool = paged.insert_prefill_paged(_t_pool(_j_pool(jcfg, quant)), t(dense_j.k),
                                       t(dense_j.v), t(JTABLES), 13)
    _same_pool(tpool, jpool, atol=0)
    chunk = rng.integers(1, cfg.vocab_size, (2, tq)).astype(np.int32)
    pos_index = np.array([13, 9], np.int32)[:, None] + np.arange(tq, dtype=np.int32)[None, :]
    want, jpool = jpaged.forward_paged(jp, jcfg, jnp.asarray(chunk), jnp.asarray(pos_index),
                                       jpool, jnp.asarray(JTABLES))
    got, tpool = paged.forward_paged(tp, cfg, t(chunk).long(), t(pos_index), tpool, t(JTABLES))
    assert got.shape == (2, tq, cfg.vocab_size)
    if quant and tq <= 8:
        dense = tl.QuantKVCache(*(torch.stack([pa.gather_pages(x[l], t(JTABLES))
                                               for l in range(cfg.n_layers)])
                                  for x in (tpool.k, tpool.v, tpool.ks, tpool.vs)))
        for name in ("k", "v", "ks", "vs"):   # the rows before the chunk's
            getattr(dense, name)[:, 1, :, 9:13] = 0
        want_t, _ = tl.forward_chunk(tp, cfg, t(chunk).long(), t(pos_index[:, 0]), dense)
        np.testing.assert_allclose(got.numpy(), want_t.numpy(), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        # int8 rows within 1 (fp32 sums in another order can move a value
        # across a rounding edge), as the dense chunk test holds them
        _same_pool(tpool, jpool, atol=1 if quant else 1e-5, scale_rtol=1e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_fused_chunk_matches_jax_fused_paged(quant):
    """forward_paged's fused chunk (T = 4) against rama_tpu's
    _forward_chunk_fused_paged with its Pallas kernels in interpret mode,
    on the int8 tiny model: logits at every column (1e-4 on an fp32 pool,
    5e-2 on an int8 pool) and the pool rows (int8 within 1)."""
    jcfg = tiny_config(seq_len=64)
    jp = jl.fuse_params(jl.quantize_params(jcfg, random_params(jcfg, seed=7), bits=8,
                                           group_size=16, dtype=jnp.float32), jcfg)
    cfg, tp = torch_cfg(jcfg), jax_params_to_torch(jcfg, jp)
    rng = np.random.default_rng(11)
    jpool = _j_pool(jcfg, quant)
    prompt = rng.integers(1, cfg.vocab_size, (2, 9)).astype(np.int32)
    _, jpool = jpaged.forward_paged(jp, jcfg, jnp.asarray(prompt),
                                    jnp.arange(9, dtype=jnp.int32)[None, :].repeat(2, 0), jpool,
                                    jnp.asarray(JTABLES))
    tpool = _t_pool(jpool)
    chunk = rng.integers(1, cfg.vocab_size, (2, 4)).astype(np.int32)
    pos0 = np.array([9, 14], np.int32)                       # slot 1's chunk crosses a page
    want, jpool = jpaged._forward_chunk_fused_paged(jp, jcfg, jnp.asarray(chunk),
                                                    jnp.asarray(pos0)[:, None] + jnp.arange(4),
                                                    jpool, jnp.asarray(JTABLES), _interpret=True)
    got, tpool = paged.forward_paged(tp, cfg, t(chunk).long(),
                                     t(pos0[:, None] + np.arange(4, dtype=np.int32)), tpool,
                                     t(JTABLES))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-2 if quant else 1e-4,
                               rtol=0)
    if quant:
        assert int((tpool.k.int() - t(jpool.k).int()).abs().max()) <= 1
    else:
        _same_pool(tpool, jpool, atol=1e-5)


def test_paged_chain_equals_dense_chain(model):
    """The port's paged decode chain equals its dense one on the same tokens
    (fp32 pool with interleaved pages, and an int8 pool), step by step."""
    _, _, cfg, tp = model
    pools = [paged.PagedKVCache.create(cfg, 2 * MP, PS, dtype=torch.float32, device="cpu"),
             paged.QuantPagedKVCache.create(cfg, 2 * MP, PS, device="cpu")]
    dense = [tl.KVCache.create(cfg, 2, MP * PS, dtype=torch.float32, device="cpu"),
             tl.QuantKVCache.create(cfg, 2, MP * PS, device="cpu")]
    tok = torch.tensor([1, 1])
    for pos in range(40):
        p = torch.tensor([pos, pos])
        for i in range(2):
            lp, pools[i] = paged.decode_step_paged(tp, cfg, tok, p, pools[i], t(JTABLES))
            ld, dense[i] = tl.decode_step(tp, cfg, tok, p, dense[i])
            np.testing.assert_allclose(lp.numpy(), ld.numpy(), rtol=1e-5, atol=1e-5)
        tok = torch.argmax(ld, dim=-1)


def test_gather_path_runs_only_on_the_cpu(model):
    _, _, cfg, tp = model
    pool = paged.PagedKVCache.create(cfg, 4, PS, dtype=torch.float32, device="cpu")
    pool = paged.PagedKVCache(pool.k.to("meta"), pool.v.to("meta"))
    with pytest.raises(ValueError, match="gather path runs on the CPU only"):
        paged._forward_gather_paged(tp, cfg, torch.zeros(1, 9, dtype=torch.long, device="meta"),
                                    torch.zeros(1, 9, dtype=torch.long, device="meta"), pool,
                                    torch.zeros(1, 2, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("ps", [64, 128])
@pytest.mark.parametrize("mp", [1, 3, 8, 32, 64])
@pytest.mark.parametrize("walk", [False, True])
def test_split_plan_of_a_pool_equals_the_dense_plan(ps, mp, walk):
    """At 64- and 128-row pages a pool of mp pages walks the dense plan of
    mp * ps rows (64-row tiles, the same G and splits): the paged kernel
    then equals the dense one over the gathered rows bit for bit."""
    from rama_tpu_torch.ops.kernels import decode_attention as da

    assert da.split_plan(mp * ps, ps, walk) == da.split_plan(mp * ps, walk=walk)
    assert da.split_plan(mp * ps, ps, walk).tile == 64


@pytest.mark.parametrize("ps", [8, 16, 24, 48, 96])
@pytest.mark.parametrize("mp", [1, 5, 256])
@pytest.mark.parametrize("walk", [False, True])
def test_split_plan_of_small_pages_keeps_tiles_inside_a_page(ps, mp, walk):
    """Below 64-row pages a tile is split_rows(ps) rows (inside one page);
    a walk split of G tiles may span pages, and every row of the pool is in
    exactly one tile."""
    from rama_tpu_torch.ops.kernels import decode_attention as da

    s = mp * ps
    plan = da.split_plan(s, ps, walk)
    assert plan.tile == pa.split_rows(ps) and ps % plan.tile == 0
    ntiles = s // plan.tile
    assert plan.nsplit == -(-ntiles // plan.tiles)
    assert walk or plan.tiles == 1
    tiles = [t for k in range(plan.nsplit)
             for t in range(k * plan.tiles, min((k + 1) * plan.tiles, ntiles))]
    assert tiles == list(range(ntiles))
