"""Kernel 3's plain version (decode_attention_plain) against rama_tpu's
decode_attention_layer and decode_attention_layer_tiled in interpret mode:
ragged positions (0, tile boundaries, S-1), layers 0 and L-1, MHA and GQA.

Tolerance: fp32 caches atol 1e-4; bf16 caches (probabilities rounded to
bf16 before P.V at different points: normalized in the whole-S kernel,
unnormalized per tile in the tiled one) compared in fp32 with rel 2e-2 of
max |ref|. The card kernel's split plan (which cache rows each split
covers) is pinned at the end of the file."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rama_tpu.ops.pallas.decode_attention import (decode_attention_layer,
                                                  decode_attention_layer_tiled)
from rama_tpu_torch.ops.kernels import decode_attention as da
from rama_tpu_torch.ops.kernels.decode_attention import (decode_attention,
                                                         decode_attention_plain)

torch.set_num_threads(1)


def make(L, b, nh, nkv, s, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nh, hd)).astype(np.float32)
    k = (rng.standard_normal((L, b, nkv, s, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((L, b, nkv, s, hd)) * 0.5).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("nh,nkv", [(2, 2), (4, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas(tiled, nh, nkv, dtype):
    L, b, s, hd = 2, 4, 64, 128
    q, k, v = make(L, b, nh, nkv, s, hd, seed=nh)
    pos = np.array([0, 31, 32, 63], np.int32)       # pos 0, tile edge, S-1
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    fn = decode_attention_layer_tiled if tiled else decode_attention_layer
    kw = {"chunk": 32} if tiled else {}
    for layer in (0, L - 1):
        want = np.asarray(fn(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                             jnp.asarray(pos), jnp.int32(layer), interpret=True, **kw)
                          .astype(jnp.float32))
        got = decode_attention_plain(
            torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
            torch.from_numpy(v).to(td), torch.from_numpy(pos), layer).float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("nh,nkv", [(8, 1), (6, 2), (16, 1)])
def test_gqa_decode_plain_matches_pallas(nh, nkv, q8):
    """K4 / K7's plain versions at GQA groups 8, 3 and 16 (a decode step of
    16 query rows a kv head is the card's 16-row form) against
    decode_attention_layer / _q8 in interpret mode on bf16 q (hd 64, S
    128, positions 0, a 64-row split edge, S - 1): rel 2e-2 of max |ref|
    for the bf16 cache, as above; the int8 cache atol 0.03 / rtol 0.05, as
    K9's q8 test."""
    from rama_tpu.models.llama import kv_quant_rows
    from rama_tpu.ops.pallas.decode_attention import decode_attention_layer_q8

    L, b, s, hd = 2, 4, 128, 64
    q, k, v = make(L, b, nh, nkv, s, hd, seed=nh + nkv)
    pos = np.array([0, 63, 64, s - 1], np.int32)
    jq = jnp.asarray(q, jnp.bfloat16)
    t = lambda a: torch.from_numpy(np.array(a))
    tq = t(jq.astype(jnp.float32)).bfloat16()
    for layer in (0, L - 1):
        if q8:
            (k8, ks), (v8, vs) = kv_quant_rows(jnp.asarray(k)), kv_quant_rows(jnp.asarray(v))
            want = decode_attention_layer_q8(jq, k8, v8, ks, vs, jnp.asarray(pos),
                                             jnp.int32(layer), interpret=True)
            got = da.decode_attention_q8_plain(tq, t(k8), t(v8), t(ks), t(vs), t(pos), layer)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       atol=0.03, rtol=0.05)
        else:
            jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
            want = np.asarray(decode_attention_layer(jq, jk, jv, jnp.asarray(pos),
                                                     jnp.int32(layer), interpret=True)
                              .astype(jnp.float32))
            got = decode_attention_plain(tq, t(jk.astype(jnp.float32)).bfloat16(),
                                         t(jv.astype(jnp.float32)).bfloat16(), t(pos),
                                         layer).float().numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


def test_pos_zero_returns_first_value_row():
    q, k, v = make(1, 2, 4, 2, 16, 8, seed=9)
    out = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.zeros(2, dtype=torch.int32), 0)
    want = np.repeat(v[0, :, :, 0, :], 2, axis=1).reshape(2, -1)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-6)


def test_cpu_wrapper_dispatches_to_plain():
    q, k, v = make(2, 2, 2, 2, 16, 16, seed=3)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.tensor([3, 15], dtype=torch.int32), 1)
    torch.testing.assert_close(decode_attention(*args), decode_attention_plain(*args),
                               rtol=0, atol=0)


# Kernel 9: the same function over ONE layer's cache (B, nkv, S, hd), against
# rama_tpu's decode_attention / decode_attention_q8 in interpret mode.
# Tolerance: fp32 atol 1e-4; bf16 rel 2e-2 of max |ref| (as above); the int8
# cache with bf16 q within the bar of the K7 test (atol 0.03, rtol 0.05: the
# Pallas kernel rounds probs * vs to bf16 after a normalized softmax).

@pytest.mark.parametrize("nh,nkv", [(2, 2), (4, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_plain_matches_pallas(nh, nkv, dtype):
    from rama_tpu.ops.pallas.decode_attention import decode_attention as j_flat
    from rama_tpu_torch.ops.kernels.decode_attention import decode_attention_flat_plain

    b, s, hd = 4, 64, 128
    q, k, v = make(1, b, nh, nkv, s, hd, seed=10 + nh)
    pos = np.array([0, 31, 32, 63], np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(j_flat(jnp.asarray(q, jd), jnp.asarray(k[0], jd), jnp.asarray(v[0], jd),
                             jnp.asarray(pos), interpret=True).astype(jnp.float32))
    got = decode_attention_flat_plain(torch.from_numpy(q).to(td), torch.from_numpy(k[0]).to(td),
                                      torch.from_numpy(v[0]).to(td),
                                      torch.from_numpy(pos)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("rep", [1, 2])
def test_flat_q8_plain_matches_pallas(rep):
    from rama_tpu.models.llama import kv_quant_rows
    from rama_tpu.ops.pallas.decode_attention import decode_attention_q8 as j_flat_q8
    from rama_tpu_torch.ops.kernels.decode_attention import decode_attention_flat_q8_plain

    rng = np.random.default_rng(20 + rep)
    b, nkv, s, hd = 3, 2, 64, 128
    k = rng.standard_normal((b, nkv, s, hd)).astype(np.float32)
    v = rng.standard_normal((b, nkv, s, hd)).astype(np.float32)
    (k8, ks), (v8, vs) = kv_quant_rows(jnp.asarray(k)), kv_quant_rows(jnp.asarray(v))
    jq = jnp.asarray(rng.standard_normal((b, nkv * rep, hd)), jnp.bfloat16)
    pos = np.array([0, 40, s - 1], np.int32)
    want = np.asarray(j_flat_q8(jq, k8, v8, ks, vs, jnp.asarray(pos), interpret=True),
                      np.float32)
    t = lambda a: torch.from_numpy(np.array(a))
    got = decode_attention_flat_q8_plain(t(jq.astype(jnp.float32)).to(torch.bfloat16), t(k8),
                                         t(v8), t(ks), t(vs), t(pos)).float().numpy()
    np.testing.assert_allclose(got, want, atol=0.03, rtol=0.05)


def test_flat_cpu_wrappers_dispatch_to_plain_and_equal_the_layered_kernel():
    """On the CPU the K9 wrappers run their plain versions, which are K4's /
    K7's over the stacked view of one layer (bit for bit)."""
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels.kv_write import kv_quant_rows

    q, k, v = make(2, 3, 4, 2, 48, 16, seed=4)
    q, k, v = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    pos = torch.tensor([0, 47, 60], dtype=torch.int32)     # 60: past the cache, clamped
    got = da.decode_attention_flat(q, k[1], v[1], pos)
    torch.testing.assert_close(got, da.decode_attention_flat_plain(q, k[1], v[1], pos),
                               rtol=0, atol=0)
    torch.testing.assert_close(got, da.decode_attention(q, k, v, pos, 1), rtol=0, atol=0)
    (k8, ks), (v8, vs) = kv_quant_rows(k), kv_quant_rows(v)
    got = da.decode_attention_flat_q8(q, k8[1], v8[1], ks[1], vs[1], pos)
    torch.testing.assert_close(got, da.decode_attention_q8(q, k8, v8, ks, vs, pos, 1),
                               rtol=0, atol=0)


# The split plan of the card's kernel (split_plan): the cache rows each split
# of a launch covers, tile by tile. It is a function of the cache alone (its
# rows, a pool's page size, the body), never of the positions or of the
# queries a slot: so a verification row and the decode row at its position
# walk the same splits, bit for bit on the card.

def _plan_rows(plan, s):
    """The cache rows of each split of `plan` over s rows, tile by tile."""
    ntiles = -(-s // plan.tile)
    return [[list(range(t * plan.tile, min((t + 1) * plan.tile, s)))
             for t in range(k * plan.tiles, min((k + 1) * plan.tiles, ntiles))]
            for k in range(plan.nsplit)]


@pytest.mark.parametrize("s", [1, 63, 64, 65, 200, 1024, 1100, 2048, 4096, 32768])
@pytest.mark.parametrize("walk", [False, True])
@pytest.mark.parametrize("tiles", [None, 3])
def test_split_plan_tiles_cover_every_cache_row_once(s, walk, tiles):
    """The tiles of the plan's splits cover rows 0..S-1 exactly once, in
    order, each starting at a multiple of 64, no split empty; a split is one
    tile but on the walk body (int8 cache), where it is G (`tiles` when
    given); nsplit is the kernel's ceil(ceil(S / 64) / G)."""
    plan = da.split_plan(s, walk=walk, tiles=tiles)
    splits = _plan_rows(plan, s)
    assert [r for split in splits for tile in split for r in tile] == list(range(s))
    assert all(tile[0] % 64 == 0 for split in splits for tile in split)
    assert all(splits)
    assert plan.tile == da.CHUNK == 64
    assert plan.tiles == ((tiles or da.walk_tiles(-(-s // 64))) if walk else 1)
    assert plan.nsplit == -(-(-(-s // 64)) // plan.tiles)


def test_split_plan_depends_on_the_cache_alone():
    """split_plan takes the cache's rows, a pool's page size, the body and
    an explicit G, nothing of a launch's positions or queries; no public
    wrapper, dense or paged, passes G, so every launch over one cache gets
    walk_tiles' G; G grows with the rows (never down), at least 1."""
    import inspect

    from rama_tpu_torch.ops.kernels import paged_attention as pa

    assert list(inspect.signature(da.split_plan).parameters) == ["s", "ps", "walk", "tiles"]
    for fn in (da.decode_attention_q8, da.decode_attention_flat_q8, da.chunk_attention_q8,
               pa.paged_decode_attention_q8, pa.paged_chunk_attention_q8):
        assert "tiles" not in inspect.signature(fn).parameters
    gs = [da.split_plan(s, walk=True).tiles for s in range(64, 65 * 1024, 64)]
    assert gs[0] == 1 and all(a <= b for a, b in zip(gs, gs[1:]))
    assert da.split_plan(4096, walk=True) == da.split_plan(4096, walk=True)


@pytest.mark.parametrize("s,ps", [(200, None), (1024, None), (4096, None), (512, 64),
                                  (4096, 128), (256, 16), (240, 24), (96, 32)])
@pytest.mark.parametrize("walk", [False, True])
@pytest.mark.parametrize("tiles", [None, 3])
def test_scratch_holds_every_split_a_query_row_sees(s, ps, walk, tiles):
    """`scratch` (the output and partials both wrappers allocate, dense and
    paged) holds one partial a (slot, query, head) for each split of the
    plan; the split of every row limit 0..S-1 is among them, the last one
    included."""
    plan = da.split_plan(s, ps, walk, tiles)
    q = torch.zeros(2, 3, 4, 16, dtype=torch.bfloat16)
    out, part_o, part_ml = da.scratch(q, plan)
    assert (out.shape, out.dtype) == ((2, 3, 64), torch.bfloat16)
    assert part_o.shape == (2, 3, 4, plan.nsplit, 16) and part_o.dtype == torch.float32
    assert part_ml.shape == (2, 3, 4, plan.nsplit, 2) and part_ml.dtype == torch.float32
    assert max(lim // (plan.tile * plan.tiles) for lim in range(s)) == plan.nsplit - 1


@pytest.mark.parametrize("t,rep,form", [
    (1, 1, (8, 1)), (8, 1, (8, 1)), (1, 8, (8, 1)), (2, 4, (8, 1)), (3, 3, (16, 1)),
    (2, 8, (16, 1)), (1, 16, (16, 1)), (4, 8, (32, 1)), (5, 5, (32, 1)), (8, 8, (64, 1)),
    (4, 12, (64, 1)), (5, 16, (64, 2)), (8, 16, (64, 2)), (3, 50, (64, 3))])
def test_row_form_takes_the_fewest_rows_then_groups_of_64(t, rep, form):
    """The form of the tensor-core bodies a launch of T queries over a GQA
    group rep runs: the fewest of 8, 16, 32, 64 rows that hold T * rep,
    past 64 rows groups of 64 (csrc dattn_mma.cuh form_rows). Every
    Llama-2 shape at T <= 8 (rep 1) keeps the 8-row form."""
    assert da.row_form(t, rep) == form


@pytest.mark.parametrize("hd,mma,walk", [
    (48, {8: 16640, 16: 18944, 32: 23552, 64: 32768}, {8: 13068, 64: 29196}),
    (64, {8: 20992, 16: 23552, 32: 28672, 64: 38912}, {8: 13324, 64: 31244}),
    (128, {8: 38400, 16: 41984, 32: 49152, 64: 63488}, {8: 22540, 64: 47628})])
def test_form_smem_of_each_form(hd, mma, walk):
    """Shared bytes a split CTA of each form asks for (csrc MmaSmem,
    WalkSmem + walk_smem at one slot): the 8-row forms' are the ones the
    bodies always had (38,400 and 22,540 at hd 128); at hd 128 the mma body's 64-row
    form needs the opt-in above 48 KB (its 32-row form is 48 KB, 49,152
    bytes, exactly), and the walk's 64-row form stays under it up to 191
    slots (its table grows 8 bytes a slot)."""
    for form, n in mma.items():
        assert da.form_smem("mma", form, hd) == n
    for form, n in walk.items():
        assert da.form_smem("walk", form, hd) == n
    assert da.form_smem("walk", 8, 128, b=8) == 22596
    assert da.form_smem("walk", 64, 128, b=191) <= 48 * 1024 < da.form_smem("walk", 64, 128,
                                                                              b=192)


@pytest.mark.parametrize("body,ran,t,rep", [
    ("mma", 8, 8, 1), ("walk", 8, 1, 8), ("mma", 64, 8, 8), ("walk", 32, 4, 8),
    ("mma", 64, 8, 16), ("walk", 16, 3, 3)])
def test_count_launch_counts_the_form_the_kernel_reports(body, ran, t, rep):
    """A tensor-core launch is counted by its body and by the row form the C
    entry reports it launched; a form other than the one `row_form` sized
    the launch for raises; a SIMT launch is counted by body only."""
    by_body = dict.fromkeys(da.BODIES, 0)
    by_form = {b: dict.fromkeys(da.FORMS, 0) for b in ("mma", "walk")}
    da.count_launch(by_body, by_form, body, ran, t, rep)
    assert by_body == {**dict.fromkeys(da.BODIES, 0), body: 1}
    assert [(b, f) for b, forms in by_form.items() for f, n in forms.items() if n] == [
        (body, ran)]
    wrong = next(f for f in da.FORMS if f != ran)
    with pytest.raises(ValueError, match=f"launched its {wrong}-row form"):
        da.count_launch(by_body, by_form, body, wrong, t, rep)
    da.count_launch(by_body, by_form, "simt", 8, t, rep)
    assert by_body["simt"] == 1 and sum(by_form[body].values()) == 1


def test_walk_ctas_fill_one_wave_and_never_exceed_the_items():
    """The walk body's CTAs a kv head: one wave of the card (resident CTAs)
    over the kv heads, rounded down (no second wave), at most B * nsplit
    (slot, split) items, at least 1."""
    assert da.walk_ctas(8, 32, 16, 660) == 20
    assert da.walk_ctas(8, 32, 2, 660) == 16
    assert da.walk_ctas(1, 32, 1, 660) == 1
    assert da.walk_ctas(8, 4, 64, 660) == 165
    assert da.walk_ctas(3, 64, 0, 660) == 1
