"""Kernel 2's plain version (rama_tpu_torch.ops.kernels.ffn.ffn_plain) against
rama_tpu's ffn_fused_layered run in interpret mode, for the il-interleaved
and the plain [W1 | W3] w13 layouts, int8 and packed int4 weights, built by
each package's own fuse_params from the same numpy weights, at M of one
tensor-core CTA (<= 64) and of several row blocks (M = 33 to 128: the
Pallas kernel's dequantize path, acc_mode false above M = 32).

Tolerance: the Pallas kernel rounds the hidden activation to bf16
(ffn.py:170); the plain version keeps it in x's dtype — so fp32 inputs are
compared with rel 2e-2 of max |ref|, like bf16 ones."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_params_to_torch, torch_cfg
from rama_tpu.config import ModelConfig as JCfg
from rama_tpu.models import llama as jl
from rama_tpu.ops.pallas.ffn import ffn_fused_layered
from rama_tpu.testing.ref_model import random_params
from rama_tpu_torch.models import llama as tl
from rama_tpu_torch.ops.kernels.ffn import ffn as t_ffn
from rama_tpu_torch.ops.kernels.ffn import ffn_plain, split_h13

torch.set_num_threads(1)

# hidden 512 with gs 64: phase-A tile 256, two tiles -> interleaved w13.
# int4: w13 gs 8 (dim 128), w2 gs 32 (hidden 512), tile 256 as well.
CFG = JCfg(dim=128, hidden_dim=512, n_layers=2, n_heads=2, n_kv_heads=2,
           vocab_size=64, seq_len=16)


def _fused(bits):
    np_params = random_params(CFG, seed=5, scale=0.1)
    jp = jl.fuse_params(jl.quantize_params(CFG, np_params, bits=bits, group_size=64,
                                           dtype=jnp.float32), CFG)
    tp = tl.fuse_params(tl.quantize_params(torch_cfg(CFG), np_params, bits=bits,
                                           group_size=64, dtype=torch.float32,
                                           device="cpu"),
                        torch_cfg(CFG))
    return jp, tp


@pytest.fixture(scope="module")
def fused():
    return _fused(8)


@pytest.fixture(scope="module")
def fused4():
    return _fused(4)


@pytest.mark.parametrize("bits", [8, 4])
def test_both_packages_interleave_w13_identically(fused, fused4, bits):
    jp, tp = fused if bits == 8 else fused4
    assert jp["w13"].il == tp["w13"].il == 256
    assert tp["w13"].bits == tp["w2"].bits == bits
    np.testing.assert_array_equal(tp["w13"].q.numpy(), np.asarray(jp["w13"].q))
    np.testing.assert_array_equal(tp["w13"].scales.numpy(), np.asarray(jp["w13"].scales))


@pytest.mark.parametrize("interleaved", [True, False])
@pytest.mark.parametrize("m,dtype", [(1, "float32"), (8, "float32"), (8, "bfloat16")])
@pytest.mark.parametrize("layer", [0, 1])
def test_plain_matches_pallas(fused, interleaved, m, dtype, layer):
    _check_plain_matches_pallas(fused[0], interleaved, m, dtype, layer)


@pytest.mark.parametrize("interleaved", [True, False])
@pytest.mark.parametrize("m,dtype", [(1, "float32"), (8, "float32"), (8, "bfloat16")])
@pytest.mark.parametrize("layer", [0, 1])
def test_int4_plain_matches_pallas(fused4, interleaved, m, dtype, layer):
    jp = fused4[0]
    assert jp["w13"].group_size == 8 and jp["w2"].group_size == 32
    _check_plain_matches_pallas(jp, interleaved, m, dtype, layer)


def _layout(jp, interleaved):
    """rama_tpu's fused (w13, w2): w13 as fuse_params interleaved it, or
    with the interleave undone (plain [W1 | W3] columns, il = 0)."""
    jw13, jw2 = jp["w13"], jp["w2"]
    if not interleaved:
        def plain(a):
            *lead, k, n = a.shape
            t = np.asarray(a).reshape(*lead, k, n // 512, 2, 256)
            return jnp.asarray(np.swapaxes(t, -3, -2).reshape(*lead, k, n))
        from rama_tpu.ops.quant import QuantizedTensor
        jw13 = QuantizedTensor(q=plain(jw13.q), scales=plain(jw13.scales),
                               group_size=jw13.group_size, bits=jw13.bits, il=0)
    return jw13, jw2


def _check_plain_matches_pallas(jp, interleaved, m, dtype, layer, scales="f32"):
    jw13, jw2 = _layout(jp, interleaved)
    tw = jax_params_to_torch(CFG, {"w13": jw13, "w2": jw2})
    assert tw["w13"].il == (256 if interleaved else 0)
    if scales == "bf16":
        from rama_tpu.ops import quant as jq
        from rama_tpu_torch.ops import quant as tq

        jw13, jw2 = (jq.cast_scales({"w13": jw13, "w2": jw2}, jnp.bfloat16)[k]
                     for k in ("w13", "w2"))
        tw = tq.cast_scales(tw, torch.bfloat16)
        assert tw["w13"].scales.dtype == tw["w2"].scales.dtype == torch.bfloat16
        np.testing.assert_array_equal(tw["w13"].scales.view(torch.int16).numpy(),
                                      np.asarray(jw13.scales).view(np.int16))
    x = np.random.default_rng(6).standard_normal((m, CFG.dim)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(ffn_fused_layered(jnp.asarray(x, jd), jw13, jw2, jnp.int32(layer),
                                        interpret=True).astype(jnp.float32))
    got = ffn_plain(torch.from_numpy(x).to(td), tw["w13"], tw["w2"], layer).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("scales", ["f32", "bf16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("interleaved", [True, False])
@pytest.mark.parametrize("m", [33, 64, 65, 128])
@pytest.mark.parametrize("bits", [8, 4])
def test_plain_matches_pallas_past_one_cta(fused, fused4, bits, m, interleaved, dtype, scales):
    """M of one 64-row CTA (33, 64) and of two row blocks (65, 128), where
    the Pallas kernel takes its dequantize path (acc_mode false): int8 and
    int4 (w13 gs 8, w2 gs 32), both w13 layouts, bf16 and fp32 activations,
    f32 and bf16-stored scales, layer 1; the file's tolerance."""
    _check_plain_matches_pallas((fused if bits == 8 else fused4)[0], interleaved, m, dtype, 1,
                                scales)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,dtype", [(1, "float32"), (8, "float32"), (32, "float32"),
                                     (8, "bfloat16")])
@pytest.mark.parametrize("layer", [0, 1])
def test_bf16_scales_plain_matches_pallas(fused, fused4, bits, m, dtype, layer):
    """K3 / K3' with bf16-stored scales: the plain version on the port's
    cast_scales params against ffn_fused_layered in interpret mode on
    rama_tpu's cast_scales params (the same bf16 scales, bit for bit),
    int8 and int4, layer 0 and layer 1 (whose scales a wrong element-size
    offset would miss); the tolerance of the f32-scale test above."""
    from rama_tpu.ops import quant as jq
    from rama_tpu_torch.ops import quant as tq

    jp, tp = fused if bits == 8 else fused4
    jp, tp = jq.cast_scales(jp, jnp.bfloat16), tq.cast_scales(tp, torch.bfloat16)
    for name in ("w13", "w2"):
        assert tp[name].scales.dtype == torch.bfloat16 and tp[name].il == jp[name].il
        np.testing.assert_array_equal(tp[name].scales.view(torch.int16).numpy(),
                                      np.asarray(jp[name].scales).view(np.int16))
    x = np.random.default_rng(7).standard_normal((m, CFG.dim)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(ffn_fused_layered(jnp.asarray(x, jd), jp["w13"], jp["w2"],
                                        jnp.int32(layer), interpret=True).astype(jnp.float32))
    got = ffn_plain(torch.from_numpy(x).to(td), tp["w13"], tp["w2"], layer).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("m", [1, 32, 33, 64, 65, 512])
@pytest.mark.parametrize("bits", [8, 4])
def test_every_decode_step_and_verify_round_takes_the_fused_ffn(fused, fused4, bits, m):
    """The port's route (models/llama.py `_ffn_fusable`): quantized w13 /
    w2 of the same bits take K3 at any M, past one CTA's 64 rows too;
    mixed bits and unquantized weights take the split matmuls. Not
    rama_tpu's VMEM rule, which fuses these dim-128 weights at every M
    here but Llama-2-7B int8 only up to M = 70 (ROADMAP §3)."""
    from rama_tpu_torch.ops.quant import QuantizedTensor

    tp = (fused if bits == 8 else fused4)[1]
    assert tl._ffn_fusable(tp, m)
    other = 4 if bits == 8 else 8
    w2 = QuantizedTensor(q=tp["w2"].q, scales=tp["w2"].scales, group_size=tp["w2"].group_size,
                         bits=other)
    assert not tl._ffn_fusable({**tp, "w2": w2}, m)
    assert not tl._ffn_fusable({**tp, "w13": tp["w13"].q.float()}, m)


@pytest.mark.parametrize("model,bits,last", [("7B", 8, 70), ("7B", 4, 58),
                                             ("TinyLlama", 8, 474), ("TinyLlama", 4, 507),
                                             ("Yi-34B", 8, 0), ("Yi-34B", 4, 0)])
def test_jax_vmem_budget_fuses_fewer_rows_than_the_port(model, bits, last):
    """rama_tpu's ffn_tileable(max_m = max(M, 8)), the JAX model's rule, at
    the served models' FFN shapes (int8 gs 64; int4 w13 gs 64, w2 the
    pick_int4_group_size of H: 16 at 7B, 32 at TinyLlama, 64 at Yi) fuses up
    to `last` rows, none at Yi-34B; the port's
    fused FFN serves every M (the deliberate difference of ROADMAP §3).
    Zero-stride weights: only shapes are read."""
    from rama_tpu.ops.pallas.ffn import ffn_tileable, phase_a_tile
    from rama_tpu.ops.quant import QuantizedTensor as JQT
    from rama_tpu_torch.ops.quant import pick_int4_group_size

    d, h = {"7B": (4096, 11008), "TinyLlama": (2048, 5632), "Yi-34B": (7168, 20480)}[model]
    gs13, gs2 = 64, 64 if bits == 8 else pick_int4_group_size(h, 64)

    def qt(k, n, gs, il=0):
        rows = k if bits == 8 else k // 2
        return JQT(q=np.broadcast_to(np.int8(0), (1, rows, n)),
                   scales=np.broadcast_to(np.float32(0), (1, k // gs, n)), group_size=gs,
                   bits=bits, il=il)

    w13, w2 = qt(d, 2 * h, gs13, phase_a_tile(h, bits, gs2) or 0), qt(h, d, gs2)
    fused = [m for m in (1, 8, last, last + 1, 4096) if ffn_tileable(w13, w2, max_m=max(m, 8))]
    assert fused == ([1, 8, last] if last else [])
    assert ffn_mod.body_for(torch.bfloat16, last + 1) == "mma"


def test_split_h13_matches_jax(fused):
    jp, tp = fused
    h = np.arange(3 * 1024, dtype=np.float32).reshape(3, 1024)
    for a, b in zip(split_h13(torch.from_numpy(h), tp["w13"]),
                    jl.split_h13(jnp.asarray(h), jp["w13"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("bits", [8, 4])
def test_cpu_wrapper_dispatches_to_plain(fused, fused4, bits):
    from rama_tpu_torch.ops import quant as tq
    from rama_tpu_torch.ops.kernels import ffn as mod

    _, tp = fused if bits == 8 else fused4
    x = torch.randn(2, CFG.dim)
    before = dict(mod.launches), dict(mod.launches_by_scale)
    torch.testing.assert_close(t_ffn(x, tp["w13"], tp["w2"], 1),
                               ffn_plain(x, tp["w13"], tp["w2"], 1), rtol=0, atol=0)
    tb = tq.cast_scales(tp, torch.bfloat16)
    torch.testing.assert_close(t_ffn(x, tb["w13"], tb["w2"], 1),
                               ffn_plain(x, tb["w13"], tb["w2"], 1), rtol=0, atol=0)
    assert (mod.launches, mod.launches_by_scale) == before


# -- the card body's dispatch and plan (pure Python; the kernels run only on
# the card, tests/test_torch_cuda.py) --------------------------------------

from rama_tpu_torch.ops.kernels import ffn as ffn_mod  # noqa: E402

# 7B: K 4096, H 11008, N 4096; w13 / w2 K blocks of int8 gs 64 and of int4
# gs 64 / 16 (packing blocks of 2 gs rows)
_7B_BLOCKS = {8: (64, 64), 4: (128, 32)}


@pytest.mark.parametrize("m", range(1, ffn_mod.FFN_MAX_M + 1))
def test_body_for_takes_tensor_cores_for_bf16(m):
    assert ffn_mod.body_for(torch.bfloat16, m) == "mma"
    assert ffn_mod.body_for(torch.float32, m) == "simt"


def test_body_for_refuses_rows_past_the_kernel():
    """The kernel serves every M >= 1 (row blocks above FFN_MAX_M); only an
    empty x is refused."""
    for m in (ffn_mod.FFN_MAX_M + 1, 256, 512, 4096):
        assert ffn_mod.body_for(torch.bfloat16, m) == "mma"
        assert ffn_mod.body_for(torch.float32, m) == "simt"
    for m in (0, -1):
        with pytest.raises(ValueError, match="M >= 1"):
            ffn_mod.body_for(torch.bfloat16, m)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("phase_a", [True, False])
def test_mma_plan_holds_every_row_in_one_tile(bits, phase_a):
    """Every M <= FFN_MAX_M fits one CTA's n8 tiles (the smallest of 1 / 2 /
    4 / 8 that holds M) in one row block, so each weight byte is read once,
    and the grid is the same at any M."""
    k, nout = (4096, 11008) if phase_a else (11008, 4096)
    kb = _7B_BLOCKS[bits][0 if phase_a else 1]
    grid = ffn_mod.mma_plan(1, k, nout, kb, phase_a)[1:]
    assert grid[-1] == 1
    for m in range(1, ffn_mod.FFN_MAX_M + 1):
        nt, *rest = ffn_mod.mma_plan(m, k, nout, kb, phase_a)
        assert nt in ffn_mod.FORMS_NT and m <= 8 * nt and (nt == 1 or m > 4 * nt)
        assert tuple(rest) == grid
        assert ffn_mod.form_for(m) == "one"


@pytest.mark.parametrize("m", [65, 100, 128, 129, 256, 474, 512, 4096])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("phase_a", [True, False])
def test_mma_plan_takes_row_blocks_past_one_cta(m, bits, phase_a):
    """Above FFN_MAX_M the plan runs NT 8 over ceil(M / 64) row blocks with
    the tiles and the K split of M = 1 (ks from the tiles, not from M: a
    row's split order, and so its bits, is the same in every form)."""
    k, nout = (4096, 11008) if phase_a else (11008, 4096)
    kb = _7B_BLOCKS[bits][0 if phase_a else 1]
    one = ffn_mod.mma_plan(1, k, nout, kb, phase_a)
    nt, tiles, ks, sps, rblocks = ffn_mod.mma_plan(m, k, nout, kb, phase_a)
    assert nt == 8 and rblocks == -(-m // ffn_mod.FFN_MAX_M) and rblocks > 1
    assert (tiles, ks, sps) == one[1:4]
    assert ffn_mod.form_for(m) == "rows"


# (K, H) of each model's FFN and its w13 / w2 K blocks: int8 gs 64; int4 w13
# gs 64 (packing blocks of 128), w2 pick_int4_group_size's 16 (7B) or 32
# (TinyLlama's 5632)
_FFN_MODELS = {"7B": ((4096, 11008), {8: (64, 64), 4: (128, 32)}),
               "TinyLlama": ((2048, 5632), {8: (64, 64), 4: (128, 64)})}


@pytest.mark.parametrize("m", [1, 8, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("model", list(_FFN_MODELS))
def test_mma_plan_fills_the_card_at_7b(m, bits, model):
    """Both phases at the 7B and TinyLlama shapes, row blocks counted
    (every form holds two CTAs an SM): at least one CTA per SM of
    the H100's 132, the last wave of two-CTA slots filled to 95 %. One
    exception, a limit of the split options: TinyLlama's w2 (K 5632, 8
    column tiles) splits at most 15 ways (SWAB_MAX_SPLITS 16 of whole
    slabs), so one row block is 120 CTAs and two or more fill their last
    wave to 120 / 132."""
    (k, h), blocks = _FFN_MODELS[model]
    for phase_a, (kin, nout) in ((True, (k, h)), (False, (h, k))):
        nt, tiles, ks, _, rblocks = ffn_mod.mma_plan(m, kin, nout,
                                                     blocks[bits][0 if phase_a else 1], phase_a)
        ctas = tiles * ks * rblocks
        fill = ctas / (-(-ctas // 264) * 264)
        assert ks > 1 and ffn_mod.mma_ctas_per_sm(nt, bits) == 2
        if model == "TinyLlama" and not phase_a:
            assert (tiles, ks) == (8, 15)
            assert ctas == 120 if rblocks == 1 else (ctas >= 132 and fill >= 120 / 132 - 1e-9)
        else:
            assert ctas >= 132 and fill >= 0.95


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("nt", [1, 2, 4, 8])
def test_every_form_holds_two_ctas_an_sm(bits, nt):
    """Each form's shared memory (the ring of swab_smem_bytes; the 64-row
    int8 form keeps three stages, not four) leaves room for the two CTAs an
    SM that ffn_mma's register cap allows, so the plan's slots are what
    every form gets (the card checks the occupancy API: test_torch_cuda)."""
    assert ffn_mod.mma_ctas_per_sm(nt, bits) == 2
    smem = ffn_mod.mma_smem_bytes(nt, bits)
    assert 2 * (smem + 1024) <= 233472
    want = {(4, 8): 104448, (8, 8): 92160, (8, 4): 88064}
    assert want.get((nt, bits), smem) == smem


@pytest.mark.parametrize("k,k_block", [(4096, 64), (4096, 128), (11008, 64), (11008, 32),
                                       (64, 16), (64, 8), (176, 16), (288, 96), (288, 32),
                                       (768, 32), (768, 64), (256, 64), (512, 96)])
@pytest.mark.parametrize("phase_a", [True, False])
def test_mma_plan_splits_whole_k_blocks(k, k_block, phase_a):
    """Splits start on whole slabs and whole K blocks (scale groups, int4
    packing blocks), cover every slab once, and leave none empty."""
    nslabs = -(-k // 64)
    _, _, ks, sps, _ = ffn_mod.mma_plan(8, k, 4096, k_block, phase_a)
    assert (sps * 64) % k_block == 0 or ks == 1
    assert (ks - 1) * sps < nslabs <= ks * sps
    assert ks == 1 or sps >= 4


def _qt(k, n, gs, bits, il=0):
    from rama_tpu_torch.ops.quant import QuantizedTensor

    rows = k if bits == 8 else k // 2
    return QuantizedTensor(q=torch.zeros(rows, n, dtype=torch.int8),
                           scales=torch.zeros(k // gs, n), group_size=gs, bits=bits, il=il)


@pytest.mark.parametrize("k,h,n,gs13,gs2", [(64, 176, 64, 4, 8), (288, 768, 288, 2, 16),
                                            (288, 768, 288, 48, 16)])
def test_tiny_and_stories_int4_take_the_masked_path(k, h, n, gs13, gs2):
    """int4 at the tiny (gs 4) and stories15M (quantize_int4's gs 2, or 48)
    shapes: w13's group size is off the 16 grid, so phase A reads with plain
    masked loads; 7B's group sizes take cp.async, misaligned pointers not."""
    aligned = (0, 256, 512)
    assert not ffn_mod.mma_vec(_qt(k, 2 * h, gs13, 4), aligned, True)
    assert ffn_mod.mma_vec(_qt(h, n, gs2, 4), aligned, False) == (gs2 % 16 == 0)
    assert ffn_mod.mma_vec(_qt(4096, 22016, 64, 4, il=256), aligned, True)
    assert ffn_mod.mma_vec(_qt(11008, 4096, 16, 4), aligned, False)
    assert ffn_mod.mma_vec(_qt(4096, 22016, 64, 8, il=256), aligned, True)
    assert not ffn_mod.mma_vec(_qt(4096, 22016, 64, 8, il=256), (0, 8, 512), True)
    # a hidden width off the 16 grid (w13 width 2H a multiple of 16)
    assert not ffn_mod.mma_vec(_qt(64, 2 * 40, 16, 8), aligned, True)


@pytest.mark.parametrize("h,il", [(512, 256), (512, 0), (176, 16), (176, 0), (768, 256)])
def test_pair_columns_invert_split_h13(h, il):
    """Hidden unit j's (W1, W3) columns, as the tensor-core body pairs them,
    are where split_h13 reads unit j's a and c."""
    w13 = _qt(16, 2 * h, 16, 8, il=il)
    cols = torch.arange(2 * h, dtype=torch.float32)[None]
    a, c = split_h13(cols, w13)
    for j in range(h):
        assert ffn_mod.pair_columns(j, h, il) == (int(a[0, j]), int(c[0, j]))
