"""Kernel 1's plain version (rama_tpu_torch.ops.kernels.quant_matmul) against
the Pallas functions it replaces, run in interpret mode on the CPU:
quant_matmul (2-D weight) and quant_matmul_layered (stacked weight, layer
chosen per call), with int8 and with packed int4 weights.

Tolerances: fp32 activations at decode M (the Pallas accscale path, fp32
dots) atol 1e-4; bf16 activations, and fp32 at M >= 64 where the Pallas
kernel dots in bf16 (quant_matmul.py:31-35), compared in fp32 with rel 2e-2
of max |ref|. The CUDA kernel itself is held against the plain version on
the card (test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rama_tpu.ops import quant as jq
from rama_tpu.ops.pallas.quant_matmul import quant_matmul, quant_matmul_layered
from rama_tpu_torch.ops import quant as tq
from rama_tpu_torch.ops.kernels import build
from rama_tpu_torch.ops.kernels import quant_matmul as qm
from rama_tpu_torch.ops.kernels.quant_matmul import (MMA_BK, MMA_BN, MMV_WIDTHS, body_for,
                                                     mma_plan, mma_vec, mmv_plan,
                                                     quant_matmul as t_quant_matmul,
                                                     quant_matmul_plain, split_k)

torch.set_num_threads(1)


def _close(got, want, exact: bool):
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    if exact:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


def _weights(shape, gs, seed=0, bits=8):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.05
    if bits == 4:
        return jq.quantize_int4(w, gs), tq.quantize_int4(w, gs)
    return jq.quantize_int8(w, gs), tq.quantize_int8(w, gs)


@pytest.mark.parametrize("m,dtype", [(1, "float32"), (8, "float32"), (8, "bfloat16"),
                                     (64, "float32"), (16, "bfloat16"), (32, "bfloat16"),
                                     (64, "bfloat16")])
def test_plain_matches_pallas_2d(m, dtype):
    jw, tw = _weights((256, 384), 64)
    x = np.random.default_rng(1).standard_normal((m, 256)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = quant_matmul(jnp.asarray(x, jd), jw, interpret=True)
    got = quant_matmul_plain(torch.from_numpy(x).to(td), tw)
    assert got.dtype == td
    _close(got, want, exact=(dtype == "float32" and m <= 32))


@pytest.mark.parametrize("layer", [0, 2])
@pytest.mark.parametrize("m,dtype", [(8, "float32"), (8, "bfloat16"), (3, "float32"),
                                     (16, "bfloat16"), (32, "bfloat16"), (64, "bfloat16")])
def test_plain_matches_pallas_layered(layer, m, dtype):
    jw, tw = _weights((3, 256, 256), 64, seed=2)
    x = np.random.default_rng(3).standard_normal((m, 256)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = quant_matmul_layered(jnp.asarray(x, jd), jw, jnp.int32(layer),
                                interpret=True)
    got = quant_matmul_plain(torch.from_numpy(x).to(td), tw, layer)
    _close(got, want, exact=(dtype == "float32"))


def test_cpu_wrapper_dispatches_to_plain():
    """A CPU tensor takes the plain version (no kernel, no launch count)."""
    from rama_tpu_torch.ops.kernels import quant_matmul as mod

    x = torch.randn(4, 128)
    before = dict(mod.launches)
    for bits in (8, 4):
        _, tw = _weights((2, 128, 64), 32, seed=4, bits=bits)
        torch.testing.assert_close(t_quant_matmul(x, tw, 1), quant_matmul_plain(x, tw, 1),
                                   rtol=0, atol=0)
    assert mod.launches == before


@pytest.mark.parametrize("ngroups,col_tiles,gs,mt", [
    (64, 24, 64, 8),     # 7B wqkv: 11 splits x 24 column tiles
    (64, 8, 64, 8),      # 7B wo
    (172, 8, 64, 8),     # 7B w2 (K = 11008)
    (9, 2, 32, 1),       # stories15M-sized
    (1, 1, 16, 4),
    (32, 24, 128, 8),    # 7B int4 wqkv: 32 packing blocks of 2 x 64 rows
    (344, 8, 32, 8),     # 7B int4 w2 (K = 11008, gs 16)
    (88, 1, 2, 1),       # tiny int4 w2 (K = 176, gs 1)
])
def test_split_k_covers_k_within_smem(ngroups, col_tiles, gs, mt):
    """The GEMV's split plan covers every scale group exactly once, leaves
    no split empty, and keeps each split's x slab within 48 KB."""
    ks, gps = split_k(ngroups, col_tiles, gs, mt)
    assert ks >= 1 and gps >= 1
    assert (ks - 1) * gps < ngroups <= ks * gps
    assert mt * gps * gs * 4 <= 48 * 1024


@pytest.mark.parametrize("m,dtype", [(1, "float32"), (8, "float32"), (8, "bfloat16"),
                                     (64, "float32"), (64, "bfloat16")])
@pytest.mark.parametrize("k,gs", [(256, 64), (288, 16)])
def test_int4_plain_matches_pallas_2d(m, dtype, k, gs):
    """Packed int4 (gs 16 at K = 256; K = 288 reduces gs to 2)."""
    jw, tw = _weights((k, 384), gs, seed=5, bits=4)
    assert tw.group_size == jw.group_size and tw.bits == 4
    x = np.random.default_rng(6).standard_normal((m, k)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = quant_matmul(jnp.asarray(x, jd), jw, interpret=True)
    got = quant_matmul_plain(torch.from_numpy(x).to(td), tw)
    assert got.dtype == td and got.shape == (m, 384)
    _close(got, want, exact=(dtype == "float32" and m <= 32))


@pytest.mark.parametrize("layer", [0, 2])
@pytest.mark.parametrize("m,dtype", [(1, "float32"), (8, "float32"), (8, "bfloat16"),
                                     (64, "float32")])
def test_int4_plain_matches_pallas_layered(layer, m, dtype):
    jw, tw = _weights((3, 256, 256), 64, seed=7, bits=4)
    x = np.random.default_rng(8).standard_normal((m, 256)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = quant_matmul_layered(jnp.asarray(x, jd), jw, jnp.int32(layer), interpret=True)
    got = quant_matmul_plain(torch.from_numpy(x).to(td), tw, layer)
    _close(got, want, exact=(dtype == "float32" and m <= 32))


def test_k_block_is_the_packing_block_for_int4():
    """A split of an int4 weight never cuts a packing block: its K block is
    2*gs rows (the two scale groups whose rows share bytes)."""
    _, w8 = _weights((2, 256, 64), 16, seed=9)
    _, w4 = _weights((2, 256, 64), 16, seed=9, bits=4)
    assert (w8.k_block, w8.k_dim) == (16, 256)
    assert (w4.k_block, w4.k_dim, w4.q.shape[-2]) == (32, 256, 128)


@pytest.mark.parametrize("m,dtype,body", [
    (1, torch.bfloat16, "mmv"), (8, torch.bfloat16, "mmv"), (8, torch.float32, "gemv"),
    (1, torch.float32, "gemv"), (9, torch.bfloat16, "mmv"), (32, torch.bfloat16, "mmv"),
    (33, torch.bfloat16, "mma"), (4096, torch.bfloat16, "mma"),
    (9, torch.float32, "simt"), (4096, torch.float32, "simt"),
])
def test_body_for_picks_gemv_then_mma_for_bf16_and_simt_for_fp32(m, dtype, body):
    """The body a CUDA call launches: for bf16 the swap-AB tensor-core body
    up to MMV_MAX_M rows (a decode step, a verify round of 8 x 4), then the
    tensor-core GEMM; for fp32 the CUDA-core GEMV up to GEMV_MAX_M rows,
    then the CUDA-core tiled GEMM."""
    assert (qm.MMV_MAX_M, qm.GEMV_MAX_M) == (32, 8)
    assert body_for(dtype, m) == body


# (n, k, k_block, bits): 7B wqkv, wo, lm_head int8 gs 64; int4 gs 64
# (packing blocks of 128 rows); int4 w2 gs 16; ragged stories / tiny shapes
_MMV_SHAPES = [(12288, 4096, 64, 8), (4096, 4096, 64, 8), (32000, 4096, 64, 8),
               (12288, 4096, 128, 4), (4096, 4096, 128, 4), (4096, 11008, 32, 4),
               (1000, 288, 32, 8), (384, 288, 96, 8), (200, 176, 2, 4), (64, 64, 64, 8)]


@pytest.mark.parametrize("n,k,k_block,bits", _MMV_SHAPES)
@pytest.mark.parametrize("m", [1, 8, 32])
@pytest.mark.parametrize("vec", [True, False])
def test_mmv_plan_covers_every_slab_once_in_whole_k_blocks(n, k, k_block, bits, m, vec):
    """The decode body's plan: a CTA width the kernel has (128 only on the
    masked path), column tiles covering N, every 64-row K slab in exactly
    one split, no split empty, every split boundary on a K block boundary
    (a scale group, or an int4 packing block)."""
    bn, tiles, ks, sps = mmv_plan(m, n, k, k_block, bits, vec)
    assert bn in (MMV_WIDTHS if vec else (128,))
    assert tiles == -(-n // bn)
    nslabs = -(-k // MMA_BK)
    bounds = [min(i * sps, nslabs) for i in range(ks + 1)]
    assert bounds[0] == 0 and bounds[-1] == nslabs
    assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:]))   # none empty
    assert all(b * MMA_BK % k_block == 0 for b in bounds[1:-1])  # whole K blocks
    assert ks == 1 or sps >= 4                                  # the ring fills


@pytest.mark.parametrize("n,k,k_block,bits", _MMV_SHAPES[:6])
@pytest.mark.parametrize("m", [1, 8, 16, 32])
def test_mmv_plan_fills_one_wave_at_the_7b_shapes(n, k, k_block, bits, m):
    """At the 7B shapes the grid fits one wave of CTA slots (132 SMs x the
    CTAs an SM holds at that width, n8 tile count and weight type) and
    fills at least 90 % of it."""
    bn, tiles, ks, sps = mmv_plan(m, n, k, k_block, bits)
    nt = 1 if m <= 8 else 2 if m <= 16 else 4
    slots = 132 * qm.mmv_ctas_per_sm(bn, nt, bits)
    assert 0.9 * slots <= tiles * ks <= slots


def test_mmv_plan_is_the_swept_one_at_the_7b_shapes():
    """The plans that the H100 sweep found fastest (PERF.md §6): 128
    columns and five splits for wqkv, sixteen for wo, two for lm_head at
    decode M; at M = 32 (three 128-column CTAs an SM for int8) four splits
    for wqkv and 256 columns for wo and lm_head."""
    assert [mmv_plan(8, n, k, kb, b)[::3] for n, k, kb, b in _MMV_SHAPES[:5]] == [
        (128, 13), (128, 4), (128, 32), (128, 14), (128, 4)]
    assert [mmv_plan(8, n, k, kb, b)[2] for n, k, kb, b in _MMV_SHAPES[:5]] == [5, 16, 2, 5, 16]
    assert [mmv_plan(32, n, k, kb, 8)[:3] for n, k, kb, _ in _MMV_SHAPES[:3]] == [
        (128, 96, 4), (256, 16, 16), (256, 125, 2)]


def test_mmv_ctas_per_sm_follow_registers_and_shared_memory():
    """Four 128-column CTAs an SM (the register cap) but three at NT = 4
    int8 (63.5 KB of shared memory each); two 256-column CTAs."""
    assert [qm.mmv_ctas_per_sm(128, nt, 8) for nt in (1, 2, 4)] == [4, 4, 3]
    assert [qm.mmv_ctas_per_sm(128, nt, 4) for nt in (1, 2, 4)] == [4, 4, 4]
    assert [qm.mmv_ctas_per_sm(256, nt, b) for nt in (1, 4) for b in (8, 4)] == [2, 2, 2, 2]


@pytest.mark.parametrize("m,n,k,k_block", [
    (32, 12288, 4096, 64),     # 7B wqkv in a verify round (int8 gs 64)
    (32, 4096, 4096, 128),     # wo, int4 gs 64 (packing blocks of 128 rows)
    (32, 4096, 11008, 32),     # w2, int4 gs 16
    (32, 32000, 4096, 64),     # lm_head: enough tiles, no split
    (256, 4096, 11008, 64),    # w2 at M = 256
    (4096, 22016, 4096, 64),   # w13 of an 8 x 512 admission
    (40, 1000, 288, 32),       # the ragged stories shape: 4.5 slabs
    (17, 384, 288, 96),        # a K block of 1.5 slabs
    (100, 200, 176, 2),        # tiny int4 (gs 1)
])
@pytest.mark.parametrize("vec", [True, False])
def test_mma_plan_covers_every_slab_once_in_whole_k_blocks(m, n, k, k_block, vec):
    """The tensor-core GEMM's plan: a tile height the kernel has, every
    64-row K slab in exactly one split, no split empty, every split
    boundary on a K block boundary (a scale group, or an int4 packing
    block), and splits only where the output tiles fill at most half of
    the CTA slots."""
    bm, ks, sps = mma_plan(m, n, k, k_block, vec)
    assert bm in ((32, 64, 128, 256) if vec else (64,))
    nslabs = -(-k // MMA_BK)
    bounds = [min(i * sps, nslabs) for i in range(ks + 1)]
    assert bounds[0] == 0 and bounds[-1] == nslabs
    assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:]))   # none empty
    assert all(b * MMA_BK % k_block == 0 for b in bounds[1:-1])  # whole K blocks
    assert ks >= 1
    if ks > 1:
        slots = 132 * qm._MMA_CTAS_PER_SM[bm]
        assert 2 * -(-m // bm) * -(-n // MMA_BN) <= slots


def test_mma_plan_tile_heights_follow_m():
    assert [mma_plan(m, 4096, 4096, 64)[0] for m in (9, 32, 33, 64, 65, 128, 129, 4096)] == [
        32, 32, 64, 64, 128, 128, 256, 256]


def test_mma_vec_takes_the_copy_path_only_where_16_byte_copies_fit():
    """cp.async path: N and gs multiples of 16, gs dividing (or a multiple
    of) the slab's weight rows, every pointer 16-byte aligned."""
    x = torch.zeros(64, 256)

    def qt(n, gs, bits=8):
        k = 256
        rows = k // 2 if bits == 4 else k
        return tq.QuantizedTensor(q=torch.zeros(rows, n, dtype=torch.int8),
                                  scales=torch.ones(k // gs, n), group_size=gs, bits=bits)

    for w, want in ((qt(384, 64), True), (qt(384, 16), True), (qt(384, 128), True),
                    (qt(1000, 32), False), (qt(384, 8), False), (qt(384, 32, 4), True),
                    (qt(384, 64, 4), True), (qt(384, 16, 4), True)):
        assert mma_vec(x, w, w.q.data_ptr(), w.scales.data_ptr()) is want
    w = qt(384, 64)
    assert not mma_vec(x, w, w.q.data_ptr() + 8, w.scales.data_ptr())
    assert not mma_vec(x[:, 1:], w, w.q.data_ptr(), w.scales.data_ptr())
    # gs 48: a 64-row slab straddles groups differently slab to slab
    w48 = tq.QuantizedTensor(q=torch.zeros(192, 384, dtype=torch.int8),
                             scales=torch.ones(4, 384), group_size=48, bits=8)
    assert not mma_vec(x, w48, w48.q.data_ptr(), w48.scales.data_ptr())


# -- bf16-stored weight scales (cast_scales) -----------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("layer", [None, 0, 2])
@pytest.mark.parametrize("m,dtype", [(1, "float32"), (8, "float32"), (32, "float32"),
                                     (8, "bfloat16"), (32, "bfloat16")])
def test_bf16_scales_plain_matches_pallas(bits, layer, m, dtype):
    """K1 / K2 with bf16-stored scales: the plain version on the port's
    cast_scales params against quant_matmul (2-D) / quant_matmul_layered
    (layer 0, and layer 2, where a scale offset in the wrong element size
    would land) in interpret mode on rama_tpu's cast_scales params, int8
    and int4. Both upcast the same bf16 scales to fp32, so the tolerances
    are the f32-scale ones above: fp32 atol 1e-4, bf16 rel 2e-2."""
    shape = (256, 384) if layer is None else (3, 256, 256)
    jw, tw = _weights(shape, 16 if bits == 4 else 64, seed=11, bits=bits)
    jw = jq.cast_scales({"w": jw}, jnp.bfloat16)["w"]
    tw = tq.cast_scales({"w": tw}, torch.bfloat16)["w"]
    assert tw.scales.dtype == torch.bfloat16 and tw.bits == bits
    x = np.random.default_rng(12).standard_normal((m, 256)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    if layer is None:
        want = quant_matmul(jnp.asarray(x, jd), jw, interpret=True)
    else:
        want = quant_matmul_layered(jnp.asarray(x, jd), jw, jnp.int32(layer), interpret=True)
    got = quant_matmul_plain(torch.from_numpy(x).to(td), tw, layer)
    assert got.dtype == td
    _close(got, want, exact=(dtype == "float32"))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("sdtype", [torch.float32, torch.bfloat16])
def test_weight_ptrs_offset_a_layer_in_the_scales_element_size(bits, sdtype):
    """Layer l's scales start l * stride(0) elements of the scales' own
    size in: with bf16 scales an f32-sized offset would land on layer 2l."""
    _, tw = _weights((4, 256, 64), 32, seed=13, bits=bits)
    tw = tq.cast_scales({"w": tw}, sdtype)["w"]
    for layer in range(4):
        qp, sp = qm.weight_ptrs(tw, layer)
        assert qp == tw.q[layer].data_ptr()
        assert sp == tw.scales[layer].data_ptr()
    assert qm.weight_ptrs(tq.QuantizedTensor(q=tw.q[3], scales=tw.scales[3],
                                             group_size=32, bits=bits), None)[1] == \
        tw.scales[3].data_ptr()


def test_check_weight_takes_f32_or_bf16_scales_only():
    """The wrappers take f32 and bf16 scales (a scale-type code each) and
    refuse any other scale dtype."""
    _, tw = _weights((2, 128, 64), 32, seed=14)
    cpu = torch.device("cpu")
    for sdtype, code, name in ((torch.float32, 0, "f32"), (torch.bfloat16, 1, "bf16")):
        w = tq.cast_scales({"w": tw}, sdtype)["w"]
        qm.check_weight(w, cpu)
        assert build.dtype_code(w.scales) == code and qm.SCALE_NAMES[sdtype] == name
    with pytest.raises(ValueError, match="float32 or bfloat16 scales"):
        qm.check_weight(tq.cast_scales({"w": tw}, torch.float16)["w"], cpu)


def test_cpu_wrapper_with_bf16_scales_dispatches_to_plain():
    """A CPU tensor with bf16-stored scales takes the plain version too: no
    launch counted, by bits or by scale dtype."""
    x = torch.randn(4, 128)
    before = (dict(qm.launches), dict(qm.launches_by_scale))
    for bits in (8, 4):
        _, tw = _weights((2, 128, 64), 32, seed=15, bits=bits)
        tw = tq.cast_scales({"w": tw}, torch.bfloat16)["w"]
        torch.testing.assert_close(t_quant_matmul(x, tw, 1), quant_matmul_plain(x, tw, 1),
                                   rtol=0, atol=0)
    assert (qm.launches, qm.launches_by_scale) == before


@pytest.mark.parametrize("n,k,k_block,bits", _MMV_SHAPES[:6])
def test_mma_vec_is_the_same_for_bf16_scales(n, k, k_block, bits):
    """bf16 scale rows take the cp.async path wherever f32 ones do (N a
    multiple of 16: every row starts on 16 bytes), so the plan, which
    depends on vec, does not change with the scales' dtype."""
    gs = k_block // 2 if bits == 4 else k_block
    rows = k // 2 if bits == 4 else k
    x = torch.zeros(8, k)
    w = tq.QuantizedTensor(q=torch.zeros(rows, n, dtype=torch.int8),
                           scales=torch.ones(k // gs, n), group_size=gs, bits=bits)
    wb = tq.cast_scales({"w": w}, torch.bfloat16)["w"]
    assert mma_vec(x, w, w.q.data_ptr(), w.scales.data_ptr()) == \
        mma_vec(x, wb, wb.q.data_ptr(), wb.scales.data_ptr()) is True
