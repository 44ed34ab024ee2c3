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
from rama_tpu_torch.ops.kernels.quant_matmul import (quant_matmul as t_quant_matmul,
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
                                     (64, "float32")])
def test_plain_matches_pallas_2d(m, dtype):
    jw, tw = _weights((256, 384), 64)
    x = np.random.default_rng(1).standard_normal((m, 256)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = quant_matmul(jnp.asarray(x, jd), jw, interpret=True)
    got = quant_matmul_plain(torch.from_numpy(x).to(td), tw)
    assert got.dtype == td
    _close(got, want, exact=(dtype == "float32" and m <= 32))


@pytest.mark.parametrize("layer", [0, 2])
@pytest.mark.parametrize("m,dtype", [(8, "float32"), (8, "bfloat16"), (3, "float32")])
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
