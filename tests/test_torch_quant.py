"""rama_tpu_torch.ops.quant vs rama_tpu.ops.quant: int8 quantization is
bit-identical (same fp32 divide, round-half-to-even), dequantization and
the file-layout / classifier conversions agree exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rama_tpu.ops import quant as jq
from rama_tpu_torch.ops import quant as tq

torch.set_num_threads(1)


@pytest.mark.parametrize("shape,gs", [((128, 96), 64), ((2, 288, 40), 64),
                                      ((3, 64, 176), 16)])
def test_quantize_int8_bit_identical(shape, gs):
    w = (np.random.default_rng(0).standard_normal(shape) * 0.05).astype(np.float32)
    w.reshape(-1)[::37] = 0.0  # zero runs exercise the 1e-10 scale floor
    want = jq.quantize_int8(w, gs)
    got = tq.quantize_int8(w, gs)
    assert got.group_size == want.group_size
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))


def test_quantize_int8_all_zero_group():
    w = np.zeros((64, 8), np.float32)
    got, want = tq.quantize_int8(w, 32), jq.quantize_int8(w, 32)
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))


@pytest.mark.parametrize("shape,gs", [((100, 64), 16), ((32000 // 100, 288), 64)])
def test_quantize_embedding_bit_identical(shape, gs):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want, got = jq.quantize_embedding(w, gs), tq.quantize_embedding(w, gs)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    ids = np.array([[0, 5, 7], [3, 3, 1]])
    np.testing.assert_array_equal(
        got.lookup(torch.from_numpy(ids), torch.float32).numpy(),
        np.asarray(want.lookup(jnp.asarray(ids), jnp.float32)))
    # the classifier view: same bytes, transposed, contiguous for the kernels
    cj, ct = want.as_classifier(), got.as_classifier()
    assert ct.q.is_contiguous() and ct.scales.is_contiguous()
    np.testing.assert_array_equal(ct.q.numpy(), np.asarray(cj.q))
    np.testing.assert_array_equal(ct.scales.numpy(), np.asarray(cj.scales))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_matches(dtype):
    w = np.random.default_rng(2).standard_normal((2, 128, 48)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jq.dequantize(jq.quantize_int8(w, 32), jd).astype(jnp.float32))
    got = tq.dequantize(tq.quantize_int8(w, 32), td).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_from_q80_file_layout_matches():
    rng = np.random.default_rng(3)
    q = rng.integers(-127, 128, (2, 48, 64), dtype=np.int8)
    s = rng.uniform(0.1, 1.0, (2, 48, 4)).astype(np.float32)
    want, got = jq.from_q80_file_layout(q, s, 16), tq.from_q80_file_layout(q, s, 16)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_matches_matmul_xla(dtype):
    """fp32: atol 1e-5 (same product, other summation order); bf16: both
    round weights and output to bf16 — compared in fp32 with rel 2e-2."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((256, 96)).astype(np.float32) * 0.05
    x = rng.standard_normal((5, 256)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jq.matmul_xla(jnp.asarray(x, jd), jq.quantize_int8(w, 64),
                                    dtype=jd).astype(jnp.float32))
    got = tq.matmul_plain(torch.from_numpy(x).to(td), tq.quantize_int8(w, 64)).float()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max())
