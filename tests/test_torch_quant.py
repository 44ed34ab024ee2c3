"""rama_tpu_torch.ops.quant vs rama_tpu.ops.quant: int8 and int4
quantization are bit-identical (same fp32 divide, round-half-to-even, group
size reduction and nibble packing), dequantization and the file-layout /
classifier conversions agree exactly."""

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


# K of the golden configs and 7B: dim 64 / hidden 176 (tiny), dim 288 /
# hidden 768 (stories15M), 4096 (Llama-2-7B dim); group sizes as requested
@pytest.mark.parametrize("k", [64, 176, 288, 768, 4096])
@pytest.mark.parametrize("gs", [8, 16, 64])
def test_quantize_int4_bit_identical(k, gs):
    w = (np.random.default_rng(k + gs).standard_normal((2, k, 24)) * 0.05).astype(np.float32)
    w.reshape(-1)[::37] = 0.0
    w[0, : 2 * 64, 3] = 0.0  # an all-zero group: the 1e-10 scale floor
    want = jq.quantize_int4(w, gs)
    got = tq.quantize_int4(w, gs)
    assert got.bits == 4 and got.group_size == want.group_size
    assert got.shape == want.shape and got.k_dim == want.k_dim == k
    assert got.q.shape == (2, k // 2, 24) and got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            tq.dequantize(got, td).float().numpy(),
            np.asarray(jq.dequantize(want, jd).astype(jnp.float32)))


def test_pick_int4_group_size_matches():
    for k in (32, 64, 96, 176, 288, 768, 4096, 11008, 14336):
        for gs in (1, 8, 16, 32, 64, 128):
            assert tq.pick_int4_group_size(k, gs) == jq.pick_int4_group_size(k, gs), (k, gs)
    # the shapes the int4 path meets: tiny, stories15M and Llama-2-7B
    assert [tq.pick_int4_group_size(k, g) for k, g in
            ((64, 8), (176, 8), (288, 16), (768, 16), (4096, 64), (11008, 64))] == \
        [4, 1, 2, 16, 64, 16]


@pytest.mark.parametrize("gs", [1, 2, 16])
def test_unpack_int4_matches(gs):
    """Every byte value unpacks to the JAX package's sign-extended nibbles,
    planes placed block-locally."""
    from rama_tpu.ops.quant import _unpack_int4

    packed = np.arange(-128, 128, dtype=np.int8).reshape(16 * gs, -1)
    packed = np.ascontiguousarray(np.tile(packed, (1, 2)))
    got = tq.unpack_int4(torch.from_numpy(packed), gs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_unpack_int4(jnp.asarray(packed), gs)))
    assert int(got.min()) == -8 and int(got.max()) == 7


def test_int4_values_and_packing_layout():
    """Values lie in [-7, 7] (never -8) and byte row j of block b holds
    logical rows 2b*gs + j (low nibble) and 2b*gs + gs + j (high)."""
    w = np.random.default_rng(5).standard_normal((64, 8)).astype(np.float32)
    qt = tq.quantize_int4(w, 16)
    full = tq.unpack_int4(qt.q, 16).int()
    assert int(full.min()) >= -7 and int(full.max()) <= 7
    p = qt.q.int()
    lo, hi = ((p & 15) ^ 8) - 8, p >> 4
    for b in range(2):
        for j in range(16):
            assert torch.equal(lo[b * 16 + j], full[2 * b * 16 + j])
            assert torch.equal(hi[b * 16 + j], full[2 * b * 16 + 16 + j])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_int4_matches_matmul_xla(dtype):
    rng = np.random.default_rng(6)
    w = rng.standard_normal((2, 256, 96)).astype(np.float32) * 0.05
    x = rng.standard_normal((5, 256)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jw = jq.quantize_int4(w[1], 64)
    want = np.asarray(jq.matmul_xla(jnp.asarray(x, jd), jw, dtype=jd).astype(jnp.float32))
    got = tq.matmul_plain(torch.from_numpy(x).to(td), tq.quantize_int4(w[1], 64)).float()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max())


def _bf16_bits(a) -> np.ndarray:
    """The 16-bit patterns of a bf16 array (JAX's ml_dtypes or a torch tensor)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _leaves(seed=7):
    """int8, int4 and embedding leaves of both packages from one numpy seed,
    plus a dense leaf that cast_scales must pass through."""
    rng = np.random.default_rng(seed)
    w8 = (rng.standard_normal((2, 128, 96)) * 0.05).astype(np.float32)
    w4 = (rng.standard_normal((2, 256, 64)) * 0.05).astype(np.float32)
    emb = rng.standard_normal((50, 64)).astype(np.float32)
    norm = rng.standard_normal(64).astype(np.float32)
    jp = {"wqkv": jq.quantize_int8(w8, 32), "w2": jq.quantize_int4(w4, 16),
          "tok_embedding": jq.quantize_embedding(emb, 16), "final_norm": jnp.asarray(norm)}
    tp = {"wqkv": tq.quantize_int8(w8, 32), "w2": tq.quantize_int4(w4, 16),
          "tok_embedding": tq.quantize_embedding(emb, 16),
          "final_norm": torch.from_numpy(norm)}
    return jp, tp


def test_cast_scales_bit_identical():
    """The port's cast_scales equals rama_tpu's on every quantized leaf --
    dtype bf16 and the same 16 bits for every scale -- keeps q, group size,
    bits and il, and passes other leaves through unchanged."""
    jp, tp = _leaves()
    want, got = jq.cast_scales(jp, jnp.bfloat16), tq.cast_scales(tp, torch.bfloat16)
    assert set(got) == set(want)
    for name in ("wqkv", "w2", "tok_embedding"):
        assert got[name].scales.dtype == torch.bfloat16, name
        assert np.asarray(want[name].scales).dtype == jnp.bfloat16, name
        assert got[name].scales.is_contiguous()
        np.testing.assert_array_equal(_bf16_bits(got[name].scales),
                                      _bf16_bits(want[name].scales))
        assert got[name].q is tp[name].q and got[name].group_size == tp[name].group_size
    assert (got["wqkv"].bits, got["w2"].bits) == (8, 4)
    assert got["final_norm"] is tp["final_norm"]
    # the input dict is not changed
    assert tp["wqkv"].scales.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_scale_plain_paths_upcast_like_jax(dtype):
    """With bf16-stored scales, dequantize, the embedding lookup and
    matmul_plain upcast the scales to fp32 before use, as rama_tpu does:
    equal to JAX's on cast_scales params (int8 and int4 weights)."""
    jp, tp = _leaves(8)
    jp, tp = jq.cast_scales(jp, jnp.bfloat16), tq.cast_scales(tp, torch.bfloat16)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    for name in ("wqkv", "w2"):
        want = np.asarray(jq.dequantize(jp[name], jd).astype(jnp.float32))
        np.testing.assert_array_equal(tq.dequantize(tp[name], td).float().numpy(), want)
        # layer 1 of the stacked weight as a 2-D one
        j1 = jq.QuantizedTensor(q=jp[name].q[1], scales=jp[name].scales[1],
                                group_size=jp[name].group_size, bits=jp[name].bits)
        t1 = tq.QuantizedTensor(q=tp[name].q[1], scales=tp[name].scales[1],
                                group_size=tp[name].group_size, bits=tp[name].bits)
        x = np.random.default_rng(9).standard_normal((3, t1.k_dim)).astype(np.float32)
        want = np.asarray(jq.matmul_xla(jnp.asarray(x, jd), j1, dtype=jd).astype(jnp.float32))
        got = tq.matmul_plain(torch.from_numpy(x).to(td), t1).float().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 if dtype == "float32"
                                   else 2e-2 * np.abs(want).max())
    ids = np.array([[0, 5, 49], [3, 3, 1]])
    np.testing.assert_array_equal(
        tp["tok_embedding"].lookup(torch.from_numpy(ids), td).float().numpy(),
        np.asarray(jp["tok_embedding"].lookup(jnp.asarray(ids), jd).astype(jnp.float32)))
