"""Card-only tests: each hand-written kernel against its plain PyTorch version
on the GPU at small and ragged shapes (plus 7B-sized weights), int8 and
packed int4, and tiny int8 / int4 models' logits through the kernels
against the plain path.
Marked `cuda`; skipped (with the reason) where torch sees no GPU. On the
card (whose Python has no JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: bf16 compared in fp32, max |err| <= 2e-2 * max |ref|; fp32 atol
1e-4 (other summation order)."""

import functools

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())


def _qt(dev, L, k, n, gs, seed, bits=8):
    from rama_tpu_torch.ops.quant import quantize_int4, quantize_int8

    g = torch.Generator().manual_seed(seed)
    quant = quantize_int8 if bits == 8 else quantize_int4
    return quant(torch.randn(L, k, n, generator=g) * 0.05, gs).to(dev)


@pytest.mark.parametrize("m", [1, 3, 8, 33, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n,gs", [(256, 384, 64), (288, 1000, 32), (4096, 4096, 64)])
def test_quant_matmul(dev, m, dtype, k, n, gs):
    from rama_tpu_torch.ops.kernels import quant_matmul as qm

    w = _qt(dev, 2, k, n, gs, seed=k + n)
    x = torch.randn(m, k, device=dev).to(dtype)
    before = qm.launches[8]
    _close(qm.quant_matmul(x, w, 1), qm.quant_matmul_plain(x, w, 1), dtype)
    assert qm.launches[8] == before + 1


def _close_k(got, want, dtype):
    """fp32 over K up to 11008: sums in another order drift by ~sqrt(K) ulps
    of the outputs (measured 1.1e-4 at outputs of ~20), so fp32 is held to
    atol 1e-5 of max |ref|; bf16 as _close."""
    if dtype == torch.float32:
        got, want = got.float(), want.float()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)
    else:
        _close(got, want, dtype)


# int4 group sizes after pick_int4_group_size: 16 (K 256), 2 (K 288, N not a
# multiple of 16), 1 (K 176), 64 (K 4096) and 16 (7B w2, K 11008)
@pytest.mark.parametrize("m", [1, 3, 8, 33, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n,gs", [(256, 384, 64), (288, 1000, 16), (176, 200, 8),
                                    (4096, 4096, 64), (11008, 4096, 64)])
def test_quant_matmul_int4(dev, m, dtype, k, n, gs):
    from rama_tpu_torch.ops.kernels import quant_matmul as qm

    w = _qt(dev, 2, k, n, gs, seed=k + n, bits=4)
    x = torch.randn(m, k, device=dev).to(dtype)
    before = qm.launches[4]
    for layer in (0, 1):
        _close_k(qm.quant_matmul(x, w, layer), qm.quant_matmul_plain(x, w, layer), dtype)
    w2d = type(w)(q=w.q[1].contiguous(), scales=w.scales[1].contiguous(),
                  group_size=w.group_size, bits=4)
    _close_k(qm.quant_matmul(x, w2d), qm.quant_matmul_plain(x, w2d), dtype)
    assert qm.launches[4] == before + 3


def _int4_qt(dev, L, k, n, gs, seed):
    """A stacked int4 weight at group size gs as given (quantize_int4 would
    reduce it for K 288): random nibbles in [-7, 7], scales ~ 1 / (7 sqrt(K))."""
    from rama_tpu_torch.ops.quant import QuantizedTensor

    g = torch.Generator().manual_seed(seed)
    lo, hi = ((torch.randint(0, 15, (L, k // 2, n), dtype=torch.uint8, generator=g) + 9) % 16
              for _ in range(2))
    s = (torch.rand(L, k // gs, n, generator=g) + 0.5) / (7 * k ** 0.5)
    return QuantizedTensor(q=(lo | (hi << 4)).view(torch.int8), scales=s, group_size=gs,
                           bits=4).to(dev)


@pytest.mark.parametrize("m", [33, 47, 100, 129])
@pytest.mark.parametrize("bits,gs", [(8, 32), (8, 16), (8, 8), (4, 16), (4, 48), (4, 32)])
@pytest.mark.parametrize("n", [1000, 384])
def test_quant_matmul_tensor_core_body(dev, m, bits, gs, n):
    """The bf16 tensor-core GEMM at ragged M above MMV_MAX_M (not a multiple of 16), K 288
    (4.5 slabs of 64: the K tail), N 1000 (the masked path: weight rows
    not 16-byte aligned) and 384 (the cp.async path), int8 gs 32 / 16 (and
    8: the masked path) and int4 gs 16 / 48 (several packing blocks a slab,
    or one straddling two; int4 gs 32 is not a divisor of K 288 / 2, so
    quantize_int4 picks gs 2, the masked path): each call one launch on the
    mma body."""
    from rama_tpu_torch.ops.kernels import quant_matmul as qm

    if bits == 4 and gs != 32:
        w = _int4_qt(dev, 2, 288, n, gs, seed=m * 7 + gs + n)
    else:
        w = _qt(dev, 2, 288, n, gs, seed=m * 7 + bits + n, bits=bits)
    x = torch.randn(m, 288, device=dev).to(torch.bfloat16)
    before = dict(qm.launches_by_body)
    got = qm.quant_matmul(x, w, 1)
    assert {b: qm.launches_by_body[b] - before[b] for b in before} == {
        "mmv": 0, "gemv": 0, "mma": 1, "simt": 0}
    _close(got, qm.quant_matmul_plain(x, w, 1), torch.bfloat16)


# (bits, gs, K, N) of the swap-AB body: int8 gs 64 / 32 on the cp.async path
# at N 384 (not a multiple of 256); N 1000 (off the 16 grid: the masked path);
# int8 gs 48 (masked); K of one K block (int8 gs 64 at K 64, int4 gs 16 at K
# 32, N 272); int4 gs 16 (7B w2's group size, cp.async), gs 2 and 48 (masked)
_MMV_CASES = [(8, 64, 256, 384), (8, 32, 288, 1000), (8, 48, 192, 200), (8, 64, 64, 384),
              (4, 16, 256, 384), (4, 2, 288, 1000), (4, 48, 768, 384), (4, 16, 32, 272)]


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 17, 32])
@pytest.mark.parametrize("case", _MMV_CASES)
def test_quant_matmul_swap_ab_body(dev, m, case):
    """The bf16 swap-AB body at decode M (one n8 tile up to 8 rows, two or
    four for a verify round's 17 / 32), layer 0 and the last layer of a
    stacked weight and a 2-D one: one launch on mmv a call, within the bf16
    bar of the plain version, and a rerun bit for bit."""
    from rama_tpu_torch.ops.kernels import quant_matmul as qm

    bits, gs, k, n = case
    seed = m * 13 + gs + k + n
    w = _int4_qt(dev, 3, k, n, gs, seed) if bits == 4 else _qt(dev, 3, k, n, gs, seed)
    assert w.group_size == gs
    w2d = type(w)(q=w.q[2].contiguous(), scales=w.scales[2].contiguous(), group_size=gs,
                  bits=bits)
    x = torch.randn(m, k, device=dev).to(torch.bfloat16)
    for weight, layer in ((w, 0), (w, 2), (w2d, None)):
        before = dict(qm.launches_by_body)
        got = qm.quant_matmul(x, weight, layer)
        assert {b: qm.launches_by_body[b] - before[b] for b in before} == {
            "mmv": 1, "gemv": 0, "mma": 0, "simt": 0}
        assert torch.equal(got, qm.quant_matmul(x, weight, layer))
        _close(got, qm.quant_matmul_plain(x, weight, layer), torch.bfloat16)


@pytest.mark.parametrize("m", [1, 8, 32])
@pytest.mark.parametrize("bits,k,n", [(8, 4096, 12288), (8, 4096, 4096), (4, 4096, 4096),
                                      (4, 11008, 4096), (8, 4096, 32000)])
def test_quant_matmul_swap_ab_splits(dev, m, bits, k, n):
    """7B wqkv, wo, int4 wo and w2 (gs 16) and lm_head through the swap-AB
    body's split-K plan (several splits but lm_head's two) and its last-CTA
    reduce: against the plain version, and twice bit for bit."""
    from rama_tpu_torch.ops.kernels import quant_matmul as qm

    gs = 16 if k == 11008 else 64
    w = (_int4_qt(dev, 1, k, n, gs, seed=m + k) if bits == 4
         else _qt(dev, 1, k, n, gs, seed=m + k + n))
    assert qm.mmv_plan(m, n, k, w.k_block, bits)[2] > 1
    x = torch.randn(m, k, device=dev).to(torch.bfloat16)
    before = qm.launches_by_body["mmv"]
    got = qm.quant_matmul(x, w, 0)
    assert torch.equal(got, qm.quant_matmul(x, w, 0))
    assert qm.launches_by_body["mmv"] == before + 2
    _close(got, qm.quant_matmul_plain(x, w, 0), torch.bfloat16)


@pytest.mark.parametrize("m", [33, 48, 100, 256])
@pytest.mark.parametrize("bits,k,n", [(8, 4096, 4096), (4, 4096, 4096), (4, 11008, 512),
                                      (8, 11008, 512)])
def test_quant_matmul_tensor_core_splits(dev, m, bits, k, n):
    """7B-deep K through the GEMM's split-K plan (several splits at M above
    MMV_MAX_M, one at M 256 for N 512) and the last-CTA reduce: against the
    plain version, twice bit for bit (the split order is fixed)."""
    from rama_tpu_torch.ops.kernels import quant_matmul as qm

    w = _qt(dev, 1, k, n, 64, seed=m + k + bits, bits=bits)
    x = torch.randn(m, k, device=dev).to(torch.bfloat16)
    got = qm.quant_matmul(x, w, 0)
    assert torch.equal(got, qm.quant_matmul(x, w, 0))
    _close(got, qm.quant_matmul_plain(x, w, 0), torch.bfloat16)


def test_quant_matmul_counts_each_body(dev):
    """bf16 counts on mmv up to M = 32 and on mma above; fp32 on gemv up to
    M = 8 and on simt above."""
    from rama_tpu_torch.ops.kernels import quant_matmul as qm

    w = _qt(dev, 1, 256, 384, 64, seed=11)
    before = dict(qm.launches_by_body)
    for m, dtype in ((8, torch.bfloat16), (9, torch.bfloat16), (32, torch.bfloat16),
                     (8, torch.float32), (9, torch.float32), (64, torch.float32),
                     (64, torch.bfloat16)):
        qm.quant_matmul(torch.randn(m, 256, device=dev).to(dtype), w, 0)
    assert {b: qm.launches_by_body[b] - before[b] for b in before} == {
        "mmv": 3, "gemv": 1, "mma": 1, "simt": 2}


def test_quant_matmul_int4_rejects_split_packing_block(dev):
    from rama_tpu_torch.ops.kernels import quant_matmul as qm
    from rama_tpu_torch.ops.quant import QuantizedTensor

    w = QuantizedTensor(q=torch.zeros(24, 64, dtype=torch.int8, device=dev),
                        scales=torch.ones(3, 64, device=dev), group_size=16, bits=4)
    with pytest.raises(ValueError, match="multiple of 32"):
        qm.quant_matmul(torch.randn(1, 48, device=dev), w)


def _ffn_call(ffn, x, w13, w2, layer, body):
    """One K3 call, asserting one launch on `body` in the form form_for picks."""
    bodies, forms = dict(ffn.launches_by_body), dict(ffn.launches_by_form)
    got = ffn.ffn(x, w13, w2, layer)
    form = ffn.form_for(x.shape[0])
    assert {b: ffn.launches_by_body[b] - bodies[b] for b in bodies} == {
        b: int(b == body) for b in bodies}
    assert {f: ffn.launches_by_form[f] - forms[f] for f in forms} == {
        f: int(f == form) for f in forms}
    return got


@pytest.mark.parametrize("m", [1, 3, 8, 9, 17, 32, 40, 64, 65, 128, 256])
@pytest.mark.parametrize("il", [0, 128])
def test_ffn(dev, m, il):
    from rama_tpu_torch.ops.kernels import ffn
    from rama_tpu_torch.ops.quant import QuantizedTensor

    w13 = _qt(dev, 2, 256, 512, 64, seed=1)
    w13 = QuantizedTensor(q=w13.q, scales=w13.scales, group_size=64, il=il)
    w2 = _qt(dev, 2, 256, 192, 64, seed=2)
    x = torch.randn(m, 256, device=dev, dtype=torch.bfloat16)
    _close(_ffn_call(ffn, x, w13, w2, 1, "mma"), ffn.ffn_plain(x, w13, w2, 1), torch.bfloat16)


# (K, H, N), w13 interleave tile, int8 group sizes (w13, w2; quantize_int8
# takes them as given), int4 group sizes (w13, w2; exact, _int4_qt)
_FFN_SHAPES = {"tiny": ((64, 176, 64), 16, (16, 16), (4, 8)),
               "stories15M": ((288, 768, 288), 256, (32, 64), (48, 16)),
               "256": ((256, 256, 192), 128, (64, 64), (16, 16))}


@pytest.mark.parametrize("m", [1, 9, 32, 40, 64, 65, 128, 256])
@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", list(_FFN_SHAPES))
def test_ffn_tensor_core_body(dev, m, interleaved, bits, shape):
    """The bf16 tensor-core body at the tiny shapes (H 176: a ragged last
    tile of units), the stories15M draft's and 256-wide ones, plain and
    interleaved w13, int8 gs 16 / 32 / 64 and int4 gs 4 / 8 / 16 / 48 (the
    masked path where the group size is off the 16 grid), M of one, two,
    four and eight n8 tiles and of two to four 64-row blocks (a short last
    block at 65 and 40 rows of one): one launch on mma a call, in the form
    form_for picks; the same weights with fp32 activations one on simt
    (held to the bf16 bar, as test_ffn_int4: the hidden activation's
    rounding point differs)."""
    from rama_tpu_torch.ops.kernels import ffn
    from rama_tpu_torch.ops.quant import QuantizedTensor

    (k, h, n), tile, gs8, gs4 = _FFN_SHAPES[shape]
    if bits == 8:
        w13, w2 = _qt(dev, 2, k, 2 * h, gs8[0], seed=m + k), _qt(dev, 2, h, n, gs8[1], seed=h)
    else:
        w13, w2 = (_int4_qt(dev, 2, k, 2 * h, gs4[0], seed=m + k),
                   _int4_qt(dev, 2, h, n, gs4[1], seed=h))
    w13 = QuantizedTensor(q=w13.q, scales=w13.scales, group_size=w13.group_size, bits=bits,
                          il=tile if interleaved else 0)
    for dtype, body in ((torch.bfloat16, "mma"), (torch.float32, "simt")):
        x = torch.randn(m, k, device=dev).to(dtype)
        _close(_ffn_call(ffn, x, w13, w2, 1, body), ffn.ffn_plain(x, w13, w2, 1),
               torch.bfloat16)


# (K, H, int4 w2 group size): the 7B FFN and TinyLlama-1.1B's (w2 gs 16 / 32,
# pick_int4_group_size of H)
_FFN_MODELS = {"7B": (4096, 11008, 16), "TinyLlama": (2048, 5632, 32)}


@functools.lru_cache(maxsize=8)
def _model_ffn(dev, model, bits, seed, scales="f32"):
    """One layer of `model`'s FFN (made on the host once for the tests that
    share it)."""
    from rama_tpu_torch.ops.quant import QuantizedTensor

    k, h, gs4 = _FFN_MODELS[model]
    if bits == 8:
        w13, w2 = _qt(dev, 1, k, 2 * h, 64, seed=seed), _qt(dev, 1, h, k, 64, seed=seed + 1)
    else:
        w13, w2 = (_int4_qt(dev, 1, k, 2 * h, 64, seed=seed),
                   _int4_qt(dev, 1, h, k, gs4, seed=seed + 1))
    w13 = QuantizedTensor(q=w13.q, scales=w13.scales, group_size=w13.group_size, bits=bits,
                          il=256)
    if scales == "bf16":
        w13, w2 = _as_bf16_scales(w13)[0], _as_bf16_scales(w2)[0]
    return w13, w2


@pytest.mark.parametrize("m", [1, 8, 32, 40, 64, 65, 128, 256])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("model", list(_FFN_MODELS))
@pytest.mark.parametrize("scales", ["f32", "bf16"])
def test_ffn_tensor_core_splits(dev, m, bits, model, scales):
    """The 7B and TinyLlama FFNs (int4 w13 gs 64, w2 gs 16 / 32, the il 256
    layout; f32 and bf16-stored scales) through the split-K plan of both
    phases and their last-CTA reduces, one to four row blocks: against the
    plain version, and twice bit for bit (the split order is fixed); each
    call one launch on mma in the form form_for picks."""
    from rama_tpu_torch.ops.kernels import ffn

    w13, w2 = _model_ffn(dev, model, bits, 5, scales)
    k, h, _ = _FFN_MODELS[model]
    assert ffn.mma_plan(m, k, h, w13.k_block, True)[2] > 1
    assert ffn.mma_plan(m, h, k, w2.k_block, False)[2] > 1
    x = torch.randn(m, k, device=dev).to(torch.bfloat16)
    got = _ffn_call(ffn, x, w13, w2, 0, "mma")
    assert torch.equal(got, ffn.ffn(x, w13, w2, 0))
    _close(got, ffn.ffn_plain(x, w13, w2, 0), torch.bfloat16)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("model", list(_FFN_MODELS))
@pytest.mark.parametrize("scales", ["f32", "bf16"])
def test_ffn_rows_equal_at_any_m_bit_for_bit(dev, bits, model, scales):
    """A row of K3 has the same bits whatever M computes it: the rows of
    an M = 256 call (the rows form, four row blocks) equal the same rows
    computed in calls of 32 (NT 4) and of 64 (NT 8, one CTA), and those of
    a 100-row call (a short last block) the first 100 of them (the plan's K
    split depends on the shapes alone)."""
    from rama_tpu_torch.ops.kernels import ffn

    w13, w2 = _model_ffn(dev, model, bits, 7, scales)
    x = torch.randn(256, _FFN_MODELS[model][0], device=dev).to(torch.bfloat16)
    got = _ffn_call(ffn, x, w13, w2, 0, "mma")
    for rows in (32, 64):
        parts = torch.cat([ffn.ffn(x[i:i + rows].contiguous(), w13, w2, 0)
                           for i in range(0, 256, rows)])
        assert torch.equal(got, parts), rows
    assert torch.equal(ffn.ffn(x[:100].contiguous(), w13, w2, 0), got[:100])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("scales", [torch.float32, torch.bfloat16])
def test_ffn_forms_get_the_ctas_an_sm_the_plan_counts(dev, bits, scales):
    """Every form of the tensor-core body (1 / 2 / 4 / 8 n8 tiles), both
    phases and load paths, gets the CTAs an SM that mma_ctas_per_sm (and so
    the plan's slots) counts: two (occupancy API)."""
    from rama_tpu_torch.ops.kernels import ffn

    for nt in ffn.FORMS_NT:
        for vec in (True, False):
            for phase_a in (True, False):
                assert ffn.occupancy(nt, bits, vec, phase_a, scales) == \
                    ffn.mma_ctas_per_sm(nt, bits) == 2


@pytest.mark.parametrize("m", [1, 8, 32])
@pytest.mark.parametrize("il", [0, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ffn_int4(dev, m, il, dtype):
    """w13 gs 16 (K 256), w2 gs 16 (H 256); the tiny shapes (K 64, H 176:
    w13 gs 4, w2 gs 1) with the plain layout."""
    from rama_tpu_torch.ops.kernels import ffn
    from rama_tpu_torch.ops.quant import QuantizedTensor

    for k, h, n in ((256, 256, 192), (64, 176, 64)):
        if h % 128 and il:
            continue
        w13 = _qt(dev, 2, k, 2 * h, 64, seed=3, bits=4)
        w13 = QuantizedTensor(q=w13.q, scales=w13.scales, group_size=w13.group_size,
                              bits=4, il=il)
        w2 = _qt(dev, 2, h, n, 64, seed=4, bits=4)
        x = torch.randn(m, k, device=dev).to(dtype)
        before = ffn.launches[4]
        _close(ffn.ffn(x, w13, w2, 1), ffn.ffn_plain(x, w13, w2, 1), torch.bfloat16)
        assert ffn.launches[4] == before + 1


# -- bf16-stored weight scales (cast_scales) ---------------------------------


def _as_bf16_scales(w):
    """(w with bf16-stored scales, the same weight with those scales as f32:
    bf16 -> f32 is exact, so a body must give both the same bits)."""
    from rama_tpu_torch.ops.quant import QuantizedTensor, cast_scales

    wb = cast_scales({"w": w}, torch.bfloat16)["w"]
    wf = QuantizedTensor(q=wb.q, scales=wb.scales.float(), group_size=wb.group_size,
                         bits=wb.bits, il=wb.il)
    return wb, wf


# (bits, gs, K, N): the cp.async path (int8 gs 64, int4 gs 16 at N 384), the
# masked path (int8 gs 32 at N 1000, int4 gs 2 at K 288 / N 1000), int4 gs 48
# (a packing block straddling slabs), and 7B-deep K through the split plans
# (int8 wo gs 64, int4 w2 gs 16)
_S16_CASES = [(8, 64, 256, 384), (8, 32, 288, 1000), (4, 16, 256, 384), (4, 2, 288, 1000),
              (4, 48, 768, 384), (8, 64, 4096, 4096), (4, 16, 11008, 512)]
# (M, activation dtype) of each quant_matmul body: the swap-AB body (bf16 M
# <= 32), the GEMM (bf16 M > 32), the fp32 GEMV (M <= 8), the fp32 tiled GEMM
_S16_BODIES = {"mmv": ((1, torch.bfloat16), (8, torch.bfloat16), (17, torch.bfloat16),
                       (32, torch.bfloat16)),
               "mma": ((33, torch.bfloat16), (256, torch.bfloat16)),
               "gemv": ((1, torch.float32), (8, torch.float32)),
               "simt": ((9, torch.float32), (64, torch.float32))}


@pytest.mark.parametrize("body", list(_S16_BODIES))
@pytest.mark.parametrize("case", _S16_CASES)
def test_quant_matmul_bf16_scales_equal_f32_scales_bit_for_bit(dev, body, case):
    """Every quant_matmul body with bf16-stored scales: one launch on the
    body body_for picks, counted as a bf16-scale launch, equal bit for bit
    to the same body fed scales.float() (the plan depends on the shapes
    alone), within the bar of the plain version, at layer 0 and layer 2 of
    a stacked weight (whose bf16 scales start 2 * stride(0) * 2 bytes in),
    and at layer 2 equal to the 2-D slice of that layer: a stacked
    weight's launch reads its own layer's scales."""
    from rama_tpu_torch.ops.kernels import quant_matmul as qm
    from rama_tpu_torch.ops.quant import QuantizedTensor

    bits, gs, k, n = case
    seed = k + n + gs + bits
    w = _int4_qt(dev, 3, k, n, gs, seed) if bits == 4 else _qt(dev, 3, k, n, gs, seed)
    assert w.group_size == gs
    wb, wf = _as_bf16_scales(w)
    w2d = QuantizedTensor(q=wb.q[2].contiguous(), scales=wb.scales[2].contiguous(),
                          group_size=gs, bits=bits)
    for m, dtype in _S16_BODIES[body]:
        x = torch.randn(m, k, device=dev).to(dtype)
        for layer in (0, 2):
            before, scales = dict(qm.launches_by_body), dict(qm.launches_by_scale)
            got = qm.quant_matmul(x, wb, layer)
            assert {b: qm.launches_by_body[b] - before[b] for b in before} == {
                b: int(b == body) for b in before}
            assert {s: qm.launches_by_scale[s] - scales[s] for s in scales} == {
                "f32": 0, "bf16": 1}
            assert torch.equal(got, qm.quant_matmul(x, wf, layer))
            _close_k(got, qm.quant_matmul_plain(x, wb, layer), dtype)
        assert torch.equal(got, qm.quant_matmul(x, w2d))


@pytest.mark.parametrize("m", [1, 9, 32])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", list(_FFN_SHAPES) + ["7B"])
def test_ffn_bf16_scales_equal_f32_scales_bit_for_bit(dev, m, bits, shape):
    """K3 / K3' with bf16-stored scales on both bodies (bf16: the
    tensor-core body, both phases; fp32: the CUDA-core GEMVs, at the small
    shapes), the tiny (masked), stories15M and 256-wide shapes and the 7B
    one (the split plans; il 256): bit for bit the same bodies fed
    scales.float(), at layer 0 and layer 1, within the bar of the plain
    version, counted as bf16-scale calls."""
    from rama_tpu_torch.ops.kernels import ffn
    from rama_tpu_torch.ops.quant import QuantizedTensor

    if shape == "7B":
        (k, h, n), tile, gs8, gs4 = (4096, 11008, 4096), 256, (64, 64), (64, 16)
    else:
        (k, h, n), tile, gs8, gs4 = _FFN_SHAPES[shape]
    if bits == 8:
        w13, w2 = _qt(dev, 2, k, 2 * h, gs8[0], seed=m + k), _qt(dev, 2, h, n, gs8[1], seed=h)
    else:
        w13, w2 = (_int4_qt(dev, 2, k, 2 * h, gs4[0], seed=m + k),
                   _int4_qt(dev, 2, h, n, gs4[1], seed=h))
    w13 = QuantizedTensor(q=w13.q, scales=w13.scales, group_size=w13.group_size, bits=bits,
                          il=tile)
    (b13, f13), (b2, f2) = _as_bf16_scales(w13), _as_bf16_scales(w2)
    assert b13.il == tile
    dtypes = (torch.bfloat16,) if shape == "7B" else (torch.bfloat16, torch.float32)
    for dtype in dtypes:
        x = torch.randn(m, k, device=dev).to(dtype)
        for layer in (0, 1):
            scales = dict(ffn.launches_by_scale)
            got = ffn.ffn(x, b13, b2, layer)
            assert {s: ffn.launches_by_scale[s] - scales[s] for s in scales} == {
                "f32": 0, "bf16": 1}
            assert torch.equal(got, ffn.ffn(x, f13, f2, layer))
            _close(got, ffn.ffn_plain(x, b13, b2, layer), torch.bfloat16)


def test_wrappers_refuse_fp16_scales(dev):
    """K1 / K2 and K3 take f32 or bf16 scales and raise on any other scale
    dtype; they never upcast the scales into a temporary copy."""
    from rama_tpu_torch.ops.kernels import ffn
    from rama_tpu_torch.ops.kernels import quant_matmul as qm
    from rama_tpu_torch.ops.quant import cast_scales

    w = cast_scales({"w": _qt(dev, 2, 256, 384, 64, seed=3)}, torch.float16)["w"]
    for m, dtype in ((1, torch.bfloat16), (64, torch.bfloat16), (1, torch.float32)):
        with pytest.raises(ValueError, match="float32 or bfloat16 scales"):
            qm.quant_matmul(torch.randn(m, 256, device=dev).to(dtype), w, 0)
    w13 = cast_scales({"w": _qt(dev, 2, 256, 512, 64, seed=1)}, torch.float16)["w"]
    w2 = _qt(dev, 2, 256, 192, 64, seed=2)
    with pytest.raises(ValueError, match="float32 or bfloat16 scales"):
        ffn.ffn(torch.randn(8, 256, device=dev).to(torch.bfloat16), w13, w2, 1)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attn_block_full_form_with_bf16_scale_wo(dev, bits, dtype):
    """K14's full form with a bf16-scale wo (K1 applies it): bit for bit the
    same form with wo's scales as f32, within the bar of its plain version."""
    from rama_tpu_torch.ops.kernels import attn_block as ab

    b, nkv, rep, s = 8, 2, 2, 200
    q, kn, vn, cos, sin, before = _ab_case(dev, b, nkv, rep, s, dtype, seed=41)
    wb, wf = _as_bf16_scales(_qt(dev, 2, nkv * rep * 128, 384, 64, seed=9, bits=bits))
    pos = torch.tensor([0, 63, 64, 65, 127, 128, 150, 199], dtype=torch.int32, device=dev)
    outs = []
    for wo, plain in ((wb, False), (wf, False), (wb, True)):
        caches = [t.clone() for t in before]
        outs.append(_ab_call(ab, bits, wo, (q, kn, vn, cos, sin), caches, pos, 1, plain=plain))
    assert torch.equal(outs[0], outs[1])
    _close_k(outs[0], outs[2], dtype)


def test_tiny_model_bf16_scale_logits_kernels_equal_plain(dev):
    """The tiny int4 model with bf16-stored scales (cast_scales after
    fusing) in fp32: kernel-path logits equal the plain path's (atol 1e-3),
    greedy continuations agree."""
    _check_tiny_model(dev, bits=4, scale_dtype=torch.bfloat16)


@pytest.mark.parametrize("nh,nkv,hd", [(4, 4, 128), (4, 2, 48), (8, 1, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention(dev, nh, nkv, hd, dtype):
    from rama_tpu_torch.ops.kernels import decode_attention as da

    S = 256
    k = torch.randn(2, 4, nkv, S, hd, device=dev).to(dtype)
    v = torch.randn(2, 4, nkv, S, hd, device=dev).to(dtype)
    q = torch.randn(4, nh, hd, device=dev).to(dtype)
    pos = torch.tensor([0, 63, 64, S - 1], dtype=torch.int32, device=dev)
    for layer in (0, 1):
        _close(da.decode_attention(q, k, v, pos, layer),
               da.decode_attention_plain(q, k, v, pos, layer), dtype)


@pytest.mark.parametrize("nh,nkv,t,plen", [(4, 4, 16, [16, 3]), (4, 2, 40, [40, 17]),
                                           (32, 32, 64, [64, 1]),
                                           # groups 3 / 5 / 6 / 7 / 9 / 12 / 65 ("gqa"
                                           # form), plen on position-tile edges
                                           (6, 2, 40, [40, 21]), (10, 2, 33, [33, 12]),
                                           (12, 2, 20, [20, 10]), (14, 2, 64, [64, 9]),
                                           (9, 1, 17, [17, 7]), (24, 2, 30, [30, 5]),
                                           (65, 1, 9, [9, 1])])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefill_attention(dev, nh, nkv, t, plen, dtype):
    from rama_tpu_torch.ops.kernels import prefill_attention as pa

    hd = 128 if nh == 32 else 64
    q = torch.randn(2, t, nh, hd, device=dev).to(dtype)
    k = torch.randn(2, nkv, t + 8, hd, device=dev).to(dtype)
    v = torch.randn(2, nkv, t + 8, hd, device=dev).to(dtype)
    pl = torch.tensor(plen, dtype=torch.int32, device=dev)
    body = "mma" if dtype == torch.bfloat16 else "simt"
    form = "div64" if 64 % (nh // nkv) == 0 else "gqa"
    before, forms = dict(pa.launches_by_body), dict(pa.launches_by_form)
    _close(pa.prefill_attention(q, k, v, pl), pa.prefill_attention_plain(q, k, v, pl), dtype)
    assert {b: pa.launches_by_body[b] - before[b] for b in before} == {
        b: int(b == body) for b in before}
    assert {f: pa.launches_by_form[f] - forms[f] for f in forms} == {
        f: int(f == form) for f in forms}


@pytest.mark.parametrize("hd", [48, 64, 128])
@pytest.mark.parametrize("t", [1, 17, 64, 65, 200])
@pytest.mark.parametrize("rep", [1, 2, 4, 3, 5, 6, 7, 9, 12, 33, 63, 65])
def test_prefill_attention_tensor_core_body(dev, hd, t, rep):
    """The bf16 tensor-core body at its head dims: T of one row, ragged and
    on 64-row tile edges; plen 1, on a 64-key tile edge (64), mid-tile, T;
    GQA rep 1, 2, 4 (the "div64" form) and 3, 5, 6, 7, 9, 12, 33, 63, 65
    (the "gqa" form: idle rows, a partial m16 tile, a warp's 16 rows over
    16 heads at one position each at rep 33 / 63, rep 65 in two head
    slices). Each call launches the mma body once, in its form."""
    from rama_tpu_torch.ops.kernels import prefill_attention as pa

    nkv = 2
    nh = nkv * rep
    g = torch.Generator().manual_seed(hd * 1000 + t * 10 + rep)
    q = torch.randn(4, t, nh, hd, generator=g).to(dev, torch.bfloat16)
    k = torch.randn(4, nkv, t + 3, hd, generator=g).to(dev, torch.bfloat16)
    v = torch.randn(4, nkv, t + 3, hd, generator=g).to(dev, torch.bfloat16)
    plen = [1, min(64, t), max(1, (t * 2) // 3), t]
    pl = torch.tensor(plen, dtype=torch.int32, device=dev)
    form = "div64" if 64 % rep == 0 else "gqa"
    before, forms = dict(pa.launches_by_body), dict(pa.launches_by_form)
    got = pa.prefill_attention(q, k, v, pl)
    assert pa.launches_by_body["mma"] == before["mma"] + 1
    assert pa.launches_by_body["simt"] == before["simt"]
    assert {f: pa.launches_by_form[f] - forms[f] for f in forms} == {
        f: int(f == form) for f in forms}
    _close(got, pa.prefill_attention_plain(q, k, v, pl), torch.bfloat16)


def test_tiny_model_logits_kernels_equal_plain(dev):
    """int8 tiny model in fp32 on the card: prefill and decode logits through
    the kernels equal the plain path's (atol 1e-3: fp32 sums in another
    order, through three layers), and the greedy continuations agree."""
    _check_tiny_model(dev, bits=8)


def test_tiny_model_int4_logits_kernels_equal_plain(dev):
    """The same with int4 layer weights (gs 4 and 1 after the tiny shapes'
    group size reduction; the classifier stays int8)."""
    _check_tiny_model(dev, bits=4)


def _check_tiny_model(dev, bits, scale_dtype=None):
    import numpy as np

    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models.llama import (KVCache, decode_step, fuse_params, prefill,
                                             quantize_params)

    cfg = ModelConfig(dim=64, hidden_dim=176, n_layers=3, n_heads=4, n_kv_heads=2,
                      vocab_size=128, seq_len=48)
    rng = np.random.default_rng(7)
    L, D, H, V = 3, 64, 176, 128
    p = {n: (rng.standard_normal(s) * 0.05).astype(np.float32) for n, s in {
        "tok_embedding": (V, D), "wq": (L, D, D), "wk": (L, D, 32), "wv": (L, D, 32),
        "wo": (L, D, D), "w1": (L, D, H), "w2": (L, H, D), "w3": (L, D, H)}.items()}
    p.update(attn_norm=np.ones((L, D), np.float32), ffn_norm=np.ones((L, D), np.float32),
             final_norm=np.ones(D, np.float32))
    params = fuse_params(quantize_params(cfg, p, bits=bits, group_size=16,
                                         dtype=torch.float32, device=dev), cfg)
    if scale_dtype is not None:
        from rama_tpu_torch.ops.quant import cast_scales

        params = cast_scales(params, scale_dtype)
        assert params["w2"].scales.dtype == params["wcls"].scales.dtype == scale_dtype
    toks = torch.tensor([[1, 3, 42, 7, 11]], device=dev)
    caches = [KVCache.create(cfg, 1, 24, dtype=torch.float32, device=dev) for _ in range(2)]
    lk, _ = prefill(params, cfg, toks, caches[0], last_only=True)
    lp, _ = prefill(params, cfg, toks, caches[1], last_only=True, plain=True)
    torch.testing.assert_close(lk, lp, atol=1e-3, rtol=0)
    tok_k = tok_p = torch.argmax(lp[:, -1], dim=-1)
    for pos in range(5, 16):
        p_t = torch.tensor([pos], device=dev)
        lk, _ = decode_step(params, cfg, tok_k, p_t, caches[0])
        lp, _ = decode_step(params, cfg, tok_p, p_t, caches[1], plain=True)
        torch.testing.assert_close(lk, lp, atol=1e-3, rtol=0)
        tok_k, tok_p = torch.argmax(lk, dim=-1), torch.argmax(lp, dim=-1)
        assert tok_k.item() == tok_p.item()


def test_engine_on_card_matches_cpu_engine(dev):
    """The slim engine on the card (every kernel, decode ticks of 4, a prompt
    truncated to fill the cache, a stream that runs to max_len, a sampled
    stream) emits the same streams as the engine on the CPU."""
    _check_engine_on_card(dev, kv_quant=None)


def test_engine_int8_cache_on_card_matches_cpu_engine(dev):
    """The same on an int8 KV cache: admission through K8, decode through
    K6 + K7 on the card, their plain versions on the CPU."""
    _check_engine_on_card(dev, kv_quant="int8")


def _check_engine_on_card(dev, kv_quant, spec_tick=0, paged=False):
    import numpy as np

    from rama_tpu_torch.config import EngineConfig, ModelConfig
    from rama_tpu_torch.models.llama import quantize_params
    from rama_tpu_torch.runtime.engine import Engine, Request
    from rama_tpu_torch.tokenizer import Tokenizer

    cfg = ModelConfig(dim=64, hidden_dim=176, n_layers=2, n_heads=4, n_kv_heads=2,
                      vocab_size=128, seq_len=64)
    rng = np.random.default_rng(3)
    L, D, H, V = 2, 64, 176, 128
    p = {n: (rng.standard_normal(s) * 0.1).astype(np.float32) for n, s in {
        "tok_embedding": (V, D), "wq": (L, D, D), "wk": (L, D, 32), "wv": (L, D, 32),
        "wo": (L, D, D), "w1": (L, D, H), "w2": (L, H, D), "w3": (L, D, H)}.items()}
    p.update(attn_norm=np.ones((L, D), np.float32), ffn_norm=np.ones((L, D), np.float32),
             final_norm=np.ones(D, np.float32))
    vocab = ["<unk>", "<s>", "</s>"] + [chr(97 + i % 26) + str(i // 26) * (i >= 26)
                                        for i in range(V - 3)]
    tok = Tokenizer(vocab, [0.0] * V)
    outs = []
    for device, spec, pg in (("cpu", 0, False), (dev, spec_tick, paged), ("cpu", spec_tick, False)):
        eng = Engine(cfg, quantize_params(cfg, p, group_size=16, dtype=torch.float32,
                                          device=device),
                     tok, EngineConfig(max_batch_size=4, decode_tick=4, kv_quant=kv_quant,
                                       spec_tick=spec, spec_rounds=2, paged_kv=pg,
                                       kv_page_size=16))
        reqs = [Request(prompt="ab" * 40, steps=8, temperature=0.0),
                Request(prompt="abc", steps=100, temperature=0.0, stop_at_eos=False),
                Request(prompt="zq", steps=20, temperature=0.9)]
        eng.start()
        try:
            for r in reqs:
                eng.submit(r)
            got = []
            for r in reqs:
                toks = []
                while (t := r.queue.get(timeout=120)) is not None:
                    toks.append(t)
                got.append(toks)
        finally:
            eng.stop()
        assert all(r.error is None for r in reqs)
        assert len(got[1]) == 64 - 4   # ran to the end of the cache
        outs.append(got)
    assert outs[0] == outs[1] == outs[2]


def _kv_rows(dev, shape, dtype, seed):
    """Rows of mixed magnitude with a zero row and a row of .5 ties."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * (torch.rand(shape[:-1] + (1,), generator=g) * 30
                                           + 1e-3)
    flat = x.view(-1, shape[-1])
    flat[0] = 0
    flat[1] = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5, 4.5]).repeat(
        shape[-1] // 8)
    return x.to(dev).to(dtype)


def _q8_cache(dev, L, B, nkv, S, hd, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(-127, 128, (L, B, nkv, S, hd), dtype=torch.int8, generator=g).to(dev)
            for _ in range(2)] + [torch.rand((L, B, nkv, S), generator=g).to(dev)
                                  for _ in range(2)]


@pytest.mark.parametrize("nkv,S,hd", [(2, 48, 16), (6, 64, 48), (4, 256, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_write_kv_rows_q8(dev, nkv, S, hd, dtype):
    """K6 equals its plain version exactly: int8 bytes and f32 scales, with
    a zero row, .5 ties and a finished slot's overshoot past the cache end."""
    from rama_tpu_torch.ops.kernels import kv_write as kw

    got = _q8_cache(dev, 3, 5, nkv, S, hd, seed=S)
    want = [t.clone() for t in got]
    pos = torch.tensor([0, 31, 32, S - 1, S + 3], dtype=torch.int32, device=dev)
    before = kw.launches["write_kv_rows_q8"]
    for layer in (0, 2):
        k, v = (_kv_rows(dev, (5, nkv, hd), dtype, seed=layer + i) for i in (0, 7))
        kw.write_kv_rows_q8(*got, k, v, pos, layer)
        kw.write_kv_rows_q8_plain(*want, k, v, pos, layer)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert kw.launches["write_kv_rows_q8"] == before + 2


@pytest.mark.parametrize("L,nkv,T,t_ins,hd", [(2, 2, 16, 16, 16), (3, 6, 40, 33, 48),
                                              (2, 4, 64, 64, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_write_kv_strips_q8(dev, L, nkv, T, t_ins, hd, dtype):
    """K8 equals its plain version exactly, slots out of order and a
    duplicate slot carrying an identical strip."""
    from rama_tpu_torch.ops.kernels import kv_write as kw

    got = _q8_cache(dev, L, 6, nkv, 64, hd, seed=T)
    want = [t.clone() for t in got]
    k, v = (_kv_rows(dev, (L, 4, nkv, T, hd), dtype, seed=i) for i in (1, 2))
    k[:, 3], v[:, 3] = k[:, 2], v[:, 2]
    slots = torch.tensor([4, 0, 2, 2], dtype=torch.int32, device=dev)
    before = kw.launches["write_kv_strips_q8"]
    kw.write_kv_strips_q8(*got, k, v, slots, t_ins)
    kw.write_kv_strips_q8_plain(*want, k, v, slots, t_ins)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert kw.launches["write_kv_strips_q8"] == before + 1


# (S, G forced on the walk body or None for split_plan's): one tile a split at
# S 256, several at S 1024 and 4096, and a G that leaves a ragged last split
WALK_CASES = [(256, None), (1024, None), (1024, 2), (4096, None), (4096, 3)]


def _q8_forms(tiles):
    """The int8 forms (decode, chunk, paged decode, paged chunk) as their
    wrappers launch them (tiles None), or the same launches over splits of
    `tiles` tiles: G forced through the private launch, as chip_smoke's
    sweep forces it (no wrapper takes G, and a forced launch bumps no dense
    wrapper's count)."""
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import paged_attention as pa

    if tiles is None:
        return (da.decode_attention_q8, da.chunk_attention_q8, pa.paged_decode_attention_q8,
                pa.paged_chunk_attention_q8)

    def decode(q, *caches_pos_layer):
        *c, pos, layer = caches_pos_layer
        return da._launch(q[:, None], tuple(c), pos, layer, "decode_attention_q8", tiles)[:, 0]

    def chunk(q, *caches_pos_layer):
        *c, pos0, layer = caches_pos_layer
        return da._launch(q, tuple(c), pos0, layer, "chunk_attention_q8", tiles)

    def paged_decode(q, *pools_pos_tables_layer):
        *c, pos, tables, layer = pools_pos_tables_layer
        return pa._launch(q[:, None], tuple(c), pos, tables, layer, "paged_decode_attention_q8",
                          tiles)[:, 0]

    def paged_chunk(q, *pools_pos_tables_layer):
        *c, pos0, tables, layer = pools_pos_tables_layer
        return pa._launch(q, tuple(c), pos0, tables, layer, "paged_chunk_attention_q8", tiles)

    return decode, chunk, paged_decode, paged_chunk


@pytest.mark.parametrize("nh,nkv,hd", [(4, 4, 128), (4, 2, 48), (8, 2, 16), (8, 1, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,tiles", WALK_CASES)
def test_decode_attention_q8(dev, nh, nkv, hd, dtype, S, tiles):
    """K7 against its plain version: positions on tile edges and S - 1,
    splits of one tile and of several (bf16 at hd 48 / 128: the walk body)."""
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kw

    decode = _q8_forms(tiles)[0]
    k8, ks = kw.kv_quant_rows(torch.randn(2, 5, nkv, S, hd, device=dev))
    v8, vs = kw.kv_quant_rows(torch.randn(2, 5, nkv, S, hd, device=dev))
    q = torch.randn(5, nh, hd, device=dev).to(dtype)
    pos = torch.tensor([0, 63, 64, S // 2 + 1, S - 1], dtype=torch.int32, device=dev)
    before = da.launches_q8
    for layer in (0, 1):
        _close(decode(q, k8, v8, ks, vs, pos, layer),
               da.decode_attention_q8_plain(q, k8, v8, ks, vs, pos, layer), dtype)
    assert da.launches_q8 == before + 2 * (tiles is None)


def test_tiny_model_int8_cache_logits_kernels_equal_plain(dev):
    """The tiny int8 model on a QuantKVCache, fp32 on the card: prefill
    (dequantized attention) and decode (K6 + K7) logits through the kernels
    against the plain path (atol 1e-3, as the dense cache's test), greedy
    chains equal."""
    import numpy as np

    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models.llama import (QuantKVCache, decode_step, fuse_params, prefill,
                                             quantize_params)

    cfg = ModelConfig(dim=64, hidden_dim=176, n_layers=3, n_heads=4, n_kv_heads=2,
                      vocab_size=128, seq_len=48)
    rng = np.random.default_rng(8)
    L, D, H, V = 3, 64, 176, 128
    p = {n: (rng.standard_normal(s) * 0.05).astype(np.float32) for n, s in {
        "tok_embedding": (V, D), "wq": (L, D, D), "wk": (L, D, 32), "wv": (L, D, 32),
        "wo": (L, D, D), "w1": (L, D, H), "w2": (L, H, D), "w3": (L, D, H)}.items()}
    p.update(attn_norm=np.ones((L, D), np.float32), ffn_norm=np.ones((L, D), np.float32),
             final_norm=np.ones(D, np.float32))
    params = fuse_params(quantize_params(cfg, p, bits=8, group_size=16,
                                         dtype=torch.float32, device=dev), cfg)
    toks = torch.tensor([[1, 3, 42, 7, 11]], device=dev)
    caches = [QuantKVCache.create(cfg, 1, 24, device=dev) for _ in range(2)]
    lk, _ = prefill(params, cfg, toks, caches[0], last_only=True)
    lp, _ = prefill(params, cfg, toks, caches[1], last_only=True, plain=True)
    torch.testing.assert_close(lk, lp, atol=1e-3, rtol=0)
    tok_k = tok_p = torch.argmax(lp[:, -1], dim=-1)
    for pos in range(5, 16):
        p_t = torch.tensor([pos], device=dev)
        lk, _ = decode_step(params, cfg, tok_k, p_t, caches[0])
        lp, _ = decode_step(params, cfg, tok_p, p_t, caches[1], plain=True)
        torch.testing.assert_close(lk, lp, atol=1e-3, rtol=0)
        tok_k, tok_p = torch.argmax(lk, dim=-1), torch.argmax(lp, dim=-1)
        assert tok_k.item() == tok_p.item()


def _chunk_starts(S, t, dev):
    """Ragged chunk starts: 0, straddling the 64-row split, one running past
    S, the last chunk that fits."""
    return torch.tensor([0, 61, S - 2, S - t], dtype=torch.int32, device=dev)


@pytest.mark.parametrize("nh,nkv,hd,t", [(4, 4, 128, 4), (4, 2, 48, 4), (8, 2, 16, 2),
                                         (4, 4, 128, 8), (8, 1, 64, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chunk_attention(dev, nh, nkv, hd, t, dtype):
    """K10 on a bf16 / f32 cache against its plain version."""
    from rama_tpu_torch.ops.kernels import decode_attention as da

    S = 256
    k = torch.randn(2, 4, nkv, S, hd, device=dev).to(dtype)
    v = torch.randn(2, 4, nkv, S, hd, device=dev).to(dtype)
    q = torch.randn(4, t, nh, hd, device=dev).to(dtype)
    pos0 = _chunk_starts(S, t, dev)
    before = da.launches_chunk
    for layer in (0, 1):
        _close(da.chunk_attention(q, k, v, pos0, layer),
               da.chunk_attention_plain(q, k, v, pos0, layer), dtype)
    assert da.launches_chunk == before + 2


@pytest.mark.parametrize("nh,nkv,hd,t", [(4, 4, 128, 4), (4, 2, 48, 4), (8, 2, 16, 2),
                                         (4, 4, 128, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chunk_attention_q8(dev, nh, nkv, hd, t, dtype):
    """K10 on an int8 cache against its plain version."""
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kw

    S = 256
    k8, ks = kw.kv_quant_rows(torch.randn(2, 4, nkv, S, hd, device=dev))
    v8, vs = kw.kv_quant_rows(torch.randn(2, 4, nkv, S, hd, device=dev))
    q = torch.randn(4, t, nh, hd, device=dev).to(dtype)
    pos0 = _chunk_starts(S, t, dev)
    before = da.launches_chunk_q8
    for layer in (0, 1):
        _close(da.chunk_attention_q8(q, k8, v8, ks, vs, pos0, layer),
               da.chunk_attention_q8_plain(q, k8, v8, ks, vs, pos0, layer), dtype)
    assert da.launches_chunk_q8 == before + 2


def test_chunk_attention_refuses_too_many_rows(dev):
    """No T * GQA group is too many query rows a kv head any more: 3 x rep
    4 = 12 rows (past the 8 a CTA of the SIMT body holds, so two row
    groups) are served and match the plain version; what the wrapper still
    refuses, naming it, is a group that does not divide the heads."""
    from rama_tpu_torch.ops.kernels import decode_attention as da

    k = torch.randn(1, 1, 2, 16, 16, device=dev)
    v = torch.randn(1, 1, 2, 16, 16, device=dev)
    q = torch.randn(1, 3, 8, 16, device=dev)
    pos0 = torch.tensor([5], dtype=torch.int32, device=dev)
    _close(da.chunk_attention(q, k, v, pos0, 0), da.chunk_attention_plain(q, k, v, pos0, 0),
           torch.float32)
    with pytest.raises(ValueError, match="GQA group 6/4"):
        da.chunk_attention(torch.zeros(1, 3, 6, 16, device=dev), torch.zeros(1, 1, 4, 16, 16,
                           device=dev), torch.zeros(1, 1, 4, 16, 16, device=dev), pos0, 0)


# (T, rep): the row forms of the tensor-core bodies: 8 (rep 8 x T 1), 16
# (x 2), 32 (x 4), 64 (x 8) rows; rep 3 x T 3 = 9 rows, a partial m16
# block; rep 16 x T 1 / 8 = 16 / 128 rows (two row groups of 64); rep 12 x
# T 4 = 48 rows (the 64-row form, part empty); rep 1 x T 8 the 8-row form
GQA_FORMS = [(1, 8), (2, 8), (4, 8), (8, 8), (3, 3), (1, 16), (8, 16), (4, 12), (8, 1)]


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("t,rep", GQA_FORMS)
@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_gqa_row_forms_match_plain(dev, hd, t, rep, q8, paged):
    """Each row form of the tensor-core bodies (bf16; the walk body over
    int8) against the plain version, dense (S 200) and paged (128-row
    pages, shuffled, a stale entry): starts straddling a 64-row split,
    reaching and (dense) running past S; every launch on its body and in
    the form `row_form` names (as the C entry reports it), a rerun bit for
    bit, and the occupancy API's shared bytes those of that form."""
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kw
    from rama_tpu_torch.ops.kernels import paged_attention as pa

    nkv, S = 2, 200
    pos = [0, 60, 61, S - 2, S - t]
    if paged:
        tables, npages = _paged_setup(dev, 2, len(pos), nkv, hd, 128, 2, pos, t, seed=t + rep)
        shape = (2, npages, nkv, 128, hd)
    else:
        shape = (2, len(pos), nkv, S, hd)
    k, v = torch.randn(shape, device=dev), torch.randn(shape, device=dev)
    if q8:
        (k8, ks), (v8, vs) = kw.kv_quant_rows(k), kw.kv_quant_rows(v)
        caches = (k8, v8, ks, vs)
    else:
        caches = (k.to(torch.bfloat16), v.to(torch.bfloat16))
    q = torch.randn(len(pos), t, nkv * rep, hd, device=dev).to(torch.bfloat16)
    p0 = torch.tensor(pos, dtype=torch.int32, device=dev)
    sfx = "_q8" if q8 else ""
    if paged:
        kernel = getattr(pa, f"paged_chunk_attention{sfx}")
        plain = getattr(pa, f"paged_chunk_attention{sfx}_plain")
        args, counts, forms = (p0, tables), pa.launches_by_body, pa.launches_by_form
    else:
        kernel = getattr(da, f"chunk_attention{sfx}")
        plain = getattr(da, f"chunk_attention{sfx}_plain")
        args, counts, forms = (p0,), da.launches_by_body, da.launches_by_form
    body = "walk" if q8 else "mma"
    form, _ = da.row_form(t, rep)
    before, before_form = dict(counts), dict(forms[body])
    for layer in (0, 1):
        got = kernel(q, *caches, *args, layer)
        _close(got, plain(q, *caches, *args, layer), torch.bfloat16)
        assert torch.equal(got, kernel(q, *caches, *args, layer))
    assert counts == {**before, body: before[body] + 4}
    assert forms[body] == {**before_form, form: before_form[form] + 4}
    assert da.occupancy(t, nkv * rep, nkv, hd, q8)["smem_bytes"] == da.form_smem(body, form, hd)


@pytest.mark.parametrize("hd", [48, 64, 128])
@pytest.mark.parametrize("q8", [False, True])
def test_rep1_chunks_keep_the_8_row_form(dev, hd, q8):
    """A rep-1 launch at T <= 8 (every Llama-2 shape) runs the 8-row form:
    the C entry reports it launched that form, dense and paged, and the
    occupancy API reports the 8-row form's shared bytes (38,400 at hd 128
    on the bf16 cache) and its residency, whatever T."""
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kw
    from rama_tpu_torch.ops.kernels import paged_attention as pa

    body = "walk" if q8 else "mma"
    one = da.occupancy(1, 32, 32, hd, q8)
    assert one["smem_bytes"] == da.form_smem(body, 8, hd)
    nkv, S, ps = 4, 256, 128
    k, v = torch.randn(2, 3, nkv, S, hd, device=dev), torch.randn(2, 3, nkv, S, hd, device=dev)
    if q8:
        (k8, ks), (v8, vs) = kw.kv_quant_rows(k), kw.kv_quant_rows(v)
        caches = (k8, v8, ks, vs)
    else:
        caches = (k.to(torch.bfloat16), v.to(torch.bfloat16))
    # the same rows as a pool of 2 pages a slot, slot b's page j at b * 2 + j
    pool = tuple(c.unflatten(3, (2, ps)).transpose(2, 3).reshape(2, 6, nkv, ps, *c.shape[4:])
                 for c in caches)
    tables = torch.arange(6, dtype=torch.int32, device=dev).reshape(3, 2)
    p0 = torch.tensor([0, 100, S - 9], dtype=torch.int32, device=dev)
    for t in (1, 2, 4, 8):
        assert da.row_form(t, 1) == (8, 1)
        assert da.occupancy(t, 32, 32, hd, q8) == one
        q = torch.randn(3, t, nkv, hd, device=dev).to(torch.bfloat16)
        for mod, fn, extra, cs in (
                (da, da.chunk_attention_q8 if q8 else da.chunk_attention, (), caches),
                (pa, pa.paged_chunk_attention_q8 if q8 else pa.paged_chunk_attention,
                 (tables,), pool)):
            before = {b: dict(f) for b, f in mod.launches_by_form.items()}
            fn(q, *cs, p0, *extra, 1)
            ran = {(b, f): n - before[b][f] for b, forms in mod.launches_by_form.items()
                   for f, n in forms.items()}
            assert ran == {key: int(key == (body, 8)) for key in ran}
    if hd == 128 and not q8:
        assert one["smem_bytes"] == 38400


@pytest.mark.parametrize("hd", [48, 64, 128])
@pytest.mark.parametrize("t,rep", [(2, 1), (4, 1), (8, 1), (2, 2), (4, 2), (2, 4)])
@pytest.mark.parametrize("q8", [False, True])
def test_chunk_attention_tensor_core_body(dev, hd, t, rep, q8):
    """K10's tensor-core bodies (bf16, T * rep >= 2 rows; the walk body on
    the int8 cache) against the plain version on both caches: chunks
    straddling the 64-row split (60 + T: a query that sees no row of split
    1), running past S, the last that fits, a ragged last split (S 200);
    every launch on its body, reruns bit for bit."""
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kw

    S, nkv = 200, 2
    k = torch.randn(2, 5, nkv, S, hd, device=dev)
    v = torch.randn(2, 5, nkv, S, hd, device=dev)
    caches = ([*kw.kv_quant_rows(k), *kw.kv_quant_rows(v)] if q8 else
              [k.to(torch.bfloat16), v.to(torch.bfloat16)])
    if q8:
        caches = [caches[0], caches[2], caches[1], caches[3]]        # k8, v8, ks, vs
    kernel = da.chunk_attention_q8 if q8 else da.chunk_attention
    plain = da.chunk_attention_q8_plain if q8 else da.chunk_attention_plain
    q = torch.randn(5, t, nkv * rep, hd, device=dev).to(torch.bfloat16)
    pos0 = torch.tensor([0, 60, 61, S - 2, S - t], dtype=torch.int32, device=dev)
    body = "walk" if q8 else "mma"
    assert da.body_for(q.dtype, hd, q8) == body
    before = dict(da.launches_by_body)
    for layer in (0, 1):
        got = kernel(q, *caches, pos0, layer)
        _close(got, plain(q, *caches, pos0, layer), torch.bfloat16)
        assert torch.equal(got, kernel(q, *caches, pos0, layer))
    assert da.launches_by_body == {**before, body: before[body] + 4}


@pytest.mark.parametrize("hd", [48, 64, 128])
@pytest.mark.parametrize("t,rep", [(2, 1), (4, 1), (8, 1), (4, 2), (2, 4)])
@pytest.mark.parametrize("ps", [16, 128])
def test_paged_chunk_attention_tensor_core_body(dev, hd, t, rep, ps):
    """K12's chunk form on the tensor-core body against its plain version on
    both pools (16-row pages: 16-row splits; 128-row pages: 64-row
    splits), shuffled pages, -1 and stale table entries, a chunk running
    past the slot's last page; every launch on a tensor-core body (`mma`,
    the int8 pool's `walk`)."""
    from rama_tpu_torch.ops.kernels import kv_write as kw
    from rama_tpu_torch.ops.kernels import paged_attention as pa

    mp, nkv = 4, 2
    pos = [0, ps - 1, min(60, mp * ps - t), mp * ps - 2, mp * ps - t]
    tables, npages = _paged_setup(dev, 2, 5, nkv, hd, ps, mp, pos, t, seed=ps + hd + t)
    k = torch.randn(2, npages, nkv, ps, hd, device=dev)
    v = torch.randn(2, npages, nkv, ps, hd, device=dev)
    (k8, ks), (v8, vs) = kw.kv_quant_rows(k), kw.kv_quant_rows(v)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    q = torch.randn(5, t, nkv * rep, hd, device=dev).to(torch.bfloat16)
    p0 = torch.tensor(pos, dtype=torch.int32, device=dev)
    before = dict(pa.launches_by_body)
    for layer in (0, 1):
        _close(pa.paged_chunk_attention(q, k, v, p0, tables, layer),
               pa.paged_chunk_attention_plain(q, k, v, p0, tables, layer), torch.bfloat16)
        _close(pa.paged_chunk_attention_q8(q, k8, v8, ks, vs, p0, tables, layer),
               pa.paged_chunk_attention_q8_plain(q, k8, v8, ks, vs, p0, tables, layer),
               torch.bfloat16)
    assert pa.launches_by_body == {"mma": before["mma"] + 2, "walk": before["walk"] + 2,
                                   "simt": before["simt"]}


@pytest.mark.parametrize("hd", [48, 64, 128])
@pytest.mark.parametrize("rep", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("S,tiles", [(200, None), (1024, None), (1024, 3), (4096, None),
                                     (4096, 3)])
def test_chunk_rows_equal_decode_rows_bit_for_bit(dev, hd, rep, q8, paged, S, tiles):
    """Each query row of a verification chunk (K10, K12's chunk form)
    equals, bit for bit, the decode step's attention (K4 / K7, K12 decode)
    at its position: one body computes both, over the same splits, so
    greedy speculation with the target as its own draft accepts every
    draft. Dense (S rows) and paged (128-row pages), bf16 and int8 caches,
    rows straddling a tile and a split of G tiles (the int8 walk body's
    splits of several tiles at S 1024 / 4096, G forced to 3 or the plan's)
    and (dense) clamped at S - 1; every row form: rep 1 / 2 x T 4 (8 rows),
    rep 3 x T 3 (9 rows against decode steps of 3), rep 8 x T 8 (64 rows
    against 8) and rep 16 x T 8 (two row groups of 64 against decode steps
    of 16)."""
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kw
    from rama_tpu_torch.ops.kernels import paged_attention as pa

    decode_q8, chunk_q8, paged_decode_q8, paged_chunk_q8 = _q8_forms(tiles)
    t, nkv = {3: 3, 8: 8, 16: 8}.get(rep, 4), 2
    pos = [0, 60, 61, 198, 196] if S == 200 else [0, 61, 189, 253, S // 2 - 2, S - 2, S - 4]
    b = len(pos)
    if paged:
        tables, npages = _paged_setup(dev, 2, b, nkv, hd, 128, -(-S // 128), pos, t,
                                      seed=hd + rep)
        shape = (2, npages, nkv, 128, hd)
    else:
        tables, shape = None, (2, b, nkv, S, hd)
    k, v = torch.randn(shape, device=dev), torch.randn(shape, device=dev)
    if q8:
        (k8, ks), (v8, vs) = kw.kv_quant_rows(k), kw.kv_quant_rows(v)
        caches = (k8, v8, ks, vs)
    else:
        caches = (k.to(torch.bfloat16), v.to(torch.bfloat16))
    q = torch.randn(b, t, nkv * rep, hd, device=dev).to(torch.bfloat16)
    p0 = torch.tensor(pos, dtype=torch.int32, device=dev)
    if paged:
        chunk = (paged_chunk_q8 if q8 else pa.paged_chunk_attention)(q, *caches, p0, tables, 1)
    else:
        chunk = (chunk_q8 if q8 else da.chunk_attention)(q, *caches, p0, 1)
    for i in range(t):
        qi = q[:, i].contiguous()
        if paged:
            one = (paged_decode_q8 if q8 else pa.paged_decode_attention)(
                qi, *caches, p0 + i, tables, 1)
        else:
            one = (decode_q8 if q8 else da.decode_attention)(qi, *caches, p0 + i, 1)
        assert torch.equal(chunk[:, i], one), f"query {i}"


def test_chunk_attention_fp32_and_hd16_keep_the_simt_body(dev):
    """fp32 q, and bf16 at a head dim the tensor-core body has no
    instantiation of, run the SIMT body (by the counts)."""
    from rama_tpu_torch.ops.kernels import decode_attention as da

    pos0 = torch.tensor([0, 61], dtype=torch.int32, device=dev)
    for dtype, hd in ((torch.float32, 128), (torch.bfloat16, 16), (torch.float32, 64)):
        k = torch.randn(1, 2, 2, 96, hd, device=dev).to(dtype)
        q = torch.randn(2, 4, 2, hd, device=dev).to(dtype)
        before = dict(da.launches_by_body)
        _close(da.chunk_attention(q, k, k, pos0, 0), da.chunk_attention_plain(q, k, k, pos0, 0),
               dtype)
        assert da.launches_by_body == {**before, "simt": before["simt"] + 1}


@pytest.mark.parametrize("nkv,S,hd,t", [(2, 48, 16, 3), (6, 64, 48, 4), (4, 256, 128, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_write_kv_chunk_q8(dev, nkv, S, hd, t, dtype):
    """K11 equals its plain version exactly: a 32-row window straddle, a
    chunk reaching S and one wholly past it (rows dropped)."""
    from rama_tpu_torch.ops.kernels import kv_write as kw

    got = _q8_cache(dev, 3, 5, nkv, S, hd, seed=S + t)
    want = [x.clone() for x in got]
    pos0 = torch.tensor([0, 30, S - t, S - 2, S + 1], dtype=torch.int32, device=dev)
    before = kw.launches["write_kv_chunk_q8"]
    for layer in (0, 2):
        k, v = (_kv_rows(dev, (5, t, nkv, hd), dtype, seed=layer + i) for i in (0, 7))
        kw.write_kv_chunk_q8(*got, k, v, pos0, layer)
        kw.write_kv_chunk_q8_plain(*want, k, v, pos0, layer)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert kw.launches["write_kv_chunk_q8"] == before + 2


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_spec_engine_on_card_matches_cpu_engine(dev, kv_quant):
    """Speculative serving (spec_tick 3, n-gram; chunks through K10, and
    K11 on the int8 cache) emits on the card the streams the CPU engine
    emits, and the spec-off streams."""
    _check_engine_on_card(dev, kv_quant=kv_quant, spec_tick=3)


# -- the paged cache: K12, K13 ---------------------------------------------------


def _paged_setup(dev, L, B, nkv, hd, ps, mp, pos, t, seed, spare=3):
    """A pool whose slots own disjoint pages in shuffled order for the rows
    up to pos + t - 1 (at most mp pages), table entries past them -1 or a
    random page, and the dense (L, B, nkv, mp * ps, hd) view of the same
    rows."""
    g = torch.Generator().manual_seed(seed)
    used = [min(-(-(p + t) // ps), mp) for p in pos]      # rows past mp * ps: none
    npages = sum(used) + spare
    perm = torch.randperm(npages, generator=g)
    tables = torch.full((B, mp), -1, dtype=torch.int32)
    start = 0
    for b, u in enumerate(used):
        tables[b, :u] = perm[start:start + u]
        start += u
        if u < mp:
            tables[b, mp - 1] = int(perm[-1])            # a stale entry past the used pages
    return tables.to(dev), npages


def _paged_view(pool, tables):
    from rama_tpu_torch.ops.kernels.paged_attention import gather_pages

    return torch.stack([gather_pages(pool[l], tables) for l in range(pool.shape[0])])


@pytest.mark.parametrize("nh,nkv,hd,ps", [(4, 4, 128, 16), (4, 2, 48, 24), (8, 2, 16, 128),
                                          (4, 4, 64, 96)])
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention(dev, nh, nkv, hd, ps, t, dtype):
    """K12's decode (T = 1) and chunk forms against their plain versions on
    both pools: shuffled disjoint pages, -1 and stale table entries, ragged
    positions on and across page edges."""
    from rama_tpu_torch.ops.kernels import kv_write as kw
    from rama_tpu_torch.ops.kernels import paged_attention as pa

    mp = 5
    pos = [0, ps - 1, ps, 3 * ps + 5, mp * ps - t]
    tables, npages = _paged_setup(dev, 2, 5, nkv, hd, ps, mp, pos, t, seed=ps + t)
    k = torch.randn(2, npages, nkv, ps, hd, device=dev).to(dtype)
    v = torch.randn(2, npages, nkv, ps, hd, device=dev).to(dtype)
    (k8, ks), (v8, vs) = kw.kv_quant_rows(k.float()), kw.kv_quant_rows(v.float())
    q = torch.randn(5, t, nh, hd, device=dev).to(dtype)
    p0 = torch.tensor(pos, dtype=torch.int32, device=dev)
    before = dict(pa.launches)
    for layer in (0, 1):
        if t == 1:
            _close(pa.paged_decode_attention(q[:, 0], k, v, p0, tables, layer),
                   pa.paged_decode_attention_plain(q[:, 0], k, v, p0, tables, layer), dtype)
            _close(pa.paged_decode_attention_q8(q[:, 0], k8, v8, ks, vs, p0, tables, layer),
                   pa.paged_decode_attention_q8_plain(q[:, 0], k8, v8, ks, vs, p0, tables,
                                                      layer), dtype)
        else:
            _close(pa.paged_chunk_attention(q, k, v, p0, tables, layer),
                   pa.paged_chunk_attention_plain(q, k, v, p0, tables, layer), dtype)
            _close(pa.paged_chunk_attention_q8(q, k8, v8, ks, vs, p0, tables, layer),
                   pa.paged_chunk_attention_q8_plain(q, k8, v8, ks, vs, p0, tables, layer),
                   dtype)
    form = "decode" if t == 1 else "chunk"
    assert pa.launches[f"paged_{form}_attention"] == before[f"paged_{form}_attention"] + 2
    assert pa.launches[f"paged_{form}_attention_q8"] == before[f"paged_{form}_attention_q8"] + 2


@pytest.mark.parametrize("ps", [64, 128])
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("rows,tiles", [(256, None), (512, None), (4096, None), (4096, 3)])
def test_paged_attention_equals_the_dense_kernel(dev, ps, t, rows, tiles):
    """Where the 64-row tiles coincide (ps % 64 == 0), K12 over the pool
    equals K4 / K10 (and K7 / K10 int8) over the gathered dense view bit
    for bit: pools of mp * ps = 256, 512 and 4096 rows, the int8 walk
    body's splits of one tile or several (the plan's G, or 3), a split
    spanning pages."""
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kw
    from rama_tpu_torch.ops.kernels import paged_attention as pa

    decode_q8, chunk_q8, paged_decode_q8, paged_chunk_q8 = _q8_forms(tiles)
    mp, nkv, hd = rows // ps, 4, 128
    pos = [0, 63, 64, ps - 1, 250, rows // 2 + 5, rows - t]
    tables, npages = _paged_setup(dev, 2, len(pos), nkv, hd, ps, mp, pos, t, seed=7)
    k = torch.randn(2, npages, nkv, ps, hd, device=dev).to(torch.bfloat16)
    v = torch.randn(2, npages, nkv, ps, hd, device=dev).to(torch.bfloat16)
    (k8, ks), (v8, vs) = kw.kv_quant_rows(k.float()), kw.kv_quant_rows(v.float())
    q = torch.randn(len(pos), t, nkv, hd, device=dev).to(torch.bfloat16)
    p0 = torch.tensor(pos, dtype=torch.int32, device=dev)
    dense = [_paged_view(x, tables).contiguous() for x in (k, v, k8, v8, ks, vs)]
    got = pa.paged_chunk_attention(q, k, v, p0, tables, 1)
    want = da.chunk_attention(q, dense[0], dense[1], p0, 1)
    assert torch.equal(got, want)
    got = paged_chunk_q8(q, k8, v8, ks, vs, p0, tables, 1)
    want = chunk_q8(q, *dense[2:], p0, 1)
    assert torch.equal(got, want)
    if t == 1:
        got = paged_decode_q8(q[:, 0].contiguous(), k8, v8, ks, vs, p0, tables, 1)
        assert torch.equal(got, decode_q8(q[:, 0].contiguous(), *dense[2:], p0, 1))


@pytest.mark.parametrize("ps,t", [(16, 1), (16, 8), (32, 3), (128, 4), (24, 5)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_write_kv_paged_q8(dev, ps, t, dtype):
    """K13 (a) equals its plain version exactly: chunks at a page start,
    straddling a page edge, ending a page, and running past the slot's
    table (clipped into its last page)."""
    from rama_tpu_torch.ops.kernels import kv_write as kw

    mp, nkv, hd = 3, 2, 128
    pos = [0, ps - t + 1 if t > 1 else ps - 1, 2 * ps - t, mp * ps - 1]
    g = torch.Generator().manual_seed(ps * t)
    npages = 4 * mp + 1
    tables = torch.randperm(npages - 1, generator=g)[:4 * mp].view(4, mp).to(torch.int32)
    got = _q8_cache(dev, 3, npages, nkv, ps, hd, seed=ps + t)
    want = [x.clone() for x in got]
    p0 = torch.tensor(pos, dtype=torch.int32, device=dev)
    before = kw.launches["write_kv_paged_q8"]
    for layer in (0, 2):
        k, v = (_kv_rows(dev, (4, t, nkv, hd), dtype, seed=layer + i) for i in (0, 7))
        kw.write_kv_paged_q8(*got, k, v, p0, tables.to(dev), layer)
        kw.write_kv_paged_q8_plain(*want, k, v, p0, tables.to(dev), layer)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert kw.launches["write_kv_paged_q8"] == before + 2


@pytest.mark.parametrize("ps,t_ins,n", [(16, 40, 3), (128, 130, 2), (32, 32, 4)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_write_kv_prefill_paged_q8(dev, ps, t_ins, n, dtype):
    """K13 (b) equals its plain version exactly: an admission group's
    strips into shuffled pages, partial last pages, strips of the bucket
    longer than t_ins and pad strips past the group's tables."""
    from rama_tpu_torch.ops.kernels import kv_write as kw

    mp = -(-t_ins // ps) + 1
    npages = n * mp + 2
    g = torch.Generator().manual_seed(ps + n)
    tables = torch.randperm(npages, generator=g)[:n * mp].view(n, mp).to(torch.int32)
    got = _q8_cache(dev, 2, npages, 2, ps, 128, seed=t_ins)
    want = [x.clone() for x in got]
    k, v = (_kv_rows(dev, (2, n + 1, 2, t_ins + 3, 128), dtype, seed=i) for i in (1, 2))
    before = kw.launches["write_kv_prefill_paged_q8"]
    kw.write_kv_prefill_paged_q8(*got, k, v, tables.to(dev), t_ins)
    kw.write_kv_prefill_paged_q8_plain(*want, k, v, tables.to(dev), t_ins)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert kw.launches["write_kv_prefill_paged_q8"] == before + 1


@pytest.mark.parametrize("kv_quant,spec_tick", [(None, 0), ("int8", 0), (None, 3),
                                                ("int8", 3)])
def test_paged_engine_on_card_matches_cpu_engine(dev, kv_quant, spec_tick, monkeypatch):
    """The engine on a page pool (page size 16) serves on the card the
    streams the dense CPU engine serves, with K12 / K13's plain versions and
    the gather path made to raise: the card never falls back to them."""
    from rama_tpu_torch.ops.kernels import kv_write as kw
    from rama_tpu_torch.ops.kernels import paged_attention as pa
    from rama_tpu_torch.runtime import paged

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain or gather path")

    for mod, names in ((pa, ("paged_decode_attention_plain", "paged_decode_attention_q8_plain",
                             "paged_chunk_attention_plain", "paged_chunk_attention_q8_plain")),
                       (kw, ("write_kv_paged_q8_plain", "write_kv_prefill_paged_q8_plain")),
                       (paged, ("_forward_gather_paged",))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)
    before = dict(pa.launches)
    _check_engine_on_card(dev, kv_quant=kv_quant, spec_tick=spec_tick, paged=True)
    form = "chunk" if spec_tick else "decode"
    key = f"paged_{form}_attention" + ("_q8" if kv_quant else "")
    assert pa.launches[key] > before[key]


def test_paged_engine_refuses_a_page_size_the_kernel_does_not_take(dev):
    from rama_tpu_torch.config import EngineConfig, ModelConfig
    from rama_tpu_torch.models.llama import load_params
    from rama_tpu_torch.runtime.engine import Engine
    from rama_tpu_torch.tokenizer import Tokenizer

    cfg = ModelConfig(dim=64, hidden_dim=96, n_layers=1, n_heads=4, n_kv_heads=2,
                      vocab_size=8, seq_len=32)
    import numpy as np

    rng = np.random.default_rng(0)
    p = {"tok_embedding": rng.standard_normal((8, 64)), "wq": rng.standard_normal((1, 64, 64)),
         "wk": rng.standard_normal((1, 64, 32)), "wv": rng.standard_normal((1, 64, 32)),
         "wo": rng.standard_normal((1, 64, 64)), "w1": rng.standard_normal((1, 64, 96)),
         "w2": rng.standard_normal((1, 96, 64)), "w3": rng.standard_normal((1, 64, 96)),
         "attn_norm": np.ones((1, 64)), "ffn_norm": np.ones((1, 64)), "final_norm": np.ones(64)}
    params = load_params(cfg, p, dtype=torch.float32, device=dev)
    tok = Tokenizer(["<unk>", "<s>", "</s>"] + list("abcde"), [0.0] * 8)
    with pytest.raises(ValueError, match="multiple of 8"):
        Engine(cfg, params, tok, EngineConfig(paged_kv=True, kv_page_size=12))
    # a verification chunk of 5 x GQA group 2 = 10 query rows a kv head is
    # no longer refused: the paged kernel runs it in its 16-row form
    Engine(cfg, params, tok, EngineConfig(paged_kv=True, kv_page_size=16, spec_tick=4))


# -- kernel 9: T = 1 attention over one layer's cache --------------------------

@pytest.mark.parametrize("nh,nkv,hd", [(4, 4, 128), (4, 2, 48), (8, 1, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_flat(dev, nh, nkv, hd, dtype):
    from rama_tpu_torch.ops.kernels import decode_attention as da

    g = torch.Generator().manual_seed(nh + hd)
    k, v = (torch.randn(3, nkv, 200, hd, generator=g).to(dev, dtype) for _ in range(2))
    q = torch.randn(3, nh, hd, generator=g).to(dev, dtype)
    pos = torch.tensor([0, 64, 230], dtype=torch.int32, device=dev)   # 230: clamped
    before = da.launches_flat
    _close(da.decode_attention_flat(q, k, v, pos), da.decode_attention_flat_plain(q, k, v, pos),
           dtype)
    assert da.launches_flat == before + 1


@pytest.mark.parametrize("nh,nkv,hd", [(4, 4, 128), (4, 2, 48), (8, 2, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_flat_q8(dev, nh, nkv, hd, dtype):
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels.kv_write import kv_quant_rows

    g = torch.Generator().manual_seed(nh * hd)
    (k8, ks), (v8, vs) = (kv_quant_rows(torch.randn(3, nkv, 150, hd, generator=g).to(dev))
                          for _ in range(2))
    q = torch.randn(3, nh, hd, generator=g).to(dev, dtype)
    pos = torch.tensor([149, 0, 77], dtype=torch.int32, device=dev)
    before = da.launches_flat_q8
    _close(da.decode_attention_flat_q8(q, k8, v8, ks, vs, pos),
           da.decode_attention_flat_q8_plain(q, k8, v8, ks, vs, pos), dtype)
    assert da.launches_flat_q8 == before + 1


# -- kernel 14: the fused attention block --------------------------------------

def _ab_case(dev, b, nkv, rep, s, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    nh, hd = nkv * rep, 128
    q = torch.randn(b, nh, hd, generator=g).to(dev, dtype)
    qkv = torch.randn(b, 2 * nkv * hd, generator=g).to(dev, dtype)   # strided k / v rows
    kn, vn = qkv[:, :nkv * hd].view(b, nkv, hd), qkv[:, nkv * hd:].view(b, nkv, hd)
    cache = [torch.randn(2, b, nkv, s, hd, generator=g).to(dev, dtype) for _ in range(2)]
    ang = torch.rand(b, hd // 2, generator=g) * 6
    return q, kn, vn, ang.cos().to(dev), ang.sin().to(dev), cache


def _check_rows(got, want, before, pos, layer):
    """v row exact, roped k row within one ulp, other rows unchanged."""
    s = before[0].shape[3]
    b = torch.arange(pos.shape[0], device=pos.device)
    p = pos.long().clamp(0, s - 1)
    assert torch.equal(got[1][layer, b, :, p], want[1][layer, b, :, p])
    wk = want[0][layer, b, :, p].float()
    _, e = torch.frexp(wk)
    ulp = torch.ldexp(torch.ones_like(wk), e - (8 if want[0].dtype == torch.bfloat16 else 24))
    assert bool(((got[0][layer, b, :, p].float() - wk).abs() <= ulp).all())
    for g_, b0 in zip(got, before):
        rest = g_.clone()
        rest[layer, b, :, p] = b0[layer, b, :, p]
        assert torch.equal(rest, b0)


def _ab_call(ab, form, wo, args, caches, pos, layer, plain=False):
    """One K14 call of `form` ("light", or 8 / 4: the full form with that wo)."""
    if form == "light":
        fn = ab.attn_rope_write_layered_plain if plain else ab.attn_rope_write_layered
        return fn(*args, *caches, pos, layer)
    fn = ab.attn_block_layered_plain if plain else ab.attn_block_layered
    return fn(*args, *caches, wo, pos, layer)


def _ab_name(form):
    return "attn_rope_write_layered" if form == "light" else \
        "attn_block_layered" + ("_int4" if form == 4 else "")


# B 1 / 8 and 9 (past one n8 tile of the wo body), GQA rep 1 / 2 / 4 / 8 / 7;
# positions 0 (no split: the combine alone), S - 1, S + 3 (clamped) and the
# 64-row split edges, then a second set with a mid-cache position first
_AB_POSITIONS = {"edges": lambda s: [0, s - 1, s + 3, 63, 64, 65, 1, 128, 17],
                 "more": lambda s: [s // 2 + 1, 127, 63, 64, 65, s - 2, 2, 129, 0]}


@pytest.mark.parametrize("b,nkv,rep,s", [(3, 2, 1, 72), (2, 4, 2, 200), (9, 2, 4, 64),
                                         (1, 3, 1, 136), (8, 2, 1, 200), (8, 1, 8, 136),
                                         (1, 2, 8, 72), (8, 4, 4, 4096), (1, 1, 2, 4096),
                                         (8, 8, 7, 200), (1, 2, 7, 4096),
                                         # groups past 8: the 16 / 32 / 64-row forms, row
                                         # groups of 64 past 64 (65: a group of one row)
                                         (8, 1, 9, 200), (8, 8, 12, 512), (9, 2, 12, 4096),
                                         (1, 1, 16, 4096), (9, 2, 24, 136), (1, 1, 48, 4096),
                                         (8, 1, 64, 1024), (9, 1, 65, 200), (1, 1, 96, 4096),
                                         (8, 1, 96, 512)])
@pytest.mark.parametrize("positions", ["edges", "more"])
@pytest.mark.parametrize("form", ["light", 8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attn_block(dev, b, nkv, rep, s, positions, form, dtype):
    """Each form against its plain version, the attention on the body
    body_for picks (bf16: split tensor-core attention, fp32: the SIMT body)
    in the row form form_for picks, and wo on K1, the written cache rows by
    _check_rows; GQA rep 1 / 2 / 4 / 8, 7 (Yi-34B's group over its 8 kv
    heads: 7 live rows of 8), and 9 / 12 (Mistral-Large's) / 16 / 24 / 48 /
    64 / 65 / 96 (row groups of 64, or of 8 on the SIMT body)."""
    from rama_tpu_torch.ops.kernels import attn_block as ab

    q, kn, vn, cos, sin, before = _ab_case(dev, b, nkv, rep, s, dtype, seed=b * s + rep)
    pos = torch.tensor(_AB_POSITIONS[positions](s)[:b], dtype=torch.int32, device=dev)
    got_c, want_c = [t.clone() for t in before], [t.clone() for t in before]
    wo = None if form == "light" else _qt(dev, 2, nkv * rep * 128, 256, 64, seed=s, bits=form)
    name, body = _ab_name(form), ab.body_for(dtype)
    rows = ab.form_for(dtype, rep)[0]
    n0, nb = ab.launches[name], dict(ab.launches_by_body)
    nf = ab.launches_by_form[body][rows]
    got = _ab_call(ab, form, wo, (q, kn, vn, cos, sin), got_c, pos, 1)
    want = _ab_call(ab, form, wo, (q, kn, vn, cos, sin), want_c, pos, 1, plain=True)
    torch.cuda.synchronize()
    _close_k(got, want, dtype)
    _check_rows(got_c, want_c, before, pos, 1)
    assert ab.launches[name] == n0 + 1
    assert {k: ab.launches_by_body[k] - nb[k] for k in nb} == {k: int(k == body) for k in nb}
    assert ab.launches_by_form[body][rows] == nf + 1


@pytest.mark.parametrize("rep,rows", [(r, 16) for r in range(1, 9)] + [(3, 32), (8, 64),
                                                                     (12, 32), (12, 64),
                                                                     (24, 64)])
@pytest.mark.parametrize("form", ["light", 4])
def test_attn_block_larger_form_equals_the_group_form_bit_for_bit(dev, rep, rows, form):
    """A bf16 launch forced (the private _rows) into a larger row form than
    its group's (rep 1..8 into the 16-row form, which Mistral-Large's group
    12 runs; others into 32 / 64) equals the group's own form (8 / 16 / 32)
    bit for bit, output and written rows: a query row's arithmetic is the
    same in every form, the extra rows zero queries that store nothing."""
    from rama_tpu_torch.ops.kernels import attn_block as ab

    b, nkv, s = 8, 2, 1024
    q, kn, vn, cos, sin, before = _ab_case(dev, b, nkv, rep, s, torch.bfloat16, seed=rep + rows)
    pos = torch.tensor([0, 63, 64, 65, 500, 1000, 1023, 1027], dtype=torch.int32, device=dev)
    wo = None if form == "light" else _qt(dev, 2, nkv * rep * 128, 256, 64, seed=rep, bits=4)
    outs, caches = [], []
    for forced in (None, rows):
        c = [t.clone() for t in before]
        n0 = ab.launches_by_form["mma"][forced or ab.form_for(torch.bfloat16, rep)[0]]
        args = (q, kn, vn, cos, sin, *c)
        out = (ab.attn_rope_write_layered(*args, pos, 1, _rows=forced) if wo is None else
               ab.attn_block_layered(*args, wo, pos, 1, _rows=forced))
        assert ab.launches_by_form["mma"][forced or ab.form_for(torch.bfloat16, rep)[0]] == n0 + 1
        outs.append(out)
        caches.append(c)
    torch.cuda.synchronize()
    assert ab.form_for(torch.bfloat16, rep)[0] < rows
    assert torch.equal(outs[0], outs[1])
    for a, b_ in zip(*caches):
        assert torch.equal(a, b_)
    with pytest.raises(ValueError, match="larger form"):   # a smaller form than the group's
        ab.attn_rope_write_layered(q, kn, vn, cos, sin, *before, pos, 1,
                                   _rows=8 if rep > 8 else 7)


@pytest.mark.parametrize("rep,s", [(64, 57344), (32, 131072), (8, 458752)])
@pytest.mark.parametrize("form", ["light", 4])
def test_attn_block_long_cache_keeps_split_weights_in_the_workspace(dev, rep, s, form):
    """A bf16 cache whose split weights (rows x nsplit floats) pass the
    card's shared memory in the combine (the 64-row form past ~49.6k rows,
    32 past ~107.6k, 8 past ~455.5k on an H100) is taken: the combine keeps
    them in the workspace (its shared bytes then hold no weights), and each
    form is within tolerance of its plain version, the rows written."""
    from rama_tpu_torch.ops.kernels import attn_block as ab

    b, nkv = 2, 1
    rows = ab.form_for(torch.bfloat16, rep)[0]
    comb = ab.light_occupancy(rep * nkv, nkv, s)["combine"]
    assert comb["smem_bytes"] == 4 * (rows * 128 + 128 + 3 * rows)
    assert ab.light_occupancy(rep * nkv, nkv, 4096)["combine"]["smem_bytes"] > comb["smem_bytes"]
    q, kn, vn, cos, sin, before = _ab_case(dev, b, nkv, rep, s, torch.bfloat16, seed=rep)
    pos = torch.tensor([s - 1, s // 2 + 65], dtype=torch.int32, device=dev)
    wo = None if form == "light" else _qt(dev, 2, nkv * rep * 128, 256, 64, seed=rep, bits=4)
    got_c, want_c = [t.clone() for t in before], [t.clone() for t in before]
    got = _ab_call(ab, form, wo, (q, kn, vn, cos, sin), got_c, pos, 1)
    want = _ab_call(ab, form, wo, (q, kn, vn, cos, sin), want_c, pos, 1, plain=True)
    torch.cuda.synchronize()
    _close_k(got, want, torch.bfloat16)
    _check_rows(got_c, want_c, before, pos, 1)


@pytest.mark.parametrize("rep", [2, 12])
@pytest.mark.parametrize("form", ["light", 8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attn_block_back_to_back(dev, form, dtype, rep):
    """Launches back to back with the layer cycling (0, 1, 0, 1, 1) and the
    positions moving on, each against the plain version on its own copy of
    the cache: the split workspaces of one launch carry nothing into the
    next, and K1's split-K tickets under the full form are left zeroed (the
    ticket buffer is all zero after); GQA group 2 and 12 (the 16-row form,
    or two row groups of 8 on the SIMT body)."""
    from rama_tpu_torch.ops.kernels import attn_block as ab
    from rama_tpu_torch.ops.kernels import build

    b, nkv, s = 8, 2, 200
    q, kn, vn, cos, sin, before = _ab_case(dev, b, nkv, rep, s, dtype, seed=31)
    wo = None if form == "light" else _qt(dev, 2, nkv * rep * 128, 384, 64, seed=7, bits=form)
    got_c, want_c = [t.clone() for t in before], [t.clone() for t in before]
    pos = torch.tensor([0, 63, 64, 65, 127, 128, 150, 199], dtype=torch.int32, device=dev)
    for i, layer in enumerate((0, 1, 0, 1, 1)):
        p = (pos + i).clamp(max=s + 3)
        got = _ab_call(ab, form, wo, (q, kn, vn, cos, sin), got_c, p, layer)
        want = _ab_call(ab, form, wo, (q, kn, vn, cos, sin), want_c, p, layer, plain=True)
        torch.cuda.synchronize()
        _close_k(got, want, dtype)
        for g_, w_ in zip(got_c, want_c):   # the rows written so far, within one ulp
            _close_k(g_, w_, dtype)
    assert int(build.tickets(dev, 1).abs().sum()) == 0


@pytest.mark.parametrize("rep", [2, 12])
@pytest.mark.parametrize("form,dtype", [("light", torch.bfloat16), (8, torch.bfloat16),
                                        (4, torch.bfloat16), (8, torch.float32)])
def test_attn_block_replays_in_a_cuda_graph(dev, form, dtype, rep):
    """Each form captured in a CUDA graph and replayed (twice) equals an
    eager launch on the same inputs bit for bit, output and written rows:
    bf16 light (split + combine) and full (those, then K1's qmv_mma), and
    the fp32 full form (the SIMT kernel, then K1's fp32 GEMV); GQA group 2
    and 12 (Mistral-Large's: the 16-row form)."""
    from rama_tpu_torch.ops.kernels import attn_block as ab

    b, nkv, s = 8, 4, 1024
    q, kn, vn, cos, sin, before = _ab_case(dev, b, nkv, rep, s, dtype, seed=17)
    pos = torch.tensor([0, 63, 64, 65, 500, 1000, 1023, 1027], dtype=torch.int32, device=dev)
    wo = None if form == "light" else _qt(dev, 2, nkv * rep * 128, 512, 64, seed=5, bits=form)
    args = (q, kn, vn, cos, sin)
    eager_c = [t.clone() for t in before]
    eager = _ab_call(ab, form, wo, args, eager_c, pos, 1)
    graph_c = [t.clone() for t in before]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):   # warm up on the capture stream
        _ab_call(ab, form, wo, args, [t.clone() for t in before], pos, 1)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    body = ab.body_for(dtype)
    n0 = ab.launches_by_body[body]
    with torch.cuda.graph(graph):
        out = _ab_call(ab, form, wo, args, graph_c, pos, 1)
    assert ab.launches_by_body[body] == n0 + 1
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        for g_, e_ in zip(graph_c, eager_c):
            assert torch.equal(g_, e_)


@pytest.mark.parametrize("paged", [False, True])
def test_int8_decode_attention_replays_in_a_cuda_graph(dev, paged):
    """K7 (dense) and K12 _q8 (paged, 128-row pages) on the walk body,
    captured in a CUDA graph after a warm-up launch (which reads the
    card's occupancy for the grid) and replayed twice, equal an eager
    launch on the same inputs bit for bit; S 4096, so a split holds
    several tiles."""
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kw
    from rama_tpu_torch.ops.kernels import paged_attention as pa

    S, nkv, hd = 4096, 4, 128
    pos = [0, 63, 64, 1000, 2047, 3001, 4095, 4100]
    p0 = torch.tensor(pos, dtype=torch.int32, device=dev)
    if paged:
        tables, npages = _paged_setup(dev, 2, 8, nkv, hd, 128, S // 128, pos, 1, seed=23)
        shape = (2, npages, nkv, 128, hd)
    else:
        shape = (2, 8, nkv, S, hd)
    (k8, ks), (v8, vs) = (kw.kv_quant_rows(torch.randn(shape, device=dev)) for _ in range(2))
    q = torch.randn(8, 2 * nkv, hd, device=dev).to(torch.bfloat16)

    def call():
        if paged:
            return pa.paged_decode_attention_q8(q, k8, v8, ks, vs, p0, tables, 1)
        return da.decode_attention_q8(q, k8, v8, ks, vs, p0, 1)

    eager = call()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):   # warm up on the capture stream
        call()
    torch.cuda.current_stream().wait_stream(stream)
    counts = pa.launches_by_body if paged else da.launches_by_body
    n0 = counts["walk"]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    assert counts["walk"] == n0 + 1
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


# -- K11 / K13 (a) inside the int8 walk: the new rows written by the attention launch --


# (T, GQA rep) over 2 kv heads: the 8-row form (T 1 / 4 / 8 at rep 1, T 2 at
# rep 4), 16 rows (T 3 x 5), 32 (T 8 x 4, T 5 x 6), 64 (T 8 x 8, T 3 x 16)
# and row groups of 64 (T 8 x 12: a partial second group; T 8 x 16)
WRITE_FORMS = [(1, 1), (4, 1), (8, 1), (2, 4), (3, 5), (8, 4), (5, 6), (8, 8), (3, 16),
               (8, 12), (8, 16)]
# dense caches of S rows (2100: splits of G = 2 tiles), or pools of mp
# pages of ps rows (64- and 128-row pages)
WRITE_LAYOUTS = {"dense200": (None, 200), "dense2100": (None, 2100), "ps64": (64, 8),
                 "ps128": (128, 4)}


def _write_case(dev, layout, t, rep, hd, seed):
    """(caches, tables, pos0, q, k_new, v_new) of a fused-write check: an
    int8 cache (2 layers) of kv_quant_rows'd N(0, 1) rows, bf16 q, and new
    rows of mixed magnitude with a zero row and .5 ties. Planted edges,
    dense: a chunk at 0, across a 64-row tile edge, the last that fits,
    reaching S, wholly past it and further past (rows at or past S
    dropped); paged (every slot its own shuffled pages): a chunk at 0,
    across a 64-row tile edge, across a page edge, the last that fits, one
    running past the slot's table (clipped into its page mp - 1, where its
    own queries read them) and one wholly past it."""
    ps, n = WRITE_LAYOUTS[layout]
    nkv = 2
    if ps is None:
        S, tables = n, None
        pos = [0, 64 - max(t // 2, 1), S - t, S - 2, S, S + 3]
        shape = (2, len(pos), nkv, S, hd)
    else:
        mp = n
        S = mp * ps
        pos = [0, 64 - max(t // 2, 1), ps - max(t // 2, 1), S - t, S - 1, S + 5]
        g = torch.Generator().manual_seed(seed)
        npages = len(pos) * mp + 2
        perm = torch.randperm(npages, generator=g)[:len(pos) * mp]
        tables = perm.view(len(pos), mp).to(torch.int32).to(dev)
        shape = (2, npages, nkv, ps, hd)
    b = len(pos)
    (k8, ks), (v8, vs) = (_quant_rows(torch.randn(shape, device=dev)) for _ in range(2))
    q = torch.randn(b, t, nkv * rep, hd, device=dev).to(torch.bfloat16)
    k, v = (_kv_rows(dev, (b, t, nkv, hd), torch.bfloat16, seed=seed + i) for i in (1, 2))
    return [k8, v8, ks, vs], tables, torch.tensor(pos, dtype=torch.int32, device=dev), q, k, v


def _quant_rows(x):
    from rama_tpu_torch.ops.kernels import kv_write as kw

    return kw.kv_quant_rows(x)


def _fused_and_unfused(caches, tables, p0, q, k, v, layer):
    """(fused output, its cache), (unfused output, its cache): the walk
    launch given the new rows, against the standalone writer (K11 / K13
    (a)) followed by the walk without them, each on its own copy."""
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kw
    from rama_tpu_torch.ops.kernels import paged_attention as pa

    fused, split = [c.clone() for c in caches], [c.clone() for c in caches]
    t = q.shape[1]
    if tables is None:
        got = da.chunk_attention_q8(q, *fused, p0, layer, k_new=k, v_new=v)
        kw.write_kv_chunk_q8(*split, k, v, p0, layer)
        want = da.chunk_attention_q8(q, *split, p0, layer)
    elif t == 1:
        got = pa.paged_decode_attention_q8(q[:, 0], *fused, p0, tables, layer,
                                           k_new=k[:, 0], v_new=v[:, 0])
        kw.write_kv_paged_q8(*split, k, v, p0, tables, layer)
        want = pa.paged_decode_attention_q8(q[:, 0], *split, p0, tables, layer)
    else:
        got = pa.paged_chunk_attention_q8(q, *fused, p0, tables, layer, k_new=k, v_new=v)
        kw.write_kv_paged_q8(*split, k, v, p0, tables, layer)
        want = pa.paged_chunk_attention_q8(q, *split, p0, tables, layer)
    return (got, fused), (want, split)


@pytest.mark.parametrize("hd", [48, 64, 128])
@pytest.mark.parametrize("t,rep", WRITE_FORMS)
@pytest.mark.parametrize("layout", list(WRITE_LAYOUTS))
def test_walk_writes_the_new_rows_as_the_writer_then_the_walk(dev, hd, t, rep, layout):
    """The int8 walk given a chunk's new rows (K10 / K12 _q8 with k_new /
    v_new) equals the standalone writer followed by the walk without them,
    for every row form and row groups, dense and paged, T 1 .. 8, at the
    planted edges of _write_case: the outputs bit for bit, the cache or
    pool (int8 bytes and f32 scales) byte for byte, and the plain version
    within the bf16 tolerance. Each fused call counts one launch on the
    walk body and one fused write, and none of the standalone writer."""
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kw
    from rama_tpu_torch.ops.kernels import paged_attention as pa

    caches, tables, p0, q, k, v = _write_case(dev, layout, t, rep, hd, seed=hd + 10 * t + rep)
    mod = da if tables is None else pa
    for layer in (0, 1):
        writes, walks = mod.launches_write_q8, mod.launches_by_body["walk"]
        standalone = dict(kw.launches)
        (got, fused), (want, split) = _fused_and_unfused(caches, tables, p0, q, k, v, layer)
        assert mod.launches_write_q8 == writes + 1 and mod.launches_by_body["walk"] == walks + 2
        assert kw.launches["write_kv_chunk_q8"] + kw.launches["write_kv_paged_q8"] == (
            standalone["write_kv_chunk_q8"] + standalone["write_kv_paged_q8"] + 1)
        assert torch.equal(got, want)
        for a, b in zip(fused, split):
            assert torch.equal(a, b)
        if tables is None:
            plain = [c.clone() for c in caches]
            ref = da.chunk_attention_q8_plain(q, *plain, p0, layer, k, v)
        else:
            plain = [c.clone() for c in caches]
            ref = pa.paged_chunk_attention_q8_plain(q, *plain, p0, tables, layer, k, v)
            got = got if got.dim() == 3 else got[:, None]
        _close(got, ref, torch.bfloat16)
        for a, b in zip(fused, plain):
            assert torch.equal(a, b)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("t,rep", [(4, 1), (8, 16)])
def test_walk_row_write_replays_in_a_cuda_graph(dev, paged, t, rep):
    """The fused launch (the 8-row form, and two row groups of 64) captured
    in a CUDA graph after a warm-up launch and replayed twice equals an
    eager launch on its own copy of the cache: outputs bit for bit, the
    cache or pool byte for byte (a replay rewrites the same bytes)."""
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import paged_attention as pa

    caches, tables, p0, q, k, v = _write_case(dev, "ps128" if paged else "dense2100", t, rep,
                                              128, seed=31)
    eager_c, graph_c = [c.clone() for c in caches], [c.clone() for c in caches]

    def call(c):
        if paged:
            return pa.paged_chunk_attention_q8(q, *c, p0, tables, 1, k_new=k, v_new=v)
        return da.chunk_attention_q8(q, *c, p0, 1, k_new=k, v_new=v)

    eager = call(eager_c)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):   # warm up on the capture stream
        call(graph_c)
    torch.cuda.current_stream().wait_stream(stream)
    mod = pa if paged else da
    n0 = mod.launches_write_q8
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call(graph_c)
    assert mod.launches_write_q8 == n0 + 1
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert all(torch.equal(a, b) for a, b in zip(graph_c, eager_c))


def test_int8_rows_off_the_walk_take_the_standalone_writer(dev):
    """Only the int8 walk writes new rows in its launch: fp32 q (the SIMT
    body) and head_dim 16 given rows run the standalone writer (K11 / K13
    (a), one launch of its own) first and the attention without them,
    equal to that pair bit for bit (outputs and cache or pool bytes), with
    no fused write counted; rows of another shape or dtype on the walk, or
    one of the two rows alone, are refused before any launch."""
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kw
    from rama_tpu_torch.ops.kernels import paged_attention as pa

    c16, _, p16, q16, k16, v16 = _write_case(dev, "dense200", 4, 1, 16, seed=6)
    cases = [(c16, None, p16, q16, k16, v16)]
    for layout in ("dense200", "ps64"):
        caches, tables, p0, q, k, v = _write_case(dev, layout, 4, 2, 128, seed=5)
        cases.append((caches, tables, p0, q.float(), k.float(), v.float()))
    for caches, tables, p0, q, k, v in cases:
        mod = da if tables is None else pa
        writer = "write_kv_chunk_q8" if tables is None else "write_kv_paged_q8"
        n0, w0 = mod.launches_write_q8, kw.launches[writer]
        (got, fused), (want, split) = _fused_and_unfused(caches, tables, p0, q, k, v, 1)
        assert (mod.launches_write_q8, kw.launches[writer]) == (n0, w0 + 2)
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(fused, split))
    caches, _, p0, q, k, v = _write_case(dev, "dense200", 4, 1, 128, seed=5)
    with pytest.raises(ValueError, match="new rows must be"):
        da.chunk_attention_q8(q, *caches, p0, 0, k_new=k.float(), v_new=v.float())
    with pytest.raises(ValueError, match="new rows must be"):
        da.chunk_attention_q8(q, *caches, p0, 0, k_new=k[:, :2].contiguous(),
                              v_new=v[:, :2].contiguous())
    with pytest.raises(ValueError, match="come together"):
        da.chunk_attention_q8(q, *caches, p0, 0, k_new=k)


# -- K6 inside K7: the dense decode step's rows written by the walk launch --------


# GQA groups of a decode step (T = 1) over 2 kv heads: the 8-row form (rep 1 /
# 7 / 8), 16 rows (12, 16), 32 (24), 64 (64) and row groups of 64 (96: a
# partial second group; 128)
DECODE_WRITE_REPS = [1, 7, 8, 12, 16, 24, 64, 96, 128]


def _decode_write_case(dev, S, rep, hd, seed):
    """(caches, pos, q, k_new, v_new) of a fused decode-step write: an int8
    cache (2 layers) of kv_quant_rows'd N(0, 1) rows, bf16 q (B, 2 rep, hd),
    new rows (B, 2, hd) of mixed magnitude with a zero row and .5 ties, at
    positions 0, on the 64-row tile edges, S - 1 and a finished slot's
    overshoot S and S + 3 (K6's rule: row S - 1)."""
    pos = [0, 63, 64, 130, S - 1, S, S + 3]
    b, nkv = len(pos), 2
    (k8, ks), (v8, vs) = (_quant_rows(torch.randn(2, b, nkv, S, hd, device=dev))
                          for _ in range(2))
    q = torch.randn(b, nkv * rep, hd, device=dev).to(torch.bfloat16)
    k, v = (_kv_rows(dev, (b, nkv, hd), torch.bfloat16, seed=seed + i) for i in (1, 2))
    return [k8, v8, ks, vs], torch.tensor(pos, dtype=torch.int32, device=dev), q, k, v


@pytest.mark.parametrize("hd", [48, 64, 128])
@pytest.mark.parametrize("rep", DECODE_WRITE_REPS)
@pytest.mark.parametrize("S", [200, 2100])
def test_walk_writes_the_decode_steps_rows_as_k6_then_the_walk(dev, hd, rep, S):
    """K7 given the decode step's rows (decode_attention_q8 with k_new /
    v_new) equals K6 followed by K7 without them, in every row form and
    row groups, over splits of one tile (S 200) and of two (S 2100), at
    the planted positions of _decode_write_case (overshoot rows on row S -
    1): the outputs bit for bit, the cache (int8 bytes and f32 scales) byte
    for byte, the plain version within the bf16 tolerance and its cache
    exactly. Each fused call counts one K7 launch on the walk body in the
    form row_form gives, one fused write and no K6 launch."""
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kw

    caches, p0, q, k, v = _decode_write_case(dev, S, rep, hd, seed=hd + rep + S)
    form = da.row_form(1, rep)[0]
    for layer in (0, 1):
        fused, split, plain = ([c.clone() for c in caches] for _ in range(3))
        n0, w0 = da.launches_write_rows_q8, kw.launches["write_kv_rows_q8"]
        f0 = da.launches_by_form["walk"][form]
        got = da.decode_attention_q8(q, *fused, p0, layer, k_new=k, v_new=v)
        assert (da.launches_write_rows_q8, kw.launches["write_kv_rows_q8"]) == (n0 + 1, w0)
        assert da.launches_by_form["walk"][form] == f0 + 1
        kw.write_kv_rows_q8(*split, k, v, p0, layer)
        want = da.decode_attention_q8(q, *split, p0, layer)
        assert torch.equal(got, want)
        for a, b in zip(fused, split):
            assert torch.equal(a, b)
        _close(got, da.decode_attention_q8_plain(q, *plain, p0, layer, k, v), torch.bfloat16)
        for a, b in zip(fused, plain):
            assert torch.equal(a, b)


@pytest.mark.parametrize("rep", [1, 128])
def test_walk_decode_row_write_replays_in_a_cuda_graph(dev, rep):
    """The fused decode-step launch (the 8-row form, and two row groups of
    64) captured in a CUDA graph after a warm-up launch and replayed twice
    equals an eager launch on its own copy of the cache: outputs bit for
    bit, the cache byte for byte (a replay rewrites the same bytes)."""
    from rama_tpu_torch.ops.kernels import decode_attention as da

    caches, p0, q, k, v = _decode_write_case(dev, 2100, rep, 128, seed=41)
    eager_c, graph_c = [c.clone() for c in caches], [c.clone() for c in caches]
    eager = da.decode_attention_q8(q, *eager_c, p0, 1, k_new=k, v_new=v)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):   # warm up on the capture stream
        da.decode_attention_q8(q, *graph_c, p0, 1, k_new=k, v_new=v)
    torch.cuda.current_stream().wait_stream(stream)
    n0 = da.launches_write_rows_q8
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.decode_attention_q8(q, *graph_c, p0, 1, k_new=k, v_new=v)
    assert da.launches_write_rows_q8 == n0 + 1
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert all(torch.equal(a, b) for a, b in zip(graph_c, eager_c))


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 128), (torch.bfloat16, 16)])
def test_int8_decode_rows_off_the_walk_take_k6(dev, dtype, hd):
    """Off the walk (fp32 q: the SIMT body; head_dim 16) the decode step's
    rows given to K7 are written by K6's own launch first, then K7 runs
    without them: equal to that pair bit for bit (outputs, cache bytes),
    no fused write counted, K6 once; the C entry refuses K6's row rule
    (clamp) on more than one row a slot."""
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kw

    caches, p0, q, k, v = _decode_write_case(dev, 200, 2, hd, seed=7)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    fused, split = [c.clone() for c in caches], [c.clone() for c in caches]
    n0, w0 = da.launches_write_rows_q8, kw.launches["write_kv_rows_q8"]
    got = da.decode_attention_q8(q, *fused, p0, 1, k_new=k, v_new=v)
    assert (da.launches_write_rows_q8, kw.launches["write_kv_rows_q8"]) == (n0, w0 + 1)
    kw.write_kv_rows_q8(*split, k, v, p0, 1)
    assert torch.equal(got, da.decode_attention_q8(q, *split, p0, 1))
    assert all(torch.equal(a, b) for a, b in zip(fused, split))
    c, p0, q, k, v = _decode_write_case(dev, 200, 2, 128, seed=8)
    rows = tuple(r[:, None].expand(-1, 2, -1, -1).contiguous() for r in (k, v))
    with pytest.raises(ValueError, match="one new row a slot"):
        da._launch(q[:, None].expand(-1, 2, -1, -1).contiguous(), tuple(c), p0, 0,
                   "decode_attention_q8", rows=rows, clamp=True)


# -- K13 (b): the streaming strip writer -----------------------------------------


# (page rows, t_ins, strips written n of n + 1, kv heads, head_dim, a table
# entry past the pool): 8 / 16 / 64 / 128-row pages, odd t_ins, runs of one
# kv head (64 rows) and of several (short runs: 2 / 4 / 8 heads a CTA, a
# partial last group at 6 heads), the 7B serving bucket (16 rows, 32 kv
# heads) and an 8 x 512 admission
STREAM_CASES = [(8, 13, 3, 2, 128, False), (16, 333, 5, 6, 64, False),
                (64, 129, 7, 2, 48, False), (128, 77, 2, 3, 128, True),
                (128, 512, 8, 4, 128, False), (64, 64, 1, 2, 64, True),
                (128, 16, 8, 32, 128, False), (128, 5, 2, 8, 48, False)]


@pytest.mark.parametrize("ps,t_ins,n,nkv,hd,clamp", STREAM_CASES)
def test_write_kv_prefill_paged_q8_streaming_body(dev, ps, t_ins, n, nkv, hd, clamp):
    """K13 (b)'s streaming body (bf16 at hd 48 / 64 / 128) equals its plain
    version and the warp-a-row body byte for byte: shuffled pages, a
    partial last page, strips longer than t_ins, a pad strip past the
    group's tables, runs of one kv head and of several, and (clamp) a
    table entry past the pool, clamped onto a page no other entry holds.
    Each launch counts on its body."""
    from rama_tpu_torch.ops.kernels import kv_write as kw

    assert kw.prefill_body_for(torch.bfloat16, hd) == "stream"
    mp = -(-t_ins // ps) + 1
    npages = n * mp + 2
    g = torch.Generator().manual_seed(ps + t_ins)
    tables = torch.randperm(npages - 1, generator=g)[:n * mp].view(n, mp).to(torch.int32)
    if clamp:
        tables[0, 0] = npages + 4                       # page npages - 1, held by no entry
    tables = tables.to(dev)
    base = _q8_cache(dev, 3, npages, nkv, ps, hd, seed=t_ins)
    k, v = (_kv_rows(dev, (3, n + 1, nkv, t_ins + 3, hd), torch.bfloat16, seed=i)
            for i in (1, 2))
    got, rows, want = ([x.clone() for x in base] for _ in range(3))
    before = dict(kw.launches_by_body)
    kw.write_kv_prefill_paged_q8(*got, k, v, tables, t_ins)
    kw.write_kv_prefill_paged_q8(*rows, k, v, tables, t_ins, _body="rows")
    assert kw.launches_by_body == {"stream": before["stream"] + 1, "rows": before["rows"] + 1}
    kw.write_kv_prefill_paged_q8_plain(*want, k, v, tables, t_ins)
    for a, b, c in zip(got, rows, want):
        assert torch.equal(a, c) and torch.equal(b, c)


# -- K8: the streaming strip writer on the dense cache ---------------------------

# (layers, slots B, kv heads, cache rows S, strip rows T, t_ins, strips
# written n of K, head_dim, slots): the 7B serving bucket (16 rows: runs of
# 4 heads), an 8 x 512 admission (runs of 64 rows), t_ins 300 of 512 with n
# = 3 < K, S = 1000 (not a multiple of 64) with t_ins 1000, TinyLlama's hd
# 64 (4 kv heads), hd 48 with short strips (5 rows: 6 heads a CTA of 6), a
# duplicate slot carrying an identical strip, and slots -1 and B (written
# nowhere: the cache's bytes stay)
K8_STREAM_CASES = [(2, 8, 32, 256, 16, 16, 8, 128, [5, 2, 7, 0, 3, 6, 1, 4]),
                   (2, 8, 4, 512, 512, 512, 8, 128, [5, 2, 7, 0, 3, 6, 1, 4]),
                   (2, 6, 4, 600, 512, 300, 3, 128, [4, 0, 2]),
                   (2, 3, 2, 1000, 1000, 1000, 2, 128, [2, 0]),
                   (3, 5, 4, 128, 40, 33, 4, 64, [1, 4, 0, 3]),
                   (3, 4, 6, 64, 16, 5, 3, 48, [3, 1, 2]),
                   (2, 5, 4, 96, 64, 64, 4, 128, [4, 1, 1, 3]),
                   (2, 5, 4, 96, 64, 64, 4, 64, [-1, 2, 5, 0])]


@pytest.mark.parametrize("L,B,nkv,S,T,t_ins,n,hd,slots", K8_STREAM_CASES)
def test_write_kv_strips_q8_streaming_body(dev, L, B, nkv, S, T, t_ins, n, hd, slots):
    """K8's streaming body (bf16 at hd 48 / 64 / 128) equals its plain
    version and the warp-a-row body byte for byte (int8 rows and f32
    scales of the whole cache): runs of 64 rows at any S, several kv heads
    a CTA on short strips, n < K strips, a duplicate slot (identical
    strips) and slots outside [0, B) written nowhere. Each launch counts
    on its body."""
    from rama_tpu_torch.ops.kernels import kv_write as kw

    assert kw.prefill_body_for(torch.bfloat16, hd) == "stream"
    base = _q8_cache(dev, L, B, nkv, S, hd, seed=S + t_ins)
    k, v = (_kv_rows(dev, (L, n + 1, nkv, T, hd), torch.bfloat16, seed=i) for i in (3, 4))
    for j in range(1, n):
        if slots[j] == slots[j - 1]:
            k[:, j], v[:, j] = k[:, j - 1], v[:, j - 1]
    sl = torch.tensor(slots, dtype=torch.int32, device=dev)
    got, rows, want = ([x.clone() for x in base] for _ in range(3))
    before = dict(kw.strips_launches_by_body)
    kw.write_kv_strips_q8(*got, k, v, sl, t_ins)
    kw.write_kv_strips_q8(*rows, k, v, sl, t_ins, _body="rows")
    assert kw.strips_launches_by_body == {"stream": before["stream"] + 1,
                                          "rows": before["rows"] + 1}
    kw.write_kv_strips_q8_plain(*want, k, v, sl, t_ins)
    for a, b, c in zip(got, rows, want):
        assert torch.equal(a, c) and torch.equal(b, c)
    out = [s for s in slots if not 0 <= s < B]
    if out:   # the strips of out-of-range slots moved no byte
        keep = [s for s in range(B) if s not in slots]
        for a, c in zip(got, base):
            assert torch.equal(a[:, keep], c[:, keep])


def test_write_kv_strips_q8_streaming_body_replays_in_a_cuda_graph(dev):
    """K8's streaming launch captured in a CUDA graph: each replay writes
    the bytes the eager launch wrote."""
    from rama_tpu_torch.ops.kernels import kv_write as kw

    base = _q8_cache(dev, 2, 6, 8, 256, 128, seed=9)
    k, v = (_kv_rows(dev, (2, 4, 8, 100, 128), torch.bfloat16, seed=i) for i in (5, 6))
    sl = torch.tensor([5, 0, 3, 2], dtype=torch.int32, device=dev)
    eager, graph_c = [x.clone() for x in base], [x.clone() for x in base]
    kw.write_kv_strips_q8(*eager, k, v, sl, 100)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):   # warm up on the capture stream
        kw.write_kv_strips_q8(*graph_c, k, v, sl, 100)
    torch.cuda.current_stream().wait_stream(stream)
    n0 = kw.strips_launches_by_body["stream"]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kw.write_kv_strips_q8(*graph_c, k, v, sl, 100)
    assert kw.strips_launches_by_body["stream"] == n0 + 1
    for _ in range(2):
        for x, b in zip(graph_c, base):
            x.copy_(b)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(graph_c, eager))


def test_attn_block_refuses_operands_it_does_not_take(dev):
    from rama_tpu_torch.ops.kernels import attn_block as ab

    q, kn, vn, cos, sin, cache = _ab_case(dev, 2, 2, 1, 64, torch.bfloat16, seed=1)
    pos = torch.tensor([3, 4], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        ab.attn_rope_write_layered(q[..., :64], kn[..., :64], vn[..., :64], cos[:, :32],
                                   sin[:, :32], *(c[..., :64].contiguous() for c in cache),
                                   pos, 0)
    with pytest.raises(ValueError, match="int32"):
        ab.attn_rope_write_layered(q, kn, vn, cos, sin, *cache, pos.long(), 0)
    with pytest.raises(ValueError, match="dtypes differ"):
        ab.attn_rope_write_layered(q.float(), kn, vn, cos, sin, *cache, pos, 0)

def _hd128_params(dev, seed=3):
    import numpy as np

    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models.llama import quantize_params

    cfg = ModelConfig(dim=256, hidden_dim=176, n_layers=2, n_heads=2, n_kv_heads=2,
                      vocab_size=128, seq_len=64)
    rng = np.random.default_rng(seed)
    L, D, H, V = 2, 256, 176, 128
    p = {n: (rng.standard_normal(s) * 0.1).astype(np.float32) for n, s in {
        "tok_embedding": (V, D), "wq": (L, D, D), "wk": (L, D, D), "wv": (L, D, D),
        "wo": (L, D, D), "w1": (L, D, H), "w2": (L, H, D), "w3": (L, D, H)}.items()}
    p.update(attn_norm=np.ones((L, D), np.float32), ffn_norm=np.ones((L, D), np.float32),
             final_norm=np.ones(D, np.float32))
    return cfg, lambda device: quantize_params(cfg, p, group_size=16, dtype=torch.float32,
                                               device=device)


def test_t1_prefill_on_card_never_reaches_plain_attention(dev, monkeypatch):
    """prefill of a one-token prompt and forward(logit_rows) at T = 1 on the
    card run kernel 9 on a dense and an int8 cache, with the masked einsum
    and the layer dequantization made to raise; logits equal the CPU's
    (fp32, atol 1e-3)."""
    from rama_tpu_torch.models import llama
    from rama_tpu_torch.ops.kernels import decode_attention as da

    cfg, make = _hd128_params(dev)
    cpu_p, gpu_p = llama.fuse_params(make("cpu"), cfg), llama.fuse_params(make(dev), cfg)
    toks = torch.tensor([[1], [7], [3]])
    outs = {}
    for device, params in (("cpu", cpu_p), (dev, gpu_p)):
        for cls in (llama.KVCache, llama.QuantKVCache):
            kw = {"dtype": torch.float32} if cls is llama.KVCache else {}
            cache = cls.create(cfg, 3, 32, device=device, **kw)
            if device != "cpu":
                def boom(*a, **k):
                    raise AssertionError("a T = 1 call on the card reached plain attention")

                monkeypatch.setattr(llama, "_attention", boom)
                monkeypatch.setattr(llama, "_dequant_kv", boom)
            before = (da.launches_flat, da.launches_flat_q8)
            a, _ = llama.prefill(params, cfg, toks.to(device), cache, last_only=True)
            b, _ = llama.forward(params, cfg, toks.to(device) + 4,
                                 torch.ones((3, 1), dtype=torch.long, device=device), cache,
                                 logit_rows=torch.zeros(3, dtype=torch.long, device=device))
            if device != "cpu":
                q8 = cls is llama.QuantKVCache
                assert (da.launches_flat_q8 if q8 else da.launches_flat) - before[q8] == \
                    2 * cfg.n_layers
            outs.setdefault(cls.__name__, []).append((a.cpu(), b.cpu()))
            monkeypatch.undo()
    for pair in outs.values():
        for x, y in zip(*pair):
            torch.testing.assert_close(y, x, atol=1e-3, rtol=0)


@pytest.mark.parametrize("mode", [1, 2])
def test_engine_under_attn_block_on_card_never_runs_k4(dev, monkeypatch, mode):
    """A serve-style engine run on the card under RAMA_ATTN_BLOCK 1 / 2
    (K14 in every decode step, K4's wrapper made to raise) emits the CPU
    engine's greedy streams in mode 0 (fp32)."""
    from rama_tpu_torch.config import EngineConfig
    from rama_tpu_torch.models import llama
    from rama_tpu_torch.ops.kernels import attn_block as ab
    from rama_tpu_torch.runtime.engine import Engine, Request
    from rama_tpu_torch.tokenizer import Tokenizer

    cfg, make = _hd128_params(dev, seed=5)
    v = cfg.vocab_size
    tok = Tokenizer(["<unk>", "<s>", "</s>"] + [chr(97 + i % 26) + str(i // 26) * (i >= 26)
                                                for i in range(v - 3)], [0.0] * v)
    streams = []
    for device, m in (("cpu", 0), (dev, mode)):
        monkeypatch.setattr(llama, "ATTN_BLOCK", m)
        if device != "cpu":
            def boom(*a, **k):
                raise AssertionError("K4 launched under the fused attention block")

            monkeypatch.setattr(llama._KERNELS, "decode_attention", boom)
        name = "attn_block_layered" if mode == 2 else "attn_rope_write_layered"
        before = ab.launches[name]
        eng = Engine(cfg, make(device), tok, EngineConfig(max_batch_size=4, decode_tick=4))
        reqs = [Request(prompt="ab" * 20, steps=10, temperature=0.0, stop_at_eos=False),
                Request(prompt="abc", steps=100, temperature=0.0, stop_at_eos=False),
                Request(prompt="zq", steps=20, temperature=0.0, stop_at_eos=False)]
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
        if device != "cpu":
            assert ab.launches[name] > before
    assert streams[0] == streams[1]


def test_top_p_chooses_its_walk_without_a_sync(dev):
    """The sampler at V = 32000 (peaked rows, a flat row that forces the full
    sort, and an all-peaked batch) runs under set_sync_debug_mode("error"):
    no host read on the way, and the ids equal the CPU's."""
    from rama_tpu_torch.runtime.sampler import _top_p_from_u

    g = torch.Generator().manual_seed(11)
    for flat_rows in (0, 1):
        scales = torch.full((8, 1), 8.0)
        scales[:flat_rows] = 0.05
        logits = torch.randn(8, 32000, generator=g) * scales
        u = torch.rand(8, generator=g)
        temps, tps = torch.full((8,), 0.9), torch.full((8,), 0.9)
        want = _top_p_from_u(logits, u, temps, tps)
        args = [x.to(dev) for x in (logits, u, temps, tps)]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = _top_p_from_u(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kv_quant,spec_tick,paged", [(None, 0, False), ("int8", 0, False),
                                                      ("int8", 3, False), ("int8", 0, True),
                                                      (None, 3, True)])
def test_pipelined_dispatch_never_syncs_on_the_card(dev, kv_quant, spec_tick, paged):
    """The pipelined loop on the card: every chained plain or spec dispatch
    and every admission dispatched behind in-flight ticks runs under
    set_sync_debug_mode("error") (a sync raises, the loop counts an engine
    error); at least one of each ran, no error was counted, and the greedy
    and sampled streams equal the CPU engine's."""
    from rama_tpu_torch.config import EngineConfig
    from rama_tpu_torch.runtime.engine import Engine, Request

    outs = []
    for device in ("cpu", dev):
        cfg, params, tok = _small_int8_model(device)
        eng = Engine(cfg, params,
                     tok, EngineConfig(max_batch_size=4, decode_tick=4, kv_quant=kv_quant,
                                       spec_tick=spec_tick, spec_min_accept=0.0,
                                       paged_kv=paged, kv_page_size=16))
        late = Request(prompt="zq", steps=12, temperature=0.9)
        counts = {"_dispatch_chained": 0, "_dispatch_spec_chained": 0, "_admit_dispatch": 0}
        for name in counts:
            orig = getattr(eng, name)

            def strict(*a, _name=name, _orig=orig):
                behind = bool(eng._inflight_q or eng._spec_inflight_q)
                if device != "cpu":
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    out = _orig(*a)
                finally:
                    if device != "cpu":
                        torch.cuda.set_sync_debug_mode(0)
                if out is not None or (_name == "_admit_dispatch" and behind
                                       and eng._admit_jobs):
                    counts[_name] += 1
                return out

            setattr(eng, name, strict)
        name = "_process_spec_inflight" if spec_tick else "_process_inflight"
        process = getattr(eng, name)

        def submit_late(inf):
            out = process(inf)
            if not late.prompt_ids:
                eng.submit(late)         # arrives while ticks are in flight
            return out

        setattr(eng, name, submit_late)
        reqs = [Request(prompt="abc", steps=60, temperature=0.0, stop_at_eos=False),
                Request(prompt="ab" * 5, steps=50, temperature=0.8, stop_at_eos=False)]
        eng.start()
        try:
            for r in reqs:
                eng.submit(r)
            got = []
            for r in reqs + [late]:
                toks = []
                while (t := r.queue.get(timeout=300)) is not None:
                    toks.append(t)
                got.append(toks)
        finally:
            eng.stop()
        assert eng.stats()["engine_errors"] == 0 and all(r.error is None for r in reqs)
        assert counts["_dispatch_spec_chained" if spec_tick else "_dispatch_chained"] >= 1
        assert counts["_admit_dispatch"] >= 1, counts
        outs.append(got)
    assert outs[0] == outs[1]


def _small_int8_model(device):
    """A 2-layer model (dim 256, GQA 2, vocab 128, 128 rows), int8 gs 64 on
    `device`, and its letter tokenizer."""
    import numpy as np

    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models.llama import quantize_params
    from rama_tpu_torch.tokenizer import Tokenizer

    cfg = ModelConfig(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                      vocab_size=128, seq_len=128)
    rng = np.random.default_rng(3)
    L, D, H, V, KV = 2, 256, 512, 128, 128
    p = {n: (rng.standard_normal(s) * 0.05).astype(np.float32) for n, s in {
        "tok_embedding": (V, D), "wq": (L, D, D), "wk": (L, D, KV), "wv": (L, D, KV),
        "wo": (L, D, D), "w1": (L, D, H), "w2": (L, H, D), "w3": (L, D, H)}.items()}
    p.update(attn_norm=np.ones((L, D), np.float32), ffn_norm=np.ones((L, D), np.float32),
             final_norm=np.ones(D, np.float32))
    vocab = ["<unk>", "<s>", "</s>"] + [chr(97 + i % 26) + str(i // 26) * (i >= 26)
                                        for i in range(V - 3)]
    return (cfg, quantize_params(cfg, p, group_size=64, dtype=torch.float32, device=device),
            Tokenizer(vocab, [0.0] * V))


@pytest.mark.parametrize("kv_quant,paged", [(None, False), ("int8", False), ("int8", True),
                                            (None, True)])
def test_chunk_step_and_finisher_never_sync_on_the_card(dev, kv_quant, paged):
    """Chunked prefill on the card: every chunk and finisher dispatch runs
    under set_sync_debug_mode("error") (a sync raises, the loop counts an
    engine error); a 75-token prompt takes 5 chunks of 16 while a short
    stream decodes, each finisher launches K8 on the int8 cache and K13 (b)
    on the int8 pool once, and the greedy and sampled streams equal the CPU
    engine's."""
    from rama_tpu_torch.config import EngineConfig
    from rama_tpu_torch.ops.kernels import kv_write as kvw
    from rama_tpu_torch.runtime.engine import Engine, Request

    outs = []
    for device in ("cpu", dev):
        cfg, params, tok = _small_int8_model(device)
        eng = Engine(cfg, params, tok, EngineConfig(
            max_batch_size=4, decode_tick=4, kv_quant=kv_quant, paged_kv=paged,
            kv_page_size=16, prefill_chunk=16, prefill_chunk_min=16))
        counts = {"_dev_pf_chunk": 0, "_dev_pf_finish": 0}
        writes = []
        for name in counts:
            orig = getattr(eng, name)

            def strict(*a, _name=name, _orig=orig):
                before = dict(kvw.launches)
                if device != "cpu":
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    out = _orig(*a)
                finally:
                    if device != "cpu":
                        torch.cuda.set_sync_debug_mode(0)
                counts[_name] += 1
                if _name == "_dev_pf_finish":
                    writes.append({k: kvw.launches[k] - before[k] for k in (
                        "write_kv_strips_q8", "write_kv_prefill_paged_q8")})
                return out

            setattr(eng, name, strict)
        reqs = [Request(prompt="abc", steps=40, temperature=0.0, stop_at_eos=False),
                Request(prompt="abcde" * 15, steps=12, temperature=0.8, stop_at_eos=False)]
        eng.start()
        try:
            for r in reqs:
                eng.submit(r)
            got = []
            for r in reqs:
                toks = []
                while (t := r.queue.get(timeout=300)) is not None:
                    toks.append(t)
                got.append(toks)
        finally:
            eng.stop()
        assert eng.stats()["engine_errors"] == 0 and all(r.error is None for r in reqs)
        assert counts == {"_dev_pf_chunk": 5, "_dev_pf_finish": 1}
        if device != "cpu":
            writer = ("write_kv_prefill_paged_q8" if paged and kv_quant else
                      "write_kv_strips_q8" if kv_quant else None)
            assert writes == [{k: int(k == writer) for k in writes[0]}]
        outs.append(got)
    assert outs[0] == outs[1]


def _stories15m_int8(dev):
    """A stories15M-shaped model (6 layers, dim 288, head_dim 48, the
    fixture tokenizer's 32000 ids), int8 gs 32, bf16 on the card."""
    import os

    import numpy as np

    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models.llama import quantize_params
    from rama_tpu_torch.tokenizer import Tokenizer

    cfg = ModelConfig(dim=288, hidden_dim=768, n_layers=6, n_heads=6, n_kv_heads=6,
                      vocab_size=32000, seq_len=256)
    rng = np.random.default_rng(7)
    L, D, H, V = 6, 288, 768, 32000
    p = {n: (rng.standard_normal(s) * 0.05).astype(np.float32) for n, s in {
        "tok_embedding": (V, D), "wq": (L, D, D), "wk": (L, D, D), "wv": (L, D, D),
        "wo": (L, D, D), "w1": (L, D, H), "w2": (L, H, D), "w3": (L, D, H)}.items()}
    p.update(attn_norm=np.ones((L, D), np.float32), ffn_norm=np.ones((L, D), np.float32),
             final_norm=np.ones(D, np.float32))
    path = os.path.join(os.path.dirname(__file__), "fixtures", "tokenizer.bin")
    return (cfg, quantize_params(cfg, p, group_size=32, dtype=torch.bfloat16, device=dev),
            Tokenizer.from_file(path, 32000))


def test_chat_turn_and_perplexity_match_plain_on_the_card(dev, monkeypatch):
    """A stories15M-shaped chat: each of two turns' last-prefill logits
    through the kernels against plain=True on a copy of the cache, and
    perplexity over ~136 tokens (window 32, batch 2: 5 windows padded to
    6) with the kernels against plain=True: the full logits each batch is
    scored with bf16 within 2e-2, the nll within 1e-3 (rel)."""
    import copy

    import rama_tpu_torch.eval as ev
    from rama_tpu_torch.eval import perplexity
    from rama_tpu_torch.models.llama import KVCache
    from rama_tpu_torch.runtime.chat import ChatSession

    cfg, params, tok = _stories15m_int8(dev)
    s = ChatSession(params, cfg, tok, temperature=0.0, system="You are brief.")
    prefill, checked = s._prefill_chunk, []

    def compare(ids):
        ref = copy.copy(s)
        ref.cache, ref.plain = KVCache(k=s.cache.k.clone(), v=s.cache.v.clone()), True
        want = ChatSession._prefill_chunk(ref, ids)
        got = prefill(ids)
        _close(got, want, torch.bfloat16)
        checked.append(len(ids))
        return got

    s._prefill_chunk = compare
    emitted = sum(len(list(s.turn(text, max_new=16))) for text in ("Hello there.",
                                                                   "Tell me a story."))
    assert len(checked) == 2 and s.pos == sum(checked) + emitted
    text = "Once upon a time there was a little girl named Lily who loved the park. " * 8
    scored, prefill = [], ev.prefill

    def kept(*a, **kw):
        logits, cache = prefill(*a, **kw)
        scored.append(logits)
        return logits, cache

    monkeypatch.setattr(ev, "prefill", kept)
    got = perplexity(params, cfg, tok, text, window=32, batch=2)
    want = perplexity(params, cfg, tok, text, window=32, batch=2, plain=True)
    assert got["tokens"] == want["tokens"] and got["windows"] == want["windows"] >= 4
    assert len(scored) == 6
    for g, w in zip(scored[:3], scored[3:]):
        _close(g, w, torch.bfloat16)
    assert abs(got["nll"] - want["nll"]) <= 1e-3 * abs(want["nll"])
