"""Kernel 2's plain version (rama_tpu_torch.ops.kernels.ffn.ffn_plain) against
rama_tpu's ffn_fused_layered run in interpret mode, for the il-interleaved
and the plain [W1 | W3] w13 layouts, int8 and packed int4 weights, built by
each package's own fuse_params from the same numpy weights.

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


def _check_plain_matches_pallas(jp, interleaved, m, dtype, layer):
    jw13, jw2 = jp["w13"], jp["w2"]
    if not interleaved:
        # undo the interleave: plain [W1 | W3] columns, il = 0
        def plain(a):
            *lead, k, n = a.shape
            t = np.asarray(a).reshape(*lead, k, n // 512, 2, 256)
            return jnp.asarray(np.swapaxes(t, -3, -2).reshape(*lead, k, n))
        from rama_tpu.ops.quant import QuantizedTensor
        jw13 = QuantizedTensor(q=plain(jw13.q), scales=plain(jw13.scales),
                               group_size=jw13.group_size, bits=jw13.bits, il=0)
    tw = jax_params_to_torch(CFG, {"w13": jw13, "w2": jw2})
    assert tw["w13"].il == (256 if interleaved else 0)
    x = np.random.default_rng(6).standard_normal((m, CFG.dim)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(ffn_fused_layered(jnp.asarray(x, jd), jw13, jw2, jnp.int32(layer),
                                        interpret=True).astype(jnp.float32))
    got = ffn_plain(torch.from_numpy(x).to(td), tw["w13"], tw["w2"], layer).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


def test_split_h13_matches_jax(fused):
    jp, tp = fused
    h = np.arange(3 * 1024, dtype=np.float32).reshape(3, 1024)
    for a, b in zip(split_h13(torch.from_numpy(h), tp["w13"]),
                    jl.split_h13(jnp.asarray(h), jp["w13"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("bits", [8, 4])
def test_cpu_wrapper_dispatches_to_plain(fused, fused4, bits):
    from rama_tpu_torch.ops.kernels import ffn as mod

    _, tp = fused if bits == 8 else fused4
    x = torch.randn(2, CFG.dim)
    before = dict(mod.launches)
    torch.testing.assert_close(t_ffn(x, tp["w13"], tp["w2"], 1),
                               ffn_plain(x, tp["w13"], tp["w2"], 1), rtol=0, atol=0)
    assert mod.launches == before
