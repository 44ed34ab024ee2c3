"""Kernel 3's plain version (decode_attention_plain) against rama_tpu's
decode_attention_layer and decode_attention_layer_tiled in interpret mode:
ragged positions (0, tile boundaries, S-1), layers 0 and L-1, MHA and GQA.

Tolerance: fp32 caches atol 1e-4; bf16 caches (probabilities rounded to
bf16 before P.V at different points: normalized in the whole-S kernel,
unnormalized per tile in the tiled one) compared in fp32 with rel 2e-2 of
max |ref|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rama_tpu.ops.pallas.decode_attention import (decode_attention_layer,
                                                  decode_attention_layer_tiled)
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
