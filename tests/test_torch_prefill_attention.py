"""Kernel 4's plain version (prefill_attention_plain) against rama_tpu's
prefill_attention in interpret mode: every query row, plen < T, plen == T,
GQA, a cache longer than the prompt.

Tolerance: fp32 atol 1e-4; bf16 compared in fp32 with rel 2e-2 of max |ref|.
plen == 0 is not compared: the Pallas kernel's -1e30 fill turns a row with
no visible key into the mean of the first S-tile's values, the port outputs
zeros (the engine never prefills an empty row: every prompt starts with BOS)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rama_tpu.ops.pallas.prefill_attention import prefill_attention
from rama_tpu_torch.ops.kernels.prefill_attention import (prefill_attention as t_pa,
                                                          prefill_attention_plain)

torch.set_num_threads(1)


def make(b, t, nh, nkv, s, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, nh, hd)).astype(np.float32)
    k = (rng.standard_normal((b, nkv, s, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((b, nkv, s, hd)) * 0.5).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("nh,nkv,t,s,plen", [
    (2, 2, 16, 16, [16, 5]),
    (4, 2, 16, 32, [1, 9]),      # GQA, cache longer than the prompt
    (2, 1, 24, 24, [24, 13]),    # MQA, T not a power of two
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas(nh, nkv, t, s, plen, dtype):
    q, k, v = make(2, t, nh, nkv, s, 128, seed=t + nh)
    pl = np.array(plen, np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(prefill_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                        jnp.asarray(v, jd), jnp.asarray(pl),
                                        interpret=True).astype(jnp.float32))
    got = prefill_attention_plain(torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
                                  torch.from_numpy(v).to(td),
                                  torch.from_numpy(pl)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


def test_empty_prompt_rows_are_zero_not_nan():
    q, k, v = make(2, 8, 2, 2, 8, 16, seed=1)
    out = prefill_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.tensor([0, 3], dtype=torch.int32))
    assert torch.isfinite(out).all()
    assert (out[0] == 0).all() and (out[1] != 0).any()


def test_cpu_wrapper_dispatches_to_plain():
    q, k, v = make(1, 8, 2, 2, 8, 16, seed=2)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.tensor([6], dtype=torch.int32))
    torch.testing.assert_close(t_pa(*args), prefill_attention_plain(*args), rtol=0, atol=0)
