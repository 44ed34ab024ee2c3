"""Kernel 5's plain version (prefill_attention_plain) against rama_tpu's
prefill_attention in interpret mode: every query row, plen < T, plen == T,
GQA (groups that divide 64, and 3, 5, 6, 7, 12 with plen at the CUDA
tiles' position edges), a cache longer than the prompt; which kernel body
and form a CUDA call would launch; and the CUDA tiles' rows (tile_rows)
covering every (head, position) of any group once.

Tolerance: fp32 atol 1e-4; bf16 compared in fp32 with rel 2e-2 of max |ref|.
plen == 0 is not compared: the Pallas kernel's -1e30 fill turns a row with
no visible key into the mean of the first S-tile's values, the port outputs
zeros (the engine never prefills an empty row: every prompt starts with BOS)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rama_tpu.ops.pallas.prefill_attention import prefill_attention
from rama_tpu_torch.ops.kernels import prefill_attention as pa_mod
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
    # groups that do not divide 64, plen on the "gqa" form's position edges
    # (bq = 64 // group positions a tile: 21, 12, 10, 9, 5)
    (3, 1, 24, 24, [21, 22]),    # group 3
    (10, 2, 16, 24, [12, 13]),   # group 5
    (12, 2, 24, 32, [10, 20]),   # group 6
    (7, 1, 24, 24, [9, 18]),     # group 7 (Yi-34B's)
    (14, 2, 32, 40, [27, 8]),    # group 7 over 2 kv heads
    (12, 1, 16, 16, [5, 11]),    # group 12
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


@pytest.mark.parametrize("hd", [48, 64, 128])
def test_bf16_at_an_instantiated_head_dim_takes_the_tensor_core_body(hd):
    assert hd in pa_mod.MMA_HEAD_DIMS
    assert pa_mod.body_for(torch.bfloat16, hd) == "mma"


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 48), (torch.float32, 64),
                                      (torch.float32, 128), (torch.bfloat16, 16),
                                      (torch.bfloat16, 32), (torch.bfloat16, 96),
                                      (torch.bfloat16, 256)])
def test_fp32_and_other_head_dims_take_the_simt_body(dtype, hd):
    assert pa_mod.body_for(dtype, hd) == "simt"


def test_cpu_wrapper_counts_no_launch_on_either_body():
    q, k, v = make(1, 8, 2, 2, 8, 64, seed=3)
    before = (pa_mod.launches, dict(pa_mod.launches_by_body), dict(pa_mod.launches_by_form))
    t_pa(torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
         torch.from_numpy(v).bfloat16(), torch.tensor([5], dtype=torch.int32))
    assert (pa_mod.launches, pa_mod.launches_by_body, pa_mod.launches_by_form) == before


@pytest.mark.parametrize("rep", [1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16, 33, 63, 64, 65, 96, 128,
                                 130])
def test_tiles_cover_every_head_and_position_once(rep):
    """The CUDA launch's rows (csrc pa_rows, mirrored by tile_rows) for a
    group of rep over 2 kv heads and T = 2 bq + 1 (a partial last tile):
    every live row of every (kv head, slice, q tile) CTA is one (head,
    position) of the prompt, each met once; the idle rows are the 64 - hc
    * bq past the heads' positions and the heads past the group's last in
    its last slice: none where the group divides 64 (the "div64" form) or
    is a multiple of it (whole slices of the "gqa" form)."""
    nkv = 2
    hc, ns, bq = pa_mod.tile_rows(rep)
    assert hc * bq <= pa_mod.ROWS and hc == min(rep, 64) and ns * hc >= rep > (ns - 1) * hc
    t = 2 * bq + 1
    seen, idle = [], 0
    for j in range(nkv):
        for sl in range(ns):
            h0 = j * rep + sl * hc
            live = min(hc, j * rep + rep - h0) * bq
            for tile in range(-(-t // bq)):
                for r in range(pa_mod.ROWS):
                    h, pos = h0 + r // bq, tile * bq + r % bq
                    if r >= live:
                        idle += 1
                    elif pos < t:
                        seen.append((h, pos))
    assert sorted(seen) == [(h, p) for h in range(nkv * rep) for p in range(t)]
    assert (idle == 0) == (64 % rep == 0 or rep % 64 == 0)
    assert (pa_mod.form_for(nkv * rep, nkv) == "div64") == (64 % rep == 0)
