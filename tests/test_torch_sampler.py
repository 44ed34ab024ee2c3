"""rama_tpu_torch.runtime.sampler against rama_tpu.runtime.sampler: token ids
equal JAX `_top_p_from_u` on the same logits and uniforms (exact), through
the small-vocab full sort, the top-1024 prefilter and its full-sort
fallback, temperature < 1 and > 1 (not scaled — the reference quirk)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rama_tpu.runtime.sampler import _top_p_from_u as j_top_p
from rama_tpu.runtime.sampler import sample_greedy as j_greedy
from rama_tpu_torch.runtime.sampler import (_top_p_from_u, sample_batched_keyed,
                                            sample_greedy, uniform_from_key)

torch.set_num_threads(1)


@pytest.mark.parametrize("v,scale,temp,top_p", [
    (100, 1.0, 0.9, 0.9),       # small vocab: one full sort
    (8192, 8.0, 0.9, 0.9),      # peaked: the top-1024 prefilter path
    (8192, 0.05, 0.9, 0.9),     # flat: prefilter can't close -> full sort
    (8192, 1.0, 1.5, 0.8),      # temperature > 1 is NOT applied
    (8192, 1.0, 0.3, 0.95),
])
def test_ids_match_jax_on_same_uniforms(v, scale, temp, top_p):
    rng = np.random.default_rng(v + int(10 * temp))
    b = 8
    for seed in range(4):
        logits = (rng.standard_normal((b, v)) * scale).astype(np.float32)
        u = np.random.default_rng(seed).uniform(size=b).astype(np.float32)
        want = np.asarray(j_top_p(jnp.asarray(logits), jnp.asarray(u), temp, top_p))
        got = _top_p_from_u(torch.from_numpy(logits), torch.from_numpy(u), temp, top_p)
        np.testing.assert_array_equal(got.numpy(), want)


def test_per_slot_hyperparameters_match_jax():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((4, 300)).astype(np.float32) * 3
    u = rng.uniform(size=4).astype(np.float32)
    temps = np.array([0.5, 1.0, 2.0, 0.9], np.float32)
    tps = np.array([0.5, 0.9, 0.99, 0.7], np.float32)
    want = np.asarray(j_top_p(jnp.asarray(logits), jnp.asarray(u), jnp.asarray(temps),
                              jnp.asarray(tps)))
    got = _top_p_from_u(torch.from_numpy(logits), torch.from_numpy(u),
                        torch.from_numpy(temps), torch.from_numpy(tps))
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_matches_jax():
    logits = np.random.default_rng(1).standard_normal((5, 64)).astype(np.float32)
    np.testing.assert_array_equal(sample_greedy(torch.from_numpy(logits)).numpy(),
                                  np.asarray(j_greedy(jnp.asarray(logits))))


def test_uniform_from_key_is_a_pure_function_of_key_and_pos():
    keys = torch.tensor([[1, 2], [0xFFFFFFFF, 7], [1, 2]], dtype=torch.int64)
    pos = torch.tensor([5, 5, 6])
    u = uniform_from_key(keys, pos)
    assert ((u >= 0) & (u < 1)).all()
    assert u[0] != u[2] and u[0] != u[1]
    # same (key, pos) -> same draw, whatever the batch around it
    again = uniform_from_key(keys[[2, 0]], pos[[2, 0]])
    torch.testing.assert_close(again, u[[2, 0]], rtol=0, atol=0)
    # roughly uniform over many positions
    many = uniform_from_key(torch.tensor([[123, 456]]).expand(20000, 2),
                            torch.arange(20000))
    assert abs(float(many.mean()) - 0.5) < 0.01
    assert np.histogram(many.numpy(), bins=10, range=(0, 1))[0].min() > 1800


def test_keyed_batch_greedy_rows_and_sampled_rows():
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 50))
                              .astype(np.float32))
    keys = torch.tensor([[1, 1], [2, 2], [3, 3]])
    pos = torch.tensor([4, 4, 4])
    temps = torch.tensor([0.0, 0.8, 0.8])
    tps = torch.tensor([0.9, 0.9, 0.9])
    ids = sample_batched_keyed(logits, keys, pos, temps, tps)
    assert ids[0] == sample_greedy(logits)[0]
    want = _top_p_from_u(logits, uniform_from_key(keys, pos), temps, tps)
    torch.testing.assert_close(ids[1:], want[1:], rtol=0, atol=0)
