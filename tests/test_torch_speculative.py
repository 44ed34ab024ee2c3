"""rama_tpu_torch.runtime.speculative on the CPU, on the fp32 tiny model the
JAX package's speculation tests use: ngram_propose row for row equal to
rama_tpu's; single-stream n-gram and draft-model speculation emit the
greedy ids of rama_tpu's speculative generators and of the port's
sequential generate_text (also at steps = seq_len, where the last chunks
reach the cache end and their rows past it are dropped); a sampled
speculative stream equals a sequential loop with the same position-keyed
draws; and the CLI's --spec flags print the same text as --spec off.
Comparisons are exact (greedy ids)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import torch_cfg, write_tokenizer_bin
from rama_tpu.models import llama as jl
from rama_tpu.runtime import speculative as jspec
from rama_tpu.testing.ref_model import random_params, tiny_config
from rama_tpu_torch.checkpoint import save_v0
from rama_tpu_torch.cli import main as cli_main
from rama_tpu_torch.models import llama as tl
from rama_tpu_torch.runtime import speculative as spec
from rama_tpu_torch.runtime.generate import generate_prefill_decode
from rama_tpu_torch.runtime.sampler import sample_batched_keyed
from rama_tpu_torch.tokenizer import BOS_ID

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    jcfg = tiny_config()
    np_params = random_params(jcfg, seed=3)
    cfg = torch_cfg(jcfg)
    return (jcfg, jl.load_params(jcfg, np_params, dtype=jnp.float32), cfg,
            tl.load_params(cfg, np_params, dtype=torch.float32, device="cpu"))


def _histories():
    rng = np.random.default_rng(0)
    cap = 24
    rows = [rng.integers(0, 6, cap), rng.integers(0, 50, cap),          # repetitive, random
            np.array([9, 5, 6, 7, 5, 6] + [0] * (cap - 6)),
            np.tile([3, 1, 4], cap // 3), np.arange(cap)]
    return np.stack(rows).astype(np.int64)


@pytest.mark.parametrize("gram,k", [(2, 3), (2, 7), (3, 4), (1, 2)])
def test_ngram_propose_equals_jax(gram, k):
    toks = _histories()
    for n in range(0, toks.shape[1] + 1):
        ns = np.full(toks.shape[0], n)
        got = spec.ngram_propose(torch.from_numpy(toks), torch.from_numpy(ns), k, gram)
        for b in range(toks.shape[0]):
            want = jspec.ngram_propose(jnp.asarray(toks[b], jnp.int32), jnp.int32(n), k, gram)
            assert got[b].tolist() == np.asarray(want).tolist(), (b, n)


def test_ngram_propose_ragged_counts():
    """Each row of one call keeps its own count."""
    toks = _histories()
    ns = np.array([7, 12, 6, 24, 3])
    got = spec.ngram_propose(torch.from_numpy(toks), torch.from_numpy(ns), 4)
    for b in range(toks.shape[0]):
        want = jspec.ngram_propose(jnp.asarray(toks[b], jnp.int32), jnp.int32(ns[b]), 4)
        assert got[b].tolist() == np.asarray(want).tolist()
    assert got[2].tolist() == [7, 5, 6, 0]   # tail [5, 6] matches at 1 -> toks[3:7]


def _sequential(tp, cfg, prompt_ids, steps):
    cache = tl.KVCache.create(cfg, 1, dtype=torch.float32, device="cpu")
    return generate_prefill_decode(tp, cfg, prompt_ids, steps, 0.0, 0.9, None, cache)


@pytest.mark.parametrize("prompt_ids,steps,k", [([5, 9, 2, 5, 9, 2, 5, 9], 24, 4),
                                                ([11, 3, 17, 9], 16, 4),
                                                ([5, 9, 2, 5, 9, 2], 48, 8),
                                                ([5, 9, 2, 5, 9, 2], 48, 10)])
def test_ngram_greedy_equals_jax_and_sequential(model, prompt_ids, steps, k):
    """steps 48 = seq_len: the last rounds' chunks run past the cache end
    (k 10: chunks of 10 take the generic forward, whose multi-row write
    drops those rows too)."""
    jcfg, jp, cfg, tp = model
    jids, _, _ = jspec.generate_speculative_ngram(
        jp, jcfg, jnp.asarray(prompt_ids, jnp.int32), steps, len(prompt_ids), 0.0, 0.9,
        jax.random.PRNGKey(7), jl.KVCache.create(jcfg, batch=1, dtype=jnp.float32), k=k)
    cache = tl.KVCache.create(cfg, 1, dtype=torch.float32, device="cpu")
    ids, rounds, accepted = spec.generate_speculative_ngram(
        tp, cfg, prompt_ids, steps, 0.0, 0.9, spec.stream_key(7), cache, k=k)
    assert ids == np.asarray(jids).tolist()
    assert ids == _sequential(tp, cfg, prompt_ids, steps)
    assert rounds >= 1 and 0 <= accepted <= rounds * (k - 1)


@pytest.mark.parametrize("steps", [30, 48])
def test_draft_equal_to_target_accepts_every_draft(model, steps):
    """Draft == target: ids equal JAX's and the sequential loop's, and every
    draft is accepted."""
    jcfg, jp, cfg, tp = model
    prompt_ids, k = [3, 1, 4, 1, 5], 4
    jids, jrounds, jacc = jspec.generate_speculative_draft(
        jp, jcfg, jp, jcfg, jnp.asarray(prompt_ids, jnp.int32), steps, len(prompt_ids), 0.0,
        0.9, jax.random.PRNGKey(0), jl.KVCache.create(jcfg, batch=1, dtype=jnp.float32),
        jl.KVCache.create(jcfg, batch=1, dtype=jnp.float32), k=k)
    caches = [tl.KVCache.create(cfg, 1, dtype=torch.float32, device="cpu") for _ in range(2)]
    ids, rounds, accepted = spec.generate_speculative_draft(
        tp, cfg, tp, cfg, prompt_ids, steps, 0.0, 0.9, spec.stream_key(0), *caches, k=k)
    assert ids == np.asarray(jids).tolist() == _sequential(tp, cfg, prompt_ids, steps)
    assert accepted == rounds * (k - 1)


def test_draft_model_of_other_shape_keeps_the_stream(model):
    """A smaller random draft model (accepts little): ids unchanged."""
    jcfg, jp, cfg, tp = model
    dj = tiny_config(dim=32, hidden_dim=96, n_layers=2, n_heads=2, n_kv_heads=2)
    dcfg = torch_cfg(dj)
    dp = tl.load_params(dcfg, random_params(dj, seed=77), dtype=torch.float32, device="cpu")
    prompt_ids = [7, 2, 9]
    caches = (tl.KVCache.create(cfg, 1, dtype=torch.float32, device="cpu"),
              tl.KVCache.create(dcfg, 1, dtype=torch.float32, device="cpu"))
    ids, _, _ = spec.generate_speculative_draft(tp, cfg, dp, dcfg, prompt_ids, 20, 0.0, 0.9,
                                                spec.stream_key(1), *caches, k=3)
    assert ids == _sequential(tp, cfg, prompt_ids, 20)


def test_sampled_spec_equals_position_keyed_sequential(model):
    """Temperature 0.8: the speculative stream equals a token-at-a-time loop
    drawing u(key, position) for each produced position."""
    _, _, cfg, tp = model
    prompt_ids, steps, key = [5, 9, 2, 5, 9, 2], 28, spec.stream_key(11)
    cache = tl.KVCache.create(cfg, 1, dtype=torch.float32, device="cpu")
    ids, _, _ = spec.generate_speculative_ngram(tp, cfg, prompt_ids, steps, 0.8, 0.9, key,
                                                cache, k=4)
    cache = tl.KVCache.create(cfg, 1, dtype=torch.float32, device="cpu")
    want, tok = list(prompt_ids), BOS_ID
    for pos in range(steps):
        logits, cache = tl.decode_step(tp, cfg, torch.tensor([tok]), torch.tensor([pos]), cache)
        if pos < len(prompt_ids):
            tok = prompt_ids[pos]
            continue
        tok = int(sample_batched_keyed(logits, key, torch.tensor([pos + 1]),
                                       torch.tensor([0.8]), torch.tensor([0.9]))[0])
        want.append(tok)
    assert ids == want[:steps]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec_cli")
    jcfg = tiny_config(seq_len=64)
    model, draft = str(d / "m.bin"), str(d / "draft.bin")
    save_v0(model, torch_cfg(jcfg), random_params(jcfg, seed=9))
    dj = tiny_config(dim=32, hidden_dim=96, n_layers=2, n_heads=2, n_kv_heads=2, seq_len=64)
    save_v0(draft, torch_cfg(dj), random_params(dj, seed=5))
    return model, draft, write_tokenizer_bin(d / "tok.bin", jcfg.vocab_size)


@pytest.mark.parametrize("flags", [["--spec", "ngram", "--spec-k", "4"],
                                   ["--spec", "draft", "--draft-model", "DRAFT"]])
def test_cli_spec_prints_the_spec_off_text(checkpoints, capsys, flags):
    model, draft, tok = checkpoints
    base = ["generate", "-m", model, "-t", tok, "-p", "abcabc", "-s", "20", "-r", "0",
            "--dtype", "float32", "--device", "cpu"]
    assert cli_main(base) == 0
    off = capsys.readouterr().out
    assert cli_main(base + [draft if f == "DRAFT" else f for f in flags]) == 0
    cap = capsys.readouterr()
    assert cap.out == off
    assert "[spec] rounds=" in cap.err and "accepted=" in cap.err


def test_cli_spec_draft_needs_a_draft_model(checkpoints, capsys):
    model, _, tok = checkpoints
    rc = cli_main(["generate", "-m", model, "-t", tok, "--device", "cpu", "--spec", "draft"])
    assert rc == 2 and "--draft-model" in capsys.readouterr().err
