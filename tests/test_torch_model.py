"""rama_tpu_torch.models.llama against rama_tpu.models.llama in fp32 on the
CPU (where every kernel wrapper runs its plain version), plus the pinned
golden chains of tests/fixtures/goldens.json through the port's
generate_prefill_decode.

Tolerances: logits atol 1e-4 (fp32, same math, other summation order);
greedy chains exact; sampled chains exact when fed the uniforms of JAX's
key stream (the port's own counter-based draws are not threefry's)."""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_params_to_torch, jax_uniform_stream, torch_cfg
from rama_tpu.config import ModelConfig as JCfg
from rama_tpu.models import llama as jl
from rama_tpu.runtime.generate import generate_prefill_decode as j_generate
from rama_tpu.testing.ref_model import random_params, tiny_config
from rama_tpu_torch.models import llama as tl
from rama_tpu_torch.runtime.generate import generate_prefill_decode, generate_scan

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "goldens.json"
CONFIGS = {  # tests/test_goldens.py:26-31
    "tiny": JCfg(dim=64, hidden_dim=176, n_layers=3, n_heads=4, n_kv_heads=2,
                 vocab_size=128, seq_len=48),
    "stories15M": JCfg(dim=288, hidden_dim=768, n_layers=6, n_heads=6, n_kv_heads=6,
                       vocab_size=32000, seq_len=64),
}
CHAINS = ("fp32/greedy", "fp32/sampled", "int8/greedy", "int8/sampled",
          "int4/greedy", "int4/sampled")


def both_params(jcfg, np_params, quant: str, gs: int = 16):
    cfg = torch_cfg(jcfg)
    if quant == "fp32":
        jp = jl.load_params(jcfg, np_params, dtype=jnp.float32)
        tp = tl.load_params(cfg, np_params, dtype=torch.float32, device="cpu")
    else:
        jp = jl.quantize_params(jcfg, np_params, bits=8, group_size=gs, dtype=jnp.float32)
        tp = tl.quantize_params(cfg, np_params, bits=8, group_size=gs, dtype=torch.float32,
                                device="cpu")
    return cfg, jl.fuse_params(jp, jcfg), tl.fuse_params(tp, cfg)


def close(t, j, atol=1e-4):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("quant", ["fp32", "int8"])
def test_prefill_then_decode_logits_match(name, quant):
    jcfg = CONFIGS[name].replace(n_layers=2)
    cfg, jp, tp = both_params(jcfg, random_params(jcfg, seed=3), quant)
    toks = np.array([[1, 5, 9, 3, 7, 2, 8, 4]], np.int32)
    jc = jl.KVCache.create(jcfg, 1, 32, dtype=jnp.float32)
    tc = tl.KVCache.create(cfg, 1, 32, dtype=torch.float32, device="cpu")
    lj, jc = jl.prefill(jp, jcfg, jnp.asarray(toks), jc)
    lt, tc = tl.prefill(tp, cfg, torch.from_numpy(toks).long(), tc)
    close(lt, lj)
    close(tc.k, jc.k)
    for step in range(3):
        tok, pos = np.array([11 + step]), np.array([8 + step])
        lj, jc = jl.decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos, jnp.int32), jc)
        lt, tc = tl.decode_step(tp, cfg, torch.from_numpy(tok), torch.from_numpy(pos), tc)
        close(lt, lj)


def test_ragged_batch_forward_matches():
    """Per-slot positions, a padded prefill (plen < T, padded rows clamped to
    the last row as the engine does) and logit_rows."""
    jcfg = tiny_config(seq_len=32)
    cfg, jp, tp = both_params(jcfg, random_params(jcfg, seed=8), "int8")
    t_pad = 16
    lens = np.array([16, 5, 9], np.int32)
    toks = np.random.default_rng(0).integers(3, 128, (3, t_pad)).astype(np.int32)
    idx = np.arange(t_pad)[None, :]
    pos_index = np.where(idx < lens[:, None], idx, t_pad - 1).astype(np.int32)
    jc = jl.KVCache.create(jcfg, 3, t_pad, dtype=jnp.float32)
    tc = tl.KVCache.create(cfg, 3, t_pad, dtype=torch.float32, device="cpu")
    lj, jc = jl.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos_index), jc,
                        plen=jnp.asarray(lens), logit_rows=jnp.asarray(lens - 1))
    lt, tc = tl.forward(tp, cfg, torch.from_numpy(toks).long(),
                        torch.from_numpy(pos_index).long(), tc,
                        plen=torch.from_numpy(lens), logit_rows=torch.from_numpy(lens - 1))
    assert lt.shape == (3, 1, cfg.vocab_size)
    close(lt, lj)
    # decode at ragged positions on a longer cache
    jc2 = jl.KVCache.create(jcfg, 3, 32, dtype=jnp.float32)
    tc2 = tl.KVCache.create(cfg, 3, 32, dtype=torch.float32, device="cpu")
    jc2 = jl.KVCache(k=jc2.k.at[:, :, :, :t_pad].set(jc.k), v=jc2.v.at[:, :, :, :t_pad].set(jc.v))
    tc2.k[:, :, :, :t_pad] = tc.k
    tc2.v[:, :, :, :t_pad] = tc.v
    tok = np.array([7, 8, 9])
    lj, _ = jl.decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jnp.asarray(lens), jc2)
    lt, _ = tl.decode_step(tp, cfg, torch.from_numpy(tok), torch.from_numpy(lens).long(), tc2)
    close(lt, lj)


def test_plain_flag_matches_kernel_dispatch_on_cpu():
    """plain=True (the reference chip_smoke holds the kernels against) is the
    same computation as the CPU dispatch."""
    jcfg = tiny_config(seq_len=32)
    cfg, _, tp = both_params(jcfg, random_params(jcfg, seed=2), "int8")
    toks = torch.tensor([[1, 4, 6, 8]])
    a, _ = tl.prefill(tp, cfg, toks, tl.KVCache.create(cfg, 1, 16, torch.float32, "cpu"))
    b, _ = tl.prefill(tp, cfg, toks, tl.KVCache.create(cfg, 1, 16, torch.float32, "cpu"),
                      plain=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_params_from_jax_tree_match_own_quantization():
    """Port params converted from the JAX pytree give the port's own
    quantize+fuse result, bit for bit (int8, il-interleaved w13)."""
    jcfg = CONFIGS["stories15M"].replace(n_layers=1, vocab_size=256)
    cfg, jp, tp = both_params(jcfg, random_params(jcfg, seed=1), "int8")
    conv = jax_params_to_torch(jcfg, jp)
    assert conv["w13"].il == tp["w13"].il == 256
    for name in ("wqkv", "w13", "wo", "w2", "wcls"):
        torch.testing.assert_close(conv[name].q, tp[name].q, rtol=0, atol=0)
        torch.testing.assert_close(conv[name].scales, tp[name].scales, rtol=0, atol=0)


@pytest.fixture(scope="module")
def goldens():
    return json.loads(FIXTURE.read_text())


@pytest.mark.parametrize("chain", CHAINS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden_chains(goldens, name, chain):
    quant, label = chain.split("/")
    if quant == "int4":
        pytest.skip("int4 slice")
    jcfg = CONFIGS[name]
    case = goldens["cases"][name]
    cfg, _, tp = both_params(jcfg, random_params(jcfg, seed=case["seed"]), quant)
    steps = goldens["steps"]
    temp = 0.0 if label == "greedy" else 0.9
    cache = tl.KVCache.create(cfg, batch=1, max_len=steps, dtype=torch.float32, device="cpu")
    got = generate_prefill_decode(tp, cfg, goldens["prompt"], steps, temp, 0.9,
                                  jax_uniform_stream(goldens["key_seed"]), cache)
    assert got == case["chains"][chain]


@pytest.mark.parametrize("temp", [0.0, 0.9])
def test_parity_loop_matches_jax_generate(temp):
    """generate_scan (token-at-a-time, prompt forced) emits the prompt and
    then the same continuation as rama_tpu's prefill+decode path."""
    jcfg = tiny_config(seq_len=32)
    cfg, jp, tp = both_params(jcfg, random_params(jcfg, seed=4), "fp32")
    prompt, steps = [3, 42, 7], 12
    want = np.asarray(j_generate(jp, jcfg, jnp.asarray(prompt, jnp.int32), steps,
                                 len(prompt), temp, 0.9, __import__("jax").random.PRNGKey(5),
                                 jl.KVCache.create(jcfg, 1, steps, dtype=jnp.float32))).tolist()
    cache = tl.KVCache.create(cfg, 1, steps, dtype=torch.float32, device="cpu")
    got = generate_prefill_decode(tp, cfg, prompt, steps, temp, 0.9,
                                  jax_uniform_stream(5), cache)
    assert got == want
    if temp == 0.0:
        cache = tl.KVCache.create(cfg, 1, steps, dtype=torch.float32, device="cpu")
        scan = generate_scan(tp, cfg, prompt, steps, temp, 0.9, jax_uniform_stream(5), cache)
        assert scan[: len(prompt)] == prompt
        assert scan[len(prompt):] == want[len(prompt):]


@pytest.mark.parametrize("quant", ["fp32", "int8"])
def test_unfused_params_give_the_fused_logits(quant):
    """forward takes unfused (wq/wk/wv, w1/w3) params too, as rama_tpu's does;
    fusing (and the int8 w13 interleave) changes no logit."""
    jcfg = CONFIGS["stories15M"].replace(n_layers=2, vocab_size=256)
    cfg = torch_cfg(jcfg)
    np_params = random_params(jcfg, seed=6)
    if quant == "fp32":
        raw = tl.load_params(cfg, np_params, dtype=torch.float32, device="cpu")
    else:
        raw = tl.quantize_params(cfg, np_params, group_size=16, dtype=torch.float32,
                                 device="cpu")
    toks = torch.tensor([[1, 9, 4, 7, 3]])
    outs = []
    for params in (raw, tl.fuse_params(raw, cfg)):
        cache = tl.KVCache.create(cfg, 1, 16, torch.float32, "cpu")
        logits, cache = tl.prefill(params, cfg, toks, cache)
        step, _ = tl.decode_step(params, cfg, torch.tensor([5]), torch.tensor([5]), cache)
        outs.append((logits, step))
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=0)


def test_decode_batch_above_ffn_kernel_limit_takes_split_path(monkeypatch):
    """Decode batches above the FFN kernel's M limit run the split w13 / w2
    matmuls instead of the fused FFN (the JAX package's shape-based choice)."""
    jcfg = tiny_config(seq_len=16)
    cfg, _, tp = both_params(jcfg, random_params(jcfg, seed=5), "int8")
    calls = []
    monkeypatch.setattr(tl._KERNELS, "ffn", lambda *a: calls.append(a) or tl._ffn.ffn(*a))
    for b in (tl._ffn.FFN_MAX_M, tl._ffn.FFN_MAX_M + 1):
        calls.clear()
        cache = tl.KVCache.create(cfg, b, 16, torch.float32, "cpu")
        logits, _ = tl.decode_step(tp, cfg, torch.arange(b) % 100, torch.zeros(b).long(), cache)
        assert logits.shape == (b, cfg.vocab_size) and torch.isfinite(logits).all()
        assert len(calls) == (cfg.n_layers if b <= tl._ffn.FFN_MAX_M else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generate_text_cache_takes_the_params_dtype(monkeypatch, dtype):
    """generate_text's cache defaults to the params' dtype (the card's
    attention kernels take one dtype for q and the cache); an explicit
    cache_dtype still wins."""
    from rama_tpu_torch.runtime import generate as tg
    from rama_tpu_torch.tokenizer import Tokenizer

    jcfg = tiny_config(seq_len=16)
    cfg = torch_cfg(jcfg)
    params = tl.fuse_params(tl.load_params(cfg, random_params(jcfg, seed=1), dtype=dtype,
                                           device="cpu"), cfg)
    vocab = ["<unk>", "<s>", "</s>"] + [chr(97 + i % 26) * (1 + i // 26) for i in range(125)]
    tok = Tokenizer(vocab, [0.0] * len(vocab))
    made = []
    create = tl.KVCache.create
    monkeypatch.setattr(tg.KVCache, "create",
                        lambda *a, **kw: made.append(kw["dtype"]) or create(*a, **kw))
    for cache_dtype, want in ((None, dtype), (torch.float32, torch.float32)):
        _, ids = tg.generate_text(params, cfg, tok, "ab", steps=6, temperature=0.0,
                                  cache_dtype=cache_dtype)
        assert len(ids) == 6 and made[-1] == want
