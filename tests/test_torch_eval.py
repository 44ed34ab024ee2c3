"""rama_tpu_torch's perplexity (eval.py) and its `eval` subcommand against
rama_tpu's on the CPU, on the same numpy weights (a tiny model of the
fixture tokenizer's 32000 ids, fp32, dense and int8): perplexity, nll,
tokens and windows over several window / batch / max_tokens values within
rel 1e-5, the short-text ValueError, and the CLI's JSON line against
`rama_tpu.cli eval --platform cpu` on the same file.

rama_tpu's scoring cache is bf16 whatever the params; the port's takes the
params' dtype (the card's kernels take one dtype for the queries and the
cache). These tests give rama_tpu's scorer an fp32 cache
(`jax_fp32_cache`), so both compute the same function."""

import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_port import torch_cfg
from rama_tpu import eval as j_eval
from rama_tpu.cli import main as j_main
from rama_tpu.models import llama as jl
from rama_tpu.testing.ref_model import random_params, tiny_config
from rama_tpu.tokenizer import Tokenizer as JTok
from rama_tpu_torch.checkpoint import save_v0
from rama_tpu_torch.cli import main
from rama_tpu_torch.eval import perplexity
from rama_tpu_torch.models import llama as tl
from rama_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tokenizer.bin")
TEXT = ("Once upon a time, there was a little girl named Lily. She loved to play outside "
        "in the sunshine. One day, she saw a big red ball in the park. She ran to it and "
        "kicked it as hard as she could. The ball flew over the fence and into the garden "
        "of an old man. ") * 3


class _Fp32Cache:
    @staticmethod
    def create(cfg, batch, max_len=None, dtype=None):
        return jl.KVCache.create(cfg, batch, max_len, dtype=jnp.float32)


@pytest.fixture
def jax_fp32_cache(monkeypatch):
    """rama_tpu's eval with its scoring cache in fp32: its module's KVCache
    swapped, and _score jitted anew so no program traced with the bf16
    cache is reused."""
    monkeypatch.setattr(j_eval, "KVCache", _Fp32Cache)
    monkeypatch.setattr(j_eval, "_score",
                        jax.jit(j_eval._score.__wrapped__, static_argnames=("cfg",)))


@pytest.fixture(scope="module")
def model():
    jcfg = tiny_config(vocab_size=32000, seq_len=64)
    np_params = random_params(jcfg, seed=17)
    return jcfg, torch_cfg(jcfg), np_params


def params_of(model, bits):
    jcfg, cfg, np_params = model
    if bits:
        return (jl.quantize_params(jcfg, np_params, bits=bits, group_size=16, dtype=jnp.float32),
                tl.quantize_params(cfg, np_params, bits=bits, group_size=16,
                                   dtype=torch.float32, device="cpu"))
    return (jl.load_params(jcfg, np_params, dtype=jnp.float32),
            tl.load_params(cfg, np_params, dtype=torch.float32, device="cpu"))


def close(got: dict, want: dict) -> None:
    assert (got["tokens"], got["windows"]) == (want["tokens"], want["windows"])
    for key in ("perplexity", "nll"):
        assert got[key] == pytest.approx(want[key], rel=1e-5), key


@pytest.mark.parametrize("bits", [None, 8])
@pytest.mark.parametrize("window,batch,max_tokens", [
    (16, 2, None), (32, 4, None), (None, 4, 100), (16, 3, 50), (64, 1, None), (8, 4, 7)])
def test_perplexity_equals_jax(model, jax_fp32_cache, bits, window, batch, max_tokens):
    jcfg, cfg, _ = model
    jp, tp = params_of(model, bits)
    want = j_eval.perplexity(jp, jcfg, JTok.from_file(FIXTURE, 32000), TEXT, window=window,
                             batch=batch, max_tokens=max_tokens)
    got = perplexity(tp, cfg, Tokenizer.from_file(FIXTURE, 32000), TEXT, window=window,
                     batch=batch, max_tokens=max_tokens)
    close(got, want)
    assert got["windows"] > 1 or max_tokens == 7


def test_short_text_raises(model):
    jcfg, cfg, _ = model
    jp, tp = params_of(model, None)
    with pytest.raises(ValueError, match="too short"):
        j_eval.perplexity(jp, jcfg, JTok.from_file(FIXTURE, 32000), "")
    with pytest.raises(ValueError, match="too short"):
        perplexity(tp, cfg, Tokenizer.from_file(FIXTURE, 32000), "")


@pytest.mark.parametrize("flags", [[], ["--quant", "int8", "--window", "16", "--batch", "3"],
                                   ["--max-tokens", "40"]])
def test_cli_eval_json_equals_jax(model, jax_fp32_cache, tmp_path, capsys, flags):
    jcfg, cfg, np_params = model
    path, text = str(tmp_path / "m.bin"), tmp_path / "text.txt"
    save_v0(path, cfg, np_params)
    text.write_text(TEXT)
    common = ["eval", "-m", path, "-t", FIXTURE, "--text", str(text), *flags]
    lines = []
    for fn, extra in ((main, ["--device", "cpu"]), (j_main, ["--platform", "cpu"])):
        assert fn(common + extra) == 0
        out = capsys.readouterr().out.strip().splitlines()
        assert len(out) == 1
        lines.append(json.loads(out[0]))
    close(*lines)
    assert set(lines[0]) == {"perplexity", "nll", "tokens", "windows"}
