"""rama_tpu_torch's checkpoint export (export.py, checkpoint.save_v1, the
CLI's `export` subcommand) against rama_tpu's on the same inputs, on the
CPU: a seeded tiny transformers LlamaForCausalLM (MHA and GQA, tied and
untied embeddings) through hf_to_params and back through params_to_hf; a
llama2.c .pt with and without the torch.compile '_orig_mod.' prefix; a
two-shard Meta directory. Params and configs must be equal exactly, and
`rama_tpu_torch.cli export --version 0/1/2` must write .bin files byte for
byte those of `rama_tpu.cli export` on each kind of input; a v2 export
served by the port's CLI on the CPU gives rama_tpu's CLI's greedy text."""

import dataclasses
import json

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from _torch_port import write_tokenizer_bin  # noqa: E402
from rama_tpu import export as jexport  # noqa: E402
from rama_tpu.cli import _sniff_source as j_sniff  # noqa: E402
from rama_tpu.cli import main as j_main  # noqa: E402
from rama_tpu.testing.ref_model import random_params, tiny_config  # noqa: E402
from rama_tpu_torch import export  # noqa: E402
from rama_tpu_torch.checkpoint import load_checkpoint, save_v0, save_v1  # noqa: E402
from rama_tpu_torch.cli import _sniff_source, main  # noqa: E402

torch.set_num_threads(1)

# canonical name -> llama2.c / Meta state-dict key, and the axis a Meta
# shard splits (None: every shard holds the whole tensor)
NAMES = {"attn_norm": ("layers.{i}.attention_norm.weight", None),
         "wq": ("layers.{i}.attention.wq.weight", 0),
         "wk": ("layers.{i}.attention.wk.weight", 0),
         "wv": ("layers.{i}.attention.wv.weight", 0),
         "wo": ("layers.{i}.attention.wo.weight", 1),
         "ffn_norm": ("layers.{i}.ffn_norm.weight", None),
         "w1": ("layers.{i}.feed_forward.w1.weight", 0),
         "w2": ("layers.{i}.feed_forward.w2.weight", 1),
         "w3": ("layers.{i}.feed_forward.w3.weight", 0),
         "tok_embedding": ("tok_embeddings.weight", 1),
         "final_norm": ("norm.weight", None), "wcls": ("output.weight", 0)}


def hf_model(n_kv_heads: int, tie: bool):
    torch.manual_seed(n_kv_heads + 10 * tie)
    cfg = transformers.LlamaConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=n_kv_heads, vocab_size=96, max_position_embeddings=48,
        rms_norm_eps=1e-5, tie_word_embeddings=tie)
    return transformers.LlamaForCausalLM(cfg).eval()


def state_dict(cfg, params) -> dict:
    """llama2.c / Meta names, (out, in) matmul weights."""
    sd = {}
    for name, (key, _) in NAMES.items():
        a = params[name]
        if name not in ("tok_embedding", "attn_norm", "ffn_norm", "final_norm"):
            a = np.swapaxes(a, -1, -2)
        for i in range(cfg.n_layers if "{i}" in key else 1):
            sd[key.format(i=i)] = torch.from_numpy(np.ascontiguousarray(
                a[i] if "{i}" in key else a))
    return sd


def write_pt(path, cfg, params, prefix: str = "_orig_mod.") -> str:
    args = dict(dim=cfg.dim, n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, vocab_size=cfg.vocab_size, max_seq_len=cfg.seq_len,
                norm_eps=1e-5)
    torch.save({"model_args": args,
                "model": {prefix + k: v for k, v in state_dict(cfg, params).items()}}, path)
    return str(path)


def write_meta(d, cfg, params) -> str:
    d.mkdir()
    (d / "params.json").write_text(json.dumps(dict(
        dim=cfg.dim, n_layers=cfg.n_layers, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        norm_eps=1e-5, vocab_size=-1)))
    sd = state_dict(cfg, params)
    axes = {key.format(i=i): axis for key, axis in NAMES.values() for i in range(cfg.n_layers)}
    for j in range(2):
        torch.save({k: (v if axes[k] is None else torch.chunk(v, 2, dim=axes[k])[j]).clone()
                    for k, v in sd.items()}, d / f"consolidated.{j:02d}.pth")
    return str(d)


def same(got, want) -> None:
    (cfg, params), (jcfg, jparams) = got, want
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert set(params) == set(jparams)
    for k in jparams:
        assert params[k].dtype == jparams[k].dtype and np.array_equal(params[k], jparams[k]), k


@pytest.mark.parametrize("n_kv_heads", [4, 2])
@pytest.mark.parametrize("tie", [False, True])
def test_hf_to_params_equals_jax(n_kv_heads, tie):
    model = hf_model(n_kv_heads, tie)
    got = export.hf_to_params(model)
    same(got, jexport.hf_to_params(model))
    assert got[0].n_kv_heads == n_kv_heads and got[0].shared_classifier == tie


@pytest.mark.parametrize("n_kv_heads", [4, 2])
@pytest.mark.parametrize("tie", [False, True])
def test_params_to_hf_round_trip_equals_jax(tmp_path, n_kv_heads, tie):
    """The port's HF directory holds rama_tpu's state dict and config, and
    reloads (transformers.from_pretrained) to the same params and logits."""
    model = hf_model(n_kv_heads, tie)
    cfg, params = export.hf_to_params(model)
    export.params_to_hf(cfg, params, tmp_path / "mine")
    jexport.params_to_hf(cfg, params, tmp_path / "jax")
    mine = torch.load(tmp_path / "mine" / "pytorch_model.bin", weights_only=True)
    ref = torch.load(tmp_path / "jax" / "pytorch_model.bin", weights_only=True)
    assert set(mine) == set(ref) and all(torch.equal(mine[k], ref[k]) for k in ref)
    cfg_json = [json.loads((tmp_path / d / "config.json").read_text()) for d in ("mine", "jax")]
    cfg_json[0].pop("transformers_version", None), cfg_json[1].pop("transformers_version", None)
    assert cfg_json[0] == cfg_json[1]
    back = transformers.AutoModelForCausalLM.from_pretrained(tmp_path / "mine")
    same(export.hf_to_params(back), (cfg, params))
    tokens = torch.tensor([[5, 11, 42, 7, 90, 3]])
    with torch.no_grad():
        assert torch.equal(back(tokens).logits, model(tokens).logits)


@pytest.mark.parametrize("prefix", ["_orig_mod.", ""])
@pytest.mark.parametrize("shared", [True, False])
def test_llama2c_pt_equals_jax(tmp_path, prefix, shared):
    jcfg = tiny_config(n_kv_heads=2, shared_classifier=shared)
    path = write_pt(tmp_path / "ck.pt", jcfg, random_params(jcfg, seed=5), prefix)
    got = export.llama2c_pt_to_params(path)
    same(got, jexport.llama2c_pt_to_params(path))
    assert got[0].shared_classifier == shared


def test_meta_two_shards_equal_jax(tmp_path):
    jcfg = tiny_config(n_kv_heads=2, shared_classifier=False)
    d = write_meta(tmp_path / "meta", jcfg, random_params(jcfg, seed=6))
    got = export.meta_to_params(d)
    same(got, jexport.meta_to_params(d))
    assert got[0].seq_len == 2048 and not got[0].shared_classifier


def test_permutes_equal_jax_and_invert():
    w = np.random.default_rng(0).standard_normal((4 * 16, 64)).astype(np.float32)
    fwd = export.permute_forward(w, 4, 16)
    assert np.array_equal(fwd, jexport.permute_forward(w, 4, 16))
    assert np.array_equal(export.permute_reverse(fwd, 4, 16), w)


def test_hf_functions_name_transformers_when_it_is_missing(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_transformers(name, *a, **kw):
        if name == "transformers" or name.startswith("transformers."):
            raise ImportError(f"No module named {name!r}")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    jcfg = tiny_config()
    for call in (lambda: export.hf_to_params("some/dir"),
                 lambda: export.params_to_hf(jcfg, {}, "out")):
        with pytest.raises(ImportError, match="`transformers` package"):
            call()


def test_save_v1_equals_jax(tmp_path):
    from rama_tpu.checkpoint import save_v1 as j_save_v1

    for shared in (True, False):
        jcfg = tiny_config(shared_classifier=shared)
        params = random_params(jcfg, seed=8)
        save_v1(str(tmp_path / "mine.bin"), jcfg, params)
        j_save_v1(str(tmp_path / "jax.bin"), jcfg, params)
        assert (tmp_path / "mine.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
        cfg, back = load_checkpoint(str(tmp_path / "mine.bin"))
        assert cfg.shared_classifier == shared
        assert all(np.array_equal(back[k], params[k]) for k in params)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """One input of each kind: .bin (v0), llama2.c .pt, Meta, HF."""
    d = tmp_path_factory.mktemp("export_sources")
    jcfg = tiny_config(n_kv_heads=2, shared_classifier=False, seq_len=48)
    params = random_params(jcfg, seed=4)
    save_v0(str(d / "in.bin"), jcfg, params)
    model = hf_model(2, False)
    model.save_pretrained(d / "hf", safe_serialization=False)
    return {"bin": str(d / "in.bin"), "llama2c": write_pt(d / "in.pt", jcfg, params),
            "meta": write_meta(d / "meta", jcfg, params), "hf": str(d / "hf")}


@pytest.mark.parametrize("kind", ["bin", "llama2c", "meta", "hf"])
def test_sniff_source_equals_jax(sources, kind):
    assert _sniff_source(sources[kind]) == j_sniff(sources[kind]) == kind


@pytest.mark.parametrize("version", [0, 1, 2])
@pytest.mark.parametrize("kind", ["bin", "llama2c", "meta", "hf"])
def test_cli_export_writes_jaxs_bytes(sources, tmp_path, capsys, kind, version):
    outs = []
    for fn, name in ((main, "mine.bin"), (j_main, "jax.bin")):
        assert fn(["export", sources[kind], str(tmp_path / name), "--version", str(version),
                   "--group-size", "32"]) == 0
        outs.append(capsys.readouterr().err)
    assert (tmp_path / "mine.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    assert outs[0] == outs[1].replace(str(tmp_path / "jax.bin"), str(tmp_path / "mine.bin"))
    if version == 2:
        assert "max quantization group error" in outs[0]


def test_cli_export_source_flag_and_hf_target(sources, tmp_path, capsys):
    """--source names the input's kind over the sniffing; --version -1
    writes rama_tpu's HF directory."""
    for fn, name in ((main, "mine"), (j_main, "jax")):
        assert fn(["export", sources["llama2c"], str(tmp_path / name), "--version", "-1",
                   "--source", "llama2c"]) == 0
    capsys.readouterr()
    mine = torch.load(tmp_path / "mine" / "pytorch_model.bin", weights_only=True)
    ref = torch.load(tmp_path / "jax" / "pytorch_model.bin", weights_only=True)
    assert set(mine) == set(ref) and all(torch.equal(mine[k], ref[k]) for k in ref)
    with pytest.raises(OSError):
        main(["export", sources["llama2c"], str(tmp_path / "x.bin"), "--source", "meta"])


def test_v2_export_generates_jaxs_greedy_text(sources, tmp_path, capsys):
    """A v2 export of the .pt through the port's `generate --device cpu`
    and rama_tpu's `generate --platform cpu` on the same file."""
    model = str(tmp_path / "v2.bin")
    assert main(["export", sources["llama2c"], model, "--group-size", "16"]) == 0
    tok = write_tokenizer_bin(tmp_path / "tok.bin", 128)
    common = ["generate", "-m", model, "-t", tok, "-p", "abc", "-s", "12", "-r", "0",
              "--dtype", "float32"]
    capsys.readouterr()
    assert main(common + ["--device", "cpu"]) == 0
    mine = capsys.readouterr().out
    assert j_main(common + ["--platform", "cpu"]) == 0
    assert mine == capsys.readouterr().out and mine.strip()
