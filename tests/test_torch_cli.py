"""rama_tpu_torch.cli `generate` end to end on tiny checkpoints on the CPU:
flags parse, v0 and v2 checkpoints load, streams equal rama_tpu's CLI
greedy output, unported flags exit with the ROADMAP item, and the default
device is cuda (raising without a GPU)."""

import struct

import pytest
import torch

from _torch_port import torch_cfg
from rama_tpu.cli import main as j_main
from rama_tpu.testing.ref_model import random_params, tiny_config
from rama_tpu_torch.checkpoint import save_v0, save_v2
from rama_tpu_torch.cli import main

torch.set_num_threads(1)


def write_tokenizer_bin(path, vocab_size):
    vocab = ["<unk>", "<s>", "</s>"] + [chr(ord("a") + i) for i in range(26)]
    vocab += [f"t{i}" for i in range(vocab_size - len(vocab))]
    with open(path, "wb") as f:
        f.write(struct.pack("<I", max(len(v.encode()) for v in vocab)))
        for v in vocab:
            b = v.encode()
            f.write(struct.pack("<fi", 0.0, len(b)))
            f.write(b)
    return str(path)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    jcfg = tiny_config(seq_len=64)
    np_params = random_params(jcfg, seed=9)
    v0, v2 = str(d / "tiny_v0.bin"), str(d / "tiny_v2.bin")
    save_v0(v0, torch_cfg(jcfg), np_params)
    save_v2(v2, torch_cfg(jcfg), np_params, group_size=16)
    return v0, v2, write_tokenizer_bin(d / "tok.bin", jcfg.vocab_size)


def run(argv, capsys, fn=main):
    rc = fn(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.parametrize("quant,which", [("none", 0), ("int8", 0), ("auto", 1)])
def test_generate_matches_jax_cli(artifacts, capsys, quant, which):
    model, tok = artifacts[which], artifacts[2]
    common = ["generate", "-m", model, "-t", tok, "-p", "abc", "-s", "12", "-r", "0.0",
              "--quant", quant, "--dtype", "float32"]
    rc, out, err = run(common + ["--device", "cpu"], capsys)
    assert rc == 0 and "tok/s" in err
    rc_j, out_j, _ = run(common + ["--platform", "cpu"], capsys, fn=j_main)
    assert rc_j == 0
    assert out == out_j


def test_generate_sampled_is_seed_deterministic(artifacts, capsys):
    model, _, tok = artifacts
    argv = ["generate", "-m", model, "-t", tok, "-p", "abc", "-s", "16", "-r", "0.9",
            "--dtype", "float32", "--device", "cpu", "--seed", "3"]
    out1 = run(argv, capsys)[1]
    out2 = run(argv, capsys)[1]
    out3 = run(argv[:-1] + ["4"], capsys)[1]
    assert out1 == out2 and out1 != out3


def test_parity_loop_flag(artifacts, capsys):
    model, _, tok = artifacts
    base = ["generate", "-m", model, "-t", tok, "-p", "abc", "-s", "12", "-r", "0",
            "--dtype", "float32", "--device", "cpu"]
    assert run(base, capsys)[1] == run(base + ["--parity"], capsys)[1]


@pytest.mark.parametrize("flags,item", [
    (["--quant", "int4"], "int4"), (["--scale-dtype", "bf16"], "scale"),
    (["--spec", "ngram"], "speculative"), (["-o", "chat"], "chat"),
])
def test_unported_flags_exit_with_roadmap_item(artifacts, capsys, flags, item):
    model, _, tok = artifacts
    rc, _, err = run(["generate", "-m", model, "-t", tok, "--device", "cpu", *flags],
                     capsys)
    assert rc == 2 and "ROADMAP" in err and item in err


def test_default_device_is_cuda(artifacts):
    from rama_tpu_torch.cli import build_parser

    model, _, tok = artifacts
    args = build_parser().parse_args(["generate", "-m", model, "-t", tok])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["generate", "-m", model, "-t", tok])
