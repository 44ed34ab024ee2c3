"""rama_tpu_torch.cli `generate` end to end on tiny checkpoints on the CPU:
flags parse, v0 and v2 checkpoints load (dense, or quantized to int8 or
int4 at load), streams equal rama_tpu's CLI greedy output, --spec and
--scale-dtype bf16 run, unported flags exit with the ROADMAP item, and the
default device is cuda (raising without a GPU)."""

import pytest
import torch

from _torch_port import torch_cfg, write_tokenizer_bin
from rama_tpu.cli import main as j_main
from rama_tpu.testing.ref_model import random_params, tiny_config
from rama_tpu_torch.checkpoint import save_v0, save_v2
from rama_tpu_torch.cli import main

torch.set_num_threads(1)


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


@pytest.mark.parametrize("quant,which", [("none", 0), ("int8", 0), ("int4", 0), ("auto", 1)])
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
    (["--scale-dtype", "bf16"], "scale"),
    (["--spec", "ngram"], "speculative"), (["-o", "chat"], "chat"),
])
def test_unported_flags_exit_with_roadmap_item(artifacts, capsys, flags, item):
    """Unported flags exit 2 naming the ROADMAP item; --spec is ported: it
    runs speculative generation, prints its [spec] line and the greedy text
    of --spec off; --scale-dtype is ported: bf16 scales on the v2 file's
    int8 weights (and on int4 at load) give rama_tpu's CLI's greedy text
    under the same flag, and any other value is refused by argparse in
    both (exit 2)."""
    model, _, tok = artifacts
    argv = ["generate", "-m", model, "-t", tok, "--device", "cpu", *flags]
    if flags[0] == "--scale-dtype":
        for path, quant in ((artifacts[1], "auto"), (artifacts[0], "int4")):
            common = ["generate", "-m", path, "-t", tok, "-p", "abc", "-s", "12", "-r", "0",
                      "--dtype", "float32", "--quant", quant, *flags]
            rc, out, err = run(common + ["--device", "cpu"], capsys)
            assert rc == 0 and "tok/s" in err
            rc_j, out_j, _ = run(common + ["--platform", "cpu"], capsys, fn=j_main)
            assert rc_j == 0 and out == out_j
        for fn in (main, j_main):
            with pytest.raises(SystemExit) as exc:
                fn(["generate", "-m", model, "-t", tok, "--scale-dtype", "fp16"])
            assert exc.value.code == 2
        return
    if flags[0] == "--spec":
        greedy = ["-p", "abc", "-s", "12", "-r", "0", "--dtype", "float32"]
        rc, out, err = run(argv + greedy, capsys)
        assert rc == 0 and "[spec] rounds=" in err
        assert out == run(argv[:-2] + greedy, capsys)[1]
        return
    rc, _, err = run(argv, capsys)
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


def test_int4_loads_int4_layers_and_int8_classifier(artifacts):
    """--quant int4 quantizes the layer weights to packed int4 at load (gs
    64 as in the JAX CLI, reduced per tensor) and keeps the embedding and
    classifier int8."""
    from rama_tpu_torch.cli import load_model

    cfg, params, _ = load_model(artifacts[0], "int4", "float32", "cpu")
    for name in ("wqkv", "wo", "w13", "w2"):
        assert params[name].bits == 4, name
        assert params[name].shape[-2] == params[name].q.shape[-2] * 2
    assert params["wcls"].bits == 8
    assert params["w2"].group_size == 1 and params["wqkv"].group_size == 4  # tiny: 176, 64
