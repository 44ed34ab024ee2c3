"""Command-line generation — the port of rama_tpu/cli.py `generate`
(the reference's `engine` binary, engine/src/main.rs:20-105).

    python -m rama_tpu_torch.cli generate -m model.bin -t tokenizer.bin \
        -p "once upon a time" -s 200 -r 0.9 --device cuda

Loads a v0/v1/v2 .bin checkpoint, runs generation on `--device` (cuda by
default; it raises without a GPU unless `--device cpu` is given), prints
the text and a tok/s line computed the reference way: (steps - 1) / elapsed
(engine/src/main.rs:100-103). Flags of features not ported yet exit with
status 2 and name the ROADMAP item.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rama-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate", help="run timed generation")
    g.add_argument("-m", "--model", required=True, help="path to .bin checkpoint")
    g.add_argument("-t", "--tokenizer", required=True, help="path to tokenizer.bin")
    g.add_argument("-p", "--prompt", default="", help="prompt text")
    g.add_argument("-s", "--step", type=int, default=255, help="max steps")
    g.add_argument("-r", "--temperature", type=float, default=1.0)
    g.add_argument("-l", "--topp", type=float, default=0.9, help="nucleus top-p")
    g.add_argument("-o", "--mode", default="generate", choices=["generate", "chat"])
    g.add_argument("--seed", type=int, default=100)
    g.add_argument("--dtype", default="bfloat16", choices=list(_DTYPES))
    g.add_argument("--quant", default="auto", choices=["auto", "none", "int8", "int4"],
                   help="weight-only quantization: 'auto' keeps v2 files "
                        "quantized and loads v0/v1 dense; int8 quantizes any "
                        "input at load")
    g.add_argument("--scale-dtype", default=None, choices=["bf16"])
    g.add_argument("--parity", action="store_true",
                   help="token-at-a-time loop (reference semantics) instead of "
                        "the prefill+decode fast path")
    g.add_argument("--warmup", action="store_true",
                   help="run the generation once untimed first (kernel builds "
                        "and first launches stay outside the timer)")
    g.add_argument("--spec", default="off", choices=["off", "ngram", "draft"])
    g.add_argument("--spec-k", type=int, default=8)
    g.add_argument("--draft-model", default=None)
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a GPU) or cpu")
    return ap


def unported(args) -> str | None:
    """The ROADMAP item a flag asks for that this port does not have yet."""
    if args.quant == "int4":
        return "--quant int4: int4 weights (int4 slice)"
    if args.scale_dtype:
        return "--scale-dtype: bf16-stored weight scales"
    if args.spec != "off" or args.draft_model:
        return "--spec: speculative decoding (speculative.py)"
    if args.mode == "chat":
        return "-o chat: the chat loop (chat.py)"
    return None


def load_model(model: str, quant: str = "auto", dtype: str = "bfloat16",
               device: str = "cuda"):
    """Checkpoint -> (cfg, fused params on `device`, torch dtype)."""
    from rama_tpu_torch.checkpoint import (load_checkpoint, load_checkpoint_quantized,
                                           peek_version)
    from rama_tpu_torch.models.llama import (fuse_params, load_params,
                                             load_params_quantized, quantize_params)
    from rama_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    tdtype = _DTYPES[dtype]
    if quant == "auto" and peek_version(model) == 2:
        qp = load_checkpoint_quantized(model)
        cfg = qp.config
        params = load_params_quantized(cfg, qp, dtype=tdtype, device=dev)
    elif quant == "int8":
        cfg, np_params = load_checkpoint(model)
        params = quantize_params(cfg, np_params, bits=8, dtype=tdtype, device=dev)
    elif quant in ("auto", "none"):
        cfg, np_params = load_checkpoint(model)
        params = load_params(cfg, np_params, dtype=tdtype, device=dev)
    else:
        raise NotImplementedError(f"--quant {quant} is not ported yet (ROADMAP.md)")
    return cfg, fuse_params(params, cfg), tdtype


def cmd_generate(args) -> int:
    from rama_tpu_torch.runtime.generate import generate_text
    from rama_tpu_torch.tokenizer import Tokenizer

    missing = unported(args)
    if missing:
        print(f"{missing} is not ported to rama_tpu_torch yet (ROADMAP.md)",
              file=sys.stderr)
        return 2
    cfg, params, dtype = load_model(args.model, args.quant, args.dtype, args.device)
    tokenizer = Tokenizer.from_file(args.tokenizer, cfg.vocab_size)

    def run():
        return generate_text(params, cfg, tokenizer, args.prompt, steps=args.step,
                             temperature=args.temperature, top_p=args.topp,
                             seed=args.seed, cache_dtype=dtype, fast=not args.parity)

    if args.warmup:
        run()
    t0 = time.time()
    text, ids = run()
    elapsed = time.time() - t0
    print(text)
    steps = len(ids)
    print(f"\n{steps} tokens in {elapsed:.2f}s: {(steps - 1) / elapsed:.2f} tok/s "
          f"on {params['final_norm'].device}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "generate":
        return cmd_generate(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
