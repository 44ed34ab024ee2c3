"""Checkpoint ingestion from external formats: HuggingFace, Meta, llama2.c .pt
(the port's copy of rama_tpu/export.py; the CLI's `export` subcommand).

The capability of the reference's export pipeline (engine/export/export.py)
rebuilt without the intermediate PyTorch Transformer: loaders map source
state dicts straight to the canonical numpy params (rama_tpu_torch.checkpoint),
and its save_v0/v1/v2 writers emit any .bin version. Everything runs on the
host in numpy; `transformers` is imported only by the two HuggingFace
functions, which raise an ImportError naming it where it is not installed.

Key conversion facts (mirroring export.py's observable behavior):
- HF permutes WQ/WK into the half-split rotary layout; `permute_reverse`
  restores the llama2.c interleaved-pair layout (export.py:468-470) —
  extended here to GQA K projections (the reference hardcodes
  n_kv_heads == n_heads, export.py:456).
- Meta multi-shard checkpoints concatenate along axis 1 for
  tok_embeddings/wo/w2 and axis 0 otherwise (export.py:380-396).
- llama2.c .pt checkpoints carry {model_args, model} with an optional
  torch.compile '_orig_mod.' prefix (export.py:356-369).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from rama_tpu_torch.checkpoint import _from_canonical, _to_canonical
from rama_tpu_torch.config import ModelConfig


def _transformers():
    """The `transformers` package (the HuggingFace source and target only)."""
    try:
        import transformers
    except ImportError as e:
        raise ImportError("the HuggingFace export needs the `transformers` package, which "
                          "is not installed") from e
    return transformers


_LAYER_MAP = {
    # canonical name -> (source key template, needs rotary permute_reverse)
    "attn_norm": ("model.layers.{i}.input_layernorm.weight", False),
    "wq": ("model.layers.{i}.self_attn.q_proj.weight", True),
    "wk": ("model.layers.{i}.self_attn.k_proj.weight", True),
    "wv": ("model.layers.{i}.self_attn.v_proj.weight", False),
    "wo": ("model.layers.{i}.self_attn.o_proj.weight", False),
    "ffn_norm": ("model.layers.{i}.post_attention_layernorm.weight", False),
    "w1": ("model.layers.{i}.mlp.gate_proj.weight", False),
    "w2": ("model.layers.{i}.mlp.down_proj.weight", False),
    "w3": ("model.layers.{i}.mlp.up_proj.weight", False),
}


def permute_reverse(w: np.ndarray, n_heads: int, head_dim: int) -> np.ndarray:
    """HF half-split rotary layout -> llama2.c interleaved pairs.

    w: (n_heads*head_dim, in_dim). Reference: export.py:468-470.
    """
    out_dim, in_dim = w.shape
    return (w.reshape(n_heads, 2, head_dim // 2, in_dim)
            .transpose(0, 2, 1, 3)
            .reshape(out_dim, in_dim))


def permute_forward(w: np.ndarray, n_heads: int, head_dim: int) -> np.ndarray:
    """llama2.c interleaved pairs -> HF half-split rotary layout (the inverse
    of permute_reverse; reference hf_export's permute_original,
    export.py:283-284, generalized to GQA head counts)."""
    out_dim, in_dim = w.shape
    return (w.reshape(n_heads, head_dim // 2, 2, in_dim)
            .transpose(0, 2, 1, 3)
            .reshape(out_dim, in_dim))


def params_to_hf(cfg: ModelConfig, params: dict, out_dir,
                 dtype=np.float32) -> None:
    """Write canonical params as a HuggingFace Llama checkpoint directory
    (pytorch_model.bin + config.json) loadable by
    transformers.AutoModelForCausalLM — the re-export direction of the
    reference's hf_export (export.py:262-350), incl. the forward WQ/WK
    rotary permutation and tied lm_head handling.
    """
    LlamaConfig = _transformers().LlamaConfig
    hd = cfg.head_dim
    torch_dtype = torch.from_numpy(np.zeros(0, dtype=dtype)).dtype

    def t(arr):
        return torch.from_numpy(
            np.ascontiguousarray(arr, dtype=np.float32)).to(torch_dtype)

    fileo = {k: _from_canonical(k, np.asarray(v, np.float32))
             for k, v in params.items()}

    sd = {
        "model.embed_tokens.weight": t(fileo["tok_embedding"]),
        "model.norm.weight": t(fileo["final_norm"]),
    }
    for i in range(cfg.n_layers):
        for name, (tmpl, permute) in _LAYER_MAP.items():
            w = fileo[name][i]
            if permute:
                heads = cfg.n_heads if name == "wq" else cfg.n_kv_heads
                w = permute_forward(w, heads, hd)
            sd[tmpl.format(i=i)] = t(w)
    # tied weights reference the embedding (export.py:304-310)
    sd["lm_head.weight"] = (sd["model.embed_tokens.weight"]
                            if cfg.shared_classifier
                            else t(fileo["wcls"]))

    hfc = LlamaConfig(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.dim,
        intermediate_size=cfg.hidden_dim,
        num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads,
        max_position_embeddings=cfg.seq_len,
        rms_norm_eps=cfg.norm_eps,
        rope_theta=cfg.rope_theta,
        tie_word_embeddings=cfg.shared_classifier,
        architectures=["LlamaForCausalLM"],
        hidden_act="silu",
    )
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save(sd, out_dir / "pytorch_model.bin")
    hfc.save_pretrained(out_dir)


def _to_np(t) -> np.ndarray:
    return np.asarray(t.detach().to("cpu").float().numpy() if hasattr(t, "detach") else t,
                      dtype=np.float32)


def _canonicalize(file_params: dict, cfg: ModelConfig) -> dict:
    """(out,in)-oriented tensors -> canonical (in,out) pytree."""
    return {k: _to_canonical(k, v) for k, v in file_params.items()}


def hf_to_params(model_or_path) -> tuple[ModelConfig, dict]:
    """transformers Llama model (instance or path) -> (config, canonical params)."""
    if isinstance(model_or_path, (str, Path)):
        model = _transformers().AutoModelForCausalLM.from_pretrained(model_or_path)
    else:
        model = model_or_path
    hfc = model.config
    n_kv = getattr(hfc, "num_key_value_heads", None) or hfc.num_attention_heads
    cfg = ModelConfig(
        dim=hfc.hidden_size,
        hidden_dim=hfc.intermediate_size,
        n_layers=hfc.num_hidden_layers,
        n_heads=hfc.num_attention_heads,
        n_kv_heads=n_kv,
        vocab_size=hfc.vocab_size,
        seq_len=hfc.max_position_embeddings,
        shared_classifier=bool(getattr(hfc, "tie_word_embeddings", False)),
        norm_eps=hfc.rms_norm_eps,
        rope_theta=getattr(hfc, "rope_theta", 10000.0),
    )
    sd = model.state_dict()
    hd = cfg.head_dim

    fp = {
        "tok_embedding": _to_np(sd["model.embed_tokens.weight"]),
        "final_norm": _to_np(sd["model.norm.weight"]),
    }
    stacked = {name: [] for name in _LAYER_MAP}
    for i in range(cfg.n_layers):
        for name, (tmpl, permute) in _LAYER_MAP.items():
            w = _to_np(sd[tmpl.format(i=i)])
            if permute:
                heads = cfg.n_heads if name == "wq" else cfg.n_kv_heads
                w = permute_reverse(w, heads, hd)
            stacked[name].append(w)
    for name, ws in stacked.items():
        fp[name] = np.stack(ws)
    if not cfg.shared_classifier:
        fp["wcls"] = _to_np(sd["lm_head.weight"])
    params = _canonicalize(fp, cfg)
    if cfg.shared_classifier:
        params["wcls"] = np.ascontiguousarray(params["tok_embedding"].T)
    return cfg, params


def llama2c_pt_to_params(path) -> tuple[ModelConfig, dict]:
    """llama2.c training checkpoint (.pt with model_args + model)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    args = ckpt["model_args"]
    sd = ckpt["model"]
    prefix = "_orig_mod."
    sd = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}

    n_kv = args.get("n_kv_heads") or args["n_heads"]
    hidden = args.get("hidden_dim") or sd["layers.0.feed_forward.w1.weight"].shape[0]
    shared = "output.weight" not in sd or bool(
        np.array_equal(_to_np(sd["tok_embeddings.weight"]),
                       _to_np(sd.get("output.weight", sd["tok_embeddings.weight"]))))
    cfg = ModelConfig(
        dim=args["dim"], hidden_dim=hidden, n_layers=args["n_layers"],
        n_heads=args["n_heads"], n_kv_heads=n_kv,
        vocab_size=args["vocab_size"], seq_len=args["max_seq_len"],
        shared_classifier=shared, norm_eps=args.get("norm_eps", 1e-5))
    return _from_llama2c_state_dict(sd, cfg)


def _from_llama2c_state_dict(sd: dict, cfg: ModelConfig) -> tuple[ModelConfig, dict]:
    names = {
        "attn_norm": "layers.{i}.attention_norm.weight",
        "wq": "layers.{i}.attention.wq.weight",
        "wk": "layers.{i}.attention.wk.weight",
        "wv": "layers.{i}.attention.wv.weight",
        "wo": "layers.{i}.attention.wo.weight",
        "ffn_norm": "layers.{i}.ffn_norm.weight",
        "w1": "layers.{i}.feed_forward.w1.weight",
        "w2": "layers.{i}.feed_forward.w2.weight",
        "w3": "layers.{i}.feed_forward.w3.weight",
    }
    fp = {
        "tok_embedding": _to_np(sd["tok_embeddings.weight"]),
        "final_norm": _to_np(sd["norm.weight"]),
    }
    for name, tmpl in names.items():
        fp[name] = np.stack([_to_np(sd[tmpl.format(i=i)])
                             for i in range(cfg.n_layers)])
    if not cfg.shared_classifier:
        fp["wcls"] = _to_np(sd["output.weight"])
    params = _canonicalize(fp, cfg)
    if cfg.shared_classifier:
        params["wcls"] = np.ascontiguousarray(params["tok_embedding"].T)
    return cfg, params


def meta_to_params(model_dir) -> tuple[ModelConfig, dict]:
    """Meta release: params.json + consolidated.*.pth TP shards, concatenated
    back to single tensors (axis rules from export.py:380-396)."""
    import json

    model_dir = Path(model_dir)
    params_json = json.loads((model_dir / "params.json").read_text())
    shard_paths = sorted(model_dir.glob("consolidated.*.pth"))
    shards = [torch.load(p, map_location="cpu", weights_only=False)
              for p in shard_paths]

    sd = {}
    for name in list(shards[0]):
        tensors = [s[name] for s in shards]
        if len(tensors) == 1 or tensors[0].ndim == 1:
            sd[name] = tensors[0]
            continue
        axis1 = (name.startswith("tok_embeddings.")
                 or name.endswith(".attention.wo.weight")
                 or name.endswith(".feed_forward.w2.weight"))
        sd[name] = torch.cat(tensors, dim=1 if axis1 else 0)

    n_heads = params_json["n_heads"]
    n_kv = params_json.get("n_kv_heads") or n_heads
    vocab = sd["tok_embeddings.weight"].shape[0]
    hidden = sd["layers.0.feed_forward.w1.weight"].shape[0]
    shared = bool(np.array_equal(_to_np(sd["tok_embeddings.weight"]),
                                 _to_np(sd["output.weight"])))
    cfg = ModelConfig(
        dim=params_json["dim"], hidden_dim=hidden,
        n_layers=params_json["n_layers"], n_heads=n_heads, n_kv_heads=n_kv,
        vocab_size=vocab, seq_len=2048,  # export.py:411 pins 2048
        shared_classifier=shared, norm_eps=params_json["norm_eps"])
    return _from_llama2c_state_dict(sd, cfg)
