"""Perplexity evaluation — the port of rama_tpu/eval.py.

The text is tokenized once ([BOS] + ids), split into non-overlapping
windows of `window` tokens (the window count padded to a multiple of the
batch, so every forward has one shape), and scored teacher-forced: each
batch of windows is one `prefill` from position 0 with full logits (the
prefill attention kernel, K5, on the card), log_softmax in fp32, the
targets' log-probabilities summed over the mask; perplexity = exp(total
NLL / predicted tokens). Point it at wikitext-2's test split for the
standard number.

The scoring cache takes the params' dtype (the kernels take one dtype for
the queries and the cache); rama_tpu's is bf16 whatever the params.
"""

from __future__ import annotations

import numpy as np
import torch

from rama_tpu_torch.config import ModelConfig
from rama_tpu_torch.models.llama import KVCache, prefill
from rama_tpu_torch.tokenizer import BOS_ID, Tokenizer


@torch.no_grad()
def _score(params, cfg: ModelConfig, inputs: torch.Tensor, targets: torch.Tensor,
           mask: torch.Tensor, plain: bool = False) -> tuple[float, float]:
    """Sum of log p(target) over the masked positions and the mask's sum;
    inputs / targets / mask (B, T)."""
    cache = KVCache.create(cfg, batch=inputs.shape[0], max_len=inputs.shape[1],
                           dtype=params["final_norm"].dtype, device=inputs.device)
    logits, _ = prefill(params, cfg, inputs, cache, plain=plain)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = torch.gather(logp, -1, targets[..., None])[..., 0]
    return float((tgt * mask).sum()), float(mask.sum())


def perplexity(params, cfg: ModelConfig, tokenizer: Tokenizer, text: str,
               window: int | None = None, batch: int = 4, max_tokens: int | None = None,
               plain: bool = False) -> dict:
    """{"perplexity", "nll" (mean per predicted token), "tokens" (predicted),
    "windows"} of `text`, on the device the params live on. `plain=True`
    runs the kernels' plain PyTorch versions (the card's reference)."""
    ids = [BOS_ID] + tokenizer.encode(text, strict=False)
    if max_tokens:
        ids = ids[: max_tokens + 1]
    t = min(window or 512, cfg.seq_len)
    n_pred = len(ids) - 1
    if n_pred < 1:
        raise ValueError("text too short to score")
    inputs = np.asarray(ids[:-1], np.int64)
    targets = np.asarray(ids[1:], np.int64)
    n_windows = -(-n_pred // t)
    pad = n_windows * t - n_pred
    inputs = np.pad(inputs, (0, pad)).reshape(n_windows, t)
    targets = np.pad(targets, (0, pad)).reshape(n_windows, t)
    mask = np.pad(np.ones(n_pred, np.float32), (0, pad)).reshape(n_windows, t)
    wpad = (-n_windows) % batch
    if wpad:
        inputs, targets, mask = (np.pad(a, ((0, wpad), (0, 0))) for a in (inputs, targets, mask))
    dev = params["final_norm"].device
    total_lp = total_n = 0.0
    for i in range(0, inputs.shape[0], batch):
        lp, n = _score(params, cfg, *(torch.from_numpy(a[i:i + batch]).to(dev)
                                      for a in (inputs, targets, mask)), plain=plain)
        total_lp += lp
        total_n += n
    nll = -total_lp / total_n
    return {"perplexity": float(np.exp(nll)), "nll": nll, "tokens": int(total_n),
            "windows": n_windows}
