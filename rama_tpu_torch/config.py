"""Model and engine configuration (the port's copy of rama_tpu/config.py).

- `ModelConfig`: hyperparameters parsed from the checkpoint binary header
  (reference: engine/src/transformer/mod.rs:128-167 `Config::from_file`);
- `EngineConfig`: runtime knobs (reference: engine/src/lib.rs:15-46). The
  fields of features this port has not reached yet are kept so configs
  stay interchangeable; `runtime.engine.Engine` raises NotImplementedError
  when one of them is set (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Llama-family model hyperparameters.

    The v0 llama2.c binary header is 7 little-endian int32s:
    (dim, hidden_dim, n_layers, n_heads, n_kv_heads, vocab_size, seq_len).
    A negative vocab_size encodes an *unshared* classifier head
    (reference: engine/src/transformer/mod.rs:150-158; export.py:84-86).
    """

    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    seq_len: int
    shared_classifier: bool = True
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def n_rep(self) -> int:
        """Query heads per KV head (GQA group size)."""
        return self.n_heads // self.n_kv_heads

    def __post_init__(self):
        if self.dim % self.n_heads != 0:
            raise ValueError(f"dim={self.dim} not divisible by n_heads={self.n_heads}")
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(
                f"n_heads={self.n_heads} not divisible by n_kv_heads={self.n_kv_heads}"
            )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass
class EngineConfig:
    """Runtime knobs for generation and serving.

    Defaults follow the reference (engine/src/lib.rs:27-35): steps=255,
    temperature=1.0, top_p=0.9.
    """

    model_path: str = ""
    tokenizer_path: str = ""
    steps: int = 255
    temperature: float = 1.0
    top_p: float = 0.9
    seed: int = 100

    max_batch_size: int = 8
    # Decode steps per engine tick: the sampled token of step i feeds step
    # i+1 on the device, and the host fetches the (n, B) tokens once per
    # tick. Slots that finish mid-tick overshoot; the extra tokens are
    # dropped host-side and their KV rows are never attended.
    decode_tick: int = 8
    max_seq_len: int | None = None  # None -> model seq_len

    dtype: str = "bfloat16"
    quant: str | None = None  # None | "int8" (weight-only group quant)
    quant_group_size: int = 64

    # Fields of features not ported yet (ROADMAP.md); setting any of them
    # makes the Engine raise NotImplementedError.
    paged_kv: bool = False
    kv_page_size: int = 128
    kv_num_pages: int | None = None
    prefill_chunk: int = 0
    prefill_chunk_min: int | None = None
    scale_dtype: str | None = None
    kv_quant: str | None = None
    spec_tick: int = 0
    spec_rounds: int = 4
    spec_mode: str = "ngram"
    spec_min_accept: float = 0.1
    tp_size: int = 1
    dp_size: int = 1
    seq_par: bool = False
    compile_cache: str | None = None
