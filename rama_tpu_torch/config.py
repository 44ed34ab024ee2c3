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
    # KV-cache quantization: None | "int8" (per-token-per-head absmax; halves
    # the cache's bytes and doubles the slots a card holds), on the dense
    # slots or the paged pool; under tensor parallelism the scales shard
    # with their rows.
    kv_quant: str | None = None

    # Speculative serving (defaults of rama_tpu/config.py:129-160): drafts a
    # round (0 = off), rounds a spec tick (clamped to a power of two), the
    # proposer ("ngram" prompt lookup or a resident "draft" model passed to
    # the Engine), and the rolling accept fraction below which spec sleeps
    # through plain ticks (0 = always speculate). The stream is the plain
    # ticks' stream either way.
    spec_tick: int = 0
    spec_rounds: int = 4
    spec_mode: str = "ngram"
    spec_min_accept: float = 0.1

    # Paged KV cache (runtime/paged.py): one shared pool of kv_num_pages
    # pages of kv_page_size rows (None: the dense worst case, batch x
    # ceil(max_len / page size)) plus a trash page; composes with kv_quant
    # and speculation.
    paged_kv: bool = False
    kv_page_size: int = 128
    kv_num_pages: int | None = None

    # Weight-quant scales stored in bf16 ("bf16") or as quantized (None).
    scale_dtype: str | None = None
    # Directory the CUDA kernels are built into and loaded from (None: the
    # default build directory; ops/kernels/build.py).
    compile_cache: str | None = None

    # Chunked prefill: prompts longer than prefill_chunk_min (default 4x the
    # chunk) admit in chunks of prefill_chunk tokens (0 = off).
    prefill_chunk: int = 0
    prefill_chunk_min: int | None = None
    # Tensor / data parallelism: one process a rank in a torch.distributed
    # group of tp_size * dp_size ranks (rama_tpu_torch/parallel/). seq_par
    # is not ported yet (ROADMAP.md): the Engine raises NotImplementedError.
    tp_size: int = 1
    dp_size: int = 1
    seq_par: bool = False
