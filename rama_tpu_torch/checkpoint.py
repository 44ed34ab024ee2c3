"""Checkpoint IO: llama2.c-format .bin readers and writers (the port's own
copy of rama_tpu/checkpoint.py: numpy, and the native library's threaded
transpose).

Formats (written by the reference's export pipeline, engine/export/export.py):

- **v0 (legacy)**: 28-byte header of 7 little-endian int32s
  (dim, hidden_dim, n_layers, n_heads, n_kv_heads, vocab_size, seq_len), a
  negative vocab_size meaning an *unshared* final classifier, followed by fp32
  tensors in fixed order (export.py:75-127): tok_embedding, [attn_norm]*L,
  [wq]*L, [wk]*L, [wv]*L, [wo]*L, [ffn_norm]*L, [w1]*L, [w2]*L, [w3]*L,
  final_norm, freqs_cos[:seq_len], freqs_sin[:seq_len], (wcls if unshared).
- **v1**: 256-byte header (magic 0x616b3432 "ak42", version=1, the 7 ints, a
  shared-classifier byte flag, zero pad), then fp32 tensors in the v1 order
  (export.py:132-180): all attn_norms, all ffn_norms, final_norm,
  tok_embedding, wq*, wk*, wv*, wo*, w1*, w2*, w3*, (wcls if unshared).
- **v2 (Q8_0)**: v1-style header plus an int32 group_size; norms in fp32;
  every matmul weight as int8 values followed by fp32 per-group scales
  (export.py:182-260, quantize_q80 at export.py:46-70).

Unlike the reference's Rust reader (engine/src/utils/read.rs:31-33, which
reads 4 bytes at a time), these readers memory-map the file and construct
numpy views — loading a 7B checkpoint is bounded by page-in bandwidth.

Canonical in-memory parameter layout (all 2-D weights stored **(in, out)** so
the forward pass is `x @ W`; the file stores row-major (out, in)):

    tok_embedding (V, D)        attn_norm (L, D)       ffn_norm (L, D)
    wq (L, D, D)  wk (L, D, KV) wv (L, D, KV) wo (L, D, D)
    w1 (L, D, H)  w2 (L, H, D)  w3 (L, D, H)
    final_norm (D,)             wcls (D, V)

Note on GQA: the reference Rust reader sizes wk/wv as dim*dim
(engine/src/transformer/ram.rs:35-37), which mis-parses GQA checkpoints; the
export actually writes (n_kv_heads*head_dim, dim) (model.py:106-107). We read
the sizes the export writes, so GQA checkpoints parse correctly.
"""

from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass

import numpy as np

from rama_tpu_torch.config import ModelConfig

MAGIC = 0x616B3432  # "ak42" (export.py:141)
HEADER_BYTES_V1V2 = 256


# ---------------------------------------------------------------------------
# Quantization (Q8_0): symmetric int8 per-group, scale = absmax/127
# ---------------------------------------------------------------------------

def quantize_q80(w: np.ndarray, group_size: int):
    """Symmetric per-group int8 quantization (semantics of export.py:46-70).

    Returns (int8 values flat, fp32 scales per group, max abs error).
    """
    flat = np.ascontiguousarray(w, dtype=np.float32).reshape(-1)
    if flat.size % group_size != 0:
        raise ValueError(f"numel {flat.size} not a multiple of group_size {group_size}")
    groups = flat.reshape(-1, group_size)
    scale = np.abs(groups).max(axis=1) / 127.0
    scale = np.where(scale == 0.0, 1e-10, scale).astype(np.float32)
    q = np.round(groups / scale[:, None]).astype(np.int8)
    err = np.abs(q.astype(np.float32) * scale[:, None] - groups).max()
    return q.reshape(-1), scale, float(err)


def dequantize_q80(q: np.ndarray, scale: np.ndarray, group_size: int) -> np.ndarray:
    flat = q.reshape(-1, group_size).astype(np.float32) * scale.reshape(-1, 1)
    return flat.reshape(-1)


@dataclass
class QuantParams:
    """Group-quantized weights, kept in the file's (out, in) orientation.

    `quant[name]` is (int8 values shaped (..., out, in), fp32 scales shaped
    (..., out, in // group_size)). The file groups the flattened row-major
    (out, in) stream in group_size runs; since group_size divides the input
    dim, every group lies along the input dimension of a single output row —
    exactly the layout the fused dequant+matmul kernel wants.
    """

    config: ModelConfig
    group_size: int
    norms: dict  # fp32: attn_norm (L,D), ffn_norm (L,D), final_norm (D,)
    quant: dict  # name -> (int8 (...,out,in), fp32 scales (...,out,in//gs))


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------


class _Reader:
    """Sequential typed reads over a memory-mapped file."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self.pos = 0
        self.size = len(self._mm)

    def close(self):
        # numpy views created by f32()/i8() may outlive the reader; mmap
        # refuses to close while exported buffers exist. The map is released
        # when the last view is garbage collected.
        try:
            self._mm.close()
        except BufferError:
            pass
        self._f.close()

    def ints(self, n: int) -> tuple:
        out = struct.unpack_from(f"<{n}i", self._mm, self.pos)
        self.pos += 4 * n
        return out

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self._mm, self.pos)
        self.pos += 4
        return v

    def u8(self) -> int:
        v = self._mm[self.pos]
        self.pos += 1
        return v

    def f32(self, shape) -> np.ndarray:
        n = int(np.prod(shape))
        arr = np.frombuffer(self._mm, dtype="<f4", count=n, offset=self.pos)
        self.pos += 4 * n
        return arr.reshape(shape)

    def i8(self, n: int) -> np.ndarray:
        arr = np.frombuffer(self._mm, dtype=np.int8, count=n, offset=self.pos)
        self.pos += n
        return arr


def peek_version(path: str) -> int:
    """Return 0 for legacy files, else the version int from the v1/v2 header."""
    with open(path, "rb") as f:
        head = f.read(8)
    magic, ver = struct.unpack("<Ii", head)
    return ver if magic == MAGIC else 0


def _config_from_7ints(vals) -> ModelConfig:
    dim, hidden_dim, n_layers, n_heads, n_kv_heads, vocab, seq_len = vals
    # v0: negative vocab_size flags an unshared classifier (mod.rs:150-158).
    shared = vocab > 0
    return ModelConfig(
        dim=dim,
        hidden_dim=hidden_dim,
        n_layers=n_layers,
        n_heads=n_heads,
        n_kv_heads=n_kv_heads,
        vocab_size=abs(vocab),
        seq_len=seq_len,
        shared_classifier=shared,
    )


def load_config(path: str) -> ModelConfig:
    r = _Reader(path)
    try:
        return _read_header(r)[0]
    finally:
        r.close()


def _read_header(r: _Reader):
    """Parse any of the three headers. Returns (config, version, group_size)."""
    magic = r.u32()
    if magic == MAGIC:
        version = r.ints(1)[0]
        cfg = _config_from_7ints(r.ints(7))
        shared = bool(r.u8())
        cfg = cfg.replace(shared_classifier=shared)
        group_size = r.ints(1)[0] if version == 2 else 0
        r.pos = HEADER_BYTES_V1V2
        return cfg, version, group_size
    else:
        r.pos = 0
        cfg = _config_from_7ints(r.ints(7))
        return cfg, 0, 0


def _canonical_shapes(c: ModelConfig):
    """File-order tensor shapes as written (out, in); keys are canonical names."""
    return {
        "tok_embedding": (c.vocab_size, c.dim),
        "attn_norm": (c.n_layers, c.dim),
        "wq": (c.n_layers, c.n_heads * c.head_dim, c.dim),
        "wk": (c.n_layers, c.kv_dim, c.dim),
        "wv": (c.n_layers, c.kv_dim, c.dim),
        "wo": (c.n_layers, c.dim, c.n_heads * c.head_dim),
        "ffn_norm": (c.n_layers, c.dim),
        "w1": (c.n_layers, c.hidden_dim, c.dim),
        "w2": (c.n_layers, c.dim, c.hidden_dim),
        "w3": (c.n_layers, c.hidden_dim, c.dim),
        "final_norm": (c.dim,),
        "wcls": (c.vocab_size, c.dim),
    }


_MATMUL_NAMES_V2 = ["tok_embedding", "wq", "wk", "wv", "wo", "w1", "w2", "w3"]


def _to_canonical(name: str, arr: np.ndarray) -> np.ndarray:
    """File layout (out,in) -> canonical (in,out); embeddings/norms unchanged.

    Through the native library's threaded blocked transpose (csrc/native.cpp),
    as rama_tpu's loader does: the dominant host cost of loading a
    multi-GB checkpoint."""
    if name in ("tok_embedding", "attn_norm", "ffn_norm", "final_norm"):
        return arr
    from rama_tpu_torch.native import transpose_batched

    return transpose_batched(arr)


def load_checkpoint(path: str, dtype=np.float32):
    """Load a v0/v1/v2 .bin checkpoint into canonical fp32 params.

    v2 weights are dequantized. Returns (ModelConfig, dict[str, np.ndarray]).
    """
    r = _Reader(path)
    try:
        cfg, version, group_size = _read_header(r)
        shapes = _canonical_shapes(cfg)
        params = {}
        if version == 0:
            order = [
                "tok_embedding", "attn_norm", "wq", "wk", "wv", "wo",
                "ffn_norm", "w1", "w2", "w3", "final_norm",
            ]
            for name in order:
                params[name] = r.f32(shapes[name])
            # freqs are recomputable; parse to validate position then skip.
            half = cfg.head_dim // 2
            r.f32((cfg.seq_len, half))  # freqs_cos
            r.f32((cfg.seq_len, half))  # freqs_sin
            if not cfg.shared_classifier:
                params["wcls"] = r.f32(shapes["wcls"])
        elif version == 1:
            params["attn_norm"] = r.f32(shapes["attn_norm"])
            params["ffn_norm"] = r.f32(shapes["ffn_norm"])
            params["final_norm"] = r.f32(shapes["final_norm"])
            for name in _MATMUL_NAMES_V2:
                params[name] = r.f32(shapes[name])
            if not cfg.shared_classifier:
                params["wcls"] = r.f32(shapes["wcls"])
        elif version == 2:
            params["attn_norm"] = r.f32(shapes["attn_norm"])
            params["ffn_norm"] = r.f32(shapes["ffn_norm"])
            params["final_norm"] = r.f32(shapes["final_norm"])
            names = list(_MATMUL_NAMES_V2)
            if not cfg.shared_classifier:
                names.append("wcls")
            for name in names:
                # The reference serializes each *per-layer* matrix as its own
                # (q, scales) pair (export.py:197-254: the weights list holds
                # one entry per layer, and q/s interleave per entry) — so a
                # stacked (L, out, in) tensor is L interleaved blocks, not one
                # int8 block followed by all scales.
                shape = shapes[name]
                per = shape[1:] if len(shape) == 3 else shape
                n = int(np.prod(per))
                blocks = []
                for _ in range(shape[0] if len(shape) == 3 else 1):
                    q = r.i8(n)
                    s = r.f32((n // group_size,))
                    blocks.append(dequantize_q80(q, s, group_size))
                params[name] = np.stack(blocks).reshape(shape)
        else:
            raise ValueError(f"unsupported checkpoint version {version}")

        out = {}
        for name, arr in params.items():
            out[name] = _to_canonical(name, np.asarray(arr, dtype=np.float32))
        if cfg.shared_classifier:
            out["wcls"] = np.ascontiguousarray(out["tok_embedding"].T)
        if dtype != np.float32:
            out = {k: v.astype(dtype) for k, v in out.items()}
        return cfg, out
    finally:
        r.close()


def load_checkpoint_quantized(path: str) -> QuantParams:
    """Load a v2 (Q8_0) checkpoint keeping int8 values + per-group scales."""
    r = _Reader(path)
    try:
        cfg, version, group_size = _read_header(r)
        if version != 2:
            raise ValueError(f"not a v2 checkpoint: version={version}")
        if cfg.dim % group_size or cfg.hidden_dim % group_size:
            raise ValueError(
                f"group_size {group_size} must divide dim/hidden_dim for the "
                f"per-row scale layout"
            )
        shapes = _canonical_shapes(cfg)
        norms = {
            "attn_norm": r.f32(shapes["attn_norm"]).copy(),
            "ffn_norm": r.f32(shapes["ffn_norm"]).copy(),
            "final_norm": r.f32(shapes["final_norm"]).copy(),
        }
        quant = {}
        names = list(_MATMUL_NAMES_V2)
        if not cfg.shared_classifier:
            names.append("wcls")
        for name in names:
            # Per-layer (q, scales) interleaving — see load_checkpoint's v2
            # branch (reference export.py:197-254 writes one q/s pair per
            # layer matrix, not one block per stacked tensor).
            shape = shapes[name]  # file orientation (..., out, in)
            per = shape[1:] if len(shape) == 3 else shape
            n = int(np.prod(per))
            qs, ss = [], []
            for _ in range(shape[0] if len(shape) == 3 else 1):
                qs.append(r.i8(n).reshape(per).copy())
                ss.append(r.f32(per[:-1] + (per[-1] // group_size,)).copy())
            if len(shape) == 3:
                quant[name] = (np.stack(qs), np.stack(ss))
            else:
                quant[name] = (qs[0], ss[0])
        return QuantParams(config=cfg, group_size=group_size, norms=norms, quant=quant)
    finally:
        r.close()


# ---------------------------------------------------------------------------
# Writers (export pipeline: produce files byte-compatible with the formats)
# ---------------------------------------------------------------------------


def _from_canonical(name: str, arr: np.ndarray) -> np.ndarray:
    """Canonical (in,out) -> file layout (out,in), by the same threaded
    transpose as _to_canonical; embeddings/norms unchanged."""
    if name in ("tok_embedding", "attn_norm", "ffn_norm", "final_norm"):
        return arr
    from rama_tpu_torch.native import transpose_batched

    return transpose_batched(np.asarray(arr))


def compute_freqs(cfg: ModelConfig, dtype=np.float32, seq_len: int | None = None):
    """RoPE cos/sin tables, (seq_len, head_dim//2); model.py:41-47 semantics.

    `seq_len` overrides the checkpoint's table length for long-context
    serving (EngineConfig.max_seq_len > header seq_len): the rotation is the
    same exact function of position, just tabulated further out. Quality at
    positions beyond the training context is the model's extrapolation
    behavior — no NTK/position-interpolation rescaling is applied."""
    half = cfg.head_dim // 2
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, half, dtype=np.float64) * 2.0 / cfg.head_dim))
    t = np.arange(seq_len or cfg.seq_len, dtype=np.float64)
    freqs = np.outer(t, inv)
    return np.cos(freqs).astype(dtype), np.sin(freqs).astype(dtype)


def _write_f32(f, arr):
    np.ascontiguousarray(arr, dtype="<f4").tofile(f)


def save_v0(path: str, cfg: ModelConfig, params: dict):
    """Write the legacy v0 format (export.py:75-127 byte layout)."""
    vocab = cfg.vocab_size if cfg.shared_classifier else -cfg.vocab_size
    with open(path, "wb") as f:
        f.write(struct.pack("<7i", cfg.dim, cfg.hidden_dim, cfg.n_layers,
                            cfg.n_heads, cfg.n_kv_heads, vocab, cfg.seq_len))
        order = [
            "tok_embedding", "attn_norm", "wq", "wk", "wv", "wo",
            "ffn_norm", "w1", "w2", "w3", "final_norm",
        ]
        for name in order:
            _write_f32(f, _from_canonical(name, params[name]))
        cos, sin = compute_freqs(cfg)
        _write_f32(f, cos)
        _write_f32(f, sin)
        if not cfg.shared_classifier:
            _write_f32(f, _from_canonical("wcls", params["wcls"]))


def _write_header_v1v2(f, cfg: ModelConfig, version: int, group_size: int = 0):
    vocab = cfg.vocab_size  # v1/v2 store vocab unsigned; flag byte carries sharing
    f.write(struct.pack("<I", MAGIC))
    f.write(struct.pack("<i", version))
    f.write(struct.pack("<7i", cfg.dim, cfg.hidden_dim, cfg.n_layers,
                        cfg.n_heads, cfg.n_kv_heads, vocab, cfg.seq_len))
    f.write(struct.pack("<B", int(cfg.shared_classifier)))
    if version == 2:
        f.write(struct.pack("<i", group_size))
    f.write(b"\0" * (HEADER_BYTES_V1V2 - f.tell()))


def save_v1(path: str, cfg: ModelConfig, params: dict):
    """Write the v1 format (export.py:132-180 byte layout)."""
    with open(path, "wb") as f:
        _write_header_v1v2(f, cfg, 1)
        for name in ("attn_norm", "ffn_norm", "final_norm"):
            _write_f32(f, params[name])
        for name in _MATMUL_NAMES_V2:
            _write_f32(f, _from_canonical(name, params[name]))
        if not cfg.shared_classifier:
            _write_f32(f, _from_canonical("wcls", params["wcls"]))


def save_v2(path: str, cfg: ModelConfig, params: dict, group_size: int = 64):
    """Write Q8_0 (export.py:182-260 byte layout). Returns max group error."""
    # export.py:194-196 backs off on dim only; we also require hidden_dim so
    # the per-row scale layout (and the fused kernel) can consume the file.
    while cfg.dim % group_size != 0 or cfg.hidden_dim % group_size != 0:
        group_size //= 2
    max_err = 0.0
    with open(path, "wb") as f:
        _write_header_v1v2(f, cfg, 2, group_size)
        for name in ("attn_norm", "ffn_norm", "final_norm"):
            _write_f32(f, params[name])
        names = list(_MATMUL_NAMES_V2)
        if not cfg.shared_classifier:
            names.append("wcls")
        for name in names:
            w = _from_canonical(name, params[name])
            # One (q, scales) pair per layer matrix, matching the reference's
            # per-entry interleaving (export.py:197-254).
            layers = w if w.ndim == 3 else w[None]
            for wl in layers:
                q, s, err = quantize_q80(wl, group_size)
                max_err = max(max_err, err)
                q.astype(np.int8).tofile(f)
                _write_f32(f, s)
    return max_err
