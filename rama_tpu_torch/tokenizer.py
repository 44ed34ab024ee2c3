"""Byte-pair-encoding tokenizer for llama2.c `tokenizer.bin` vocabularies.

The port's own copy of `rama_tpu/tokenizer.py`. Behavioral parity with the
reference tokenizer (engine/src/tokenizer/bpe.rs:19-116):

- **File format** (bpe.rs:29-45): u32 max_token_length, then vocab_size
  records of (f32 score, i32 byte-length, utf-8 bytes).
- **encode** (bpe.rs:50-96): trim the input, drop newline characters, map each
  remaining character to its vocab id, then repeatedly merge the adjacent pair
  whose concatenation exists in the vocab with the highest score.
- **decode** (bpe.rs:101-116): `<s>`-containing tokens decode to the empty
  string; `<0xAB>` byte tokens decode to that raw byte.

A Tokenizer of `from_file` encodes with the C++ heap encoder of the port's
native library (rama_tpu_torch.native.NativeTokenizer, O(n log n)), made
at its first encode: the library is built and loaded then, into the build
directory current at that moment (an Engine's compile_cache, once an Engine
names one), and a failed build raises. The pure-Python loop below
(`_encode_plain`, O(n^2): it rescans every pair after each merge) is its
plain version, and the encoder of a Tokenizer made from lists. The two
differ at two edges only, as rama_tpu's two encoders do: the C++ encoder
trims only " \t\r\n" where str.strip trims every Unicode space, and ends
the text at a NUL byte (ROADMAP.md section 3).
"""

from __future__ import annotations

import struct
from pathlib import Path


class Tokenizer:
    def __init__(self, vocab: list[str], scores: list[float], max_token_length: int = 0):
        self.vocab = vocab
        self.scores = scores
        self.max_token_length = max_token_length
        self._native_file = None   # (path, vocab_size) of from_file: the C++ encoder's
        self._native = None        # that encoder, made at the first encode
        self.token_to_id = {}
        for i, tok in enumerate(vocab):
            # Last occurrence wins, matching the reference's HashMap insert
            # (bpe.rs:42).
            self.token_to_id[tok] = i

    @classmethod
    def from_file(cls, path: str | Path, vocab_size: int) -> "Tokenizer":
        data = Path(path).read_bytes()
        (max_len,) = struct.unpack_from("<I", data, 0)
        off = 4
        vocab, scores = [], []
        for _ in range(vocab_size):
            score, slen = struct.unpack_from("<fi", data, off)
            off += 8
            vocab.append(data[off : off + slen].decode("utf-8"))
            off += slen
            scores.append(score)
        tok = cls(vocab, scores, max_len)
        tok._native_file = (str(path), vocab_size)
        return tok

    def encode(self, s: str, strict: bool = True) -> list[int]:
        """Greedy score-maximizing BPE (bpe.rs:50-96 semantics).

        With strict=True, unknown characters raise KeyError (the reference
        panics, bpe.rs:55); strict=False skips them.
        """
        if self._native_file is None:
            return self._encode_plain(s, strict)
        if self._native is None:
            from rama_tpu_torch.native import NativeTokenizer

            self._native = NativeTokenizer(*self._native_file)
        return self._native.encode(s, strict=strict)

    def _encode_plain(self, s: str, strict: bool = True) -> list[int]:
        """The pure-Python loop: encode's plain version."""
        tokens: list[int] = []
        for ch in s.strip():
            if ch == "\n":
                continue
            tid = self.token_to_id.get(ch)
            if tid is None:
                if strict:
                    raise KeyError(f"character {ch!r} not in vocabulary")
                continue
            tokens.append(tid)

        while len(tokens) > 1:
            best_score = -1e10
            best_id = -1
            best_idx = -1
            for i in range(len(tokens) - 1):
                merged = self.vocab[tokens[i]] + self.vocab[tokens[i + 1]]
                tid = self.token_to_id.get(merged)
                if tid is not None and self.scores[tid] > best_score:
                    best_score = self.scores[tid]
                    best_id = tid
                    best_idx = i
            if best_idx < 0:
                break
            tokens[best_idx] = best_id
            del tokens[best_idx + 1]
        return tokens

    def decode_token(self, token_id: int) -> str:
        return decode(self.vocab[token_id])

    def decode_ids(self, ids) -> str:
        return "".join(self.decode_token(int(t)) for t in ids)


def decode(token_str: str) -> str:
    """Decode one raw vocab string (bpe.rs:101-116 semantics)."""
    if "<s>" in token_str:
        return ""
    if token_str and token_str[0] == "<" and token_str[-1] == ">":
        # "<0xAB>" byte tokens: hex digits at positions 3..5
        try:
            return chr(int(token_str[3:5], 16))
        except ValueError:
            return token_str
    return token_str


BOS_ID = 1  # generation starts from BOS=1 (mod.rs:182)
EOS_ID = 2
