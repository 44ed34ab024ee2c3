"""rama_tpu_torch's native host library (csrc/native.cpp, native.py) on the
CPU, built here with the host C++ compiler: the C++ encoder against
rama_tpu's (rama_tpu.native.NativeTokenizer) id for id on the fixture
tokenizer, and against the port's Python encoder (equal on ordinary text,
the documented difference at the edges: ROADMAP.md section 3); the
threaded transpose byte for byte against numpy; the library's C page
allocator (`pages_*`, bound here) against the engine's Python one, tables
and free counts over a seeded random run; and the build step (reuse, the
name's hash, the build directory current at the first encode, a failed
build or a missing compiler raising). Every comparison is exact."""

import ctypes
import os
import pathlib

import numpy as np
import pytest

from rama_tpu import native as jnative
from rama_tpu_torch import native
from rama_tpu_torch.ops.kernels import build
from rama_tpu_torch.runtime.paged import PageAllocator as PlainAllocator
from rama_tpu_torch.tokenizer import Tokenizer

FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "tokenizer.bin"
VOCAB_SIZE = 32000
# tests/test_native.py's prompts
PROMPTS = [
    "once upon a time",
    "the quick brown fox jumps over the lazy dog",
    "hello world",
    "a",
    "  leading and trailing  ",
    "multi\nline\ninput",
    "punctuation, numbers 12345 and CAPS!",
    "repeated repeated repeated repeated words words words",
]
# where the C++ encoder and the Python loop part: Unicode spaces at the ends
# (C++ trims only " \t\r\n"), a NUL byte (the C++ encoder reads up to it);
# an interior newline is dropped by both
EDGES = ["\xa0hello　", "a\x00b", "one\ntwo", "  x", "end\x00"]
PASSAGE = ("Once upon a time, there was a little girl named Lily. She loved to play "
           "outside in the sunshine with her dog Max. One day they found a big red ball "
           "in the park and played with it until the sun went down. ")


def _plain(tok: Tokenizer) -> Tokenizer:
    """The Python loop over `tok`'s vocabulary (a Tokenizer made from lists)."""
    return Tokenizer(tok.vocab, tok.scores, tok.max_token_length)


@pytest.fixture(scope="module")
def encoders():
    cpp = Tokenizer.from_file(FIXTURE, VOCAB_SIZE)
    return cpp, _plain(cpp), jnative.NativeTokenizer(FIXTURE, VOCAB_SIZE)


def _random_texts(seed: int, n: int) -> list:
    """Strings over the vocabulary's single characters (and spaces)."""
    rng = np.random.default_rng(seed)
    vocab = Tokenizer.from_file(FIXTURE, VOCAB_SIZE).vocab
    # no whitespace but the space: str.strip trims Unicode spaces, the C++
    # encoder only " \t\r\n" (test_encoder_edges_differ_as_documented)
    chars = sorted({v for v in vocab if len(v) == 1 and v != "\x00"
                    and (v == " " or not v.isspace())})
    return ["".join(rng.choice(chars, size=int(rng.integers(1, 80)))) for _ in range(n)]


def test_from_file_takes_the_cpp_encoder(encoders):
    """A from_file Tokenizer makes its C++ encoder at its first encode; a
    Tokenizer made from lists runs the Python loop."""
    cpp, py, _ = encoders
    tok = Tokenizer.from_file(FIXTURE, VOCAB_SIZE)
    assert tok._native is None and tok._native_file == (str(FIXTURE), VOCAB_SIZE)
    assert tok.encode("hello") == [12199]
    assert isinstance(tok._native, native.NativeTokenizer)
    cpp.encode("a")
    assert isinstance(cpp._native, native.NativeTokenizer)
    assert py.encode("hello") == [12199] and py._native is None and py._native_file is None


@pytest.mark.parametrize("text", PROMPTS + EDGES + ["", "   ", " \t\r\n ", "\n"],
                         ids=lambda t: repr(t)[:40])
def test_cpp_encoder_equals_rama_tpus(encoders, text):
    cpp, _, jax_cpp = encoders
    assert cpp.encode(text, strict=False) == jax_cpp.encode(text, strict=False)
    if "\x00" not in text:
        assert cpp.encode(text) == jax_cpp.encode(text)


@pytest.mark.parametrize("text", PROMPTS, ids=lambda t: t[:20])
def test_cpp_encoder_equals_the_python_loop_on_ordinary_text(encoders, text):
    cpp, py, _ = encoders
    assert cpp.encode(text) == py.encode(text)


@pytest.mark.parametrize("text,cpp_ids,py_ids", [
    ("\xa0hello　", [30081, 12199, 30358], [12199]),   # Unicode spaces kept by C++
    ("a\x00b", [29874], [370]),                             # C++ stops at the NUL
    ("one\ntwo", None, None)])                              # no difference
def test_encoder_edges_differ_as_documented(encoders, text, cpp_ids, py_ids):
    cpp, py, _ = encoders
    got_cpp, got_py = cpp.encode(text, strict=False), py.encode(text, strict=False)
    if cpp_ids is None:
        assert got_cpp == got_py
    else:
        assert (got_cpp, got_py) == (cpp_ids, py_ids)


@pytest.mark.parametrize("strict", [True, False])
def test_out_of_vocabulary_characters(encoders, strict):
    cpp, py, jax_cpp = encoders
    text = "he\x07llo \U0001F600 world"
    if strict:
        for enc in (cpp, jax_cpp):
            with pytest.raises(KeyError):
                enc.encode(text, strict=True)
        with pytest.raises(KeyError):
            py.encode(text, strict=True)
    else:
        got = cpp.encode(text, strict=False)
        assert got == jax_cpp.encode(text, strict=False) == py.encode(text, strict=False)
        assert got == cpp.encode("hello  world")


@pytest.mark.parametrize("text", ["", " ", "   ", "\t\r\n"], ids=repr)
def test_empty_and_whitespace_only_text(encoders, text):
    cpp, py, jax_cpp = encoders
    assert cpp.encode(text) == jax_cpp.encode(text) == py.encode(text) == []


def test_a_3000_token_passage(encoders):
    """The passage repeated to past 3000 tokens: the C++ encoders agree;
    the Python loop (O(n^2), seconds here) agrees on a 400-token cut."""
    cpp, py, jax_cpp = encoders
    text = PASSAGE * 62
    ids = cpp.encode(text)
    assert len(ids) >= 3000 and ids == jax_cpp.encode(text)
    short = PASSAGE * 8
    assert cpp.encode(short) == py.encode(short)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_strings_over_the_vocabulary(encoders, seed):
    cpp, py, jax_cpp = encoders
    for text in _random_texts(seed, 25):
        got = cpp.encode(text, strict=False)
        assert got == jax_cpp.encode(text, strict=False), text
        assert got == py.encode(text, strict=False), text


@pytest.mark.parametrize("shape,dtype", [
    ((37, 129), np.float32), ((3, 37, 129), np.float32), ((1, 64, 64), np.float32),
    ((5, 1, 131), np.float32), ((64, 48), np.int8), ((2, 257, 65), np.int8),
    ((3, 130, 1), np.int8), ((4, 200, 300), np.float32)])
def test_transpose_equals_numpy_byte_for_byte(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    a = (rng.standard_normal(shape).astype(np.float32) if dtype == np.float32
         else rng.integers(-128, 128, shape).astype(np.int8))
    want = np.ascontiguousarray(np.swapaxes(a, -1, -2))
    for threads in (None, 1, 3):
        got = native.transpose_batched(a, n_threads=threads)
        assert got.dtype == a.dtype and got.shape == want.shape and got.flags.c_contiguous
        assert got.tobytes() == want.tobytes()
    assert native.transpose_batched(a).tobytes() == jnative.transpose_batched(a).tobytes()


def test_transpose_of_other_dtypes_and_a_strided_view():
    a = np.arange(2 * 5 * 7, dtype=np.float64).reshape(2, 5, 7)
    assert native.transpose_batched(a).tobytes() == np.ascontiguousarray(
        a.transpose(0, 2, 1)).tobytes()
    b = np.arange(6 * 9, dtype=np.float32).reshape(6, 9)[:, ::2]
    assert native.transpose_batched(b).tobytes() == np.ascontiguousarray(b.T).tobytes()
    with pytest.raises(ValueError, match="2-D or 3-D"):
        native.transpose_batched(np.zeros((2, 2, 2, 2), np.float32))


def test_checkpoint_transposes_through_the_native_library(monkeypatch):
    from rama_tpu_torch import checkpoint

    calls = []
    real = native.transpose_batched
    monkeypatch.setattr(native, "transpose_batched", lambda a: calls.append(a.dtype) or real(a))
    w = np.arange(3 * 4 * 5, dtype=np.float32).reshape(3, 4, 5)
    assert checkpoint._to_canonical("wq", w).tobytes() == w.transpose(0, 2, 1).copy().tobytes()
    assert checkpoint._to_canonical("attn_norm", w) is w and calls == [np.float32]


class CPages:
    """The library's C page allocator (`pages_*`), bound for the comparison
    with the methods of runtime/paged.py's PageAllocator."""

    def __init__(self, num_pages: int, page_size: int, max_slots: int):
        self.lib = native.load()
        self.h = self.lib.pages_create(num_pages, page_size, max_slots)
        self.buf = (ctypes.c_int32 * num_pages)()

    def available(self) -> int:
        return self.lib.pages_available(self.h)

    def reserve(self, slot: int, seq_len: int) -> int:
        return self.lib.pages_reserve(self.h, slot, seq_len)

    def release(self, slot: int) -> None:
        self.lib.pages_release(self.h, slot)

    def table(self, slot: int) -> list:
        return self.buf[:self.lib.pages_table(self.h, slot, self.buf, len(self.buf))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_allocator_equals_the_python_one(seed):
    """A seeded random run of reserve / release over 5 slots of a 40-page
    pool of 16-row pages, past exhaustion: every reserve's return (-1 when
    the free pages do not suffice), every table and the free count agree."""
    rng = np.random.default_rng(seed)
    cpp, plain = CPages(40, 16, 5), PlainAllocator(40, 16, 5)
    exhausted = 0
    for _ in range(400):
        slot = int(rng.integers(0, 5))
        if rng.random() < 0.3:
            cpp.release(slot)
            plain.release(slot)
        else:
            rows = int(rng.integers(0, 260))
            got = cpp.reserve(slot, rows)
            assert got == plain.reserve(slot, rows)
            exhausted += got == -1
        assert cpp.available() == plain.available()
        assert [cpp.table(s) for s in range(5)] == [plain.table(s) for s in range(5)]
    assert exhausted > 0
    cpp.lib.pages_free(cpp.h)


def test_a_second_load_reuses_the_built_library(monkeypatch, tmp_path):
    counts = {"builds": 0, "loads": 0}
    monkeypatch.setattr(build, "counts", counts)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_libs", {})
    lib = native.load()
    assert counts == {"builds": 1, "loads": 1} and native.lib_path().parent == tmp_path
    assert native.load() is lib and counts == {"builds": 1, "loads": 1}
    monkeypatch.setattr(build, "_libs", {})        # another process: the library is on disk
    native.load()
    assert counts == {"builds": 1, "loads": 2}
    assert [p.name for p in tmp_path.iterdir()] == [native.lib_path().name]   # no temp file


def test_load_all_loads_the_native_library(monkeypatch):
    """Engine.warmup's load_all loads the native library with the kernels'
    (here nvcc is missing: it gets as far as the first kernel library)."""
    counts = {"builds": 0, "loads": 0}
    monkeypatch.setattr(build, "counts", counts)
    monkeypatch.setattr(build, "_libs", {})

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "build_all", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_all()
    assert list(build._libs) == [native.NAME] and counts["loads"] == 1


def test_the_library_lands_in_the_build_directory_of_the_first_encode(monkeypatch, tmp_path):
    """A Tokenizer made before an engine names its compile_cache builds and
    loads the library there at its first encode; from then on the process
    refuses another build directory, as it does once a kernel is loaded."""
    monkeypatch.setattr(build, "BUILD_DIR", build.DEFAULT_BUILD_DIR)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "counts", {"builds": 0, "loads": 0})
    tok = Tokenizer.from_file(FIXTURE, VOCAB_SIZE)
    assert build._libs == {}                                # nothing loaded yet
    cache = build.set_build_dir(tmp_path / "cache")         # as Engine(compile_cache=...)
    assert tok.encode("hello") == [12199]
    assert native.lib_path().parent == cache and native.lib_path().exists()
    assert build.counts == {"builds": 1, "loads": 1}
    assert build.set_build_dir(cache) == cache
    with pytest.raises(RuntimeError, match="already loaded"):
        build.set_build_dir(tmp_path / "other")


def test_the_name_hashes_the_flags_and_the_compiler():
    base = native.lib_path()
    assert base.name.startswith("native-") and base.parent == build.BUILD_DIR
    assert native.lib_path(native.CXX_FLAGS + ("-DX",)) != base
    assert native.lib_path(tuple(f for f in native.CXX_FLAGS if f != "-O3")) != base
    assert not any(f.startswith("-march") for f in native.CXX_FLAGS)


def test_the_name_follows_the_compilers_version(monkeypatch):
    base = native.lib_path()
    monkeypatch.setattr(native, "_versions", {native.compiler(): "another compiler 1.0"})
    assert native.lib_path() != base


def test_a_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="host C.. compiler 'no-such-compiler-here' not found"):
        native.load()
    tok = Tokenizer.from_file(FIXTURE, VOCAB_SIZE)
    with pytest.raises(RuntimeError, match="not found"):
        tok.encode("hello")                                # no quiet Python fallback
    assert _plain(tok).encode("hello") == [12199]


def test_a_failed_build_raises_and_leaves_no_library(monkeypatch, tmp_path):
    bad = tmp_path / "native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed on native.cpp"):
        native.build_library()
    assert not any((tmp_path / "build").iterdir())


def test_the_build_honours_cxx(monkeypatch, tmp_path):
    """$CXX names the compiler: a wrapper script that records its call."""
    log = tmp_path / "calls"
    wrapper = tmp_path / "cxx-wrapper"
    wrapper.write_text(f"#!/bin/sh\necho \"$@\" >> {log}\nexec c++ \"$@\"\n")
    wrapper.chmod(0o755)
    monkeypatch.setenv("CXX", str(wrapper))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    out = native.build_library()
    assert out.exists() and "-O3" in log.read_text() and "-march" not in log.read_text()
    assert os.access(out, os.R_OK)


def test_the_c_interface_is_rama_tpus():
    """csrc/native.cpp exports the C entries of native/rama_native.cpp, with
    the same declarations."""
    import re

    def entries(path):
        text = pathlib.Path(path).read_text()
        return sorted(re.findall(r"^(?:[\w*]+\s+)+\**(?:tokenizer|transpose|pages)_\w+\([^)]*\)",
                                 text, flags=re.M))

    root = pathlib.Path(__file__).resolve().parents[1]
    mine = entries(native.SOURCE)
    assert mine == entries(root / "native" / "rama_native.cpp")
    names = {e.split("(")[0].split()[-1].lstrip("*") for e in mine}
    lib = native.load()
    for name in ("tokenizer_create", "tokenizer_free", "tokenizer_encode", "transpose_f32",
                 "transpose_i8", "pages_create", "pages_free", "pages_available",
                 "pages_reserve", "pages_release", "pages_table"):
        assert name in names and getattr(lib, name).argtypes is not None, name
