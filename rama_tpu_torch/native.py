"""The port's native host library (csrc/native.cpp): ctypes bindings and
its build step. The counterpart of rama_tpu/native.py, with the same
signatures and errors:

- `NativeTokenizer`: the heap BPE encoder, O(n log n) where the Python
  loop of tokenizer.py (the plain version) is O(n^2); every entry point
  encodes through it (`Tokenizer.from_file`);
- `transpose_batched`: the threaded blocked (L, R, C) -> (L, C, R)
  transpose of checkpoint.py's `_to_canonical`.

The library also keeps the C page allocator of rama_tpu's (`pages_*`); the
engine pages with runtime/paged.py's Python allocator, whose tables the C
one matches (tests/test_torch_native.py).

The library is built on first use by the host C++ compiler (`$CXX`, else
`c++`; no nvcc) into the kernels' build directory (`build.BUILD_DIR`:
build/rama_tpu_torch/ under the checkout, or EngineConfig.compile_cache),
as `native-<hash>.so`, the hash taken over the source, the flags and the
compiler's `--version`; a temporary file is renamed into place, so
processes that build it at the same moment all end with one whole library.
The flags carry no `-march=native`: a build directory copied to another
host must not stop there on an illegal instruction. It is loaded once a
process, as the kernel libraries are (`build._libs["native"]`), so
`build.set_build_dir` refuses another directory once it is loaded;
`build.counts` counts the compiler runs and the load; `build.load_all`
(Engine.warmup) loads it. There is no fallback: a missing compiler or a
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from rama_tpu_torch.ops.kernels import build

SOURCE = build.CSRC / "native.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-pthread")

NAME = "native"                  # its key in build._libs
_versions: dict[str, str] = {}   # compiler path -> its `--version` output


def compiler() -> str:
    """The host C++ compiler: `$CXX`, else `c++`, found on PATH."""
    name = os.environ.get("CXX") or "c++"
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"host C++ compiler {name!r} not found ($CXX, else c++ on PATH): "
                           f"the port's native library cannot be built")
    return found


def _version(cxx: str) -> str:
    if cxx not in _versions:
        _versions[cxx] = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                                        check=True).stdout
    return _versions[cxx]


def lib_path(flags=CXX_FLAGS, build_dir=None) -> Path:
    """Where the library built with `flags` by this host's compiler lives
    (in `build_dir`, by default the build directory)."""
    cxx = compiler()
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(_version(cxx).encode())
    h.update(SOURCE.read_bytes())
    return Path(build_dir or build.BUILD_DIR) / f"native-{h.hexdigest()[:12]}.so"


def build_library(flags=CXX_FLAGS, build_dir=None) -> Path:
    """Compile csrc/native.cpp unless its library exists; returns its path
    (raises if the compiler fails)."""
    out = lib_path(flags, build_dir)
    with build._lock:
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cxx = compiler()
        proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)], capture_output=True,
                              text=True)
        build.counts["builds"] += 1
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed on {SOURCE.name} (rc {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library (built on first use), its C entries declared."""
    lib = build._libs.get(NAME)
    if lib is not None:
        return lib
    path = build_library()
    with build._lock:
        if NAME not in build._libs:
            lib = ctypes.CDLL(str(path))
            i32, i64, p = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
            pi32 = ctypes.POINTER(i32)
            for fn, res, args in (
                    ("tokenizer_create", p, [ctypes.c_char_p, i32]),
                    ("tokenizer_free", None, [p]),
                    ("tokenizer_encode", i32, [p, ctypes.c_char_p, i32, pi32, i32]),
                    ("transpose_f32", None, [p, p, i64, i64, i64, i32]),
                    ("transpose_i8", None, [p, p, i64, i64, i64, i32]),
                    ("pages_create", p, [i32, i32, i32]),
                    ("pages_free", None, [p]),
                    ("pages_available", i32, [p]),
                    ("pages_reserve", i32, [p, i32, i32]),
                    ("pages_release", None, [p, i32]),
                    ("pages_table", i32, [p, i32, pi32, i32])):
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = args
            build._libs[NAME] = lib
            build.counts["loads"] += 1
        return build._libs[NAME]


class NativeTokenizer:
    """Heap-based BPE encoder with the reference's merge semantics."""

    def __init__(self, path: str | Path, vocab_size: int):
        self._lib = load()
        self._h = self._lib.tokenizer_create(str(path).encode(), vocab_size)
        if not self._h:
            raise IOError(f"failed to parse tokenizer file {path}")

    def encode(self, s: str, strict: bool = True) -> list[int]:
        """Ids of `s`; strict: KeyError on a character not in the
        vocabulary, else such characters are skipped."""
        data = s.encode("utf-8")
        # at most one id a character, so the count (which the C entry returns
        # whole even past its capacity) fits
        cap = max(16, len(data) + 8)
        buf = (ctypes.c_int32 * cap)()
        n = self._lib.tokenizer_encode(self._h, data, int(strict), buf, cap)
        if n < 0:
            raise KeyError("character not in vocabulary")
        return buf[:n]

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tokenizer_free(self._h)
            self._h = None


def transpose_batched(src: np.ndarray, n_threads: int | None = None) -> np.ndarray:
    """(L, R, C) or (R, C) -> contiguous (.., C, R): float32 and int8 by the
    threaded C++ blocked transpose (min(cpu_count, 8) threads by default),
    other dtypes by numpy."""
    if src.ndim not in (2, 3):
        raise ValueError(f"transpose_batched takes a 2-D or 3-D array, not {src.shape}")
    a = src[None] if src.ndim == 2 else src
    if a.dtype not in (np.float32, np.int8):
        out = np.ascontiguousarray(a.transpose(0, 2, 1))
    else:
        lib = load()
        fn = lib.transpose_f32 if a.dtype == np.float32 else lib.transpose_i8
        a = np.ascontiguousarray(a)
        l, r, c = a.shape
        out = np.empty((l, c, r), dtype=a.dtype)
        fn(a.ctypes.data, out.ctypes.data, l, r, c, n_threads or min(os.cpu_count() or 1, 8))
    return out[0] if src.ndim == 2 else out
