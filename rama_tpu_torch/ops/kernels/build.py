"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled on first use by its own `nvcc` process — all
of them started together — into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -split-compile=4
         -o build/rama_tpu_torch/<name>-<hash>.so

(route (b) of building a hand-written kernel: no PyTorch headers, seconds
per file; `-split-compile=4` runs a file's optimisation passes on up to
four threads, which about halves the build of `ffn.cu` and
`quant_matmul.cu`, the files that instantiate every body for both weight
scale types). The libraries land in the build directory, by default
`build/rama_tpu_torch/` under the checkout (listed in .gitignore;
`set_build_dir` names another: EngineConfig.compile_cache), named by a
hash of the sources and flags, so an edited kernel is rebuilt and an
unchanged one is reused from any process. They are loaded with ctypes;
pointers and the stream pass as `c_void_p`, every C entry returns
`cudaGetLastError()` and `check` raises on a non-zero code. `load_all`
builds and loads every library at once (Engine.warmup), the native host
library of rama_tpu_torch/native.py too, and `counts` keeps the compiler
runs (nvcc, and the host compiler's for the native library) and library
loads of the process.

There is no fallback: a missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "rama_tpu_torch"
BUILD_DIR = DEFAULT_BUILD_DIR   # where libraries are built and loaded from (set_build_dir)
SOURCES = ("quant_matmul", "ffn", "decode_attention", "prefill_attention", "kv_write",
           "attn_block")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-split-compile=4")

# dtype codes of csrc/common.cuh (rama::DType): activations and caches, and
# the quantized weights' stored scales
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # name -> nvcc output (-Xptxas -v report)
counts = {"builds": 0, "loads": 0}  # compiler runs and libraries loaded by this process


def set_build_dir(path) -> Path:
    """Build into and load from `path` from now on (EngineConfig.
    compile_cache). A process never mixes libraries of two directories:
    naming another directory once a library (a kernel's, or the native host
    library of rama_tpu_torch/native.py) is loaded raises."""
    global BUILD_DIR
    path = Path(path).expanduser().resolve()
    with _lock:
        if path != BUILD_DIR and _libs:
            raise RuntimeError(f"libraries are already loaded from {BUILD_DIR}; "
                               f"this process cannot load them from {path}")
        BUILD_DIR = path
    return path


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): "
                           "the port's CUDA kernels cannot be built here")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing, one nvcc each, all
    in parallel. Returns {name: nvcc output} (kept beside each library, so
    a library built by an earlier process still has its report); raises if
    any build fails."""
    with _lock:
        todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).exists()}
        for name in SOURCES:
            log = _lib_path(name).with_suffix(".log")
            if name not in todo and name not in build_logs and log.exists():
                build_logs[name] = log.read_text()
        if not todo:
            return dict(build_logs)
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, out in todo.items():
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out)
            counts["builds"] += 1
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
            else:
                out.with_suffix(".log").write_text(log)
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return dict(build_logs)


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use, with the
    argtypes of each C entry in `signatures` declared (every entry returns
    an int error code)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all()
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.rama_error_string.argtypes = [ctypes.c_int]
            lib.rama_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
            counts["loads"] += 1
        return _libs[name]


def load_all() -> None:
    """Build every missing library, then load each one with its C entries
    declared, and the native host library (rama_tpu_torch.native): after
    this no kernel call of the process runs nvcc or loads a library
    (Engine.warmup)."""
    import importlib

    from rama_tpu_torch import native

    native.load()
    for name in SOURCES:
        library(name, importlib.import_module(f"rama_tpu_torch.ops.kernels.{name}")._SIGNATURES)


_tickets: dict[torch.device, torch.Tensor] = {}


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """Zeroed uint32 counters for the split-K kernels' last-CTA reduction.
    Each kernel leaves the counters it used at zero again, so one buffer per
    device serves every launch on the stream."""
    with _lock:
        buf = _tickets.get(device)
        if buf is None or buf.numel() < n:
            buf = torch.zeros(max(4096, n), dtype=torch.int32, device=device)
            _tickets[device] = buf
        return buf


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.rama_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16 tensors, not {t.dtype}")
    return DTYPE_CODES[t.dtype]


def require(cond: bool, msg: str) -> None:
    """Argument check of a kernel wrapper (raises ValueError; never skipped
    under python -O, unlike assert)."""
    if not cond:
        raise ValueError(msg)


P = ctypes.c_void_p
I = ctypes.c_int
