"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled on first use by its own `nvcc` process — all
of them started together — into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/rama_tpu_torch/<name>-<hash>.so

(route (b) of building a hand-written kernel: no PyTorch headers, seconds
per file). The libraries land in `build/rama_tpu_torch/` under the checkout
(listed in .gitignore), named by a hash of the sources and flags, so an
edited kernel is rebuilt and an unchanged one is reused. They are loaded
with ctypes; pointers and the stream pass as `c_void_p`, every C entry
returns `cudaGetLastError()` and `check` raises on a non-zero code.

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
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "rama_tpu_torch"
SOURCES = ("quant_matmul", "ffn", "decode_attention", "prefill_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# activation dtype codes of csrc/common.cuh (rama::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # name -> nvcc output (-Xptxas -v report)


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
    in parallel. Returns {name: nvcc output}; raises if any build fails."""
    with _lock:
        todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).exists()}
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
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
            else:
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
        return _libs[name]


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
        raise TypeError(f"kernels take float32 or bfloat16 activations, not {t.dtype}")
    return DTYPE_CODES[t.dtype]


def require(cond: bool, msg: str) -> None:
    """Argument check of a kernel wrapper (raises ValueError; never skipped
    under python -O, unlike assert)."""
    if not cond:
        raise ValueError(msg)


P = ctypes.c_void_p
I = ctypes.c_int
