"""The port stands alone: importing every rama_tpu_torch module loads
neither JAX nor any module of rama_tpu, and without nvcc / a GPU the
kernel path raises instead of falling back."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "rama_tpu_torch"


def _modules():
    return sorted("rama_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
                  .removesuffix(".__init__").removesuffix("__init__")
                  for p in PORT.rglob("*.py"))


def test_import_loads_no_jax_and_no_rama_tpu():
    mods = [m.rstrip(".") for m in _modules()]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
            " or k == 'rama_tpu' or k.startswith('rama_tpu.'))\n"
            "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                               ROOT / "chip_ab.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_nothing_of_jax_or_rama_tpu(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "rama_tpu"), f"{path}: imports {n}"


@pytest.mark.parametrize("module", ["rama_tpu_torch.native", "rama_tpu_torch.export",
                                    "rama_tpu_torch.tokenizer"])
def test_host_modules_load_no_jax_and_no_transformers(module):
    """The native library's bindings, the export module and the tokenizer
    load neither JAX, nor rama_tpu, nor transformers (imported only by the
    two HuggingFace functions); the tokenizer module not even torch (the
    plain encoder's process in chip_smoke.py imports it alone)."""
    code = ("import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "print(repr(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'rama_tpu', 'transformers', 'torch'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = {k.split(".")[0] for k in ast.literal_eval(out.stdout)}
    assert loaded <= ({"torch"} if module != "rama_tpu_torch.tokenizer" else set())


def test_native_build_raises_without_a_compiler(monkeypatch, tmp_path):
    """Without the host C++ compiler the native library's build raises:
    nothing falls back to the Python encoder or transpose."""
    from rama_tpu_torch import native
    from rama_tpu_torch.ops.kernels import build
    from rama_tpu_torch.tokenizer import Tokenizer

    monkeypatch.setenv("CXX", "/nonexistent/c++")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    fixture = ROOT / "tests" / "fixtures" / "tokenizer.bin"
    for call in (native.load, lambda: Tokenizer.from_file(fixture, 32000).encode("hello"),
                 lambda: native.transpose_batched(np.zeros((2, 3), np.float32))):
        with pytest.raises(RuntimeError, match="compiler"):
            call()


def test_kernel_build_raises_without_nvcc(monkeypatch):
    """Without nvcc the build raises; nothing falls back to the plain path."""
    from rama_tpu_torch.ops.kernels import build

    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "BUILD_DIR", pathlib.Path("/nonexistent/build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library("quant_matmul", {})


def test_resolve_device_refuses_missing_gpu():
    from rama_tpu_torch.utils.platform import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            resolve_device("cuda")


def test_wrappers_refuse_other_devices():
    from rama_tpu_torch.ops.kernels.decode_attention import decode_attention

    q = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(q, q, q, q, 0)
