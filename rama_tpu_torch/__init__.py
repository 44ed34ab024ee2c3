"""rama_tpu_torch — the PyTorch/CUDA port of rama_tpu for one NVIDIA H100.

The JAX package `rama_tpu` stays the reference. This package imports torch
and never JAX, nor any module of `rama_tpu`; the Pallas kernels of its
main path are hand-written Hopper kernels under `csrc/`, built on first use
by `ops/kernels/build.py`. Entry points run on `cuda` unless the caller
passes `--device cpu` / `device="cpu"`.
"""
