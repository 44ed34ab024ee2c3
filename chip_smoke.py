#!/usr/bin/env python3
"""Drive the rama_tpu_torch port on one NVIDIA H100 and check it.

    python3 chip_smoke.py                 # every phase (the full check)
    python3 chip_smoke.py --phases build,kernels   # a subset while iterating:
                                  # last line {"ok": false, ...}, exit code 4

Phases, in order (any failure raises and the script exits non-zero):
  card     nvidia-smi name / power limit, torch's device name
  build    nvcc builds every csrc/*.cu for sm_90a (in parallel), prints the
           -Xptxas -v register / spill report
  kernels  each kernel against its plain PyTorch version on the card at the
           Llama-2-7B shapes of the serving path and at ragged edges (max
           |err| <= 0.05 of max |ref| within each output row, or each
           (slot, row, head) for attention, after bench.py's gate; the 7B
           attention checks again with planted edge rows); CUDA-event
           times of kernel, plain version and, where one PyTorch call
           computes the same function, that call (library_ms, a yardstick
           the port never calls)
  model    Llama-2-7B int8 params from a seed on the card (untied
           classifier), kernel-path logits against the plain path
  generate generate_text, greedy, a few dozen tokens (non-degenerate)
  serve    the port's server (build_app around an 8-slot Engine, max_len
           1024) on a local port; concurrent /gen requests; TTFT, tok/s,
           /metrics
  profile  torch.profiler over 8-slot decode steps: host ms/step, device
           kernel ms/step by kernel, device busy share
  cli      a small synthetic v2 checkpoint through `python -m
           rama_tpu_torch.cli generate --device cuda`

The launch counters are set to 0 just before `generate` and read after
`serve` (the main path); every kernel must have launched there. The line
before last holds the card's name and power limit, the line before that
the {"kernels": [...]} record, and the last line the {"ok": true, ...}
result, which only a run of every phase prints.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOPS = 989e12           # dense bf16 tensor-core peak
TOL = 0.05                    # max |err| / max |ref| (bench.py:65-72)
ALL_PHASES = ("card", "build", "kernels", "model", "generate", "serve", "profile",
              "cli")
PARTIAL_RC = 4                # exit code of a run that skipped phases


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(torch, name: str, got, want, per: int | None = None) -> float:
    """Fail unless every group of `per` consecutive outputs (default: one
    output row) is within TOL of its own max |ref|: a slot, head or row with
    large outputs sets no limit for another. Returns the max |err|."""
    per = per or want.shape[-1]
    got, want = got.float().reshape(-1, per), want.float().reshape(-1, per)
    if not bool(torch.isfinite(got).all()):
        raise SystemExit(f"FAILED {name}: non-finite kernel output")
    err = (got - want).abs().amax(dim=1)
    rel = err / (want.abs().amax(dim=1) + 1e-6)
    worst = int(rel.argmax())
    log(f"[check] {name}: max_abs_err {float(err.max()):.3e} worst rel "
        f"{float(rel[worst]):.3e} (group {worst} of {rel.numel()} x {per})")
    if float(rel[worst]) > TOL:
        raise SystemExit(f"FAILED {name}: rel err {float(rel[worst]):.4f} > {TOL} "
                         f"in group {worst} of {per} outputs")
    return float(err.max())


def plant_decode_edges(q, k_cache, pos, layer: int, rows) -> None:
    """Give each slot's cache rows at pos, pos + 1 (never visible) and at
    `rows` (the kernel's split edges) a key aligned with the slot's query
    (score ~ 5.7 against ~N(0, 1) elsewhere, rep 1), so that a kernel
    dropping one visible edge row or reading one row past pos moves that
    slot's output by tens of percent of its own max."""
    s = k_cache.shape[3]
    for b, p in enumerate(pos.tolist()):
        for r in {p, p + 1, *rows}:
            if 0 <= r < s:
                k_cache[layer, b, :, r] = q[b] * 0.5


def plant_prefill_edges(v_cache, plens, rows) -> None:
    """Scale the value rows at plen - 1, plen (never visible) and at `rows`
    (the kernel's key-tile edges) by 16, so that a kernel dropping or adding
    one such key moves the outputs of the query rows that see it by tens of
    percent of their own max."""
    s = v_cache.shape[2]
    for b, p in enumerate(plens):
        for r in {p - 1, p, *rows}:
            if 0 <= r < s:
                v_cache[b, :, r] *= 16


class Layered:
    """Cycle the layer index across timed launches, as a decode step does
    (consecutive launches on one layer would read its weights from L2)."""

    def __init__(self, n_layers: int):
        self.n, self.i = n_layers, 0

    def next(self) -> int:
        self.i = (self.i + 1) % self.n
        return self.i


# ---------------------------------------------------------------------------


def seven_b_config(ModelConfig):
    return ModelConfig(dim=4096, hidden_dim=11008, n_layers=32, n_heads=32,
                       n_kv_heads=32, vocab_size=32000, seq_len=1024,
                       shared_classifier=False)


def random_int8_params(torch, cfg, device, seed: int = 0, gs: int = 64):
    """Llama-2-7B int8 params from a seed, generated on the card, in the fused
    layout (wqkv, il-interleaved w13), with an UNTIED classifier (a tied one
    gives logits a self-match term that locks greedy decode onto one token).
    Scales are sized so int8 weights act like ~N(0, 1/K) entries."""
    from rama_tpu_torch.models.llama import _rope_tables, phase_a_tile
    from rama_tpu_torch.ops.quant import QuantizedEmbedding, QuantizedTensor

    g = torch.Generator(device=device).manual_seed(seed)
    L, D, H, V = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size

    def qt(k, n, il=0):
        q = torch.randint(-127, 128, (L, k, n), dtype=torch.int8, device=device,
                          generator=g)
        s = torch.rand((L, k // gs, n), device=device, generator=g) + 0.5
        return QuantizedTensor(q=q, scales=s / (73.0 * math.sqrt(k)), group_size=gs,
                               bits=8, il=il)

    emb_s = torch.full((V, D // gs), 1.0 / (73.0 * math.sqrt(D)), device=device)
    emb = QuantizedEmbedding(q=torch.randint(-127, 128, (V, D), dtype=torch.int8,
                                             device=device, generator=g),
                             scales=emb_s, group_size=gs)
    cls = QuantizedEmbedding(q=torch.randint(-127, 128, (V, D), dtype=torch.int8,
                                             device=device, generator=g),
                             scales=emb_s.clone(), group_size=gs)
    bf = torch.bfloat16
    p = {
        "tok_embedding": emb,
        "attn_norm": torch.ones((L, D), dtype=bf, device=device),
        "ffn_norm": torch.ones((L, D), dtype=bf, device=device),
        "final_norm": torch.ones((D,), dtype=bf, device=device),
        "wqkv": qt(D, (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim),
        "w13": qt(D, 2 * H, il=phase_a_tile(H, gs) or 0),
        "wo": qt(D, D),
        "w2": qt(H, D),
        "wcls": cls.as_classifier(),
    }
    p["rope_cos"], p["rope_sin"] = _rope_tables(cfg, device)
    return p


# ---------------------------------------------------------------------------


def phase_build() -> None:
    from rama_tpu_torch.ops.kernels import build

    t0 = time.time()
    logs = build.build_all()
    log(f"[build] {len(build.SOURCES)} kernels built with nvcc "
        f"{' '.join(build.NVCC_FLAGS)} in {time.time() - t0:.1f} s")
    for name in build.SOURCES:
        # ptxas -v: one 'Compiling entry function' line and one 'Used N
        # registers' line per instantiated kernel
        lines = [ln.strip() for ln in logs.get(name, "").splitlines()
                 if "Used" in ln or "spill" in ln]
        log(f"[ptxas] {name}.cu: {len(lines)} lines")
        for ln in lines:
            if "Used" in ln or ("spill" in ln and not ln.startswith("0 bytes")):
                log(f"[ptxas]   {ln}")


def phase_kernels(torch, results: dict) -> None:
    """Each kernel vs its plain version at 7B shapes and ragged edges."""
    import torch.nn.functional as F

    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models.llama import phase_a_tile
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import ffn as ffn_mod
    from rama_tpu_torch.ops.kernels import prefill_attention as pa
    from rama_tpu_torch.ops.kernels import quant_matmul as qm
    from rama_tpu_torch.ops.quant import QuantizedTensor, quantize_int8

    dev = torch.device("cuda")
    cfg = seven_b_config(ModelConfig)
    g = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    L, D, H, gs = cfg.n_layers, cfg.dim, cfg.hidden_dim, 64

    def rq(l, k, n, il=0):
        q = torch.randint(-127, 128, (l, k, n), dtype=torch.int8, device=dev, generator=g)
        s = (torch.rand((l, k // gs, n), device=dev, generator=g) + 0.5) / (73 * math.sqrt(k))
        return QuantizedTensor(q=q, scales=s, group_size=gs, bits=8, il=il)

    def rx(*shape, dtype=bf):
        return torch.randn(shape, device=dev, generator=g).to(dtype)

    # -- kernel 1: quant_matmul ------------------------------------------------
    wqkv = rq(L, D, 3 * D)
    wcls = rq(1, D, cfg.vocab_size)
    wcls2 = QuantizedTensor(q=wcls.q[0].contiguous(), scales=wcls.scales[0].contiguous(),
                       group_size=gs)
    for m in (1, 8, 128):
        x = rx(m, D)
        for l in (0, L - 1):
            compare(torch, f"quant_matmul wqkv M={m} layer={l}",
                    qm.quant_matmul(x, wqkv, l),
                    qm.quant_matmul_plain(x, wqkv, l))
    x8 = rx(8, D)
    compare(torch, "quant_matmul lm_head M=8 (2-D)",
            qm.quant_matmul(x8, wcls2), qm.quant_matmul_plain(x8, wcls2))
    # ragged: N not a multiple of 16, K of 9 groups of 32, odd M, fp32
    small = quantize_int8(torch.randn(2, 288, 1000, generator=torch.Generator().manual_seed(2)), 32)
    small = QuantizedTensor(q=small.q.to(dev), scales=small.scales.to(dev), group_size=32)
    for m, dt in ((3, bf), (40, bf), (5, torch.float32)):
        xs = rx(m, 288, dtype=dt)
        compare(torch, f"quant_matmul ragged K=288 N=1000 M={m} {dt}",
                qm.quant_matmul(xs, small, 1),
                qm.quant_matmul_plain(xs, small, 1))
    err = compare(torch, "quant_matmul timed inputs (x8, wqkv layer 0)",
                  qm.quant_matmul(x8, wqkv, 0), qm.quant_matmul_plain(x8, wqkv, 0))
    lay = Layered(L)
    t_k = time_ms(torch, lambda: qm.quant_matmul(x8, wqkv, lay.next()))
    t_p = time_ms(torch, lambda: qm.quant_matmul_plain(x8, wqkv, lay.next()), reps=5)
    nb = D * 3 * D + (D // gs) * 3 * D * 4 + 8 * D * 2 + 8 * 3 * D * 2
    b_ms, b_by = bound_ms(nb, 2 * 8 * D * 3 * D)
    results["quant_matmul"] = dict(
        name="quant_matmul", route="cuda", source="rama_tpu_torch/csrc/quant_matmul.cu",
        replaces="rama_tpu/ops/pallas/quant_matmul.py:265", max_abs_err=err,
        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape="x (8, 4096) bf16 @ wqkv[l] (4096, 12288) int8 gs 64")
    for label, (xx, w, l, n) in {
        "wo M=8": (x8, rq(L, D, D), 0, D),
        "lm_head M=8": (x8, wcls2, None, cfg.vocab_size),
        "wqkv M=1": (rx(1, D), wqkv, 0, 3 * D),
        "wqkv M=256 (prefill, tiled)": (rx(256, D), wqkv, 0, 3 * D),
    }.items():
        lay2 = Layered(L)
        fn = ((lambda xx=xx, w=w: qm.quant_matmul(xx, w)) if l is None else
              (lambda xx=xx, w=w: qm.quant_matmul(xx, w, lay2.next())))
        t = time_ms(torch, fn)
        m = xx.shape[0]
        b, by = bound_ms(D * n * 1.0625 + m * (D + n) * 2, 2 * m * D * n)
        log(f"[time] quant_matmul {label}: {t:.4f} ms (bound {b:.4f} ms, {by})")

    # -- kernel 2: ffn ---------------------------------------------------------
    il = phase_a_tile(H, gs) or 0
    w13, w2 = rq(L, D, 2 * H, il=il), rq(L, H, D)
    for m in (1, 8):
        x = rx(m, D)
        for l in (0, L - 1):
            compare(torch, f"ffn il={il} M={m} layer={l}",
                    ffn_mod.ffn(x, w13, w2, l),
                    ffn_mod.ffn_plain(x, w13, w2, l))
    # plain [W1 | W3] layout and a ragged hidden dim (tiny's 176)
    w13p = QuantizedTensor(q=w13.q[:2], scales=w13.scales[:2], group_size=gs, il=0)
    w2p = QuantizedTensor(q=w2.q[:2], scales=w2.scales[:2], group_size=gs)
    compare(torch, "ffn plain layout M=8", ffn_mod.ffn(x8, w13p, w2p, 1),
            ffn_mod.ffn_plain(x8, w13p, w2p, 1))
    tg = torch.Generator().manual_seed(3)
    t13 = quantize_int8(torch.randn(1, 64, 352, generator=tg), 16)
    t2 = quantize_int8(torch.randn(1, 176, 64, generator=tg), 16)
    t13, t2 = t13.to(dev), t2.to(dev)
    xt = rx(3, 64)
    compare(torch, "ffn tiny H=176 M=3", ffn_mod.ffn(xt, t13, t2, 0),
            ffn_mod.ffn_plain(xt, t13, t2, 0))
    err = compare(torch, "ffn timed inputs (x8, layer 0)", ffn_mod.ffn(x8, w13, w2, 0),
                  ffn_mod.ffn_plain(x8, w13, w2, 0))
    lay = Layered(L)
    t_k = time_ms(torch, lambda: ffn_mod.ffn(x8, w13, w2, lay.next()))
    t_p = time_ms(torch, lambda: ffn_mod.ffn_plain(x8, w13, w2, lay.next()), reps=5)
    nb = (D * 2 * H + H * D) * (1 + 4 / gs) + 8 * D * 2 * 2
    b_ms, b_by = bound_ms(nb, 2 * 8 * (D * 2 * H + H * D))
    results["ffn"] = dict(
        name="ffn", route="cuda", source="rama_tpu_torch/csrc/ffn.cu",
        replaces="rama_tpu/ops/pallas/ffn.py:252", max_abs_err=err, ms=t_k,
        plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"x (8, 4096) bf16, w13[l] (4096, 22016) il={il}, w2[l] (11008, 4096)")
    x1 = rx(1, D)
    t1 = time_ms(torch, lambda: ffn_mod.ffn(x1, w13, w2, lay.next()))
    log(f"[time] ffn M=1: {t1:.4f} ms")
    del w13, w2, w13p, w2p

    # -- kernel 3: decode attention --------------------------------------------
    B, nkv, hd, S = 8, cfg.n_kv_heads, cfg.head_dim, cfg.seq_len
    kc = rx(L, B, nkv, S, hd)
    vc = rx(L, B, nkv, S, hd)
    q = rx(B, cfg.n_heads, hd)
    pos = torch.tensor([0, 255, 256, 1023, 63, 64, 511, 700], dtype=torch.int32,
                       device=dev)
    splits = (63, 64, 255, 256, 511, 512, 767, 768, 1023)   # 64-row split edges
    for planted in (False, True):
        for l in (0, L - 1):
            if planted:
                plant_decode_edges(q, kc, pos, l, splits)
            compare(torch, f"decode_attention B=8 S=1024 layer={l} pos={pos.tolist()}"
                    f"{' planted edges' if planted else ''}",
                    da.decode_attention(q, kc, vc, pos, l),
                    da.decode_attention_plain(q, kc, vc, pos, l), per=hd)
    # GQA (rep 2) with hd 48 and hd 16, fp32 and bf16
    for hd_s, dt in ((48, bf), (16, torch.float32)):
        kq = rx(2, 3, 2, 80, hd_s, dtype=dt)
        vq = rx(2, 3, 2, 80, hd_s, dtype=dt)
        qq = rx(3, 4, hd_s, dtype=dt)
        pq = torch.tensor([0, 64, 79], dtype=torch.int32, device=dev)
        compare(torch, f"decode_attention GQA rep=2 hd={hd_s} {dt}",
                da.decode_attention(qq, kq, vq, pq, 1),
                da.decode_attention_plain(qq, kq, vq, pq, 1), per=hd_s)
    err = compare(torch, "decode_attention timed inputs (layer 0)",
                  da.decode_attention(q, kc, vc, pos, 0),
                  da.decode_attention_plain(q, kc, vc, pos, 0), per=hd)
    lay = Layered(L)
    t_k = time_ms(torch, lambda: da.decode_attention(q, kc, vc, pos, lay.next()))
    t_p = time_ms(torch, lambda: da.decode_attention_plain(q, kc, vc, pos, lay.next()))
    vis = (torch.arange(S, device=dev)[None, :] <= pos[:, None].long())[:, None, None, :]

    def sdpa_decode():
        l = lay.next()
        return F.scaled_dot_product_attention(q[:, :, None, :], kc[l], vc[l],
                                              attn_mask=vis)

    t_lib = time_ms(torch, sdpa_decode)
    rows = int((pos.clamp(0, S - 1) + 1).sum())
    nb = rows * nkv * hd * 2 * 2 + 2 * q.numel() * 2
    b_ms, b_by = bound_ms(nb, rows * cfg.n_heads * hd * 4)
    results["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="rama_tpu_torch/csrc/decode_attention.cu",
        replaces="rama_tpu/ops/pallas/decode_attention.py:262", max_abs_err=err,
        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_lib,
        shape=f"q (8, 32, 128) bf16, cache (32, 8, 32, 1024, 128), pos {pos.tolist()}")
    del kc, vc

    # -- kernel 4: prefill attention ---------------------------------------------
    tiles = (31, 32, 63, 64, 127, 128, 255, 256, 287, 288, 511)   # key-tile edges
    long_prompt = (8, 512, 512, [512, 300, 450, 129, 256, 511, 77, 384])
    cases = ((8, 16, 16, [16, 5, 1, 9, 16, 2, 3, 12]),    # serving bucket, plen < T
             (2, 128, 128, [128, 77]),
             (1, 512, 1024, [300]),
             long_prompt)
    for b, t, s, plens in cases:
        qp = rx(b, t, cfg.n_heads, hd)
        kp, vp = rx(b, nkv, s, hd), rx(b, nkv, s, hd)
        pl = torch.tensor(plens, dtype=torch.int32, device=dev)
        for planted in (False, True):
            if planted:
                plant_prefill_edges(vp, plens, tiles)
            compare(torch, f"prefill_attention B={b} T={t} S={s} plen={plens}"
                    f"{' planted edges' if planted else ''}",
                    pa.prefill_attention(qp, kp, vp, pl),
                    pa.prefill_attention_plain(qp, kp, vp, pl), per=hd)
    f32 = torch.float32
    qg, kg, vg = rx(2, 24, 4, 48, dtype=f32), rx(2, 2, 32, 48, dtype=f32), rx(2, 2, 32, 48, dtype=f32)
    plg = torch.tensor([24, 7], dtype=torch.int32, device=dev)
    compare(torch, "prefill_attention GQA rep=2 hd=48 f32",
            pa.prefill_attention(qg, kg, vg, plg),
            pa.prefill_attention_plain(qg, kg, vg, plg), per=48)

    def time_prefill(b, t, plens) -> dict:
        """Check, then time kernel, plain version and SDPA at one shape."""
        qp = rx(b, t, cfg.n_heads, hd)
        kp, vp = rx(b, nkv, t, hd), rx(b, nkv, t, hd)
        pl = torch.tensor(plens, dtype=torch.int32, device=dev)
        err = compare(torch, f"prefill_attention timed inputs B={b} T={t}",
                      pa.prefill_attention(qp, kp, vp, pl),
                      pa.prefill_attention_plain(qp, kp, vp, pl), per=hd)
        t_k = time_ms(torch, lambda: pa.prefill_attention(qp, kp, vp, pl))
        t_p = time_ms(torch, lambda: pa.prefill_attention_plain(qp, kp, vp, pl))
        tpos = torch.arange(t, device=dev)
        mask = ((tpos[None, None, :] <= tpos[None, :, None])
                & (tpos[None, None, :] < pl[:, None, None].long()))[:, None]
        t_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qp.transpose(1, 2), kp, vp, attn_mask=mask))
        # a query row >= plen attends to all plen keys, as in the Pallas kernel
        pairs = sum(sum(min(i + 1, p) for i in range(t)) for p in plens)
        nb = 2 * qp.numel() * 2 + sum(plens) * nkv * hd * 2 * 2
        b_ms, b_by = bound_ms(nb, pairs * cfg.n_heads * hd * 4)
        return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                    library_ms=t_lib, shape=f"q ({b}, {t}, 32, 128) bf16, k/v ({b}, 32, "
                    f"{t}, 128), plen {plens}")

    results["prefill_attention"] = dict(
        name="prefill_attention", route="cuda",
        source="rama_tpu_torch/csrc/prefill_attention.cu",
        replaces="rama_tpu/ops/pallas/prefill_attention.py:107",
        **time_prefill(*cases[0][:2], cases[0][3]))
    b, t, _, plens = long_prompt
    results["prefill_attention"]["long_prompt"] = time_prefill(b, t, plens)
    for r in [*results.values(), results["prefill_attention"]["long_prompt"]]:
        log(f"[kernel] {r.get('name', 'prefill_attention long prompt')}: {r['ms']:.4f} "
            f"ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}")


def phase_model(torch, cfg, params) -> None:
    """Kernel-path logits vs the plain path on a prompt prefill + 2 steps."""
    from rama_tpu_torch.models.llama import KVCache, decode_step, prefill

    dev = torch.device("cuda")
    toks = torch.tensor([[1, 9038, 2501, 263, 931, 29892, 727, 471]], device=dev)
    caches = [KVCache.create(cfg, 1, 64, device=dev) for _ in range(2)]
    with torch.no_grad():
        lk, _ = prefill(params, cfg, toks, caches[0], last_only=True)
        lp, _ = prefill(params, cfg, toks, caches[1], last_only=True, plain=True)
        compare(torch, "7B logits prefill (kernels vs plain)", lk[:, -1], lp[:, -1])
        tok = torch.argmax(lp[:, -1], dim=-1)
        for i in range(2):
            pos = torch.tensor([toks.shape[1] + i], device=dev)
            lk, _ = decode_step(params, cfg, tok, pos, caches[0])
            lp, _ = decode_step(params, cfg, tok, pos, caches[1], plain=True)
            compare(torch, f"7B logits decode step {i} (kernels vs plain)", lk, lp)
            tok = torch.argmax(lp, dim=-1)


def phase_generate(torch, cfg, params, tokenizer) -> None:
    from rama_tpu_torch.runtime.generate import generate_text

    torch.cuda.synchronize()
    t0 = time.time()
    text, ids = generate_text(params, cfg, tokenizer, "Once upon a time", steps=48,
                              temperature=0.0)
    dt = time.time() - t0
    gen = ids[len(tokenizer.encode("Once upon a time")):]
    log(f"[generate] {len(ids)} ids in {dt:.2f} s; generated {gen[:16]}...")
    if len(set(gen)) < 2:
        raise SystemExit(f"FAILED generate: degenerate trajectory {gen}")


def phase_serve(torch, cfg, params, tokenizer, card: str) -> None:
    import aiohttp
    from aiohttp import web

    from rama_tpu_torch.config import EngineConfig
    from rama_tpu_torch.runtime.engine import Engine
    from rama_tpu_torch.server.app import build_app

    engine = Engine(cfg, params, tokenizer,
                    EngineConfig(max_batch_size=8, max_seq_len=1024, decode_tick=8))
    engine.start()
    prompts = ["Once upon a time", "The little dog", "In a far away land",
               "She opened the door", "Tom and Lily", "The sun was", "A big red ball",
               "One day"]
    steps = 32

    async def one(session, url, prompt, temp):
        t0 = time.perf_counter()
        ttft, n, ended = None, 0, False
        async with session.get(url, params={"prompt": prompt, "steps": str(steps),
                                            "temperature": str(temp)}) as resp:
            if resp.status != 200:
                raise SystemExit(f"FAILED serve: /gen status {resp.status}")
            async for raw in resp.content:
                line = raw.decode().rstrip("\n")
                if line.startswith("data: "):
                    n += 1
                    if ttft is None:
                        ttft = time.perf_counter() - t0
                elif line.startswith("event: error"):
                    raise SystemExit(f"FAILED serve: error event for {prompt!r}")
            ended = True
        return ttft, n, ended

    async def run():
        app = build_app(engine, default_steps=steps)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        base = f"http://127.0.0.1:{port}"
        try:
            async with aiohttp.ClientSession() as session:
                t0 = time.perf_counter()
                outs = await asyncio.wait_for(asyncio.gather(*[
                    one(session, base + "/gen", p, 0.0 if i % 2 == 0 else 0.8)
                    for i, p in enumerate(prompts)]), timeout=600)
                wall = time.perf_counter() - t0
                async with session.get(base + "/metrics") as resp:
                    stats = await resp.json()
        finally:
            await runner.cleanup()
        return outs, wall, stats

    try:
        outs, wall, stats = asyncio.run(run())
    finally:
        engine.stop()
    total = sum(n for _, n, _ in outs)
    if not all(ended and n > 0 for _, n, ended in outs):
        raise SystemExit(f"FAILED serve: a stream did not finish {outs}")
    if stats["tokens_generated"] < total or stats["engine_errors"]:
        raise SystemExit(f"FAILED serve: /metrics {stats} vs {total} streamed")
    ttfts = sorted(t for t, _, _ in outs)
    log(f"[serve] {len(outs)} concurrent /gen, {total} tokens in {wall:.3f} s: "
        f"{total / wall:.2f} tok/s aggregate; TTFT p50 {ttfts[len(ttfts) // 2] * 1e3:.1f} "
        f"ms max {ttfts[-1] * 1e3:.1f} ms; decode_tok_per_s "
        f"{stats['decode_tok_per_s']:.2f} ({card})")
    log(f"[serve] metrics phases {json.dumps(stats['phases'])}")


def phase_profile(torch, cfg, params) -> None:
    """torch.profiler over 8 decode steps at 8 slots (positions 64..71): host
    wall per step, device kernel time per step by kernel, device busy share."""
    from torch.profiler import ProfilerActivity, profile

    from rama_tpu_torch.models.llama import KVCache, decode_step

    dev = torch.device("cuda")
    cache = KVCache.create(cfg, 8, 128, device=dev)
    tok = torch.arange(8, device=dev) + 100
    with torch.no_grad():
        for i in range(2):  # warm
            decode_step(params, cfg, tok, torch.full((8,), 60 + i, device=dev), cache)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(8):
                logits, _ = decode_step(params, cfg, tok, torch.full((8,), 64 + i, device=dev),
                                        cache)
                tok = torch.argmax(logits, dim=-1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if dt and ev.device_type.name == "CUDA":
            rows.append((dt, ev.key, ev.count))
    busy_us = sum(r[0] for r in rows)
    log(f"[profile] 8 slots x 8 decode steps: host wall {wall / 8 * 1e3:.3f} ms/step "
        f"(profiler on); device kernel time {busy_us / 8 / 1e3:.3f} ms/step; "
        f"device busy share {busy_us / 1e6 / wall:.3f}")
    for dt, key, count in sorted(rows, reverse=True)[:12]:
        log(f"[profile]   {dt / 8 / 1e3:.4f} ms/step  x{count // 8:<4d} {key[:90]}")
    if not rows:
        log("[profile] the profiler recorded no device time")


def phase_cli(torch) -> None:
    from rama_tpu_torch.checkpoint import save_v2
    from rama_tpu_torch.config import ModelConfig

    cfg = ModelConfig(dim=288, hidden_dim=768, n_layers=2, n_heads=6, n_kv_heads=6,
                      vocab_size=32000, seq_len=64)
    rng = np.random.default_rng(5)
    L, D, H, V = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    p = {"tok_embedding": w(V, D), "attn_norm": np.ones((L, D), np.float32),
         "wq": w(L, D, D), "wk": w(L, D, D), "wv": w(L, D, D), "wo": w(L, D, D),
         "ffn_norm": np.ones((L, D), np.float32), "w1": w(L, D, H), "w2": w(L, H, D),
         "w3": w(L, D, H), "final_norm": np.ones(D, np.float32)}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "synthetic_v2.bin")
        save_v2(path, cfg, p, group_size=64)
        cmd = [sys.executable, "-m", "rama_tpu_torch.cli", "generate", "-m", path,
               "-t", str(ROOT / "tests" / "fixtures" / "tokenizer.bin"), "-p",
               "Once upon a time", "-s", "32", "-r", "0", "--device", "cuda"]
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT)
    log(f"[cli] rc {out.returncode}; stderr tail: {out.stderr.strip()[-300:]}")
    if out.returncode != 0:
        raise SystemExit(f"FAILED cli: {out.stderr[-2000:]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    phases = ap.parse_args().phases.split(",")
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; the phases are {','.join(ALL_PHASES)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import ffn as ffn_mod
    from rama_tpu_torch.ops.kernels import prefill_attention as pa
    from rama_tpu_torch.ops.kernels import quant_matmul as qm
    from rama_tpu_torch.tokenizer import Tokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    card = nvidia_smi_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}: "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    if "build" in phases:
        phase_build()
    results: dict = {}
    if "kernels" in phases:
        phase_kernels(torch, results)
        torch.cuda.empty_cache()
    modules = {"quant_matmul": qm, "ffn": ffn_mod, "decode_attention": da,
               "prefill_attention": pa}
    main_path = {"generate", "serve"} <= set(phases)
    if {"model", "generate", "serve", "profile"} & set(phases):
        cfg = seven_b_config(ModelConfig)
        t0 = time.time()
        params = random_int8_params(torch, cfg, torch.device("cuda"))
        torch.cuda.synchronize()
        log(f"[model] Llama-2-7B int8 params on the card in {time.time() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        tokenizer = Tokenizer.from_file(ROOT / "tests" / "fixtures" / "tokenizer.bin",
                                        cfg.vocab_size)
        if "model" in phases:
            phase_model(torch, cfg, params)
        for mod in modules.values():
            mod.launches = 0
        if "generate" in phases:
            phase_generate(torch, cfg, params, tokenizer)
        if "serve" in phases:
            phase_serve(torch, cfg, params, tokenizer, card)
        launches = {name: mod.launches for name, mod in modules.items()}
        log(f"[launches] main path: {launches}")
        if main_path and min(launches.values()) == 0:
            raise SystemExit(f"FAILED: a kernel never launched on the main path {launches}")
        for name, r in results.items():
            r["launches"] = launches[name]
        if "profile" in phases:
            phase_profile(torch, cfg, params)
        del params
        torch.cuda.empty_cache()
    if "cli" in phases:
        phase_cli(torch)
    log(f"[done] {time.time() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "long_prompt")
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys} for r in results.values()]}))
    print(nvidia_smi_line())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    skipped = [ph for ph in ALL_PHASES if ph not in phases]
    if skipped:
        # not every kernel was checked and launched: no "ok" for a subset
        print(json.dumps({"ok": False, "skipped_phases": skipped, "device": device}))
        return PARTIAL_RC
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
