#!/usr/bin/env python3
"""Time the decode attention kernels, the fused attention block and whole
decode steps of a checkout of the port on one card, so that two trees can
be compared back to back, in turns.

    python3 chip_ab.py --root DIR --tag NAME    # the port under DIR/rama_tpu_torch

Prints one JSON line per measure (`{"tag": ..., "measure": ..., ...}`), all
on the Llama-2-7B shapes that chip_smoke.py uses (32 heads = 32 kv heads,
head_dim 128, 8 slots, random data from a seed) unless a measure names
another model:

  - the prefill attention (K5): device ms (torch.profiler) and CUDA-event
    ms a call at chip_smoke.py's 7B shapes (8 x 512 with its ragged plen,
    one 4096-token prompt), at TinyLlama-1.1B's group 8 (32 heads over 4,
    head_dim 64, 8 x 512) and, where the tree takes any whole GQA group,
    at Yi-34B's group 7 (56 heads over 8, 8 x 512); the fp32 SIMT body
    at the 7B 8 x 512 shape, at group 8 (64 heads over 8) and group 7 of
    the same rows; `--k5-only` stops after these;
  - the chunk attention (K10) on a bf16 cache, S 1024, T 4 and 8; on an
    int8 cache, S 1024 and 4096, T 4; the paged chunk (K12) on bf16 and
    int8 pools of 128-row pages, T 4: the split kernel's and the combine's
    device ms (torch.profiler), CUDA-event ms a call, and the T = 1 kernel
    (K4 / K7 / K12 decode) over the same rows beside it;
    scaled_dot_product_attention's CUDA-event and device ms at T 4 / 8;
  - the int8-cache decode step's attention at chip_smoke.py's shapes: K7
    at S 1024 (K4's positions) and S 4096 (long positions), K9 q8 (one
    layer's cache) at the same two, K12 decode on the int8 and the bf16
    pool of 128-row pages (positions on page edges up to 4092): split and
    combine device ms and CUDA-event ms a call;
  - the fused attention block (K14) at S 1024 on K4's positions (32
    layers) and at S 4096 on long positions (4 layers), bf16: the light
    form and the full form with int8 and int4 wo, each one's device ms
    and its device ms by kernel, beside K4 over the same rows (its split
    and combine) and the light form followed by K1's wo (the unfused
    composition of the full form); the same at Yi-34B's group 7 (56 heads
    over 8) and at group 8 (64 over 8), 8 layers at S 1024, and, where
    the tree takes any whole GQA group (attn_block.form_for), at
    Mistral-Large-Instruct-2407's group 12 (96 over 8); `--k14-only`
    runs only these;
  - 8-slot 7B int8 verify rounds of 4 and plain decode steps at pos 64 (a
    128-row bf16 cache) and at pos 2048 (4096-row bf16 and int8 caches),
    and decode steps on an int8 page pool (32 pages of 128 rows a slot) at
    pos 64 and 2048: device ms a round or step, and the attention's part
    of it;
  - `profile_ab`: 8-slot 7B int8 decode steps under RAMA_ATTN_BLOCK 0, 1
    and 2 at pos 64 and 2048 of a 4096-row bf16 cache;
  - the fused FFN (K3 / K3'): device ms (torch.profiler) and CUDA-event ms
    a call at the 7B shapes (int8 gs 64; int4 w13 gs 64, w2 gs 16; il 256;
    8 layers cycled), M = 1 / 8 / 32, and, where the tree takes any M, 64 /
    128 / 256, with the bound beside; `--ffn-only` runs only these;
  - `--write-only`: the int8 row writers K6 / K11 / K13 (a) beside the
    walk that attends to their rows, device ms (CUDA events over a CUDA
    graph of 20 launches, chip_smoke.graph_device_ms) at the serving
    shapes: K7 at S 4096 (the decode step), K10 _q8 at S 4096, T 4, and
    K12 _q8 on an int8 pool of 128-row pages at T 1 and 4: the walk alone,
    the standalone writer then the walk, the writer alone, and, on a tree
    whose walk writes the rows itself (the `k_new` / `v_new` operands of
    that entry), that fused launch; the admission strip writers K13 (b) at
    8 strips of 16 and of 512 rows into 128-row pages and K8 at the same
    strips into the 8-slot dense int8 cache of 4096 rows (each the tree's
    own body); then 8-slot 7B int8 decode steps and verify rounds of 4 on an
    int8 cache (`profile_kv8`'s, `profile_spec`'s) and decode steps on an
    int8 pool (`profile_paged`'s) at pos 64 and 2048: device and host ms a
    step or round (`--write-kernels`: the kernels alone);
  - `--sampler-only`: the engine's keyed sampler (`sample_batched_keyed`,
    temperature 1.0, top-p 0.9: the server's sampled defaults) over the
    logits of an 8-slot decode step (8 x 32000) and of an 8-slot verify
    round of 4 (32 x 32000), peaked (every row's nucleus inside the top
    1024: the capped walk's case) and flat (the full sort's case): device
    ms (torch.profiler) and CUDA-event ms a call;
  - `--sass PARENT.so CHANGE.so --match REGEX`: no card; disassembles
    both libraries with the toolkit's `cuobjdump -sass` and, for each
    kernel whose mangled name matches REGEX in both, prints how many of
    its instructions differ (addresses and encodings left out);
  - `--summary FILE`: no card; reads the JSON lines of runs in turns (a
    file of this script's output) and prints, for each measure and each
    of its times, every tag's runs in the order they ran, their median
    and quartiles, and in how many pairs (the k-th parent run with the
    k-th change run) the change reads lower; the change's fused write
    (`fused_ms`) is also paired with the parent's writer then walk
    (`writer_then_walk_ms`), the launches its path ran before.

It uses only entry points that every slice of the port since the paged
cache has, and chip_smoke.py's helpers from its own directory, so it can
time an older checkout: unpack it (git archive) under a git-ignored
directory and pass it as --root. Compare two trees only on the same
card, back to back, in turns (parent, change, change, parent). Needs a
CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def summarize(path: str, base: str = "parent", other: str = "change",
              against: tuple = (("fused_ms", "writer_then_walk_ms"),)) -> list[str]:
    """The lines `--summary` prints for the JSON lines in `path`: for each
    (measure, key ending in _ms or busy), each tag's runs, median and
    quartiles, then the pairs of `base` and `other` in which `other` reads
    lower (the k-th run of each, as many pairs as the shorter has); for
    each (key of `other`, key of `base`) in `against`, the same pairs
    across the two keys."""
    import statistics as st

    runs: dict[tuple, dict[str, list]] = {}
    for line in Path(path).read_text().splitlines():
        if not line.startswith("{"):
            continue
        r = json.loads(line)
        for k, x in r.items():
            if (k.endswith("_ms") or k == "busy") and isinstance(x, (int, float)):
                runs.setdefault((r["measure"], k), {}).setdefault(r["tag"], []).append(x)
    out = []
    for (measure, k), by in sorted(runs.items()):
        for tag, xs in by.items():
            q = st.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
            out.append(f"{measure} | {k} | {tag}: n {len(xs)}, median {st.median(xs):.5f}, "
                       f"quartiles {q[0]:.5f} / {q[2]:.5f}, runs "
                       + " ".join(f"{x:.5f}" for x in xs))
        pairs = [(k, k)] + [(ko, kb) for ko, kb in against if ko == k]
        for ko, kb in pairs:
            a = runs.get((measure, kb), {}).get(base, [])
            b = runs.get((measure, ko), {}).get(other, [])
            if a and b:
                n = min(len(a), len(b))
                out.append(f"{measure} | {other} {ko} lower than {base} {kb} in "
                           f"{sum(b[i] < a[i] for i in range(n))} of {n} pairs")
    return out


def sass_functions(lib: str) -> dict[str, list[str]]:
    """{mangled kernel name: its SASS instructions} of a library, from
    `cuobjdump -sass`, each instruction without its address and encoding
    comments."""
    import re
    import subprocess

    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", lib], capture_output=True, text=True,
                         check=True, timeout=600).stdout
    funcs: dict[str, list[str]] = {}
    name = None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and (ins := re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)):
            funcs[name].append(ins.group(1))
    return funcs


def sass_diff(old: str, new: str, match: str) -> list[str]:
    """The lines `--sass` prints: each kernel matching `match` in both
    libraries, its instruction counts and how many instructions differ."""
    import difflib
    import re

    a, b = sass_functions(old), sass_functions(new)
    out = []
    for name in sorted(n for n in a if re.search(match, n)):
        if name not in b:
            out.append(f"{name}: only in {old}")
            continue
        sm = difflib.SequenceMatcher(a=a[name], b=b[name], autojunk=False)
        differ = sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in sm.get_opcodes()
                     if tag != "equal")
        out.append(f"{name}: {len(a[name])} / {len(b[name])} instructions, {differ} differ")
    for name in sorted(n for n in b if re.search(match, n) and n not in a):
        out.append(f"{name}: only in {new}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose rama_tpu_torch is timed")
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--k5-only", action="store_true", help="time the prefill attention only")
    ap.add_argument("--ffn-only", action="store_true", help="time the fused FFN (K3) only")
    ap.add_argument("--k14-only", action="store_true",
                    help="time the fused attention block (K14) only")
    ap.add_argument("--write-only", action="store_true",
                    help="time the int8 row writers beside the walk, and int8 rounds / steps")
    ap.add_argument("--write-kernels", action="store_true",
                    help="time the int8 row writers beside the walk only")
    ap.add_argument("--sampler-only", action="store_true",
                    help="time the keyed sampler over a step's and a round's logits only")
    ap.add_argument("--summary", metavar="FILE",
                    help="summarize the JSON lines of runs in turns in FILE (no card)")
    ap.add_argument("--sass", nargs=2, metavar=("PARENT_SO", "CHANGE_SO"),
                    help="count the SASS instructions that differ between two libraries")
    ap.add_argument("--match", default=".", help="--sass: kernels whose name matches")
    args = ap.parse_args()
    if args.summary:
        print("\n".join(summarize(args.summary)))
        return 0
    if args.sass:
        print("\n".join(sass_diff(*args.sass, args.match)))
        return 0
    sys.path.insert(0, str(Path(args.root).resolve()))    # the tree under test
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    # chip_smoke.py's helpers from this directory, whatever --root holds
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch.nn.functional as F

    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models.llama import KVCache, QuantKVCache, _rope_tables
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kvw
    from rama_tpu_torch.ops.kernels import paged_attention as pga

    assert Path(da.__file__).resolve().is_relative_to(Path(args.root).resolve()), da.__file__
    dev = torch.device("cuda")
    cfg = cs.seven_b_config(ModelConfig)
    g = torch.Generator(device=dev).manual_seed(12)
    gc = torch.Generator().manual_seed(12)
    bf = torch.bfloat16
    nh, nkv, hd, B = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 8

    def emit(measure: str, **kw) -> None:
        print(json.dumps({"tag": args.tag, "measure": measure, **kw}), flush=True)

    def rx(*shape, dtype=bf):
        return torch.randn(shape, device=dev, generator=g).to(dtype)

    def attention(measure, fn, one, lib=None) -> None:
        """fn / one: a call on a layer (the chunk, the T = 1 kernel on the
        same rows); lib: the SDPA call, or None."""
        lay = cs.Layered(4)
        rec = dict(ms=cs.time_ms(torch, lambda: fn(lay.next())),
                   chunk=cs.attention_split_combine(torch, lambda: fn(lay.next())),
                   one_query=cs.attention_split_combine(torch, lambda: one(lay.next())))
        one_ms = rec["one_query"]["split_ms"]
        rec["split_over_one_query"] = rec["chunk"]["split_ms"] / one_ms if one_ms else None
        if lib is not None:
            rec["library_ms"] = cs.time_ms(torch, lambda: lib(lay.next()))
            rec["library_device_ms"] = cs.device_ms_per_call(torch, lambda: lib(lay.next()))
        emit(measure, **rec)

    if args.sampler_only:
        from rama_tpu_torch.runtime.sampler import sample_batched_keyed

        for rows, what in ((B, "step"), (B * (cs.SPEC_TICK + 1), "round")):
            keys = torch.randint(0, 1 << 32, (rows, 2), device=dev, generator=g)
            pos = torch.arange(rows, device=dev) + 64
            temps, tps = (torch.full((rows,), v, device=dev) for v in (1.0, 0.9))
            for scale, case in ((8.0, "peaked"), (0.05, "flat")):
                logits = torch.randn(rows, cfg.vocab_size, device=dev, generator=g) * scale

                def draw():
                    return sample_batched_keyed(logits, keys, pos, temps, tps)

                emit(f"sampler {what} {rows} x {cfg.vocab_size} {case}",
                     device_ms=cs.device_ms_per_call(torch, draw),
                     ms=cs.time_ms(torch, draw))
        emit("card", card=cs.nvidia_smi_line(), kind=torch.cuda.get_device_name(0))
        return 0

    # -- K3: the fused FFN ------------------------------------------------------------
    from rama_tpu_torch.ops.kernels import ffn as ffn_mod
    from rama_tpu_torch.ops.quant import QuantizedTensor

    def time_k3() -> None:
        """K3 int8 and int4 at the 7B FFN, 8 layers cycled (1.1 / 0.68 GB:
        past the L2), M = 1 / 8 / 32 on every tree and 64 / 128 / 256 on a
        tree whose K3 takes any M (form_for)."""
        D, H, L = cfg.dim, cfg.hidden_dim, 8
        for bits in (8, 4):
            if bits == 8:
                w13, w2 = (QuantizedTensor(
                    q=torch.randint(-127, 128, (L, k, n), dtype=torch.int8, device=dev,
                                    generator=g),
                    scales=(torch.rand((L, k // 64, n), device=dev, generator=g) + 0.5)
                    / (73 * k ** 0.5), group_size=64, bits=8, il=il)
                    for k, n, il in ((D, 2 * H, 256), (H, D, 0)))
            else:
                w13 = cs.random_int4_qt(torch, L, D, 2 * H, 64, dev, g, il=256)
                w2 = cs.random_int4_qt(torch, L, H, D, 64, dev, g)
            lay = cs.Layered(L)
            for m in (1, 8, 32) + ((64, 128, 256) if hasattr(ffn_mod, "form_for") else ()):
                x = rx(m, D)
                b_ms, b_by = cs.bound_ms(cs.ffn_bytes(w13, w2, m),
                                         2 * m * (D * 2 * H + H * D))
                emit(f"ffn int{bits} M={m}",
                     device_ms=cs.device_ms_per_call(
                         torch, lambda: ffn_mod.ffn(x, w13, w2, lay.next())),
                     ms=cs.time_ms(torch, lambda: ffn_mod.ffn(x, w13, w2, lay.next())),
                     bound_ms=b_ms, bound_by=b_by)
            del w13, w2
            torch.cuda.empty_cache()

    if args.ffn_only:
        time_k3()
        emit("card", card=cs.nvidia_smi_line(), kind=torch.cuda.get_device_name(0))
        return 0

    # -- K11 / K13 (a) beside the walk, and int8 rounds / steps ---------------------------
    def time_writes() -> None:
        import inspect

        from rama_tpu_torch.ops.kernels import paged_attention as pga
        from rama_tpu_torch.runtime.paged import QuantPagedKVCache

        fused = "k_new" in inspect.signature(da.chunk_attention_q8).parameters
        S, T = cs.KV8_MAX_LEN, cs.SPEC_TICK + 1
        c = cs.quantized_cache(torch, kvw, rx, 4, B, nkv, S, hd)
        # K6 in K7: the decode step's rows
        pos = torch.tensor([0, 63, 64, 255, 1023, 2047, 4000, 4095], dtype=torch.int32,
                           device=dev)
        q1, k1, v1 = rx(B, nh, hd), rx(B, nkv, hd), rx(B, nkv, hd)
        lay = cs.Layered(4)

        def pair_k6():
            l = lay.next()
            kvw.write_kv_rows_q8(*c, k1, v1, pos, l)
            return da.decode_attention_q8(q1, *c, pos, l)

        fns = {"walk_ms": lambda: da.decode_attention_q8(q1, *c, pos, lay.next()),
               "writer_then_walk_ms": pair_k6,
               "writer_ms": lambda: kvw.write_kv_rows_q8(*c, k1, v1, pos, lay.next())}
        if "k_new" in inspect.signature(da.decode_attention_q8).parameters:
            fns["fused_ms"] = lambda: da.decode_attention_q8(q1, *c, pos, lay.next(), k_new=k1,
                                                            v_new=v1)
        emit(f"K6 in K7 S={S}", **cs.graph_device_ms(torch, fns))
        p0 = torch.tensor([0, 63, 1021, 2047, 3000, 4000, 4090, S - T], dtype=torch.int32,
                          device=dev)
        q, kn, vn = rx(B, T, nh, hd), rx(B, T, nkv, hd), rx(B, T, nkv, hd)
        lay = cs.Layered(4)

        def pair():
            l = lay.next()
            kvw.write_kv_chunk_q8(*c, kn, vn, p0, l)
            return da.chunk_attention_q8(q, *c, p0, l)

        fns = {"walk_ms": lambda: da.chunk_attention_q8(q, *c, p0, lay.next()),
               "writer_then_walk_ms": pair,
               "writer_ms": lambda: kvw.write_kv_chunk_q8(*c, kn, vn, p0, lay.next())}
        if fused:
            fns["fused_ms"] = lambda: da.chunk_attention_q8(q, *c, p0, lay.next(), k_new=kn,
                                                           v_new=vn)
        emit(f"K11 in K10 S={S} T={T}", **cs.graph_device_ms(torch, fns))
        del c
        mp, ps = S // cs.PAGE_SIZE, cs.PAGE_SIZE
        for t in (1, T):
            pos = [0, 127, 128, 255, 1000, 2047, 3000, S - t]
            tables, npages = cs.paged_tables(torch, [p + t for p in pos], ps, mp, 4, gc)
            tables, p0 = tables.to(dev), torch.tensor(pos, dtype=torch.int32, device=dev)
            (k8, ks), (v8, vs) = (kvw.kv_quant_rows(rx(4, npages, nkv, ps, hd, dtype=torch.float32))
                                  for _ in range(2))
            pool = (k8, v8, ks, vs)
            q, kn, vn = rx(B, t, nh, hd), rx(B, t, nkv, hd), rx(B, t, nkv, hd)

            def attend(l, **rows):
                if t == 1:
                    rows = {k: r[:, 0] for k, r in rows.items()}
                    return pga.paged_decode_attention_q8(q[:, 0], *pool, p0, tables, l, **rows)
                return pga.paged_chunk_attention_q8(q, *pool, p0, tables, l, **rows)

            def pair():
                l = lay.next()
                kvw.write_kv_paged_q8(*pool, kn, vn, p0, tables, l)
                return attend(l)

            fns = {"walk_ms": lambda: attend(lay.next()), "writer_then_walk_ms": pair,
                   "writer_ms": lambda: kvw.write_kv_paged_q8(*pool, kn, vn, p0, tables,
                                                              lay.next())}
            if fused:
                fns["fused_ms"] = lambda: attend(lay.next(), k_new=kn, v_new=vn)
            emit(f"K13 (a) in K12 ps={ps} T={t}", **cs.graph_device_ms(torch, fns))
            del pool, k8, v8
        torch.cuda.empty_cache()
        # K13 (b): an admission group's strips, every layer
        for t in (16, 512):
            tables, npages = cs.paged_tables(torch, [t] * B, ps, mp, 4, gc)
            tables = tables.to(dev)
            pool = [torch.zeros((cfg.n_layers, npages, nkv, ps, hd), dtype=torch.int8,
                                device=dev) for _ in range(2)] + [
                torch.zeros((cfg.n_layers, npages, nkv, ps), device=dev) for _ in range(2)]
            ks_, vs_ = (rx(cfg.n_layers, B, nkv, t, hd) for _ in range(2))
            emit(f"K13 (b) strips T={t} ps={ps}", **cs.graph_device_ms(torch, {
                "device_ms": lambda: kvw.write_kv_prefill_paged_q8(*pool, ks_, vs_, tables, t)}))
            del pool, ks_, vs_
            torch.cuda.empty_cache()
        # K8: an admission group's strips into the 8-slot dense int8 cache of
        # 4096 rows, every layer (the tree's own body)
        c8 = [torch.zeros((cfg.n_layers, B, nkv, S, hd), dtype=torch.int8, device=dev)
              for _ in range(2)] + [torch.zeros((cfg.n_layers, B, nkv, S), device=dev)
                                    for _ in range(2)]
        slots = torch.tensor([5, 2, 7, 0, 3, 6, 1, 4], dtype=torch.int32, device=dev)
        for t in (16, 512):
            ks_, vs_ = (rx(cfg.n_layers, B, nkv, t, hd) for _ in range(2))
            emit(f"K8 strips T={t} S={S}", **cs.graph_device_ms(torch, {
                "device_ms": lambda: kvw.write_kv_strips_q8(*c8, ks_, vs_, slots, t)}))
            del ks_, vs_
        del c8
        torch.cuda.empty_cache()
        if args.write_kernels:
            return
        params = cs.random_params(torch, cfg, dev, bits=8)
        long = dict(params)
        long["rope_cos"], long["rope_sin"] = _rope_tables(cfg, dev, seq_len=S)
        cache = QuantKVCache.create(cfg, 8, S, device=dev)
        for start in (64, 2048):
            r = cs.phase_profile(torch, cfg, long, tag=f"ab {args.tag}", cache=cache,
                                 start=start)
            emit(f"profile_kv8 int8 cache pos {start}", **r)
            r = cs.phase_profile(torch, cfg, long, tag=f"ab {args.tag}", cache=cache,
                                 start=start, chunk=T)
            emit(f"profile_spec int8 cache pos {start} chunk {T}", **r)
        del cache
        torch.cuda.empty_cache()
        tables = torch.randperm(8 * mp, generator=torch.Generator().manual_seed(4))
        tables = tables.view(8, mp).to(torch.int32).to(dev)
        cache = QuantPagedKVCache.create(cfg, 8 * mp + 1, ps, device=dev)
        for start in (64, 2048):
            r = cs.phase_profile(torch, cfg, long, tag=f"ab {args.tag}", cache=cache,
                                 start=start, tables=tables)
            emit(f"profile_paged int8 pool pos {start}", **r)
        del cache, long, params
        torch.cuda.empty_cache()

    if args.write_only or args.write_kernels:
        time_writes()
        emit("card", card=cs.nvidia_smi_line(), kind=torch.cuda.get_device_name(0))
        return 0

    # -- K14: the fused attention block, beside K4 on the same rows -----------------------
    from rama_tpu_torch.ops.kernels import attn_block as ab
    from rama_tpu_torch.ops.kernels import quant_matmul as qm

    cos_t, sin_t = _rope_tables(cfg, dev, seq_len=cs.KV8_MAX_LEN)

    def time_k14(label: str, nh: int, nkv: int, layers: tuple) -> None:
        """K14's light and full forms at nh heads over nkv (wo (nh * hd,
        nh * hd)), 8 slots, S 1024 and 4096 with `layers` layers cycled."""
        D = nh * hd
        for (S, pos), n_l in zip(((1024, [0, 255, 256, 1023, 63, 64, 511, 700]),
                                  (4096, [0, 63, 1021, 2047, 3000, 4000, 4090, 4092])), layers):
            pos = torch.tensor(pos, dtype=torch.int32, device=dev)
            q, kn, vn = rx(B, nh, hd), rx(B, nkv, hd), rx(B, nkv, hd)
            cos, sin = cos_t[pos.long()], sin_t[pos.long()]
            kc, vc = rx(n_l, B, nkv, S, hd), rx(n_l, B, nkv, S, hd)
            wo = {8: QuantizedTensor(
                q=torch.randint(-127, 128, (n_l, D, D), dtype=torch.int8, device=dev,
                                generator=g),
                scales=(torch.rand((n_l, D // 64, D), device=dev, generator=g) + 0.5)
                / (73 * D ** 0.5), group_size=64, bits=8),
                4: cs.random_int4_qt(torch, n_l, D, D, 64, dev, g)}
            lay = cs.Layered(n_l)
            block = (q, kn, vn, cos, sin, kc, vc)

            def light():
                return ab.attn_rope_write_layered(*block, pos, lay.next())

            def timed(fn) -> dict:
                return dict(device_ms=cs.device_ms_per_call(torch, fn),
                            by_kernel_ms=cs.device_ms_by_kernel(torch, fn))

            rec = {"k4": dict(device_ms=cs.device_ms_per_call(
                torch, lambda: da.decode_attention(q, kc, vc, pos, lay.next())),
                **cs.attention_split_combine(torch, lambda: da.decode_attention(
                    q, kc, vc, pos, lay.next()))), "light": timed(light)}
            for bits, w in wo.items():
                rec[f"full int{bits}"] = timed(
                    lambda w=w: ab.attn_block_layered(*block, w, pos, lay.next()))

                def light_k1(w=w):
                    l = lay.next()
                    return qm.quant_matmul(ab.attn_rope_write_layered(*block, pos, l), w, l)

                rec[f"light + K1 wo int{bits}"] = timed(light_k1)
            rec["light_over_k4"] = rec["light"]["device_ms"] / rec["k4"]["device_ms"]
            emit(f"attn_block{label} S={S}", **rec)
            del kc, vc, wo
            torch.cuda.empty_cache()

    def all_k14() -> None:
        time_k14("", nh, nkv, (32, 4))
        time_k14(" Yi-34B group 7", 56, 8, (8, 4))
        time_k14(" group 8", 64, 8, (8, 4))
        if hasattr(ab, "form_for"):   # a tree whose K14 takes any whole GQA group
            time_k14(" Mistral-Large group 12", 96, 8, (8, 4))

    if args.k14_only:
        all_k14()
        emit("card", card=cs.nvidia_smi_line(), kind=torch.cuda.get_device_name(0))
        return 0

    # -- K5: prefill attention ------------------------------------------------------
    from rama_tpu_torch.ops.kernels import prefill_attention as pa

    ragged = [512, 300, 450, 129, 256, 511, 77, 384]
    f32 = torch.float32
    for measure, (b, t, nh_, nkv_, hd_, plens, dt) in {
            "7B B=8 T=512": (8, 512, 32, 32, 128, ragged, bf),
            "7B B=1 T=4096": (1, 4096, 32, 32, 128, [4096], bf),
            "TinyLlama B=8 T=512 group 8": (8, 512, 32, 4, 64, ragged, bf),
            "Yi-34B B=8 T=512 group 7": (8, 512, 56, 8, 128, ragged, bf),
            # the fp32 SIMT body (no served path runs it)
            "7B B=8 T=512 fp32": (8, 512, 32, 32, 128, ragged, f32),
            "B=8 T=512 group 8 fp32": (8, 512, 64, 8, 128, ragged, f32),
            "Yi-34B B=8 T=512 group 7 fp32": (8, 512, 56, 8, 128, ragged, f32)}.items():
        if 64 % (nh_ // nkv_) and not hasattr(pa, "form_for"):
            continue   # a tree whose K5 takes only groups that divide 64
        q, k, v = (rx(*shape, dtype=dt) for shape in ((b, t, nh_, hd_), (b, nkv_, t, hd_),
                                                       (b, nkv_, t, hd_)))
        pl = torch.tensor(plens, dtype=torch.int32, device=dev)
        emit(f"prefill_attention {measure}",
             device_ms=cs.device_ms_per_call(torch, lambda: pa.prefill_attention(q, k, v, pl)),
             ms=cs.time_ms(torch, lambda: pa.prefill_attention(q, k, v, pl)))
        del q, k, v
    if args.k5_only:
        emit("card", card=cs.nvidia_smi_line(), kind=torch.cuda.get_device_name(0))
        return 0

    # -- K10, bf16 cache, S 1024 ------------------------------------------------------
    S = 1024
    k, v = rx(4, B, nkv, S, hd), rx(4, B, nkv, S, hd)
    for t in (4, 8):
        pos0 = torch.tensor([0, 61, 128, 255, 511, 700, 900, S - 4], dtype=torch.int32,
                            device=dev)
        pos0 = (pos0 - (t - 4)).clamp(min=0)
        q, q1 = rx(B, t, nh, hd), rx(B, nh, hd)
        last = (pos0 + t - 1).clamp(max=S - 1)
        vis = da._visible(pos0, t, S)[:, None]
        attention(f"chunk_attention S={S} T={t}",
                  lambda l: da.chunk_attention(q, k, v, pos0, l),
                  lambda l: da.decode_attention(q1, k, v, last, l),
                  lambda l: F.scaled_dot_product_attention(q.transpose(1, 2), k[l], v[l],
                                                           attn_mask=vis))
    del k, v

    # -- K10, int8 cache, S 1024 and 4096 ------------------------------------------------
    for S, pos in ((1024, [0, 61, 128, 255, 511, 700, 900, 1020]),
                   (4096, [0, 63, 1021, 2047, 3000, 4000, 4090, 4092])):
        c = cs.quantized_cache(torch, kvw, rx, 4, B, nkv, S, hd)
        pos0 = torch.tensor(pos, dtype=torch.int32, device=dev)
        q, q1 = rx(B, 4, nh, hd), rx(B, nh, hd)
        last = (pos0 + 3).clamp(max=S - 1)
        attention(f"chunk_attention_q8 S={S} T=4",
                  lambda l: da.chunk_attention_q8(q, *c, pos0, l),
                  lambda l: da.decode_attention_q8(q1, *c, last, l))
        del c
        torch.cuda.empty_cache()

    # -- K12 chunk, 128-row pages, mp 32 ---------------------------------------------------
    S, ps = 4096, 128
    p0 = torch.tensor([0, 127, 128, 255, 1000, 2047, 3000, 4092], dtype=torch.int32)
    tables, npages = cs.paged_tables(torch, [min(int(p) + 4, S) for p in p0], ps, S // ps, 8, gc)
    tables, p0 = tables.to(dev), p0.to(dev)
    kv = [rx(4, npages, nkv, ps, hd) for _ in range(2)]
    q8p = [None] * 4
    q8p[0], q8p[2] = kvw.kv_quant_rows(kv[0].float())
    q8p[1], q8p[3] = kvw.kv_quant_rows(kv[1].float())
    q, q1 = rx(B, 4, nh, hd), rx(B, nh, hd)
    last = (p0 + 3).clamp(max=S - 1)
    attention("paged_chunk_attention ps=128 T=4",
              lambda l: pga.paged_chunk_attention(q, *kv, p0, tables, l),
              lambda l: pga.paged_decode_attention(q1, *kv, last, tables, l))
    attention("paged_chunk_attention_q8 ps=128 T=4",
              lambda l: pga.paged_chunk_attention_q8(q, *q8p, p0, tables, l),
              lambda l: pga.paged_decode_attention_q8(q1, *q8p, last, tables, l))
    del kv, q8p
    torch.cuda.empty_cache()

    # -- the int8-cache decode step's attention: K7, K9 q8, K12 decode ------------------
    def decode(measure, fn, n_layers) -> None:
        lay = cs.Layered(n_layers)
        emit(measure, ms=cs.time_ms(torch, lambda: fn(lay.next())),
             **cs.attention_split_combine(torch, lambda: fn(lay.next())))

    for S, n_l, pos in ((1024, 32, [0, 255, 256, 1023, 63, 64, 511, 700]),
                        (4096, 4, [0, 63, 64, 255, 1023, 2047, 4000, 4095])):
        c = cs.quantized_cache(torch, kvw, rx, n_l, B, nkv, S, hd)
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        q = rx(B, nh, hd)
        decode(f"decode_attention_q8 S={S}", lambda l: da.decode_attention_q8(q, *c, pos, l), n_l)
        decode(f"decode_attention_flat_q8 S={S}",
               lambda l: da.decode_attention_flat_q8(q, *[t[l] for t in c], pos), n_l)
        del c
        torch.cuda.empty_cache()
    S, ps = 4096, 128
    p0 = torch.tensor([0, 127, 128, 255, 1000, 2047, 3000, 4092], dtype=torch.int32)
    tables, npages = cs.paged_tables(torch, [min(int(p) + 1, S) for p in p0], ps, S // ps, 8, gc)
    tables, p0 = tables.to(dev), p0.to(dev)
    kv = [rx(4, npages, nkv, ps, hd) for _ in range(2)]
    q8p = [None] * 4
    q8p[0], q8p[2] = kvw.kv_quant_rows(kv[0].float())
    q8p[1], q8p[3] = kvw.kv_quant_rows(kv[1].float())
    q = rx(B, nh, hd)
    decode("paged_decode_attention_q8 ps=128",
           lambda l: pga.paged_decode_attention_q8(q, *q8p, p0, tables, l), 4)
    decode("paged_decode_attention ps=128",
           lambda l: pga.paged_decode_attention(q, *kv, p0, tables, l), 4)
    del kv, q8p
    torch.cuda.empty_cache()

    all_k14()

    # -- 7B int8 verify rounds and decode steps ------------------------------------------
    params = cs.random_params(torch, cfg, dev, bits=8)
    for chunk in (1, cs.SPEC_TICK + 1):
        r = cs.phase_profile(torch, cfg, params, tag=f"ab {args.tag}", chunk=chunk)
        emit(f"profile pos 64 bf16 chunk {chunk}", **r)
    long = dict(params)
    long["rope_cos"], long["rope_sin"] = _rope_tables(cfg, dev, seq_len=cs.KV8_MAX_LEN)
    for name, cls in (("bf16", KVCache), ("int8", QuantKVCache)):
        cache = cls.create(cfg, 8, cs.KV8_MAX_LEN, device=dev)
        for chunk in (1, cs.SPEC_TICK + 1):
            r = cs.phase_profile(torch, cfg, long, tag=f"ab {args.tag}", cache=cache,
                                 start=2048, chunk=chunk)
            emit(f"profile pos 2048 {name} chunk {chunk}", **r)
        del cache
        torch.cuda.empty_cache()
    from rama_tpu_torch.runtime.paged import QuantPagedKVCache

    mp = cs.KV8_MAX_LEN // cs.PAGE_SIZE
    tables = torch.randperm(8 * mp, generator=torch.Generator().manual_seed(4))
    tables = tables.view(8, mp).to(torch.int32).to(dev)
    cache = QuantPagedKVCache.create(cfg, 8 * mp + 1, cs.PAGE_SIZE, device=dev)
    for start in (64, 2048):
        r = cs.phase_profile(torch, cfg, long, tag=f"ab {args.tag}", cache=cache, start=start,
                             tables=tables)
        emit(f"profile pos {start} int8 pool", **r)
    del cache, long
    torch.cuda.empty_cache()
    for key, r in cs.profile_ab(torch, cfg, params).items():
        emit(f"profile_ab {key}", **r)
    del params
    torch.cuda.empty_cache()
    time_k3()
    emit("card", card=cs.nvidia_smi_line(), kind=torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
