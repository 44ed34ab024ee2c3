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
           the port never calls); K5 (prefill attention) also at GQA rep 2
           and 4, the stories drafts' hd 48 and 64, fp32 hd 48 (the SIMT
           body), with planted 32- and 64-key tile edges, each call on the
           body `body_for` picks, and timed at (8, 16), (8, 512) and one
           4096-token prompt; every quant_matmul call checked on the body
           body_for picks (bf16 up to M = 32: the swap-AB tensor-core
           body, incl. the masked path at N 1000, gs 48 and K of one
           block); the swap-AB body (the `quant_matmul_mmv` record) timed
           at int8 wqkv / wo / lm_head M = 1 / 8 / 16 / 32 (CUDA-event and
           device ms, bound) beside the tensor-core GEMM's device ms at M
           = 16 / 32; the GEMM (bf16, M > 32, the `quant_matmul_mma`
           record) checked and timed at int8 wqkv M = 256 / 4096 and wo /
           w13 / w2 M = 4096 (CUDA-event and device ms, TFLOP/s, bound,
           plain version, and a dense yardstick: torch.matmul by the layer
           dequantized to bf16 beforehand); K3 (ffn) at M = 1 / 8 / 32 on
           the body body_for picks (bf16: the tensor-core body) and at M =
           33 / 40 / 64 / 65 / 100 / 128 / 256 / 474 / 512 on both bodies
           (bf16 in the form form_for picks: "one" up to 64 rows, "rows"
           of 64-row blocks above, by the launch counts; every bf16 row bit
           for bit the same as in 32-row calls), timed at M = 1 / 8 / 32 /
           64 / 128 / 256 (CUDA-event and device ms, bound) beside, at M >=
           32, the split route through quant_matmul (w13 product, silu * c,
           w2 product) and a dense bf16 yardstick (torch.matmul by w13 / w2
           dequantized beforehand, not the same function), and at
           TinyLlama-1.1B's FFN at M = 64 / 512 (the `tinyllama` key);
           K4's device time beside SDPA's
  kernels4 the same for the int4 instantiations of quant_matmul (the
           swap-AB body, the fp32 GEMV, the prefill GEMM, stacked and 2-D
           weights) and ffn, at the 7B int4 shapes (wqkv / wo / w13 gs 64,
           w2 gs 16) and at the tiny and stories15M shapes (gs 1, 2, 4, 16,
           and 48), ragged N, fp32 and bf16; the swap-AB body timed at
           int4 wqkv / wo / w2 gs 16 / a 2-D wqkv M = 1 / 8 / 16 / 32, the
           GEMM at int4 wqkv M = 256 / 4096 and w2 gs 16 M = 256; K3'
           checked at every M and timed as K3
  kernels_kv8  the int8 KV cache's kernels: the row writer and the strip
           inserter (exact: int8 bytes and f32 scales at atol 0) at the 7B
           shapes of an 8-slot 4096-row cache, layers 0 and 31, and at the
           tiny / stories15M shapes; the strip inserter K8 on its streaming
           body (bf16 at hd 48 / 64 / 128) and its warp-a-row body, each
           byte for byte against the plain version at 7B 8 x 16 and 8 x 512,
           t_ins 300 of 512 with n = 3, S = 1000, hd 64 / 48, a duplicate
           slot, slots -1 and B (no byte of the cache moves) and a CUDA
           graph replay, both bodies timed at 8 x 16 and 8 x 512 (device ms
           over graphs of 20 in turns, the bound's share); the int8 decode
           attention (rel 0.05
           per (slot, head)) at S 4096 and at S 1024 with the bf16
           kernel's positions, with planted edge rows, GQA rep 2 and 4,
           fp32 and bf16 q, each launch on the body body_for picks (bf16:
           the walk body, dattn_walk, by the counts and the profiled
           kernel name); CUDA-event times as for `kernels`, and its split
           and combine device ms with the bound's share, the grid (CTAs
           launched against the splits with work, beside one CTA a 64-row
           tile), the occupancy, and G (tiles a split) swept over 1 / 2 /
           4 / 8; K6 inside K7 (the walk given the decode step's rows, at S
           4096, tile edges, S - 1 and a finished slot's overshoot S, S + 3
           onto row S - 1, planted rows) against K6 then the walk (bit for
           bit, cache byte for byte) and the plain version, its device ms
           (a CUDA graph of 20 launches) beside the walk alone, K6 then the
           walk and K6 alone
  model    Llama-2-7B int8 params from a seed on the card (untied
           classifier), kernel-path logits against the plain path
  generate generate_text, greedy, a few dozen tokens (non-degenerate)
  serve    the port's server (build_app around an 8-slot Engine, max_len
           1024) on a local port; concurrent /gen requests; TTFT, tok/s,
           /metrics
  profile  torch.profiler over 8-slot decode steps: host ms/step (with and
           without the profiler), device kernel ms/step by kernel, device
           busy share, K3's and K1's device ms and share of a step (also
           in profile_spec's verify rounds, profile4 and profile_ab)
  profile_prefill  one 7B int8 admission of 8 x 512 tokens through
           llama.prefill on a bf16 cache of 1024 rows: device ms (CUDA
           events), torch.profiler's device ms by kernel, K5's share and
           the tensor-core GEMM's (with its TFLOP/s)
  model_kv8    the int8 params on an int8 KV cache of 4096 rows: kernel-path
           logits against the plain path after a prefill and decode steps
           at positions 8, 9, 1500 and 4000 (RoPE tabulated to 4096); the
           gap to the bf16-cache logits is printed, not gated
  serve_kv8    the server with an 8-slot int8 KV cache at max_len 4096
  serve_warmup serve_kv8 in a fresh process whose compile_cache is a new
           directory under build/ holding this run's built libraries: no
           nvcc runs; Engine.warmup(max_prompt=64) builds nothing and loads
           every library, then serving loads no library and admits only
           warmed (k, T) buckets; the greedy streams equal serve_kv8's; the
           first request's TTFT beside serve_kv8's
  profile_kv8  the profile of 8-slot decode steps on the int8 cache, at
           positions 64 and 2048
  model4   Llama-2-7B int4 params (int4 layers, int8 embedding and
           classifier) from a seed on the card, logits against the plain path
  serve4   the server on the int4 model: 8 concurrent /gen requests
  profile4 the profile of 8-slot int4 decode steps
  kernels_spec the speculation slice's kernels: the chunk attention (K10)
           on a bf16 and an int8 cache (rel 0.05 per (slot, query, head))
           at the 7B shapes, T 2 / 4 / 8, ragged chunk starts straddling
           the 64-row splits and reaching S, with planted edge rows at
           pos0 + t and pos0 + t + 1, every launch on the tensor-core body
           (by the launch counts by body); GQA rep 2 / 4, hd 16 / 48 / 64 /
           128, bf16 (hd 48 / 64 / 128 on the tensor-core body) and fp32
           (the SIMT body; the int8 cache's chunks on the walk body); the
           standalone chunk writer (K11) exact, with chunks straddling a
           32-row window and reaching S; K11 inside K10 (the walk given
           the chunk's rows, at S 4096, T 1 / 2 / 4 / 8, planted rows)
           against the writer then the walk (bit for bit, cache byte for
           byte) and the plain version, and its device ms (CUDA events
           over a CUDA graph of 20 launches) beside the walk alone, the
           writer then the walk and the writer alone (also K6 and K8 in
           kernels_kv8, K13 (a) / (b) in kernels_paged); K4 at the stories15M draft's
           head_dim 48; CUDA-event times beside K4 / K6 on the same rows;
           device ms of the split kernel and the combine beside the T = 1
           split on the same rows (the profiled split kernel must be
           dattn_mma for both), and SDPA's CUDA-event and device ms
  model_spec   7B int8 forward_chunk (T 4) through the kernels against the
           plain path on a bf16 and an int8 cache of 4096 rows, chunk
           starts 8, 61, 1500, 1021 and 4092
  serve_spec   the server on 8 slots with spec_tick 3 (n-gram drafts,
           always speculating): 8 concurrent /gen, tok/s, TTFT, accept rate
  profile_spec the profile of an 8-slot verify round (T 4) against an
           8-slot plain decode step, bf16 and int8 caches, at pos 64 of a
           128-row cache and at pos 2048 of a 4096-row one (the attention's
           device ms a round or step beside the total)
  spec_draft   the engine in draft mode with the target as its own draft
           (accept rate >= 0.9; a spec-off run of the same requests,
           outside the launch count, for the first differing position),
           then with a synthetic stories15M-shaped draft checkpoint (accept
           ~0: dormancy with plain ticks, and draft-cache resync)
  spec_draft_ab  spec_draft's self-draft under RAMA_ATTN_BLOCK 1 and 2 (the
           draft's decode steps on K14, the verification on K10): each
           accept rate logged, no gate; after the path's count is read
  serve_spec_kv8   serve_spec on the int8 KV cache at max_len 4096
  kernels_paged the paged slice's kernels on 7B shapes (pages of 128 rows,
           mp 32: max_len 4096, 8 slots, a shuffled pool): the paged
           attention (K12: decode and chunk forms, bf16 and int8 pools; rel
           TOL per (slot, query, head), the 1e-2 bar logged) at positions on
           page edges, T 1 / 4 / 8, planted edges, and against K4 / K7 / K10
           over the gathered dense view (bit for bit where the 64-row splits
           coincide); a 16-row-page case; hd 64 / 48 at GQA rep 2 / 1 over
           32- / 24-row pages; every launch on a tensor-core body in
           bf16 (the int8 pool's on the walk body), the SIMT body in fp32
           (by the counts by body and the profiled split kernel), the
           int8 decode's grid (CTAs launched against the splits with
           work); the paged writers (K13) exact, rows past
           a table clipped into its last page; K13 (a) inside K12 (the walk
           given the step's or chunk's rows, T 1 / 4 / 8, planted rows,
           rows past a table) against the writer then the walk and the
           plain version, timed as K11 inside K10; K13 (b)'s streaming body
           (bf16 at hd 48 / 64 / 128) and its warp-a-row body exact at 16-,
           64- and 128-row pages, odd t_ins, n < K and a clamped table
           entry, timed at 16 and 512 rows a strip (device ms, CUDA events
           over a graph of 20, both bodies in turns, the bound's share);
           CUDA-event times beside the dense kernels on the same rows
  model_paged  7B int8 decode steps and chunks (T 4) through the paged
           kernels against the plain path on a dense cache of the same rows,
           bf16 and int8 pools, positions up to 4092
  serve_paged, serve_paged_kv8, serve_spec_paged, serve_spec_paged_kv8
           the server on 8 slots at max_len 4096 over a pool of 64 pages of
           128 rows (a quarter of the dense worst case): bf16 / int8 pool,
           plain or spec_tick 3; every page free again after each run
  serve_pipe   the pipelined loop: Llama-2-7B int8 on the 8-slot int8 KV
           cache at max_len 4096, three in-process engines (plain, n-gram
           spec_tick 3, the paged int8 pool), each serving 16 requests of
           32 tokens (half greedy, half sampled at temperature 1.0, top-p
           0.9; request 1 alone, 2-8 on its first token, 9-16 on theirs)
           at _PIPELINE_DEPTH 1 / 3 / 3 / 1, then profiled at 3: the
           same token ids in every run, at depth 3 >= 1 chained tick and
           >= 1 admission dispatched behind a tick in flight, every tick
           and admission dispatch under set_sync_debug_mode("error") with
           no engine error; logs tok/s, the device busy share and the
           mid-stream TTFT by depth (no gate)
  serve_chunk  chunked prefill: Llama-2-7B int8 at max_len 4096, 8 slots,
           ticks of 8, on three in-process engines (a bf16 and an int8 dense
           cache, an int8 pool of 64 pages of 128 rows), each run with
           prefill_chunk 0 and 256 (prefill_chunk_min 1024) in ABBA turns
           (the second B and A under the profiler, CUDA only): six short
           requests of 64 tokens (3 greedy, 3 sampled), then, once each
           has its first token, two greedy long prompts of 3000 and 1500
           tokens (a passage's ids repeated) of 32 tokens. Gates: every
           stream its token count and the engine's count of every token;
           the short streams' ids equal across the four runs; each long
           prompt's first-token logits in the job's `last` within TOL of
           the direct prefill's, and its slot's cache rows 0..plen-1
           after the finisher (dequantized on the int8 caches) within TOL
           of the direct admission's, by (layer, kv head); every chunk's
           quant_matmul launches on the tensor-core bodies, none of K5; K8
           once a job on the int8 cache, K13 (b) once a job on the pool;
           >= 1 non-final chunk dispatched behind a tick in flight; every
           tick, admission, chunk and finisher dispatch under
           set_sync_debug_mode("error") with no engine error. Records (no
           gate): tok/s, the long prompts' TTFT, the largest gap between
           two emissions of a short stream while a long prompt admits,
           chunks, jobs, chunks behind a tick, the busy share
  profile_chunk  after serve_chunk's launches are read: a chunk at off 0
           and 2048 of a 4096-row job timed (CUDA events, device ms)
           beside its 32 layers' masked attention alone (the K10 candidate)
  chat     a ChatSession on the 7B int8 params (bf16 cache, the model's
           1024-row context): three greedy turns of up to 32 tokens with a
           system prompt; each turn's last-prefill logits within TOL of
           the plain path on a copy of the cache, the running position the
           templates' lengths plus the emitted tokens, the decode steps on
           K1 / K3 / K4's tensor-core bodies and no K5 launch
  eval     perplexity on the 7B int8 params over ~4000 tokens (window 512,
           batch 4: K5 and the GEMM, full logits), with the kernels and then
           the plain path: the first batch's full logits within TOL of the
           plain path's, row by row, and the nll within EVAL_NLL_GAP (rel);
           logs both values, the gap and the seconds each took
  profile_paged  device ms per 8-slot decode step on a bf16 and an int8
           pool at positions 64 and 2048, beside the dense cache's, each
           with the attention's device ms
  kernels_attn the last slice's kernels: K9 (T = 1 attention over one
           layer's cache, bf16 and int8, rel TOL per (slot, head)) at K4 / K7's
           shapes and positions with planted edges, int8 also at S 4096,
           timed beside K4 / K7 over the same rows (SDPA's CUDA-event and
           device ms beside K9); K14 (the fused attention block: light, and
           full with int8 and int4 wo) against its plain version with
           planted edges and the new row's key aligned with q, positions 0,
           on and around the 64-row split edges, S - 1 and S + 3 (clamped),
           every bf16 launch on split tensor-core attention (the counts by
           body): the written v row bit for bit, the roped k row within one
           ulp, every other cache row unchanged; device ms (and by kernel:
           split, combine, wo) at S 1024 on K4's positions and at S 4096 on
           long ones beside K4 over the same rows and K1's wo at M = 8, each
           kernel's registers, local bytes and CTAs an SM; CUDA-event times
           beside the unfused composition of the same step (apply_rope x 2,
           the row write, K4, and K1's wo)
  model_attn   7B decode-step logits under RAMA_ATTN_BLOCK 1 and 2 (int8,
           and int4 with the int4 params) against the plain path under the
           same mode and the unfused plain path; with the int8 params a
           one-token prefill and forward(logit_rows) at T = 1 on a bf16 and
           an int8 cache (K9), kernels against plain
  serve_ab1, serve_ab2, serve4_ab2  the server under RAMA_ATTN_BLOCK 1, 2
           (int8) and 2 (int4): K14 once a layer of every decode step, K4
           never
  profile_ab   device ms, host ms and busy share per 8-slot decode step under
           modes 0, 1 and 2 at positions 64 and 2048 of a 4096-row cache
  prefill_t1   the T = 1 generic layer through prefill / forward on bf16 and
           int8 caches with the plain T = 1 attention made to raise: K9 once
           a layer of every call
  model_b64    7B int8 logits at 64 slots, kernels against the plain path: a
           prefill of 64 prompts, a decode step (K3 at M = 64, "one" form)
           and forward_chunk T 4 (M = 256, "rows" form)
  serve_b64, serve_b64_spec  the server on 64 slots at max_len 512 (a
           17.2 GB bf16 cache), 64 concurrent /gen of 32 tokens: plain
           decoding (every step K3 at M = 64, "one" form), n-gram
           speculation at spec_tick 3 (every verify round K3 at M = 256,
           "rows" form); each K3 launch once a layer of a step or round
  profile_b64  64-slot decode steps and verify rounds of 4 at pos 64:
           device ms, K3's and K1's ms and share
  kernels_s16  the bf16-stored-scale forms (cast_scales) of K1 / K2 and
           K3 on every body that reads a weight scale (the swap-AB body,
           the GEMM, the fp32 GEMV and tiled GEMM, the FFN's tensor-core
           body and fp32 GEMVs; K14's full form on a bf16-scale wo) at the
           7B shapes, int8 and int4, layers 0, 1 and 31: each within TOL
           of its plain version on the same scales and equal bit for bit
           to the same body fed scales.float(); device ms in turns (f32,
           bf16, bf16, f32) beside the f32-scale form on the same weight
           bytes, bytes and bound with 2-byte scales; K3 / K3' at K3's M
           past 32 as well (both bodies, rows bit for bit as in 32-row
           calls and as with the same scales in f32)
  model_s16    7B int8 logits with bf16-stored scales, kernels against the
           plain path on the same scales (after the int8 path)
  model4_s16, serve4_s16, profile4_s16  the same for the int4 params, the
           int4 server with EngineConfig(scale_dtype="bf16"), and its
           decode-step profile beside profile4's in the same call
  kernels_gqa  the decode / chunk attention at GQA groups past the 8-row
           form (K4, K7, K9, K10; K12 decode and chunk, bf16 and int8
           pools): rep 8 x T 1 / 2 / 4 / 8, rep 3 x T 3, rep 16 x T 1 / 8
           (8-128 query rows a kv head) at hd 64 and 128 against the plain
           versions with planted edges, each launch on its body and row
           form (the counts by body and by the form the C entry reports it
           launched), chunk rows equal to the
           decode rows bit for bit at rep 3 / 8 / 16, the int8 walk given
           the chunk's rows (K11 / K13 (a) inside it) in every form against
           the writer then the walk and the plain version, each form's shared
           bytes (occupancy API) against form_smem, the SIMT body's row
           groups (fp32); K10 and K12's chunk form timed at TinyLlama's
           shape (8 slots, 4 kv heads, hd 64, S 2048) at T 4 and 8 (and K10
           on the bf16 cache at T 2, the 16-row form): CUDA-event and
           device ms (the profiled split kernel's form), plain ms, bound,
           SDPA over the repeated kv heads (bf16 dense), each beside the
           same of the T = 1 launch (K4 / K7 / K12 decode) on the same rows;
           K5 at GQA groups that do not divide 64 (its "gqa" form: rep 3 /
           5 / 6 / 7 / 9 / 12 / 65, hd 64 and 128, bf16 and fp32, T 1 / 9 /
           63 / 64 / 65 / 512, plen on the position tiles' edges, planted
           value edges) against its plain version, each launch on its body
           and form; every group 1 .. 65 once at a small shape; and K5 timed
           at Yi-34B's 8 x 512 admission (group 7) beside the "div64" form
           (group 8) on the same kv rows, with SDPA over the repeated kv
           heads (the `prefill_attention_gqa` record)
  model_gqa    TinyLlama-1.1B int8 (random weights from a seed at its
           published width and depth) logits through the kernels against
           the plain path: a decode step and forward_chunk at T 4 and 8, on
           a bf16 and an int8 cache of 2048 rows
  serve_gqa, serve_gqa_spec, serve_gqa_spec_kv8, serve_gqa_spec_paged_kv8
           the server on TinyLlama: plain decoding; n-gram speculation at
           spec_tick 7 (64 query rows a kv head) on the bf16 cache, 3 (32
           rows) on the int8 cache, 7 on an int8 pool of 128-row pages
  profile_gqa_spec  a TinyLlama verify round of 8 (K3 at M = 64) against a
           plain step at pos 64 and 1024, each with K3's and K1's share
  spec_gqa_self  TinyLlama as its own draft at spec_tick 7: accept >= 0.9
  model_yi     Yi-34B int8 (random weights from a seed at its published
           width: GQA group 7, 56 heads over 8 kv heads, head_dim 128)
           logits through the kernels against the plain path: a padded
           prefill of 8 prompts (plen on the "gqa" form's 9-position tile
           edges), a decode step and forward_chunk at T 4 on a bf16 cache,
           then a decode step on an int8 cache (K6 inside K7's 8-row form)
  serve_yi, serve_yi_kv8, serve_yi_spec, serve_yi_ab2  the server on
           Yi-34B (8 slots, max_len 2048, a 64000-piece tokenizer file made
           from the fixture's pieces): plain decoding on a bf16 cache; on an
           int8 cache (admission through K5 on the scratch, then K8);
           n-gram speculation at spec_tick 3 (28 query rows a kv head: the
           32-row chunk form, K3 at M = 32); RAMA_ATTN_BLOCK 2 (K14 at rep 7)
  profile_prefill_yi  one Yi-34B admission of 8 x 512 tokens (K5's device
           ms and share, the GEMM's), an 8-slot decode step and a verify
           round of 4 at pos 64 (device ms by kernel)
  cli      a small synthetic v2 checkpoint through `python -m
           rama_tpu_torch.cli generate --device cuda`, a v0 one with
           `--quant int4`, the v2 one again with `--scale-dtype bf16`, a
           TinyLlama-width 2-layer v2 file with `--spec ngram` (T 8), then
           `generate -o chat` on the v2 file with two user lines and `exit`
           on stdin (rc 0, two replies) and `eval --text` on a file it
           writes (rc 0, one JSON line with a finite perplexity)

The main paths, each with the launch counters set to 0 just before it
and read just after (`PATHS`; the four paged ones: K12 decode and K13
on the pools, K12 chunk under speculation, never K4 / K7 / K10 / K6 / K8 /
K11): int8 (`generate` + `serve`), where every int8 kernel
must have launched; int8 KV (`serve_kv8`), where the int8 cache's three
kernels (K6 inside every K7 launch: `write_kv_rows_q8_fused` equal to
`decode_attention_q8`, K6's own launch never), the int8 matmul / FFN and
the prefill attention must have, and the bf16 decode attention must not;
n-gram speculation (`serve_spec`),
where K10 on the bf16 cache, the matmul, FFN and prefill must have, and
the T = 1 decode attention must not (every tick verifies a chunk);
draft-model speculation (`spec_draft`, its spec-off baseline run before
the counters are set to 0), where K10, the matmul, FFN, prefill and the
T = 1 decode attention (the draft's decode, and the dormant plain ticks)
must have; speculation on the int8
KV cache (`serve_spec_kv8`), where K10 on the int8 cache, K11, the strip
writer, matmul, FFN and prefill must have, and the bf16 decode attention
must not; int4 (`serve4`), where every int4 kernel, the int8 classifier's
GEMV and both attention kernels must have; int4 with bf16-stored scales
(`serve4_s16`), where the same must have and every K1 / K2 / K3 launch
must read bf16 scales (every other path's, f32 ones); the fused attention block
under RAMA_ATTN_BLOCK 1 (`serve_ab1`) and 2 (`serve_ab2`, `serve4_ab2` on
int4), where K14 launches as often as the fused FFN (once a layer of each
decode step), every launch on split tensor-core attention (`[launches]`:
`attn_block_mma` / `_simt`), and K4 never; `prefill_t1`, where K9 launches on both
caches and no decode, chunk or prefill attention does; the two 64-slot
paths (`serve_b64`, `serve_b64_spec`), where K3 must launch once a layer
of every decode step in its "one" form and of every verify round in its
"rows" form (`ffn_one` equal to `decode_attention`, `ffn_rows` to
`chunk_attention`: no step or round took the split w13 / w2 route); and
the five TinyLlama paths (`serve_gqa`, the three `serve_gqa_spec*`,
`spec_gqa_self`), where every verification chunk must run a row form of
more than 8 rows (and, at T 8, K3 in its "one" form once a layer of every
round); chunked prefill (`serve_chunk`), where K4, K7 with K6's rows, K12
with K13 (a)'s, K8, K13 (b), K5 (the direct admissions), the matmul and
the FFN must have, and no chunk attention; the chat loop (`chat`), where
the matmul, the FFN and K4 must have and K5 must not; `eval`, where K5
and the GEMM must have and no decode-sized product, K3 or decode
attention may
(the `*_gqa` records: launches in such a form on the mma body, bf16 cache,
or the walk body, int8 cache, as the C entry reports the form it launched;
`[launches]` `decode_attention_mma_rows*` / `_walk_rows*`,
`paged_attention_*_rows*`), while every Llama-2-7B path's
decode-attention launch must run the 8-row form; and the four Yi-34B paths
(`serve_yi`, `serve_yi_kv8`, `serve_yi_spec`, `serve_yi_ab2`), where every
K5 launch must run its "gqa" form (`prefill_attention_gqa` equal to
`prefill_attention`), which no launch of a path without that pair may
(every Llama-2-7B and TinyLlama path). Every K5 launch
of a path that records K5 must be on its tensor-core body, and every
quant_matmul and ffn launch of every path on a tensor-core body: the
swap-AB body at M <= 32, the GEMM above, never the CUDA-core GEMV or
tiled GEMM (`[launches]`: `quant_matmul_mmv` / `_gemv` / `_mma` / `_simt`,
`ffn_mma` / `ffn_simt`), and every decode-attention launch (K4, K7, K9,
K10, and K12 on the pools: decode steps and verification chunks alike) on
its tensor-core body (`decode_attention_mma` / `_simt`,
`paged_attention_mma` / `_simt`; the kernels record keeps each path's
counts by body, `launches_by_body`). The int8 KV,
speculation, attention-block and T = 1 paths reuse the int8 path's params. The line before
last holds the card's name and power limit, the line before that the
{"kernels": [...]} record, and the last line the {"ok": true, ...} result,
which only a run of every phase prints.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import gc
import json
import math
import os
import shutil
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
ALL_PHASES = ("card", "build", "kernels", "kernels4", "kernels_kv8", "kernels_spec",
              "kernels_paged", "kernels_attn", "model", "generate", "serve", "profile",
              "profile_prefill", "model_kv8", "serve_kv8", "profile_kv8", "serve_warmup",
              "model_spec",
              "serve_spec", "profile_spec", "spec_draft", "spec_draft_ab", "serve_spec_kv8",
              "model_paged", "serve_paged", "profile_paged", "serve_paged_kv8",
              "serve_spec_paged", "serve_spec_paged_kv8", "serve_pipe", "serve_chunk",
              "profile_chunk", "chat", "eval", "model_attn", "serve_ab1",
              "serve_ab2", "profile_ab", "prefill_t1", "model_b64", "serve_b64", "profile_b64",
              "serve_b64_spec", "model4", "serve4", "profile4",
              "kernels_s16", "model_s16", "model4_s16", "serve4_s16", "profile4_s16",
              "serve4_ab2", "kernels_gqa", "model_gqa", "serve_gqa", "serve_gqa_spec",
              "profile_gqa_spec", "serve_gqa_spec_kv8", "serve_gqa_spec_paged_kv8",
              "spec_gqa_self", "model_yi", "serve_yi", "profile_prefill_yi", "serve_yi_kv8",
              "serve_yi_spec", "serve_yi_ab2", "model_ml", "serve_ml", "serve_ml_ab1",
              "serve_ml_ab2", "profile_ml_ab", "cli")
INT4_STD = math.sqrt((15 ** 2 - 1) / 12)   # std of a nibble drawn from [-7, 7]
K1_KERNELS = ("qmv_mma", "qmm_mma", "qmv_kernel", "qmm_tiled")   # quant_matmul's bodies
ATTN_SPLIT_KERNELS = ("dattn_split", "dattn_mma", "dattn_walk")   # the split kernel's bodies
# the decode-attention kernel's two wrappers, each counting its launches by
# body: the name of those counts in read_launches -> (the records of its
# entries, bodies)
ATTN_FAMILIES = {
    "decode_attention": (("decode_attention", "decode_attention_q8", "decode_attention_flat",
                          "decode_attention_flat_q8", "chunk_attention", "chunk_attention_q8"),
                         ("mma", "walk", "simt")),
    "paged_attention": (("paged_decode_attention", "paged_decode_attention_q8",
                         "paged_chunk_attention", "paged_chunk_attention_q8"),
                        ("mma", "walk", "simt"))}
# kernel 14's forms (the fused attention block), counted by body together
AB_KERNELS = ("attn_rope_write_layered", "attn_block_layered", "attn_block_layered_int4")
# the kernels whose launches are also counted by body: record name ->
# (prefix of those counts in read_launches, bodies)
BODY_COUNTS = {
    **{name: (family, bodies) for family, (names, bodies) in ATTN_FAMILIES.items()
       for name in names},
    **{name: ("prefill_attention", ("mma", "simt"))
       for name in ("prefill_attention", "prefill_attention_gqa")},
    **{name: ("attn_block", ("mma", "simt")) for name in (*AB_KERNELS, "attn_block_gqa")},
    **{name: ("quant_matmul", ("mmv", "gemv", "mma", "simt"))
       for name in ("quant_matmul", "quant_matmul_int4")},
    **{name: ("ffn", ("mma", "simt")) for name in ("ffn", "ffn_int4")},
    **{name: ("decode_attention", ("mma", "walk", "simt"))
       for name in ("chunk_attention_gqa", "chunk_attention_q8_gqa")},
    "write_kv_strips_q8": ("write_kv_strips_q8", ("stream", "rows")),
    "paged_chunk_attention_q8_gqa": ("paged_attention", ("mma", "walk", "simt"))}
# the decode-attention records whose launches are also counted by body and
# row form (the tensor-core bodies' 8 / 16 / 32 / 64-row forms, as the C
# entry reports them): record name -> prefix
FORM_COUNTS = {name: prefix for name, (prefix, _) in BODY_COUNTS.items()
               if prefix in ("decode_attention", "paged_attention")}
# launch counts kept in another kernel's record: the walk launches that wrote
# their rows are K11's / K13 (a)'s launches on the main path
RECORD_OF = {"write_kv_chunk_q8_fused": "write_kv_chunk_q8",
             "write_kv_paged_q8_fused": "write_kv_paged_q8",
             "write_kv_rows_q8_fused": "write_kv_rows_q8",
             # K8's / K13 (b)'s launches by body (none on the warp-a-row body on a
             # bf16 path at hd 48 / 64 / 128)
             "write_kv_strips_q8_stream": "write_kv_strips_q8",
             "write_kv_strips_q8_rows": "write_kv_strips_q8",
             "write_kv_prefill_paged_q8_rows": "write_kv_prefill_paged_q8"}
# K8 on a dense int8-cache path: every launch on the streaming body
# (`equal`), none on the warp-a-row body
K8_STREAM = dict(record={"write_kv_strips_q8_stream": "stream_body_launches"},
                 forbid={"write_kv_strips_q8_rows": "rows_body_launches"},
                 equal={"write_kv_strips_q8_stream": "write_kv_strips_q8"})
PARTIAL_RC = 4                # exit code of a run that skipped phases
KV8_MAX_LEN = 4096            # Llama-2-7B's published context
SPEC_TICK = 3                 # drafts per verification round: chunks of 4
PAGE_SIZE = 128               # the paged serving paths' page rows (the server's default)
PAGED_NUM_PAGES = 64          # their pool: a quarter of the 8 x 32 pages of the dense worst case
GQA_SPEC_TICK = 7             # TinyLlama's verify rounds of T 8: 64 query rows a kv head (group 8)
B64_SLOTS = 64                # the wide-batch 7B paths' slots: K3 at M = 64 ("one" form) a step,
B64_MAX_LEN = 512             # M = 256 ("rows") a verify round of 4; a bf16 cache of 17.2 GB
# K3's checked row counts past 32: one CTA (33-64), row blocks (65-512;
# 474 TinyLlama's last fused M under rama_tpu's VMEM rule)
FFN_CHECK_M = (33, 40, 64, 65, 100, 128, 256, 474, 512)
FFN_TIME_M = (1, 8, 32, 64, 128, 256)   # K3's timed M at 7B (TinyLlama: 64, 512)
# (rep, T) of kernels_gqa: 8 / 16 / 32 / 64 query rows a kv head, 9 (a
# partial m16 block), 16 (a decode step) and 128 (two row groups of 64)
GQA_FORMS = ((8, 1), (8, 2), (8, 4), (8, 8), (3, 3), (16, 1), (16, 8))

# The six main paths: their weight bits, phases (model check or None, main
# path, profile or None), the server's engine settings, the kernels each
# must launch, with the key of the kernels record that takes each one's
# count ("launches" on the path of the kernel's own weights or cache; the
# int4 path also runs the int8 classifier's GEMV and the attention kernels,
# the other paths the int8 matmul / FFN and the prefill attention), and the
# kernels it must not launch (their count goes to the record too).
# `after`: phases run on the path's params once its launches are read
INT8_PATH = dict(label="int8", bits=8, phases=("model", "generate", "serve", "profile"),
                 serve={}, after=("profile_prefill", "model_s16"),
                 record={"quant_matmul": "launches", "ffn": "launches",
                         "decode_attention": "launches", "prefill_attention": "launches",
                         "quant_matmul_mma": "launches"},
                 forbid={})
# K6 on the int8 KV path: every decode step's rows are written by the K7
# walk launch that attends to them (`write_kv_rows_q8_fused`, K6's record;
# `equal`: every K7 launch carries rows), never by K6's own launch
KV8_PATH = dict(label="int8 KV", bits=8, phases=("model_kv8", "serve_kv8", "profile_kv8"),
                serve=dict(max_seq_len=KV8_MAX_LEN, kv_quant="int8"),
                record={"write_kv_rows_q8_fused": "launches", "decode_attention_q8": "launches",
                        "write_kv_strips_q8": "launches",
                        "quant_matmul": "launches_kv8_path", "ffn": "launches_kv8_path",
                        "prefill_attention": "launches_kv8_path"},
                forbid={"decode_attention": "launches_kv8_path",
                        "write_kv_rows_q8": "standalone_launches"},
                equal={"write_kv_rows_q8_fused": "decode_attention_q8"})
# the int8 KV path again in a fresh process after Engine.warmup, its kernels
# built by this run and loaded from a new compile_cache directory: the same
# kernels, each launch counted from the end of the warmup on
WARMUP_PATH = dict(label="int8 KV after warmup", bits=8, phases=(None, "serve_warmup", None),
                   serve=KV8_PATH["serve"], warmup=64,
                   record={name: "launches_warmup_path" for name in KV8_PATH["record"]},
                   forbid={name: "launches_warmup_path" for name in KV8_PATH["forbid"]},
                   equal=dict(KV8_PATH["equal"]))
SPEC_PATH = dict(label="speculation", bits=8,
                 phases=("model_spec", "serve_spec", "profile_spec"),
                 serve=dict(spec_tick=SPEC_TICK),
                 record={"chunk_attention": "launches", "quant_matmul": "launches_spec_path",
                         "ffn": "launches_spec_path", "prefill_attention": "launches_spec_path",
                         "quant_matmul_mma": "launches_spec_path"},
                 forbid={"decode_attention": "launches_spec_path"})
SPEC_DRAFT_PATH = dict(label="draft speculation", bits=8,
                       phases=(None, "spec_draft", "spec_draft_ab"),
                       serve={},
                       record={"chunk_attention": "launches_spec_draft_path",
                               "decode_attention": "launches_spec_draft_path",
                               "quant_matmul": "launches_spec_draft_path",
                               "ffn": "launches_spec_draft_path",
                               "prefill_attention": "launches_spec_draft_path"},
                       forbid={})
# K11 / K13 (a) on the int8 paths: every verify round's (and paged step's)
# rows are written by the walk launch that attends to them
# (`write_kv_*_q8_fused`: that launch's count, which goes to the K11 / K13
# (a) record, RECORD_OF; `equal`: every walk launch of the path carries
# rows); the standalone writers never launch there (their count goes to the
# record's `standalone_launches`)
SPEC_KV8_PATH = dict(label="speculation int8 KV", bits=8, phases=(None, "serve_spec_kv8", None),
                     serve=dict(spec_tick=SPEC_TICK, max_seq_len=KV8_MAX_LEN, kv_quant="int8"),
                     record={"chunk_attention_q8": "launches",
                             "write_kv_chunk_q8_fused": "launches",
                             "write_kv_strips_q8": "launches_spec_kv8_path",
                             "quant_matmul": "launches_spec_kv8_path",
                             "ffn": "launches_spec_kv8_path",
                             "prefill_attention": "launches_spec_kv8_path"},
                     forbid={"decode_attention": "launches_spec_kv8_path",
                             "write_kv_chunk_q8": "standalone_launches"},
                     equal={"write_kv_chunk_q8_fused": "chunk_attention_q8"})
# the paged paths: 8 slots at max_len 4096 on a pool of PAGED_NUM_PAGES
# pages of PAGE_SIZE rows (K12 / K13 where the dense paths run K4, K7,
# K10, K6, K8, K11; write_kv_paged_q8 is one kernel and one count for the
# decode rows and the verification chunks; K13 (b) on its streaming body,
# never the warp-a-row one: `write_kv_prefill_paged_q8_rows` forbidden)
PAGED_SERVE = dict(max_seq_len=KV8_MAX_LEN, paged=True)
PAGED_PATH = dict(label="paged", bits=8, phases=("model_paged", "serve_paged", "profile_paged"),
                  serve=PAGED_SERVE,
                  record={"paged_decode_attention": "launches",
                          "quant_matmul": "launches_paged_path", "ffn": "launches_paged_path",
                          "prefill_attention": "launches_paged_path"},
                  forbid={"decode_attention": "launches_paged_path",
                          "chunk_attention": "launches_paged_path"})
PAGED_KV8_PATH = dict(label="paged int8 KV", bits=8, phases=(None, "serve_paged_kv8", None),
                      serve=dict(PAGED_SERVE, kv_quant="int8"),
                      record={"paged_decode_attention_q8": "launches",
                              "write_kv_paged_q8_fused": "launches",
                              "write_kv_prefill_paged_q8": "launches",
                              "quant_matmul": "launches_paged_kv8_path",
                              "ffn": "launches_paged_kv8_path",
                              "prefill_attention": "launches_paged_kv8_path"},
                      forbid={"write_kv_paged_q8": "standalone_launches",
                              "write_kv_prefill_paged_q8_rows": "rows_body_launches",
                              **{name: "launches_paged_kv8_path" for name in (
                                  "write_kv_rows_q8", "decode_attention_q8", "write_kv_strips_q8",
                                  "decode_attention")}},
                      equal={"write_kv_paged_q8_fused": "paged_decode_attention_q8"})
SPEC_PAGED_PATH = dict(label="paged speculation", bits=8, phases=(None, "serve_spec_paged", None),
                       serve=dict(PAGED_SERVE, spec_tick=SPEC_TICK),
                       record={"paged_chunk_attention": "launches",
                               "quant_matmul": "launches_spec_paged_path",
                               "ffn": "launches_spec_paged_path",
                               "prefill_attention": "launches_spec_paged_path"},
                       forbid={name: "launches_spec_paged_path" for name in (
                           "decode_attention", "chunk_attention", "paged_decode_attention")})
SPEC_PAGED_KV8_PATH = dict(
    label="paged speculation int8 KV", bits=8, phases=(None, "serve_spec_paged_kv8", None),
    serve=dict(PAGED_SERVE, spec_tick=SPEC_TICK, kv_quant="int8"),
    record={"paged_chunk_attention_q8": "launches",
            **{name: "launches_spec_paged_kv8_path" for name in (
                "write_kv_paged_q8_fused", "write_kv_prefill_paged_q8", "quant_matmul", "ffn",
                "prefill_attention")}},
    forbid={"write_kv_paged_q8": "standalone_launches_spec_paged_kv8_path",
            "write_kv_prefill_paged_q8_rows": "rows_body_launches",
            **{name: "launches_spec_paged_kv8_path" for name in (
                "decode_attention_q8", "chunk_attention_q8", "write_kv_chunk_q8",
                "write_kv_strips_q8", "decode_attention", "chunk_attention",
                "paged_decode_attention_q8")}},
    equal={"write_kv_paged_q8_fused": "paged_chunk_attention_q8"})
# the pipelined loop (serve_pipe): the int8 KV cache's plain ticks (K7 with
# K6's rows), its n-gram verify rounds (K10 with K11's rows) and the paged
# int8 pool's steps (K12 with K13 (a)'s rows), each engine's admissions
# through K8 or K13 (b), every tick chained or dispatched behind another
PIPE_SERVE = dict(max_batch_size=8, max_seq_len=KV8_MAX_LEN, decode_tick=8, kv_quant="int8",
                  spec_mode="ngram", spec_min_accept=0.0)
PIPE_ENGINES = (("plain", {}), ("spec", dict(spec_tick=SPEC_TICK)),
                ("paged", dict(paged_kv=True, kv_page_size=PAGE_SIZE,
                               kv_num_pages=PAGED_NUM_PAGES)))
PIPE_TURNS = (1, 3, 3, 1)     # _PIPELINE_DEPTH of the timed runs, in ABBA turns
PIPE_STEPS = 32
PIPE_PATH = dict(label="pipelined loop", bits=8, phases=(None, "serve_pipe", None), serve={},
                 record={name: "launches_pipe_path" for name in (
                     "decode_attention_q8", "write_kv_rows_q8_fused", "chunk_attention_q8",
                     "write_kv_chunk_q8_fused", "paged_decode_attention_q8",
                     "write_kv_paged_q8_fused", "write_kv_strips_q8",
                     "write_kv_prefill_paged_q8", "quant_matmul", "ffn", "prefill_attention",
                     "quant_matmul_mma")},
                 forbid={"write_kv_rows_q8": "standalone_launches_pipe_path",
                         "write_kv_chunk_q8": "standalone_launches_pipe_path",
                         "write_kv_paged_q8": "standalone_launches_pipe_path",
                         "write_kv_prefill_paged_q8_rows": "rows_body_launches_pipe_path",
                         **{name: "launches_pipe_path" for name in (
                             "decode_attention", "chunk_attention", "paged_decode_attention",
                             "paged_chunk_attention_q8")}},
                 equal={"write_kv_rows_q8_fused": "decode_attention_q8",
                        "write_kv_chunk_q8_fused": "chunk_attention_q8",
                        "write_kv_paged_q8_fused": "paged_decode_attention_q8"})
# chunked prefill (serve_chunk): a bf16 dense cache's ticks (K4), an int8
# cache's (K7 with K6's rows) and an int8 pool's (K12 with K13 (a)'s), the
# short prompts admitted directly (K5; K8 / K13 (b)), the long ones by K5 in
# the direct runs and by chunk jobs in the chunked ones (the masked
# attention in plain PyTorch, the job's strips through K8 / K13 (b) or a
# copy), the GEMM for every chunk; no chunk attention (no speculation)
CHUNK_SERVE = dict(max_batch_size=8, max_seq_len=KV8_MAX_LEN, decode_tick=8)
CHUNK_ENGINES = (("bf16", {}), ("int8", dict(kv_quant="int8")),
                 ("paged", dict(kv_quant="int8", paged_kv=True, kv_page_size=PAGE_SIZE,
                                kv_num_pages=PAGED_NUM_PAGES)))
CHUNK_MODE = dict(prefill_chunk=256, prefill_chunk_min=1024)
CHUNK_TURNS = (False, True, True, False)    # chunked off / on in ABBA turns
CHUNK_SHORT = ("Once upon a time", "The little dog ran", "In a far away land",
               "She opened the door", "Tom and Lily played", "The sun was hot")
CHUNK_SHORT_STEPS, CHUNK_LONG_STEPS = 64, 32
CHUNK_LONG = (3000, 1500)   # the long prompts' tokens (BOS not counted)
CHUNK_PATH = dict(label="chunked prefill", bits=8, phases=(None, "serve_chunk", "profile_chunk"),
                  serve={},
                  record={name: "launches_chunk_path" for name in (
                      "decode_attention", "decode_attention_q8", "write_kv_rows_q8_fused",
                      "paged_decode_attention_q8", "write_kv_paged_q8_fused",
                      "write_kv_strips_q8", "write_kv_prefill_paged_q8", "quant_matmul",
                      "quant_matmul_mma", "ffn", "prefill_attention")},
                  forbid={"write_kv_rows_q8": "standalone_launches_chunk_path",
                          "write_kv_paged_q8": "standalone_launches_chunk_path",
                          "write_kv_prefill_paged_q8_rows": "rows_body_launches_chunk_path",
                          **{name: "launches_chunk_path" for name in (
                              "chunk_attention", "chunk_attention_q8", "paged_decode_attention",
                              "paged_chunk_attention", "paged_chunk_attention_q8")}},
                  equal={"write_kv_rows_q8_fused": "decode_attention_q8",
                         "write_kv_paged_q8_fused": "paged_decode_attention_q8"})
# the chat loop: each turn's template prefilled mid-sequence (the masked
# attention, the matmuls at M = its bucket), then decode steps (K1 / K3 / K4)
CHAT_SYSTEM = ("You are a helpful assistant who tells short stories to small children, "
               "always kind and always brief.")
CHAT_TURNS = ("Tell me a story about a dog.", "What was the dog's name?",
              "Now tell me one about a cat.")
CHAT_PATH = dict(label="chat", bits=8, phases=(None, "chat", None), serve={},
                 record={name: "launches_chat_path" for name in (
                     "quant_matmul", "ffn", "decode_attention")},
                 forbid={name: "launches_chat_path" for name in (
                     "prefill_attention", "chunk_attention", "decode_attention_q8")})
# eval: batches of 4 windows of 512 prefilled from position 0 with full
# logits: K5, every product on the GEMM (M = 2048), the FFN split
EVAL_WINDOW, EVAL_BATCH, EVAL_TOKENS = 512, 4, 4000
# the nll's rel gap, kernels against plain: 4.68e-5 measured at 7B int8 on
# the H100; logits all equal (a dead kernel) score ln(32000), 3.1e-2 away
EVAL_NLL_GAP = 1e-3
EVAL_PATH = dict(label="eval", bits=8, phases=(None, "eval", None), serve={}, mmv=False,
                 record={name: "launches_eval_path" for name in (
                     "quant_matmul", "quant_matmul_mma", "prefill_attention")},
                 forbid={name: "launches_eval_path" for name in (
                     "quant_matmul_mmv", "ffn", "decode_attention")})
# the fused attention block (kernel 14) under RAMA_ATTN_BLOCK 1 / 2 on the
# int8 params, and 2 on the int4 ones (`attn_block`: the mode the path runs
# under): K14 where the default path runs the RoPE, the row write and K4, 32
# launches a decode step as the fused FFN has (`equal`), and K4 never
AB1_PATH = dict(label="attention block 1", bits=8, phases=("model_attn", "serve_ab1", None),
                serve={}, attn_block=1,
                record={"attn_rope_write_layered": "launches",
                        **{name: "launches_ab1_path" for name in (
                            "quant_matmul", "ffn", "prefill_attention")}},
                forbid={name: "launches_ab1_path" for name in (
                    "decode_attention", "attn_block_layered", "attn_block_gqa")},
                equal={"attn_rope_write_layered": "ffn"})
AB2_PATH = dict(label="attention block 2", bits=8, phases=(None, "serve_ab2", "profile_ab"),
                serve={}, attn_block=2,
                record={"attn_block_layered": "launches",
                        **{name: "launches_ab2_path" for name in (
                            "quant_matmul", "ffn", "prefill_attention")}},
                forbid={name: "launches_ab2_path" for name in (
                    "decode_attention", "attn_rope_write_layered", "attn_block_gqa")},
                equal={"attn_block_layered": "ffn"})
# kernel 9: the generic layer at T = 1 (prefill of a one-token prompt,
# forward with logit_rows) through the library entry points, the plain
# T = 1 attention made to raise
PREFILL_T1_PATH = dict(label="T = 1 prefill", bits=8, phases=(None, "prefill_t1", None),
                       serve={},
                       record={"decode_attention_flat": "launches",
                               "decode_attention_flat_q8": "launches",
                               "quant_matmul": "launches_prefill_t1_path"},
                       forbid={name: "launches_prefill_t1_path" for name in (
                           "decode_attention", "decode_attention_q8", "prefill_attention",
                           "chunk_attention")})
AB2_INT4_PATH = dict(label="attention block 2 int4", bits=4,
                     phases=("model_attn", "serve4_ab2", None), serve={}, attn_block=2,
                     record={"attn_block_layered_int4": "launches",
                             **{name: "launches_ab2_int4_path" for name in (
                                 "quant_matmul_int4", "ffn_int4", "quant_matmul",
                                 "prefill_attention")}},
                     forbid={name: "launches_ab2_int4_path" for name in (
                         "decode_attention", "attn_rope_write_layered", "attn_block_layered",
                         "attn_block_gqa")},
                     equal={"attn_block_layered_int4": "ffn_int4"})
# Llama-2-7B int8 at 64 slots (max_len 512): every decode step runs K3 at M
# = 64 on its "one" form, once a layer of the step (`equal`: as many as the
# T = 1 attention's launches), and no step the split w13 / w2 route; under
# n-gram speculation at spec_tick 3 every verify round runs K3 at M = 256
# on its "rows" form (4 row blocks), once a layer of the round. `mmv`
# False: no product of these paths need run at M <= 32 (the admissions'
# last-row logits do only where fewer than 33 requests arrive together)
B64_SERVE = dict(max_seq_len=B64_MAX_LEN, slots=B64_SLOTS)
B64_PATH = dict(label="64 slots", bits=8, phases=("model_b64", "serve_b64", "profile_b64"),
                serve=B64_SERVE, mmv=False,
                record={name: "launches_b64_path" for name in (
                    "ffn", "ffn_one", "quant_matmul", "quant_matmul_mma", "decode_attention",
                    "prefill_attention")},
                forbid={name: "launches_b64_path" for name in ("ffn_rows", "chunk_attention")},
                equal={"ffn_one": "decode_attention"})
B64_SPEC_PATH = dict(label="64 slots speculation T 4", bits=8,
                     phases=(None, "serve_b64_spec", None),
                     serve=dict(B64_SERVE, spec_tick=SPEC_TICK), mmv=False,
                     record={name: "launches_b64_spec_path" for name in (
                         "ffn", "ffn_rows", "quant_matmul", "quant_matmul_mma",
                         "chunk_attention", "prefill_attention")},
                     forbid={name: "launches_b64_spec_path" for name in ("decode_attention",)},
                     equal={"ffn_rows": "chunk_attention", "ffn_one": "decode_attention"})
INT4_PATH = dict(label="int4", bits=4, phases=("model4", "serve4", "profile4"),
                 serve={},
                 record={"quant_matmul_int4": "launches", "ffn_int4": "launches",
                         "quant_matmul": "launches_int4_path",
                         "decode_attention": "launches_int4_path",
                         "prefill_attention": "launches_int4_path",
                         "quant_matmul_mma": "launches_int4_path"},
                 forbid={})
# the int4 server with bf16-stored weight scales (EngineConfig.scale_dtype):
# every K1 / K2 / K3 launch of the path must read bf16 scales (`scales`),
# and every launch of the other paths f32 ones (check_launches)
INT4_S16_PATH = dict(label="int4 bf16 scales", bits=4, scales="bf16",
                     phases=("model4_s16", "serve4_s16", "profile4_s16"),
                     serve=dict(scale_dtype="bf16"),
                     record={"quant_matmul_scale_bf16": "launches",
                             "ffn_scale_bf16": "launches",
                             **{name: "launches_s16_path" for name in (
                                 "quant_matmul_int4", "ffn_int4", "quant_matmul",
                                 "decode_attention", "prefill_attention",
                                 "quant_matmul_mma")}},
                     forbid={})
# TinyLlama-1.1B (`model`: its params, GQA group 8, head_dim 64) at its
# full width: plain decoding; n-gram speculation at spec_tick 7 (verify
# rounds of T 8: 64 query rows a kv head, M = 64 rows of the weight
# products: the GEMM for wqkv / wo / lm_head, K3's "one" form for the FFN,
# one launch a layer of every round: `equal`) on the bf16 cache, at
# spec_tick 3 (32 rows, M = 32: K3) on the int8 cache and at 7 on an int8
# page pool; the target as its own draft at 7. `equal`: every chunk launch
# of the path ran a form of more than 8 rows (the `*_gqa` records count
# those by form)
GQA_SERVE = dict(max_seq_len=2048)
GQA_PATH = dict(label="TinyLlama int8", model="tinyllama", bits=8,
                phases=("model_gqa", "serve_gqa", None), serve=GQA_SERVE,
                record={name: "launches_gqa_path" for name in (
                    "decode_attention", "quant_matmul", "ffn", "prefill_attention",
                    "quant_matmul_mma")},
                forbid={"chunk_attention": "launches_gqa_path"})
GQA_SPEC_PATH = dict(label="TinyLlama speculation T 8", model="tinyllama", bits=8,
                     phases=(None, "serve_gqa_spec", "profile_gqa_spec"),
                     serve=dict(GQA_SERVE, spec_tick=GQA_SPEC_TICK),
                     record={"chunk_attention_gqa": "launches",
                             **{name: "launches_gqa_spec_path" for name in (
                                 "chunk_attention", "quant_matmul", "prefill_attention",
                                 "quant_matmul_mma", "ffn", "ffn_one")}},
                     forbid={name: "launches_gqa_spec_path" for name in (
                         "decode_attention", "chunk_attention_q8", "ffn_rows")},
                     equal={"chunk_attention_gqa": "chunk_attention",
                            "ffn_one": "chunk_attention"})
GQA_SPEC_KV8_PATH = dict(label="TinyLlama speculation T 4 int8 KV", model="tinyllama", bits=8,
                         phases=(None, "serve_gqa_spec_kv8", None),
                         serve=dict(GQA_SERVE, spec_tick=SPEC_TICK, kv_quant="int8"),
                         record={"chunk_attention_q8_gqa": "launches",
                                 **{name: "launches_gqa_spec_kv8_path" for name in (
                                     "chunk_attention_q8", "write_kv_chunk_q8_fused",
                                     "write_kv_strips_q8", "quant_matmul", "ffn",
                                     "prefill_attention")}},
                         forbid={"write_kv_chunk_q8": "standalone_launches_gqa_spec_kv8_path",
                                 **{name: "launches_gqa_spec_kv8_path" for name in (
                                     "decode_attention", "decode_attention_q8",
                                     "chunk_attention")}},
                         equal={"chunk_attention_q8_gqa": "chunk_attention_q8",
                                "write_kv_chunk_q8_fused": "chunk_attention_q8"})
GQA_SPEC_PAGED_KV8_PATH = dict(
    label="TinyLlama paged speculation T 8 int8 KV", model="tinyllama", bits=8,
    phases=(None, "serve_gqa_spec_paged_kv8", None),
    serve=dict(GQA_SERVE, paged=True, spec_tick=GQA_SPEC_TICK, kv_quant="int8"),
    record={"paged_chunk_attention_q8_gqa": "launches",
            **{name: "launches_gqa_spec_paged_kv8_path" for name in (
                "paged_chunk_attention_q8", "write_kv_paged_q8_fused",
                "write_kv_prefill_paged_q8", "quant_matmul", "prefill_attention",
                "quant_matmul_mma", "ffn", "ffn_one")}},
    forbid={"write_kv_paged_q8": "standalone_launches_gqa_spec_paged_kv8_path",
            "write_kv_prefill_paged_q8_rows": "rows_body_launches",
            **{name: "launches_gqa_spec_paged_kv8_path" for name in (
                "decode_attention_q8", "chunk_attention_q8", "write_kv_chunk_q8",
                "write_kv_strips_q8", "paged_decode_attention_q8", "ffn_rows")}},
    equal={"paged_chunk_attention_q8_gqa": "paged_chunk_attention_q8",
           "ffn_one": "paged_chunk_attention_q8",
           "write_kv_paged_q8_fused": "paged_chunk_attention_q8"})
GQA_SELF_PATH = dict(label="TinyLlama as its own draft", model="tinyllama", bits=8,
                     phases=(None, "spec_gqa_self", None), serve={},
                     record={name: "launches_gqa_self_path" for name in (
                         "chunk_attention_gqa", "chunk_attention", "decode_attention",
                         "quant_matmul", "ffn", "prefill_attention")},
                     forbid={},
                     equal={"chunk_attention_gqa": "chunk_attention"})
# Yi-34B (`model`: its params, GQA group 7, head_dim 128) at its full
# width: plain decoding on a bf16 cache, an int8 cache, n-gram speculation
# at spec_tick 3 (28 query rows a kv head: the 32-row chunk form) and the
# fused attention block in mode 2 (K14 at rep 7). `equal`: every K5 launch
# of the path ran its "gqa" form (no 7B or TinyLlama K5 launch may)
YI_SERVE = dict(max_seq_len=2048)
YI_K5 = ("prefill_attention_gqa", "prefill_attention")
YI_PATH = dict(label="Yi-34B int8", model="yi", bits=8,
               phases=("model_yi", "serve_yi", "profile_prefill_yi"), serve=YI_SERVE,
               record={"prefill_attention_gqa": "launches",
                       **{name: "launches_yi_path" for name in (
                           "prefill_attention", "decode_attention", "quant_matmul", "ffn",
                           "quant_matmul_mma")}},
               forbid={"chunk_attention": "launches_yi_path"},
               equal=dict([YI_K5]))
YI_KV8_PATH = dict(label="Yi-34B int8 KV", model="yi", bits=8,
                   phases=(None, "serve_yi_kv8", None),
                   serve=dict(YI_SERVE, kv_quant="int8"),
                   record={name: "launches_yi_kv8_path" for name in (
                       "prefill_attention_gqa", "prefill_attention", "write_kv_rows_q8_fused",
                       "decode_attention_q8", "write_kv_strips_q8", "quant_matmul", "ffn")},
                   forbid={"decode_attention": "launches_yi_kv8_path",
                           "write_kv_rows_q8": "standalone_launches_yi_kv8_path"},
                   equal=dict([YI_K5, ("write_kv_rows_q8_fused", "decode_attention_q8")]))
YI_SPEC_PATH = dict(label="Yi-34B speculation T 4", model="yi", bits=8,
                    phases=(None, "serve_yi_spec", None),
                    serve=dict(YI_SERVE, spec_tick=SPEC_TICK),
                    record={name: "launches_yi_spec_path" for name in (
                        "prefill_attention_gqa", "prefill_attention", "chunk_attention_gqa",
                        "chunk_attention", "quant_matmul", "ffn")},
                    forbid={name: "launches_yi_spec_path" for name in (
                        "decode_attention", "chunk_attention_q8")},
                    equal=dict([YI_K5, ("chunk_attention_gqa", "chunk_attention")]))
YI_AB2_PATH = dict(label="Yi-34B attention block 2", model="yi", bits=8,
                   phases=(None, "serve_yi_ab2", None), serve=YI_SERVE, attn_block=2,
                   record={name: "launches_yi_ab2_path" for name in (
                       "prefill_attention_gqa", "prefill_attention", "attn_block_layered",
                       "quant_matmul", "ffn")},
                   forbid={name: "launches_yi_ab2_path" for name in (
                       "decode_attention", "attn_rope_write_layered", "attn_block_gqa")},
                   equal=dict([YI_K5, ("attn_block_layered", "ffn")]))
# Mistral-Large-Instruct-2407 (`model`: its params, GQA group 12, head_dim
# 128, int4 layers at gs 64, f32 scales) at its full width and depth, 8
# slots at max_len 512: plain decoding (K4 in its 16-row form on every
# decode step: `equal`, and K5's "gqa" form), and the fused attention
# block in modes 1 and 2 (K14 once a layer of every decode step, as K3,
# every launch in the 16-row form: attn_block_gqa counts K14's launches in
# a form of more than 8 rows; K4 never)
ML_MAX_LEN = 512
ML_SERVE = dict(max_seq_len=ML_MAX_LEN)
ML_PATH = dict(label="Mistral-Large int4", model="ml", bits=4,
               phases=("model_ml", "serve_ml", None), serve=ML_SERVE,
               record={name: "launches_ml_path" for name in (
                   "prefill_attention_gqa", "prefill_attention", "decode_attention",
                   "decode_attention_mma_rows16", "quant_matmul_int4", "quant_matmul",
                   "ffn_int4")},
               forbid={name: "launches_ml_path" for name in (
                   "chunk_attention", "decode_attention_flat", "decode_attention_mma_rows8",
                   "attn_rope_write_layered", "attn_block_layered_int4", "attn_block_gqa")},
               equal=dict([YI_K5, ("decode_attention_mma_rows16", "decode_attention"),
                           ("decode_attention", "ffn_int4")]))
ML_AB1_PATH = dict(label="Mistral-Large int4 attention block 1", model="ml", bits=4,
                   phases=(None, "serve_ml_ab1", None), serve=ML_SERVE, attn_block=1,
                   record={name: "launches_ml_ab1_path" for name in (
                       "prefill_attention_gqa", "prefill_attention", "attn_rope_write_layered",
                       "attn_block_gqa", "quant_matmul_int4", "quant_matmul", "ffn_int4")},
                   forbid={name: "launches_ml_ab1_path" for name in (
                       "decode_attention", "attn_block_layered_int4", "attn_block_simt")},
                   equal=dict([YI_K5, ("attn_rope_write_layered", "ffn_int4"),
                               ("attn_block_gqa", "attn_rope_write_layered"),
                               ("attn_block_mma_rows16", "attn_rope_write_layered")]))
ML_AB2_PATH = dict(label="Mistral-Large int4 attention block 2", model="ml", bits=4,
                   phases=(None, "serve_ml_ab2", "profile_ml_ab"), serve=ML_SERVE,
                   attn_block=2,
                   record={"attn_block_gqa": "launches",
                           **{name: "launches_ml_ab2_path" for name in (
                               "prefill_attention_gqa", "prefill_attention",
                               "attn_block_layered_int4", "quant_matmul_int4", "quant_matmul",
                               "ffn_int4")}},
                   forbid={name: "launches_ml_ab2_path" for name in (
                       "decode_attention", "attn_rope_write_layered", "attn_block_simt")},
                   equal=dict([YI_K5, ("attn_block_layered_int4", "ffn_int4"),
                               ("attn_block_gqa", "attn_block_layered_int4"),
                               ("attn_block_mma_rows16", "attn_block_layered_int4")]))
PATHS = (INT8_PATH, KV8_PATH, WARMUP_PATH, SPEC_PATH, SPEC_DRAFT_PATH, SPEC_KV8_PATH, PAGED_PATH,
         PAGED_KV8_PATH, SPEC_PAGED_PATH, SPEC_PAGED_KV8_PATH, PIPE_PATH, CHUNK_PATH, CHAT_PATH,
         EVAL_PATH, AB1_PATH, AB2_PATH,
         PREFILL_T1_PATH, B64_PATH, B64_SPEC_PATH, INT4_PATH, INT4_S16_PATH, AB2_INT4_PATH,
         GQA_PATH, GQA_SPEC_PATH,
         GQA_SPEC_KV8_PATH, GQA_SPEC_PAGED_KV8_PATH, GQA_SELF_PATH, YI_PATH, YI_KV8_PATH,
         YI_SPEC_PATH, YI_AB2_PATH, ML_PATH, ML_AB1_PATH, ML_AB2_PATH)
# every path that launches quant_matmul runs its decode-sized products (M
# <= 32: a step, a verify round, a one-token prefill, the prefill's
# last-row logits) on the swap-AB body: that count goes to the
# quant_matmul_mmv record, under the same key
for _path in PATHS:
    if "quant_matmul" in _path["record"] and _path.get("mmv", True):
        _path["record"]["quant_matmul_mmv"] = _path["record"]["quant_matmul"]
    if "write_kv_strips_q8" in _path["record"]:
        for _part in ("record", "forbid", "equal"):
            _path.setdefault(_part, {}).update(K8_STREAM[_part])


def log(msg: str) -> None:
    print(msg, flush=True)


PHASE_S: dict = {}   # wall seconds of each phase this run, in order


@contextlib.contextmanager
def clock(name: str):
    """Log the wall seconds of the phase (or set-up step) `name` run inside,
    and keep them in PHASE_S for the `[phases]` line."""
    t0 = time.time()
    yield
    PHASE_S[name] = round(PHASE_S.get(name, 0.0) + time.time() - t0, 1)
    log(f"[phase] {name} {time.time() - t0:.1f} s")


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


def compare(torch, name: str, got, want, per: int | None = None, bar: float | None = None) -> float:
    """Fail unless every group of `per` consecutive outputs (default: one
    output row) is within TOL of its own max |ref|: a slot, head or row with
    large outputs sets no limit for another. `bar`, a tighter target, is
    logged as met or not and gates nothing. Returns the max |err|."""
    per = per or want.shape[-1]
    got, want = got.float().reshape(-1, per), want.float().reshape(-1, per)
    if not bool(torch.isfinite(got).all()):
        raise SystemExit(f"FAILED {name}: non-finite kernel output")
    err = (got - want).abs().amax(dim=1)
    rel = err / (want.abs().amax(dim=1) + 1e-6)
    worst = int(rel.argmax())
    met = "" if bar is None else f" ({'within' if float(rel[worst]) <= bar else 'OUTSIDE'} "\
                                   f"the {bar:g} bar)"
    log(f"[check] {name}: max_abs_err {float(err.max()):.3e} worst rel "
        f"{float(rel[worst]):.3e} (group {worst} of {rel.numel()} x {per}){met}")
    if float(rel[worst]) > TOL:
        raise SystemExit(f"FAILED {name}: rel err {float(rel[worst]):.4f} > {TOL} "
                         f"in group {worst} of {per} outputs")
    return float(err.max())


def quantized_cache(torch, kvw, rx, l: int, b: int, n: int, s: int, d: int) -> list:
    """(k8, v8, ks, vs) of an int8 cache (l, b, n, s, d) of N(0, 1) rows
    (rx draws them) quantized by kv_quant_rows, a layer at a time."""
    dev = torch.device("cuda")
    c = [torch.empty((l, b, n, s, d), dtype=torch.int8, device=dev) for _ in range(2)] + [
        torch.empty((l, b, n, s), device=dev) for _ in range(2)]
    for i in range(l):
        c[0][i], c[2][i] = kvw.kv_quant_rows(rx(b, n, s, d, dtype=torch.float32))
        c[1][i], c[3][i] = kvw.kv_quant_rows(rx(b, n, s, d, dtype=torch.float32))
    return c


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


def plant_decode_edges_q8(kvw, q, k8, ks, pos, layer: int, rows) -> None:
    """plant_decode_edges on an int8 cache: the planted key rows are q * 0.5
    quantized by kv_quant_rows (the score the same ~ 5.7)."""
    s = k8.shape[3]
    q8, sc = kvw.kv_quant_rows(q * 0.5)              # (B, nh, hd), (B, nh)
    for b, p in enumerate(pos.tolist()):
        for r in {p, p + 1, *rows}:
            if 0 <= r < s:
                k8[layer, b, :, r] = q8[b]
                ks[layer, b, :, r] = sc[b]


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


def chunk_edge_keys(q, pos0, s: int, rows) -> dict:
    """Planted keys for a chunk q (B, T, nh, hd) at chunk starts pos0, as
    {(slot, cache row): key (nh, hd)}: row pos0 + j (j = 0 .. T) gets
    0.5 (q[b, j-1] + q[b, j]) (terms outside the chunk dropped), so query t
    scores ~5.7 (rep 1) both on its last visible row pos0 + t and on the
    first row it must not see, pos0 + t + 1; the split edges `rows` get
    0.5 q[b, 0] unless the chunk's rows take them."""
    t = q.shape[1]
    keys = {}
    for b, p in enumerate(pos0.tolist()):
        for r in rows:
            if 0 <= r < s:
                keys[(b, r)] = q[b, 0] * 0.5
        for j in range(t + 1):
            if 0 <= p + j < s:
                keys[(b, p + j)] = sum(q[b, c] for c in (j - 1, j) if 0 <= c < t) * 0.5
    return keys


def group_key(key, nkv: int):
    """A planted key (nh, hd) of chunk_edge_keys as the key rows of nkv kv
    heads: the key of each GQA group's first query head (rep 1: the key)."""
    return key if key.shape[0] == nkv else key.view(nkv, -1, key.shape[-1])[:, 0]


def plant_chunk_edges(q, cache, pos0, layer: int, rows, kvw=None) -> None:
    """chunk_edge_keys into k of a (k, v) cache, or of an int8 (k8, v8, ks,
    vs) cache, quantized by kvw.kv_quant_rows (group_key: under GQA the
    planted rows score high for each group's first head)."""
    nkv = cache[0].shape[2]
    for (b, r), key in chunk_edge_keys(q, pos0, cache[0].shape[3], rows).items():
        key = group_key(key, nkv)
        if kvw is None:
            cache[0][layer, b, :, r] = key.to(cache[0].dtype)
        else:
            cache[0][layer, b, :, r], cache[2][layer, b, :, r] = kvw.kv_quant_rows(key.float())


def reset_launches(qm, ffn_mod, da, pa, kvw, pga, ab) -> None:
    for counts in (qm.launches, ffn_mod.launches, kvw.launches, pga.launches, ab.launches):
        for key in counts:
            counts[key] = 0
    da.launches = da.launches_q8 = da.launches_chunk = da.launches_chunk_q8 = pa.launches = 0
    da.launches_flat = da.launches_flat_q8 = da.launches_write_q8 = pga.launches_write_q8 = 0
    da.launches_write_rows_q8 = 0
    for bodies in (pa.launches_by_body, pa.launches_by_form, qm.launches_by_body,
                   ffn_mod.launches_by_body, ffn_mod.launches_by_form,
                   da.launches_by_body, pga.launches_by_body, ab.launches_by_body,
                   *ab.launches_by_form.values(),
                   qm.launches_by_scale, ffn_mod.launches_by_scale,
                   *da.launches_by_form.values(), *pga.launches_by_form.values(),
                   kvw.launches_by_body, kvw.strips_launches_by_body):
        for body in bodies:
            bodies[body] = 0


def read_launches(qm, ffn_mod, da, pa, kvw, pga, ab) -> dict:
    """Each kernel's launch count by the name of its kernels record."""
    def wide(by_form: dict, body: str) -> int:
        return sum(n for f, n in by_form[body].items() if f > 8)

    return {"quant_matmul": qm.launches[8], "quant_matmul_int4": qm.launches[4],
            "ffn": ffn_mod.launches[8], "ffn_int4": ffn_mod.launches[4],
            # by the weight scales' stored dtype; the bf16-scale forms' records
            **{f"quant_matmul_scale_{s}": n for s, n in qm.launches_by_scale.items()},
            **{f"ffn_scale_{s}": n for s, n in ffn_mod.launches_by_scale.items()},
            **{f"ffn_{body}": n for body, n in ffn_mod.launches_by_body.items()},
            # by form: "one" (M <= 64, every row in one CTA), "rows" (row blocks)
            **{f"ffn_{form}": n for form, n in ffn_mod.launches_by_form.items()},
            "decode_attention": da.launches, "prefill_attention": pa.launches,
            "prefill_attention_mma": pa.launches_by_body["mma"],
            "prefill_attention_simt": pa.launches_by_body["simt"],
            # K5 launches in the form for a GQA group that does not divide 64
            "prefill_attention_gqa": pa.launches_by_form["gqa"],
            **{f"quant_matmul_{body}": n for body, n in qm.launches_by_body.items()},
            "decode_attention_q8": da.launches_q8, "chunk_attention": da.launches_chunk,
            "chunk_attention_q8": da.launches_chunk_q8,
            "decode_attention_flat": da.launches_flat,
            "decode_attention_flat_q8": da.launches_flat_q8, **kvw.launches, **pga.launches,
            # the walk launches that wrote their chunk's or step's rows (K11 / K6 /
            # K13 (a) fused)
            "write_kv_chunk_q8_fused": da.launches_write_q8,
            "write_kv_rows_q8_fused": da.launches_write_rows_q8,
            "write_kv_paged_q8_fused": pga.launches_write_q8,
            # K8 and K13 (b) by body: "stream" (bf16 at hd 48 / 64 / 128), "rows"
            **{f"write_kv_strips_q8_{b}": n for b, n in kvw.strips_launches_by_body.items()},
            **{f"write_kv_prefill_paged_q8_{b}": n for b, n in kvw.launches_by_body.items()},
            **{f"decode_attention_{body}": n for body, n in da.launches_by_body.items()},
            **{f"paged_attention_{body}": n for body, n in pga.launches_by_body.items()},
            **ab.launches, **{f"attn_block_{body}": n for body, n in ab.launches_by_body.items()},
            # K14 by body and the row form the C entry reports it launched;
            # attn_block_gqa: its launches in a form of more than 8 rows
            **{f"attn_block_{body}_rows{f}": n for body, forms in ab.launches_by_form.items()
               for f, n in forms.items()},
            "attn_block_gqa": wide(ab.launches_by_form, "mma"),
            # by body and the row form the C entry reports it launched; the `*_gqa`
            # records: a wrapper family's launches in a form of more than 8 rows on
            # the bf16 cache's body (mma) or the int8 cache's (walk)
            **{f"{prefix}_{body}_rows{f}": n
               for prefix, mod in (("decode_attention", da), ("paged_attention", pga))
               for body, forms in mod.launches_by_form.items() for f, n in forms.items()},
            "chunk_attention_gqa": wide(da.launches_by_form, "mma"),
            "chunk_attention_q8_gqa": wide(da.launches_by_form, "walk"),
            "paged_chunk_attention_q8_gqa": wide(pga.launches_by_form, "walk")}


def check_launches(path: dict, launches: dict) -> None:
    """Fail a main path on which one of its kernels never launched, on
    which a kernel it must not run did, on which a kernel launched
    another number of times than the kernel `equal` pairs it with (one
    launch a layer of each decode step, as the fused FFN; or, for a `*_gqa`
    record, every launch of its chunk wrapper in a row form of more than 8
    rows), or on which a Llama-2-7B path's decode-attention launch ran
    another row form than the 8-row one, or on which a K5 launch ran the
    form for a group that does not divide 64 though `equal` does not pair
    prefill_attention_gqa with prefill_attention (a path that pairs them
    must run every K5 launch in that form), or on which K5
    ran its SIMT body (every K5 launch of a 7B path, bf16 at hd 128, and of
    the stories draft, bf16 at hd 48, takes the tensor-core body), or on
    which a quant_matmul or ffn launch took the SIMT body (every path runs
    bf16 activations: the tensor-core bodies serve them, the swap-AB one
    at M <= 32 and the GEMM above), or on which a decode-attention launch
    (K4, K7, K9, K10; K12 on the pools: bf16 at hd 128, and the stories
    draft's 48) took the SIMT body or, over an int8 cache, not the walk
    body (its walk launches must equal the _q8 launches), or on which a
    launch of the fused attention block (K14, bf16) took its SIMT body, not
    split tensor-core attention, or on which a quant_matmul or ffn launch
    read weight scales of another stored dtype than the path's (`scales`:
    bf16 on the bf16-scale path, f32 on every other)."""
    want = path.get("scales", "f32")
    other = "bf16" if want == "f32" else "f32"
    mixed = {k: launches[f"{k}_scale_{other}"] for k in ("quant_matmul", "ffn")
             if launches.get(f"{k}_scale_{other}", 0)}
    if mixed:
        raise SystemExit(f"FAILED: on the {path['label']} main path {mixed} launches read "
                         f"{other} weight scales; every K1 / K2 / K3 launch of it must read "
                         f"{want} ones")
    idle = [k for k in path["record"] if launches[k] == 0]
    if idle:
        raise SystemExit(f"FAILED: {idle} never launched on the {path['label']} main path "
                         f"{launches}")
    stray = [k for k in path["forbid"] if launches[k]]
    if stray:
        raise SystemExit(f"FAILED: {stray} launched on the {path['label']} main path "
                         f"{launches}")
    uneven = {k: (launches[k], launches[ref]) for k, ref in path.get("equal", {}).items()
              if launches[k] != launches[ref]}
    if uneven:
        raise SystemExit(f"FAILED: on the {path['label']} main path {uneven} (launches of "
                         f"the kernel, of the kernel it must launch as often as: the fused "
                         f"FFN, once a layer of a decode step; or the chunk wrapper whose "
                         f"every launch must run a row form of more than 8 rows; or K5, every "
                         f"launch of a Yi-34B path in its gqa form; or K3 in its one / rows "
                         f"form, once a layer of every step or verify round: a step or round "
                         f"with fewer took the split w13 / w2 route)")
    if "prefill_attention_gqa" not in path.get("equal", {}) and launches.get(
            "prefill_attention_gqa", 0):
        raise SystemExit(f"FAILED: on the {path['label']} main path "
                         f"{launches['prefill_attention_gqa']} prefill_attention launches ran "
                         f"the form for a GQA group that does not divide 64; only a path "
                         f"whose `equal` pairs prefill_attention_gqa with prefill_attention "
                         f"may run it")
    if "prefill_attention" in path["record"] and launches.get("prefill_attention_simt", 0):
        raise SystemExit(f"FAILED: {launches['prefill_attention_simt']} of "
                         f"{launches['prefill_attention']} prefill_attention launches on the "
                         f"{path['label']} main path took the SIMT body, not the tensor-core one")
    if launches.get("quant_matmul_gemv", 0):
        raise SystemExit(f"FAILED: {launches['quant_matmul_gemv']} quant_matmul launches on the "
                         f"{path['label']} main path took the CUDA-core GEMV, not the swap-AB "
                         f"tensor-core body ({launches['quant_matmul_mmv']} did)")
    if launches.get("quant_matmul_simt", 0):
        raise SystemExit(f"FAILED: {launches['quant_matmul_simt']} quant_matmul launches on the "
                         f"{path['label']} main path took the SIMT body, not the tensor-core "
                         f"GEMM ({launches['quant_matmul_mma']} did)")
    if launches.get("ffn_simt", 0):
        raise SystemExit(f"FAILED: {launches['ffn_simt']} ffn launches on the {path['label']} "
                         f"main path took the SIMT body, not the tensor-core one "
                         f"({launches['ffn_mma']} did)")
    if set(AB_KERNELS) & set(path["record"]) and launches.get("attn_block_simt", 0):
        raise SystemExit(f"FAILED: {launches['attn_block_simt']} attention-block launches on "
                         f"the {path['label']} main path took the SIMT body, not split "
                         f"tensor-core attention ({launches['attn_block_mma']} did)")
    wide = {k: n for k, n in launches.items()
            if k.startswith(("decode_attention_", "paged_attention_")) and "_rows" in k
            and not k.endswith("_rows8") and n}
    if path.get("model", "7b") == "7b" and wide:
        raise SystemExit(f"FAILED: on the {path['label']} main path {wide} decode-attention "
                         f"launches ran a row form of more than 8 rows; every Llama-2-7B "
                         f"launch (rep 1, T <= 8) runs the 8-row form")
    for family, (names, _) in ATTN_FAMILIES.items():
        if not set(names) & set(path["record"]):
            continue
        if launches.get(f"{family}_simt", 0):
            raise SystemExit(f"FAILED: {launches[f'{family}_simt']} {family} launches on the "
                             f"{path['label']} main path took the SIMT body, not the "
                             f"tensor-core one ({launches[f'{family}_mma']} did)")
        q8 = sum(launches.get(n, 0) for n in names if n.endswith("_q8"))
        if f"{family}_walk" in launches and launches[f"{family}_walk"] != q8:
            raise SystemExit(f"FAILED: on the {path['label']} main path {q8} {family} launches "
                             f"over an int8 cache, {launches[f'{family}_walk']} on its walk "
                             f"body")


def final_line(phases, device: dict) -> tuple[dict, int]:
    """The last line and exit code: "ok" only for a run of every phase."""
    skipped = [ph for ph in ALL_PHASES if ph not in phases]
    if skipped:
        return {"ok": False, "skipped_phases": skipped, "device": device}, PARTIAL_RC
    return {"ok": True, "device": device}, 0


def matmul_bytes(w, m: int) -> float:
    """Bytes one quant_matmul call must move: one layer's weight (1 byte a
    value for int8, half for int4) and scales (4 bytes each stored in f32,
    2 in bf16), bf16 x (m, K) and y (m, N)."""
    k, n = w.shape[-2:]
    return (k * n * w.bits / 8 + (k // w.group_size) * n * w.scales.element_size()
            + m * (k + n) * 2)


def check_qm(torch, qm, label: str, x, w, layer) -> float:
    """quant_matmul against its plain version, one launch on the body
    body_for picks (none on another). Returns the max |err|."""
    body = qm.body_for(x.dtype, x.shape[0])
    before = dict(qm.launches_by_body)
    got = qm.quant_matmul(x, w, layer)
    ran = {b: qm.launches_by_body[b] - before[b] for b in before}
    if ran != {b: int(b == body) for b in before}:
        raise SystemExit(f"FAILED quant_matmul {label}: launches by body {ran}, expected one "
                         f"on {body}")
    return compare(torch, f"quant_matmul {label} [{body}]", got,
                   qm.quant_matmul_plain(x, w, layer))


def time_mmv(torch, qm, label: str, w, n_layers: int, rx) -> dict:
    """K1 / K2 on the swap-AB body at M = 1, 8, 16 and 32 (a decode step of
    one and of eight slots, verify rounds of 8 x 2 and 8 x 4): each checked
    on layer 1 (check_qm), then CUDA-event and device ms with the layer
    cycling as in a decode step (a 2-D weight: one layer), beside the bound;
    at M = 16 and 32 also the device ms of the tensor-core GEMM (qmm_mma:
    the same call with MMV_MAX_M lowered to GEMV_MAX_M, the yardstick that
    sets MMV_MAX_M). Returns {M: record}."""
    layered = w.q.dim() == 3
    lay = Layered(n_layers)
    k, n = w.shape[-2:]
    out = {}
    for m in (1, 8, 16, qm.MMV_MAX_M):
        x = rx(m, k)
        err = check_qm(torch, qm, f"{label} M={m}", x, w, 1 if layered else None)

        def kernel():
            return qm.quant_matmul(x, w, lay.next() if layered else None)

        b_ms, b_by = bound_ms(matmul_bytes(w, m), 2 * m * k * n)
        rec = dict(m=m, body=qm.body_for(x.dtype, m), max_abs_err=err,
                   ms=time_ms(torch, kernel), device_ms=device_ms_per_call(torch, kernel),
                   bound_ms=b_ms, bound_by=b_by)
        if m > qm.GEMV_MAX_M:
            saved, qm.MMV_MAX_M = qm.MMV_MAX_M, qm.GEMV_MAX_M
            try:
                before = qm.launches_by_body["mma"]
                rec["mma_device_ms"] = device_ms_per_call(torch, kernel)
                if qm.launches_by_body["mma"] == before:
                    raise SystemExit(f"FAILED quant_matmul {label} M={m}: the GEMM never ran")
            finally:
                qm.MMV_MAX_M = saved
        log(f"[time] quant_matmul {label} M={m} [{rec['body']}]: {rec['ms']:.4f} ms, device "
            f"{rec['device_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{rec['device_ms'] / b_ms:.2f}x)"
            + (f"; qmm_mma device {rec['mma_device_ms']:.4f} ms" if "mma_device_ms" in rec
               else ""))
        out[str(m)] = rec
    return out


def mmv_record(results: dict) -> dict:
    """The kernels record of the swap-AB decode body (its timed shapes
    under "mmv"), made by whichever of the kernels / kernels4 phases runs
    first."""
    return results.setdefault("quant_matmul_mmv", dict(
        name="quant_matmul_mmv", route="cuda", source="rama_tpu_torch/csrc/quant_matmul.cu",
        replaces="rama_tpu/ops/pallas/quant_matmul.py:265", library_ms=None, mmv={}))


def gemm_record(w, m: int, ms: float, device_ms: float, plain_ms: float, dense_ms: float,
                dense_device_ms: float, err: float) -> dict:
    """One timed shape of the tensor-core GEMM: CUDA-event and device ms,
    TFLOP/s on the device time, the bound (one layer's weight bytes and x /
    y once, or 2 M K N bf16 operations), the plain version's ms, and the
    dense yardstick: torch.matmul of x by the layer's weight dequantized to
    bf16 beforehand (2 bytes a weight, no dequantization: a ceiling for the
    math, not the same function, never called by the port)."""
    k, n = w.shape[-2:]
    flops = 2.0 * m * k * n
    b_ms, b_by = bound_ms(matmul_bytes(w, m), flops)
    return dict(m=m, ms=ms, device_ms=device_ms, tflops=flops / device_ms / 1e9,
                bound_ms=b_ms, bound_by=b_by, plain_ms=plain_ms, dense_ms=dense_ms,
                dense_device_ms=dense_device_ms, max_abs_err=err)


def time_gemm(torch, qm, label: str, x, w, n_layers: int) -> dict:
    """Check the tensor-core GEMM against its plain version on layer 1 (one
    launch, on the mma body), then time it with the layer cycling, beside
    the plain version and the dense yardstick (gemm_record)."""
    from rama_tpu_torch.ops.kernels.quant_matmul import layer_of
    from rama_tpu_torch.ops.quant import dequantize

    m = x.shape[0]
    before = dict(qm.launches_by_body)
    got = qm.quant_matmul(x, w, 1)
    ran = {b: qm.launches_by_body[b] - before[b] for b in before}
    if ran != {b: int(b == "mma") for b in before}:
        raise SystemExit(f"FAILED quant_matmul {label}: launches by body {ran}, expected one "
                         f"on mma")
    err = compare(torch, f"quant_matmul {label} [mma]", got, qm.quant_matmul_plain(x, w, 1))
    del got
    lay = Layered(n_layers)

    def kernel():
        return qm.quant_matmul(x, w, lay.next())

    wd = dequantize(layer_of(w, 1), dtype=torch.bfloat16)

    def dense():
        return torch.matmul(x, wd)

    rec = gemm_record(w, m, time_ms(torch, kernel), device_ms_per_call(torch, kernel),
                      time_ms(torch, lambda: qm.quant_matmul_plain(x, w, lay.next()), reps=3,
                              warmup=1),
                      time_ms(torch, dense), device_ms_per_call(torch, dense), err)
    log(f"[time] quant_matmul {label} [mma]: {rec['ms']:.4f} ms, device {rec['device_ms']:.4f} "
        f"ms ({rec['tflops']:.1f} TFLOP/s), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
        f"plain {rec['plain_ms']:.4f} ms; dense bf16 yardstick {rec['dense_ms']:.4f} ms, device "
        f"{rec['dense_device_ms']:.4f} ms")
    return rec


def mma_record(results: dict) -> dict:
    """The kernels record of the tensor-core GEMM (its timed shapes under
    "gemm"), made by whichever of the kernels / kernels4 phases runs first."""
    return results.setdefault("quant_matmul_mma", dict(
        name="quant_matmul_mma", route="cuda", source="rama_tpu_torch/csrc/quant_matmul.cu",
        replaces="rama_tpu/ops/pallas/quant_matmul.py:265", library_ms=None, gemm={}))


def ffn_bytes(w13, w2, m: int) -> float:
    """Bytes one ffn call must move: w13 and w2 of one layer with their
    scales, x (m, K) in and y (m, N) out in bf16 (h stays on the chip in
    the Pallas kernel, so its round trip is not counted)."""
    h = w2.k_dim
    return matmul_bytes(w13, m) + matmul_bytes(w2, m) - m * 2 * h * 2 - m * h * 2


def check_ffn(torch, ffn_mod, label: str, x, w13, w2, layer: int) -> float:
    """K3 against its plain version, one launch on the body body_for picks
    (none on the other). Returns the max |err|."""
    body = ffn_mod.body_for(x.dtype, x.shape[0])
    before = dict(ffn_mod.launches_by_body)
    got = ffn_mod.ffn(x, w13, w2, layer)
    ran = {b: ffn_mod.launches_by_body[b] - before[b] for b in before}
    if ran != {b: int(b == body) for b in before}:
        raise SystemExit(f"FAILED ffn {label}: launches by body {ran}, expected one on {body}")
    return compare(torch, f"ffn {label} [{body}]", got, ffn_mod.ffn_plain(x, w13, w2, layer))


def check_ffn_any_m(torch, ffn_mod, label: str, w13, w2, rx, layer: int = 1,
                    twin=None) -> dict:
    """K3 past 32 rows, at each M of FFN_CHECK_M: within TOL of ffn_plain
    on both bodies (bf16: one launch on the tensor-core body in the form
    form_for picks, "one" up to 64 rows, "rows" above, by the counts;
    fp32: one on the SIMT GEMVs), every bf16 row bit for bit the same as
    that row computed in calls of 32 rows (the NT 4 form), and, with
    `twin` (the same weights with f32 scales, w13 / w2 bf16-stored), the
    same bits as the twin's call. Returns {"max_abs_err", "fp32_max_abs_err",
    "checked_m"}."""
    k = w13.k_dim
    top = max(FFN_CHECK_M)
    x_all = rx(top, k)
    ref = torch.cat([ffn_mod.ffn(x_all[i:i + 32].contiguous(), w13, w2, layer)
                     for i in range(0, top, 32)])
    errs, errs32 = [], []
    for m in FFN_CHECK_M:
        x = x_all[:m].contiguous()
        form = ffn_mod.form_for(m)
        bodies, forms = dict(ffn_mod.launches_by_body), dict(ffn_mod.launches_by_form)
        got = ffn_mod.ffn(x, w13, w2, layer)
        ran = ({b: ffn_mod.launches_by_body[b] - bodies[b] for b in bodies},
               {f: ffn_mod.launches_by_form[f] - forms[f] for f in forms})
        if ran != ({b: int(b == "mma") for b in bodies}, {f: int(f == form) for f in forms}):
            raise SystemExit(f"FAILED ffn {label} M={m}: launches by body / form {ran}, "
                             f"expected one on mma, {form}")
        errs.append(compare(torch, f"ffn {label} M={m} layer={layer} [mma, {form}]", got,
                            ffn_mod.ffn_plain(x, w13, w2, layer)))
        same = (got == ref[:m]).all(dim=1)
        if not bool(same.all()):
            raise SystemExit(f"FAILED ffn {label} M={m}: rows {torch.nonzero(~same)[:8].tolist()} "
                             f"differ from the same rows computed 32 at a time")
        if twin is not None and not torch.equal(got, ffn_mod.ffn(x, *twin, layer)):
            raise SystemExit(f"FAILED ffn {label} M={m}: bf16 scales differ from the same "
                             f"scales as f32")
        errs32.append(check_ffn(torch, ffn_mod, f"{label} M={m} fp32 layer={layer}",
                                x.float(), w13, w2, layer))
    log(f"[check] ffn {label} M={list(FFN_CHECK_M)}: every row bit for bit as in 32-row "
        f"calls{', and as with f32 scales' if twin is not None else ''}")
    return dict(max_abs_err=max(errs), fp32_max_abs_err=max(errs32),
                checked_m=list(FFN_CHECK_M))


def time_ffn(torch, ffn_mod, qm, label: str, w13, w2, n_layers: int, rx,
             ms=FFN_TIME_M) -> dict:
    """K3 at each M of `ms` with the layer cycling as in a decode step:
    checked against ffn_plain, then CUDA-event and device ms beside the
    bound (ffn_bytes, or 2 M (K 2H + H N) bf16 operations); at M >= 32 also
    the split route through quant_matmul (w13, then split_h13, silu * c,
    bf16, w2: the same function in four or more launches, on the swap-AB
    body at M <= 32 and the GEMM above; the route the model took past M =
    32 before K3 served every M) and, at each M, a dense bf16 yardstick
    (torch.matmul by the layer's w13 and w2 dequantized to bf16 beforehand,
    the same silu * c between: 2 bytes a weight, no dequantization, not the
    same function, never called by the port). Returns {M: record}."""
    import torch.nn.functional as F

    from rama_tpu_torch.ops.kernels.ffn import split_h13
    from rama_tpu_torch.ops.kernels.quant_matmul import layer_of
    from rama_tpu_torch.ops.quant import dequantize

    lay = Layered(n_layers)
    wd13 = dequantize(layer_of(w13, 1), dtype=torch.bfloat16)
    wd2 = dequantize(layer_of(w2, 1), dtype=torch.bfloat16)
    k, h = w13.k_dim, w2.k_dim
    n = w2.q.shape[-1]
    out = {}
    for m in ms:
        x = rx(m, k)

        def kernel():
            return ffn_mod.ffn(x, w13, w2, lay.next())

        def dense():
            a, c = split_h13(torch.matmul(x, wd13), w13)
            return torch.matmul(F.silu(a) * c, wd2)

        def split():
            l = lay.next()
            a, c = split_h13(qm.quant_matmul(x, w13, l), w13)
            return qm.quant_matmul((F.silu(a.float()) * c.float()).to(x.dtype), w2, l)

        err = compare(torch, f"ffn {label} timed inputs M={m}", kernel(),
                      ffn_mod.ffn_plain(x, w13, w2, lay.i))
        b_ms, b_by = bound_ms(ffn_bytes(w13, w2, m), 2 * m * (k * 2 * h + h * n))
        rec = dict(m=m, form=ffn_mod.form_for(m), max_abs_err=err, ms=time_ms(torch, kernel),
                   device_ms=device_ms_per_call(torch, kernel), bound_ms=b_ms, bound_by=b_by,
                   dense_ms=time_ms(torch, dense),
                   dense_device_ms=device_ms_per_call(torch, dense))
        if m >= 32:
            compare(torch, f"ffn {label} split route M={m}", split(),
                    ffn_mod.ffn_plain(x, w13, w2, lay.i))
            rec.update(split_ms=time_ms(torch, split),
                       split_device_ms=device_ms_per_call(torch, split))
        log(f"[time] ffn {label} M={m} [{ffn_mod.body_for(x.dtype, m)}, {rec['form']}]: "
            f"{rec['ms']:.4f} ms, device {rec['device_ms']:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}, {rec['device_ms'] / b_ms:.2f}x)"
            + (f"; split route (quant_matmul w13, silu * c, quant_matmul w2) "
               f"{rec['split_ms']:.4f} ms, device {rec['split_device_ms']:.4f} ms "
               f"(K3 / split {rec['device_ms'] / rec['split_device_ms']:.2f})"
               if "split_ms" in rec else "")
            + f"; dense bf16 yardstick (not the same function) {rec['dense_ms']:.4f} ms, "
              f"device {rec['dense_device_ms']:.4f} ms")
        out[str(m)] = rec
    return out


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


def tinyllama_config(ModelConfig, n_layers: int = 22):
    """TinyLlama-1.1B at its published shape (HF TinyLlama/TinyLlama-1.1B-
    Chat-v1.0, config.json): GQA group 8 (32 heads over 4 kv heads), head_dim
    64; n_layers cuts the depth (the cli phase's 2-layer file)."""
    return ModelConfig(dim=2048, hidden_dim=5632, n_layers=n_layers, n_heads=32, n_kv_heads=4,
                       vocab_size=32000, seq_len=2048, shared_classifier=False)


def yi34b_config(ModelConfig, n_layers: int = 60):
    """Yi-34B at its published shape (HF 01-ai/Yi-34B, config.json:
    LlamaForCausalLM, hidden_size 7168, intermediate_size 20480, 60 layers,
    56 attention heads over 8 kv heads: GQA group 7, head_dim 128; vocab
    64000, max_position_embeddings 4096, rope_theta 5e6, rms_norm_eps 1e-5,
    untied embeddings); n_layers cuts the depth."""
    return ModelConfig(dim=7168, hidden_dim=20480, n_layers=n_layers, n_heads=56,
                       n_kv_heads=8, vocab_size=64000, seq_len=4096, shared_classifier=False,
                       rope_theta=5e6)


def mistral_large_config(ModelConfig, n_layers: int = 88):
    """Mistral-Large-Instruct-2407 at its published shape (HF
    mistralai/Mistral-Large-Instruct-2407, config.json: MistralForCausalLM
    with no sliding window, the Llama architecture -- no biases, RMSNorm,
    SwiGLU, RoPE; hidden_size 12288, intermediate_size 28672, 88 layers, 96
    attention heads over 8 kv heads: GQA group 12, head_dim 128; vocab
    32768, max_position_embeddings 131072, rope_theta 1e6, rms_norm_eps
    1e-5, untied embeddings); n_layers cuts the depth."""
    return ModelConfig(dim=12288, hidden_dim=28672, n_layers=n_layers, n_heads=96,
                       n_kv_heads=8, vocab_size=32768, seq_len=131072, shared_classifier=False,
                       rope_theta=1e6)


def write_wide_tokenizer(src: Path, dst: Path, vocab_size: int, base: int = 32000) -> Path:
    """A llama2.c tokenizer file of vocab_size pieces for a model whose
    vocabulary is wider than the fixture's: the fixture's `base` pieces as
    they are, then made-up pieces "<extra_i>" whose score (-1e30, below the
    encoder's -1e10 floor) keeps them out of every merge. Prompts encode as
    with the fixture, and every id decodes. Returns dst."""
    import struct

    data = src.read_bytes()
    off = 4
    for _ in range(base):
        off += 8 + struct.unpack_from("<i", data, off + 4)[0]
    extra = b"".join(struct.pack("<fi", -1e30, len(p)) + p for p in (
        f"<extra_{i}>".encode() for i in range(vocab_size - base)))
    dst.write_bytes(data[:off] + extra)
    return dst


def random_int4_qt(torch, l, k, n, gs, device, g, il=0):
    """A stacked (l, k, n) int4 weight made on the card: the group size
    quantize_int4 picks for this K, packed bytes whose two nibbles are drawn
    from [-7, 7] (the range quantize_int4 produces, never -8), scales sized
    so the weights act like ~N(0, 1/K) entries. Made a layer at a time into
    the preallocated stacked tensors, so the temporaries are one layer's
    (Mistral-Large's w13 holds 31 GB of packed bytes)."""
    from rama_tpu_torch.ops.quant import QuantizedTensor, pick_int4_group_size

    gs = pick_int4_group_size(k, gs)
    q = torch.empty((l, k // 2, n), dtype=torch.uint8, device=device)
    s = torch.empty((l, k // gs, n), device=device)
    for i in range(l):
        lo, hi = ((torch.randint(0, 15, (k // 2, n), dtype=torch.uint8, device=device,
                                 generator=g) + 9) % 16 for _ in range(2))
        torch.bitwise_or(lo, hi << 4, out=q[i])
        torch.rand((k // gs, n), device=device, generator=g, out=s[i])
        s[i].add_(0.5).div_(INT4_STD * math.sqrt(k))
        del lo, hi
    return QuantizedTensor(q=q.view(torch.int8), scales=s, group_size=gs, bits=4, il=il)


def random_params(torch, cfg, device, bits: int = 8, seed: int = 0, gs: int = 64):
    """Llama-2-7B (or another cfg: TinyLlama-1.1B) int8 or int4 params from
    a seed, generated on the card (quantizing 6.7 B fp32 weights on the
    host would take 27 GB and minutes), in the fused layout (wqkv,
    il-interleaved w13), with an UNTIED
    classifier (a tied one gives logits a self-match term that locks greedy
    decode onto one token). int4 layer weights take quantize_int4's group
    sizes (64 for K = 4096, 16 for w2's K = 11008); the embedding and the
    classifier stay int8, as quantize_params(bits=4) leaves them. Scales are
    sized so the weights act like ~N(0, 1/K) entries."""
    from rama_tpu_torch.models.llama import _rope_tables, phase_a_tile
    from rama_tpu_torch.ops.quant import (QuantizedEmbedding, QuantizedTensor,
                                          pick_int4_group_size)

    g = torch.Generator(device=device).manual_seed(seed)
    L, D, H, V = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size

    def qt(k, n, il=0):
        if bits == 4:
            return random_int4_qt(torch, L, k, n, gs, device, g, il=il)
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
    gs2 = gs if bits == 8 else pick_int4_group_size(H, gs)
    p = {
        "tok_embedding": emb,
        "attn_norm": torch.ones((L, D), dtype=bf, device=device),
        "ffn_norm": torch.ones((L, D), dtype=bf, device=device),
        "final_norm": torch.ones((D,), dtype=bf, device=device),
        "wqkv": qt(D, (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim),
        "w13": qt(D, 2 * H, il=phase_a_tile(H, bits, gs2) or 0),
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
        # ptxas -v: a 'Compiling entry function' line, then the entry's
        # spill line and its 'Used N registers' line, per instantiated kernel
        entry, lines = "?", []
        for ln in (ln.strip() for ln in logs.get(name, "").splitlines()):
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1][:60]
            elif "Used" in ln or ("spill" in ln and not ln.startswith("0 bytes")):
                lines.append(f"{entry}: {ln.removeprefix('ptxas info    : ')}")
        log(f"[ptxas] {name}.cu: {len(lines)} lines")
        for ln in lines:
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
    for m in (1, 8, 32, 128):
        x = rx(m, D)
        for l in (0, L - 1):
            check_qm(torch, qm, f"wqkv M={m} layer={l}", x, wqkv, l)
    x8 = rx(8, D)
    check_qm(torch, qm, "lm_head M=8 (2-D)", x8, wcls2, None)
    # ragged: N not a multiple of 16, K of 9 groups of 32, odd M, fp32; a
    # group size off the 16 grid (48) and K of one K block (the masked
    # path of the swap-AB body)
    tg = torch.Generator().manual_seed(2)
    small = quantize_int8(torch.randn(2, 288, 1000, generator=tg), 32)
    small = QuantizedTensor(q=small.q.to(dev), scales=small.scales.to(dev), group_size=32)
    for m, dt in ((3, bf), (17, bf), (40, bf), (5, torch.float32), (33, torch.float32)):
        check_qm(torch, qm, f"ragged K=288 N=1000 M={m} {dt}", rx(m, 288, dtype=dt), small, 1)
    for k, n, gs_r in ((192, 200, 48), (64, 384, 64)):
        wr = quantize_int8(torch.randn(2, k, n, generator=tg), gs_r).to(dev)
        for m in (1, 8):
            check_qm(torch, qm, f"K={k} N={n} gs={gs_r} M={m}", rx(m, k), wr, 1)
    err = compare(torch, "quant_matmul timed inputs (x8, wqkv layer 0)",
                  qm.quant_matmul(x8, wqkv, 0), qm.quant_matmul_plain(x8, wqkv, 0))
    lay = Layered(L)
    t_k = time_ms(torch, lambda: qm.quant_matmul(x8, wqkv, lay.next()))
    t_p = time_ms(torch, lambda: qm.quant_matmul_plain(x8, wqkv, lay.next()), reps=5)
    b_ms, b_by = bound_ms(matmul_bytes(wqkv, 8), 2 * 8 * D * 3 * D)
    results["quant_matmul"] = dict(
        name="quant_matmul", route="cuda", source="rama_tpu_torch/csrc/quant_matmul.cu",
        replaces="rama_tpu/ops/pallas/quant_matmul.py:265", max_abs_err=err,
        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape="x (8, 4096) bf16 @ wqkv[l] (4096, 12288) int8 gs 64")
    wo = rq(L, D, D)
    # K1 / K2 on the swap-AB body at decode and verify M, beside qmm_mma
    mmv = mmv_record(results)
    for label, w in (("wqkv", wqkv), ("wo", wo), ("lm_head", wcls2)):
        mmv["mmv"][f"int8 {label}"] = time_mmv(torch, qm, f"int8 {label}", w, L, rx)
    head = mmv["mmv"]["int8 wqkv"]["8"]
    mmv.update(max_abs_err=head["max_abs_err"], ms=head["ms"], plain_ms=t_p,
               bound_ms=head["bound_ms"], bound_by=head["bound_by"],
               shape="x (8, 4096) bf16 @ wqkv[l] (4096, 12288) int8 gs 64")
    # the tensor-core GEMM (M > 32, bf16) at a prefill chunk's M and an 8 x
    # 512 admission's
    mma = mma_record(results)
    for label, (m, w) in {"wqkv M=256": (256, wqkv),
                          "wqkv M=4096": (4096, wqkv), "wo M=4096": (4096, wo)}.items():
        mma["gemm"][f"int8 {label}"] = time_gemm(torch, qm, f"int8 {label}", rx(m, D), w, L)
    head = mma["gemm"]["int8 wqkv M=256"]
    mma.update(max_abs_err=head["max_abs_err"], ms=head["ms"], plain_ms=head["plain_ms"],
               bound_ms=head["bound_ms"], bound_by=head["bound_by"],
               shape="x (256, 4096) bf16 @ wqkv[l] (4096, 12288) int8 gs 64")
    del wo

    # -- kernel 2: ffn ---------------------------------------------------------
    il = phase_a_tile(H, 8, gs) or 0
    w13, w2 = rq(L, D, 2 * H, il=il), rq(L, H, D)
    for m in (1, 8, 32):
        x = rx(m, D)
        for l in (0, L - 1):
            check_ffn(torch, ffn_mod, f"il={il} M={m} layer={l}", x, w13, w2, l)
    any_m = check_ffn_any_m(torch, ffn_mod, f"int8 il={il}", w13, w2, rx)
    # plain [W1 | W3] layout and a ragged hidden dim (tiny's 176)
    w13p = QuantizedTensor(q=w13.q[:2], scales=w13.scales[:2], group_size=gs, il=0)
    w2p = QuantizedTensor(q=w2.q[:2], scales=w2.scales[:2], group_size=gs)
    check_ffn(torch, ffn_mod, "plain layout M=8", x8, w13p, w2p, 1)
    tg = torch.Generator().manual_seed(3)
    t13 = quantize_int8(torch.randn(1, 64, 352, generator=tg), 16)
    t2 = quantize_int8(torch.randn(1, 176, 64, generator=tg), 16)
    t13, t2 = t13.to(dev), t2.to(dev)
    xt = rx(3, 64)
    check_ffn(torch, ffn_mod, "tiny H=176 M=3", xt, t13, t2, 0)
    err = compare(torch, "ffn timed inputs (x8, layer 0)", ffn_mod.ffn(x8, w13, w2, 0),
                  ffn_mod.ffn_plain(x8, w13, w2, 0))
    lay = Layered(L)
    t_k = time_ms(torch, lambda: ffn_mod.ffn(x8, w13, w2, lay.next()))
    t_p = time_ms(torch, lambda: ffn_mod.ffn_plain(x8, w13, w2, lay.next()), reps=5)
    nb = matmul_bytes(w13, 8) + matmul_bytes(w2, 8) - 8 * 2 * H * 2 - 8 * H * 2  # h on chip
    b_ms, b_by = bound_ms(nb, 2 * 8 * (D * 2 * H + H * D))
    results["ffn"] = dict(
        name="ffn", route="cuda", source="rama_tpu_torch/csrc/ffn.cu",
        replaces="rama_tpu/ops/pallas/ffn.py:252", max_abs_err=err, ms=t_k,
        plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"x (8, 4096) bf16, w13[l] (4096, 22016) il={il}, w2[l] (11008, 4096)",
        any_m=any_m, by_m=time_ffn(torch, ffn_mod, qm, "int8", w13, w2, L, rx))
    # the prefill FFN's split w13 / w2 products through the tensor-core GEMM
    for label, (k, w) in {"w13 M=4096": (D, w13), "w2 M=4096": (H, w2)}.items():
        mma["gemm"][f"int8 {label}"] = time_gemm(torch, qm, f"int8 {label}", rx(4096, k), w, L)
    del w13, w2, w13p, w2p
    # K3 at TinyLlama-1.1B's FFN (K 2048, H 5632; 8 layers, 280 MB, cycle past
    # the L2): a verify round of 8 at 8 slots (M = 64) and at 64 slots (512)
    tcfg = tinyllama_config(ModelConfig)
    tl_il = phase_a_tile(tcfg.hidden_dim, 8, gs) or 0
    t13 = rq(8, tcfg.dim, 2 * tcfg.hidden_dim, il=tl_il)
    t2 = rq(8, tcfg.hidden_dim, tcfg.dim)
    check_ffn_any_m(torch, ffn_mod, f"TinyLlama int8 il={tl_il}", t13, t2, rx)
    results["ffn"]["tinyllama"] = time_ffn(torch, ffn_mod, qm, "TinyLlama int8", t13, t2, 8,
                                           rx, ms=(64, 512))
    del t13, t2

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
    # device time alone, kernel and SDPA: a small call's wall time is the host's
    k4_dev = {"device_ms": device_ms_per_call(
                  torch, lambda: da.decode_attention(q, kc, vc, pos, lay.next())),
              "library_device_ms": device_ms_per_call(torch, sdpa_decode)}
    log(f"[time] decode_attention device {k4_dev['device_ms']:.4f} ms, SDPA device "
        f"{k4_dev['library_device_ms']:.4f} ms")
    rows = int((pos.clamp(0, S - 1) + 1).sum())
    nb = rows * nkv * hd * 2 * 2 + 2 * q.numel() * 2
    b_ms, b_by = bound_ms(nb, rows * cfg.n_heads * hd * 4)
    results["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="rama_tpu_torch/csrc/decode_attention.cu",
        replaces="rama_tpu/ops/pallas/decode_attention.py:262", max_abs_err=err,
        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_lib,
        breakdown=k4_dev,
        shape=f"q (8, 32, 128) bf16, cache (32, 8, 32, 1024, 128), pos {pos.tolist()}")
    del kc, vc

    # -- kernel 5: prefill attention ---------------------------------------------
    # key-tile edges of both bodies (32-key SIMT tiles, 64-key tensor-core tiles)
    tiles = (31, 32, 63, 64, 127, 128, 191, 192, 255, 256, 287, 288, 319, 320, 383, 384,
             447, 448, 511)
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
            k5_check(torch, pa, f"B={b} T={t} S={s} plen={plens}"
                     f"{' planted edges' if planted else ''}", qp, kp, vp, pl)
    # GQA rep 2 and 4 at hd 128; the stories drafts' hd 48 (stories15M) and 64
    # (stories42M / 110M), T not a multiple of 16, plen inside a tile; and the
    # hd 48 fp32 GQA case of the SIMT body
    f32 = torch.float32
    for b, t, s, nh_, nkv_, hd_, plens, dt in (
            (2, 200, 256, 32, 16, 128, [200, 131], bf),
            (2, 200, 256, 32, 8, 128, [191, 65], bf),
            (3, 77, 80, 6, 6, 48, [77, 37, 1], bf),
            (3, 45, 48, 8, 8, 64, [45, 29, 17], bf),
            (2, 24, 32, 4, 2, 48, [24, 7], f32)):
        qp = rx(b, t, nh_, hd_, dtype=dt)
        kp, vp = rx(b, nkv_, s, hd_, dtype=dt), rx(b, nkv_, s, hd_, dtype=dt)
        pl = torch.tensor(plens, dtype=torch.int32, device=dev)
        for planted in (False, True):
            if planted:
                plant_prefill_edges(vp, plens, tiles)
            k5_check(torch, pa, f"B={b} T={t} S={s} nh={nh_} nkv={nkv_} hd={hd_} {dt} "
                     f"plen={plens}{' planted edges' if planted else ''}", qp, kp, vp, pl)

    def time_prefill(b, t, plens) -> dict:
        """Check, then time kernel, plain version and SDPA at one shape."""
        qp = rx(b, t, cfg.n_heads, hd)
        kp, vp = rx(b, nkv, t, hd), rx(b, nkv, t, hd)
        pl = torch.tensor(plens, dtype=torch.int32, device=dev)
        return k5_time(torch, pa, f"B={b} T={t}", qp, kp, vp, pl)

    results["prefill_attention"] = dict(
        name="prefill_attention", route="cuda",
        source="rama_tpu_torch/csrc/prefill_attention.cu",
        replaces="rama_tpu/ops/pallas/prefill_attention.py:107",
        **time_prefill(*cases[0][:2], cases[0][3]))
    b, t, _, plens = long_prompt
    results["prefill_attention"]["long_prompt"] = time_prefill(b, t, plens)
    # one 4096-token prompt: the engine's bucket at max_len 4096
    results["prefill_attention"]["t4096"] = time_prefill(1, 4096, [4096])
    k5 = results["prefill_attention"]
    for r in [*results.values(), k5["long_prompt"], k5["t4096"]]:
        log(f"[kernel] {r.get('name', 'prefill_attention ' + r['shape'])}: {r['ms']:.4f} "
            f"ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}")


def k5_check(torch, pa, label: str, qp, kp, vp, pl) -> float:
    """K5 against its plain version per (slot, row, head), on the body
    body_for picks and in the form form_for picks (one launch on each, none
    on another). Returns the max |err|."""
    body, form = pa.body_for(qp.dtype, qp.shape[-1]), pa.form_for(qp.shape[2], kp.shape[1])
    before, forms = dict(pa.launches_by_body), dict(pa.launches_by_form)
    got = pa.prefill_attention(qp, kp, vp, pl)
    ran = {k: pa.launches_by_body[k] - before[k] for k in before}
    ran_form = {k: pa.launches_by_form[k] - forms[k] for k in forms}
    if (ran != {k: int(k == body) for k in before}
            or ran_form != {k: int(k == form) for k in forms}):
        raise SystemExit(f"FAILED prefill_attention {label}: launches by body {ran}, by form "
                         f"{ran_form}, expected one on {body} in the {form} form")
    return compare(torch, f"prefill_attention {label} [{body}, {form}]", got,
                   pa.prefill_attention_plain(qp, kp, vp, pl), per=qp.shape[-1])


def k5_time(torch, pa, label: str, qp, kp, vp, pl) -> dict:
    """Check (k5_check), then time K5, its plain version and SDPA (a boolean
    mask; over the kv heads repeated to the query heads under GQA) at one
    shape: CUDA-event ms, device ms, the bound from this run's plen."""
    import torch.nn.functional as F

    b, t, nh, hd = qp.shape
    nkv = kp.shape[1]
    plens = pl.tolist()
    err = k5_check(torch, pa, f"timed inputs {label}", qp, kp, vp, pl)
    t_k = time_ms(torch, lambda: pa.prefill_attention(qp, kp, vp, pl))
    t_p = time_ms(torch, lambda: pa.prefill_attention_plain(qp, kp, vp, pl))
    tpos = torch.arange(t, device=qp.device)
    mask = ((tpos[None, None, :] <= tpos[None, :, None])
            & (tpos[None, None, :] < pl[:, None, None].long()))[:, None]
    kr, vr = ((kp, vp) if nh == nkv
              else (x.repeat_interleave(nh // nkv, dim=1) for x in (kp, vp)))

    def sdpa():
        return F.scaled_dot_product_attention(qp.transpose(1, 2), kr, vr, attn_mask=mask)

    t_lib = time_ms(torch, sdpa)
    # device time alone: a small call's wall time is the host's
    dev_ms = {"device_ms": device_ms_per_call(
                  torch, lambda: pa.prefill_attention(qp, kp, vp, pl)),
              "library_device_ms": device_ms_per_call(torch, sdpa)}
    # a query row >= plen attends to all plen keys, as in the Pallas kernel
    pairs = sum(sum(min(i + 1, p) for i in range(t)) for p in plens)
    flops = pairs * nh * hd * 4
    nb = 2 * qp.numel() * qp.element_size() + sum(plens) * nkv * hd * 2 * kp.element_size()
    b_ms, b_by = bound_ms(nb, flops)
    log(f"[time] prefill_attention {label}: {t_k:.4f} ms ({flops / t_k / 1e9:.1f} "
        f"TFLOP/s), SDPA {t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {nb / 1e6:.1f} MB, "
        f"{flops / 1e9:.1f} GFLOP); device {dev_ms['device_ms']:.4f} ms, SDPA device "
        f"{dev_ms['library_device_ms']:.4f} ms")
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                library_ms=t_lib, breakdown=dev_ms, shape=f"q ({b}, {t}, {nh}, {hd}) bf16, "
                f"k/v ({b}, {nkv}, {t}, {hd}), plen {plens}")


def phase_kernels_int4(torch, results: dict) -> None:
    """The int4 instantiations of quant_matmul and ffn vs their plain
    versions, at the 7B int4 shapes and at the tiny / stories15M shapes."""
    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models.llama import phase_a_tile
    from rama_tpu_torch.ops.kernels import ffn as ffn_mod
    from rama_tpu_torch.ops.kernels import quant_matmul as qm
    from rama_tpu_torch.ops.quant import QuantizedTensor, quantize_int4

    dev = torch.device("cuda")
    cfg = seven_b_config(ModelConfig)
    g = torch.Generator(device=dev).manual_seed(4)
    bf, f32 = torch.bfloat16, torch.float32
    L, D, H = cfg.n_layers, cfg.dim, cfg.hidden_dim

    def rx(*shape, dtype=bf):
        return torch.randn(shape, device=dev, generator=g).to(dtype)

    # -- K1' / K2': quant_matmul, int4 -----------------------------------------
    wqkv = random_int4_qt(torch, L, D, 3 * D, 64, dev, g)
    wo = random_int4_qt(torch, L, D, D, 64, dev, g)
    w2 = random_int4_qt(torch, L, H, D, 64, dev, g)
    assert (wqkv.group_size, wo.group_size, w2.group_size) == (64, 64, 16)
    for label, w in (("wqkv", wqkv), ("wo", wo), ("w2 gs 16", w2)):
        for m in (1, 8, 32):
            x = rx(m, w.k_dim)
            for l in (0, L - 1):
                check_qm(torch, qm, f"int4 {label} M={m} layer={l}", x, w, l)
        for m in (128, 256):  # prefill rows: the tensor-core GEMM
            check_qm(torch, qm, f"int4 {label} M={m} layer={L - 1}", rx(m, w.k_dim), w, L - 1)
    w2d = QuantizedTensor(q=wqkv.q[1].contiguous(), scales=wqkv.scales[1].contiguous(),
                          group_size=64, bits=4)
    for m in (1, 8, 128):
        check_qm(torch, qm, f"int4 2-D (4096, 12288) M={m}", rx(m, D), w2d, None)
    # tiny (K 64 -> gs 4, K 176 -> gs 1) and stories15M (K 288 -> gs 2,
    # K 768 -> gs 16) shapes, ragged N, fp32 and bf16 activations; gs 48
    # at K 768 (the masked path: a packing block straddles slabs)
    tg = torch.Generator().manual_seed(5)
    for k, n, req in ((64, 200, 8), (176, 64, 8), (288, 1000, 16), (768, 288, 16)):
        w = quantize_int4(torch.randn(2, k, n, generator=tg), req).to(dev)
        for m, dt in ((1, bf), (5, f32), (8, bf), (17, bf), (40, bf), (33, f32)):
            check_qm(torch, qm, f"int4 K={k} gs={w.group_size} N={n} M={m} {dt}",
                     rx(m, k, dtype=dt), w, 1)
    w48 = random_int4_qt(torch, 2, 768, 384, 48, dev, g)
    assert w48.group_size == 48
    for m in (1, 8):
        check_qm(torch, qm, f"int4 K=768 gs=48 N=384 M={m}", rx(m, 768), w48, 1)
    x8 = rx(8, D)
    err = compare(torch, "quant_matmul int4 timed inputs (x8, wqkv layer 0)",
                  qm.quant_matmul(x8, wqkv, 0), qm.quant_matmul_plain(x8, wqkv, 0))
    lay = Layered(L)
    t_k = time_ms(torch, lambda: qm.quant_matmul(x8, wqkv, lay.next()))
    t_p = time_ms(torch, lambda: qm.quant_matmul_plain(x8, wqkv, lay.next()), reps=5)
    b_ms, b_by = bound_ms(matmul_bytes(wqkv, 8), 2 * 8 * D * 3 * D)
    results["quant_matmul_int4"] = dict(
        name="quant_matmul_int4", route="cuda", source="rama_tpu_torch/csrc/quant_matmul.cu",
        replaces="rama_tpu/ops/pallas/quant_matmul.py:152", max_abs_err=err,
        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape="x (8, 4096) bf16 @ wqkv[l] (4096, 12288) int4 gs 64")
    mmv = mmv_record(results)
    for label, w in (("wqkv", wqkv), ("wo", wo), ("w2 gs 16", w2),
                     ("2-D (4096, 12288)", w2d)):
        mmv["mmv"][f"int4 {label}"] = time_mmv(torch, qm, f"int4 {label}", w, L, rx)
    mma = mma_record(results)
    for label, (m, w) in {"wqkv M=256": (256, wqkv),
                          "wqkv M=4096": (4096, wqkv), "w2 gs 16 M=256": (256, w2)}.items():
        mma["gemm"][f"int4 {label}"] = time_gemm(torch, qm, f"int4 {label}", rx(m, w.k_dim),
                                                 w, L)
    del wqkv, wo

    # -- K3': ffn, int4 --------------------------------------------------------
    il = phase_a_tile(H, 4, w2.group_size) or 0
    w13 = random_int4_qt(torch, L, D, 2 * H, 64, dev, g, il=il)
    assert il == 256 and w13.group_size == 64
    for m in (1, 8, 32):
        x = rx(m, D)
        for l in (0, L - 1):
            check_ffn(torch, ffn_mod, f"int4 il={il} M={m} layer={l}", x, w13, w2, l)
    any_m = check_ffn_any_m(torch, ffn_mod, f"int4 il={il}", w13, w2, rx)
    for cfg_name, (d, h, req) in {"tiny": (64, 176, 8), "stories15M": (288, 768, 16)}.items():
        t13 = quantize_int4(torch.randn(1, d, 2 * h, generator=tg), req).to(dev)
        t2 = quantize_int4(torch.randn(1, h, d, generator=tg), req).to(dev)
        til = phase_a_tile(h, 4, t2.group_size) or 0
        t13 = QuantizedTensor(q=t13.q, scales=t13.scales, group_size=t13.group_size, bits=4,
                              il=til)  # a column relabel: the same random function
        for m, dt in ((3, bf), (8, f32)):
            x = rx(m, d, dtype=dt)
            check_ffn(torch, ffn_mod, f"int4 {cfg_name} gs {t13.group_size}/{t2.group_size} "
                      f"il={til} M={m} {dt}", x, t13, t2, 0)
    err = compare(torch, "ffn int4 timed inputs (x8, layer 0)", ffn_mod.ffn(x8, w13, w2, 0),
                  ffn_mod.ffn_plain(x8, w13, w2, 0))
    lay = Layered(L)
    t_k = time_ms(torch, lambda: ffn_mod.ffn(x8, w13, w2, lay.next()))
    t_p = time_ms(torch, lambda: ffn_mod.ffn_plain(x8, w13, w2, lay.next()), reps=5)
    nb = matmul_bytes(w13, 8) + matmul_bytes(w2, 8) - 8 * 2 * H * 2 - 8 * H * 2  # h on chip
    b_ms, b_by = bound_ms(nb, 2 * 8 * (D * 2 * H + H * D))
    results["ffn_int4"] = dict(
        name="ffn_int4", route="cuda", source="rama_tpu_torch/csrc/ffn.cu",
        replaces="rama_tpu/ops/pallas/ffn.py:252", max_abs_err=err, ms=t_k,
        plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"x (8, 4096) bf16, w13[l] (4096, 22016) int4 gs 64 il={il}, "
              f"w2[l] (11008, 4096) int4 gs 16",
        any_m=any_m, by_m=time_ffn(torch, ffn_mod, qm, "int4", w13, w2, L, rx))
    for name in ("quant_matmul_int4", "ffn_int4"):
        r = results[name]
        log(f"[kernel] {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


def s16_pair(torch, w):
    """(w with bf16-stored scales by cast_scales, the same weight bytes with
    those scales as f32): bf16 -> f32 is exact, so a body must give both
    the same bits."""
    from rama_tpu_torch.ops.quant import QuantizedTensor, cast_scales

    wb = cast_scales({"w": w}, torch.bfloat16)["w"]
    return wb, QuantizedTensor(q=wb.q, scales=wb.scales.float(), group_size=wb.group_size,
                               bits=wb.bits, il=wb.il)


def check_s16(torch, label: str, call, plain, bodies: dict, body: str, scales: dict) -> float:
    """One bf16-scale launch (call("bf16")) on `body` (its count in
    `bodies`, none on another) counted as a bf16-scale launch (`scales`),
    (a) within TOL of the plain version on the same bf16 scales per output
    row, (b) bit for bit the same body fed scales.float() (call("f32")).
    Returns the max |err|."""
    before, sb = dict(bodies), dict(scales)
    got = call("bf16")
    ran = {b: bodies[b] - before[b] for b in before}
    if ran != {b: int(b == body) for b in before}:
        raise SystemExit(f"FAILED {label} bf16 scales: launches by body {ran}, expected one "
                         f"on {body}")
    if {s: scales[s] - sb[s] for s in sb} != {"f32": 0, "bf16": 1}:
        raise SystemExit(f"FAILED {label}: not counted as one bf16-scale launch "
                         f"{ {s: scales[s] - sb[s] for s in sb} }")
    err = compare(torch, f"{label} bf16 scales [{body}]", got, plain())
    same = call("f32")
    if not torch.equal(got, same):
        diff = float((got.float() - same.float()).abs().max())
        raise SystemExit(f"FAILED {label}: the bf16-scale launch differs from the same body "
                         f"on scales.float() (max |diff| {diff:.3e}); it must equal it bit "
                         f"for bit")
    log(f"[check] {label}: bf16-scale launch equals the f32-scale launch bit for bit")
    return err


def s16_turns(torch, fb, ff) -> dict:
    """Device ms a call of the bf16-scale form (fb) and of the f32-scale form
    on the same weight bytes (ff), in turns f32, bf16, bf16, f32."""
    f1, b1, b2, f2 = (device_ms_per_call(torch, fn) for fn in (ff, fb, fb, ff))
    return dict(device_ms=(b1 + b2) / 2, f32_device_ms=(f1 + f2) / 2,
                turns_ms=[f1, b1, b2, f2])


def phase_kernels_s16(torch, results: dict) -> None:
    """The bf16-stored-scale forms (cast_scales) of K1 / K2 and K3, every
    body that reads a weight scale, at the 7B shapes, int8 and int4: each
    check one launch on the body body_for picks, within TOL of the plain
    version on the same bf16 scales per output row, and bit for bit the
    same body fed scales.float() (check_s16). Timed (device ms in turns
    beside the f32-scale form on the same weight bytes, bytes and bound
    with 2-byte scales): the swap-AB body at M = 1 / 8 / 16 / 32 on int8
    wqkv / wo / lm_head and int4 wqkv / wo / w2 gs 16; the GEMM at M = 256
    / 4096 on wqkv and at 256 on the int4 w2; the FFN's tensor-core body at
    M = 1 / 8 / 32. Correctness only: the fp32 GEMV and tiled GEMM, the
    fp32 FFN GEMVs, and K14's full form on a bf16-scale wo (K1's launch)."""
    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models.llama import _rope_tables, phase_a_tile
    from rama_tpu_torch.ops.kernels import attn_block as ab
    from rama_tpu_torch.ops.kernels import ffn as ffn_mod
    from rama_tpu_torch.ops.kernels import quant_matmul as qm
    from rama_tpu_torch.ops.quant import QuantizedTensor

    dev = torch.device("cuda")
    cfg = seven_b_config(ModelConfig)
    g = torch.Generator(device=dev).manual_seed(15)
    bf, f32 = torch.bfloat16, torch.float32
    L, D, H, V = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size

    def rx(*shape, dtype=bf):
        return torch.randn(shape, device=dev, generator=g).to(dtype)

    def rq8(l, k, n, il=0):
        q = torch.randint(-127, 128, (l, k, n), dtype=torch.int8, device=dev, generator=g)
        s = (torch.rand((l, k // 64, n), device=dev, generator=g) + 0.5) / (73 * math.sqrt(k))
        return QuantizedTensor(q=q, scales=s, group_size=64, bits=8, il=il)

    qrec = results.setdefault("quant_matmul_scale_bf16", dict(
        name="quant_matmul_scale_bf16", route="cuda", source="rama_tpu_torch/csrc/quant_matmul.cu",
        replaces="rama_tpu/ops/pallas/quant_matmul.py:265", library_ms=None, s16={}))
    frec = results.setdefault("ffn_scale_bf16", dict(
        name="ffn_scale_bf16", route="cuda", source="rama_tpu_torch/csrc/ffn.cu",
        replaces="rama_tpu/ops/pallas/ffn.py:252", library_ms=None, s16={}))

    def qm_check(label, x, wb, wf, layer, body=None):
        body = body or qm.body_for(x.dtype, x.shape[0])
        return check_s16(torch, f"quant_matmul {label}",
                         lambda s: qm.quant_matmul(x, wb if s == "bf16" else wf, layer),
                         lambda: qm.quant_matmul_plain(x, wb, layer), qm.launches_by_body,
                         body, qm.launches_by_scale)

    def qm_time(label, x, wb, wf, layered) -> dict:
        """Check on layer 1 (or the 2-D weight), then time in turns with the
        layer cycling (a 2-D weight: one layer)."""
        m, (k, n) = x.shape[0], wb.shape[-2:]
        err = qm_check(f"{label} M={m}", x, wb, wf, 1 if layered else None)
        lay = Layered(L)

        def run(w):
            return lambda: qm.quant_matmul(x, w, lay.next() if layered else None)

        nb = matmul_bytes(wb, m)
        b_ms, b_by = bound_ms(nb, 2 * m * k * n)
        rec = dict(m=m, body=qm.body_for(x.dtype, m), max_abs_err=err, bound_ms=b_ms,
                   bound_by=b_by, **s16_turns(torch, run(wb), run(wf)))
        if m == 8:
            rec["plain_ms"] = time_ms(torch, lambda: qm.quant_matmul_plain(
                x, wb, lay.next() if layered else None), reps=3, warmup=1)
        log(f"[time] quant_matmul {label} M={m} [{rec['body']}] bf16 scales: device "
            f"{rec['device_ms']:.4f} ms against {rec['f32_device_ms']:.4f} with f32 scales "
            f"(turns {', '.join(f'{t:.4f}' for t in rec['turns_ms'])}); "
            f"{nb / 1e6:.1f} MB ({matmul_bytes(wf, m) / 1e6:.1f} with f32 scales), bound "
            f"{b_ms:.4f} ms ({b_by}, {rec['device_ms'] / b_ms:.2f}x)")
        return rec

    def qm_headline(w, label):
        """The record's headline numbers at M = 8 (x (8, K), layer 1)."""
        wb, _ = w
        x8 = rx(8, wb.k_dim)
        lay = Layered(L)
        ms = time_ms(torch, lambda: qm.quant_matmul(x8, wb, lay.next()))
        head = qrec["s16"][label]["8"]
        qrec.update(max_abs_err=head["max_abs_err"], ms=ms, plain_ms=head["plain_ms"],
                    bound_ms=head["bound_ms"], bound_by=head["bound_by"], device_ms=head[
                        "device_ms"], f32_device_ms=head["f32_device_ms"],
                    shape=f"x (8, 4096) bf16 @ {label}[l], bf16 scales")

    # -- K1 / K2 int8: swap-AB body, GEMM, fp32 bodies ------------------------
    for label, w, layered in (("int8 wqkv", rq8(L, D, 3 * D), True),
                              ("int8 wo", rq8(L, D, D), True),
                              ("int8 lm_head", rq8(1, D, V), False)):
        wb, wf = s16_pair(torch, w)
        if not layered:
            wb, wf = (QuantizedTensor(q=t.q[0].contiguous(), scales=t.scales[0].contiguous(),
                                      group_size=64) for t in (wb, wf))
        qrec["s16"][label] = {str(m): qm_time(label, rx(m, D), wb, wf, layered)
                              for m in (1, 8, 16, 32)}
        if label == "int8 wqkv":
            for m in (256, 4096):
                qrec["s16"][f"{label} M={m}"] = qm_time(label, rx(m, D), wb, wf, True)
            for m, body in ((1, "gemv"), (8, "gemv"), (9, "simt"), (64, "simt")):
                qm_check(f"{label} M={m} fp32", rx(m, D, dtype=f32), wb, wf, L - 1, body)
            for m in (1, 32, 256):
                qm_check(f"{label} M={m} layer 0", rx(m, D), wb, wf, 0)
        del w, wb, wf
    torch.cuda.empty_cache()

    # -- K1' / K2' int4 -------------------------------------------------------
    w4 = {"int4 wqkv": random_int4_qt(torch, L, D, 3 * D, 64, dev, g),
          "int4 wo": random_int4_qt(torch, L, D, D, 64, dev, g),
          "int4 w2 gs 16": random_int4_qt(torch, L, H, D, 64, dev, g)}
    pairs4 = {}
    for label, w in w4.items():
        wb, wf = pairs4[label] = s16_pair(torch, w)
        k = wb.k_dim
        qrec["s16"][label] = {str(m): qm_time(label, rx(m, k), wb, wf, True)
                              for m in (1, 8, 16, 32)}
        if label != "int4 wo":
            for m in ((256, 4096) if label == "int4 wqkv" else (256,)):
                qrec["s16"][f"{label} M={m}"] = qm_time(label, rx(m, k), wb, wf, True)
            for m, body in ((8, "gemv"), (64, "simt")):
                qm_check(f"{label} M={m} fp32", rx(m, k, dtype=f32), wb, wf, L - 1, body)
    qm_headline(pairs4["int4 wqkv"], "int4 wqkv")
    wo4b, wo4f = pairs4["int4 wo"]
    del w4, pairs4
    torch.cuda.empty_cache()

    # -- K14 full form on a bf16-scale wo (K1's launch on att) ------------------
    wo8b, wo8f = s16_pair(torch, rq8(2, D, D))
    B, nkv, hd, S = 8, cfg.n_kv_heads, cfg.head_dim, cfg.seq_len
    pos = torch.tensor([0, 63, 64, 65, 511, 1000, S - 1, S + 3], dtype=torch.int32, device=dev)
    cos_t, sin_t = _rope_tables(cfg, dev)
    cos, sin = cos_t[pos.long().clamp(0, S - 1)], sin_t[pos.long().clamp(0, S - 1)]
    q, kn, vn = rx(B, cfg.n_heads, hd), rx(B, nkv, hd), rx(B, nkv, hd)
    base = [rx(2, B, nkv, S, hd), rx(2, B, nkv, S, hd)]
    for wo_b, wo_f, bits in ((wo8b, wo8f, 8),
                             (QuantizedTensor(q=wo4b.q[:2], scales=wo4b.scales[:2],
                                              group_size=64, bits=4),
                              QuantizedTensor(q=wo4f.q[:2], scales=wo4f.scales[:2],
                                              group_size=64, bits=4), 4)):
        def full(s, plain=False, wo_b=wo_b, wo_f=wo_f):
            fn = ab.attn_block_layered_plain if plain else ab.attn_block_layered
            c = [t.clone() for t in base]
            return fn(q, kn, vn, cos, sin, *c, wo_b if s == "bf16" else wo_f, pos, 1)

        check_s16(torch, f"attn_block_layered int{bits} wo B=8 S=1024 pos={pos.tolist()}",
                  full, lambda: full("bf16", plain=True), qm.launches_by_body, "mmv",
                  qm.launches_by_scale)
    del base, wo8b, wo8f, wo4b, wo4f
    torch.cuda.empty_cache()

    # -- K3 / K3': the tensor-core body (timed) and the fp32 GEMVs ---------------
    for bits in (8, 4):
        gs2 = 64 if bits == 8 else 16
        il = phase_a_tile(H, bits, gs2) or 0
        if bits == 8:
            w13, w2 = rq8(L, D, 2 * H, il=il), rq8(L, H, D)
        else:
            w13 = random_int4_qt(torch, L, D, 2 * H, 64, dev, g, il=il)
            w2 = random_int4_qt(torch, L, H, D, 64, dev, g)
        (b13, f13), (b2, f2) = s16_pair(torch, w13), s16_pair(torch, w2)
        del w13, w2
        frec.setdefault("any_m", {})[f"int{bits}"] = check_ffn_any_m(
            torch, ffn_mod, f"int{bits} bf16 scales", b13, b2, rx, twin=(f13, f2))
        by_m = {}
        for m in (1, 8, 32):
            x = rx(m, D)
            err = check_s16(torch, f"ffn int{bits} M={m} layer=1",
                            lambda s: ffn_mod.ffn(x, *((b13, b2) if s == "bf16" else
                                                       (f13, f2)), 1),
                            lambda: ffn_mod.ffn_plain(x, b13, b2, 1), ffn_mod.launches_by_body,
                            "mma", ffn_mod.launches_by_scale)
            lay = Layered(L)

            def run(w13_, w2_):
                return lambda: ffn_mod.ffn(x, w13_, w2_, lay.next())

            nb = ffn_bytes(b13, b2, m)
            b_ms, b_by = bound_ms(nb, 2 * m * (D * 2 * H + H * D))
            rec = dict(m=m, max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                       **s16_turns(torch, run(b13, b2), run(f13, f2)))
            if m == 8:
                rec["plain_ms"] = time_ms(torch, lambda: ffn_mod.ffn_plain(x, b13, b2,
                                                                           lay.next()),
                                          reps=3, warmup=1)
            log(f"[time] ffn int{bits} M={m} [mma] bf16 scales: device {rec['device_ms']:.4f} "
                f"ms against {rec['f32_device_ms']:.4f} with f32 scales (turns "
                f"{', '.join(f'{t:.4f}' for t in rec['turns_ms'])}); {nb / 1e6:.1f} MB "
                f"({ffn_bytes(f13, f2, m) / 1e6:.1f} with f32 scales), bound "
                f"{b_ms:.4f} ms ({b_by}, {rec['device_ms'] / b_ms:.2f}x)")
            by_m[str(m)] = rec
        frec["s16"][f"int{bits}"] = by_m
        for m in (1, 8):
            x = rx(m, D, dtype=f32)
            check_s16(torch, f"ffn int{bits} M={m} fp32 layer={L - 1}",
                      lambda s: ffn_mod.ffn(x, *((b13, b2) if s == "bf16" else (f13, f2)),
                                            L - 1),
                      lambda: ffn_mod.ffn_plain(x, b13, b2, L - 1), ffn_mod.launches_by_body,
                      "simt", ffn_mod.launches_by_scale)
        x0 = rx(8, D)
        check_s16(torch, f"ffn int{bits} M=8 layer=0",
                  lambda s: ffn_mod.ffn(x0, *((b13, b2) if s == "bf16" else (f13, f2)), 0),
                  lambda: ffn_mod.ffn_plain(x0, b13, b2, 0), ffn_mod.launches_by_body, "mma",
                  ffn_mod.launches_by_scale)
        if bits == 4:
            x8 = rx(8, D)
            lay = Layered(L)
            head = by_m["8"]
            frec.update(max_abs_err=head["max_abs_err"],
                        ms=time_ms(torch, lambda: ffn_mod.ffn(x8, b13, b2, lay.next())),
                        plain_ms=head["plain_ms"],
                        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                        device_ms=head["device_ms"], f32_device_ms=head["f32_device_ms"],
                        shape=f"x (8, 4096) bf16, w13[l] (4096, 22016) int4 gs 64 il={il}, "
                              f"w2[l] (11008, 4096) int4 gs 16, bf16 scales")
        del b13, f13, b2, f2
        torch.cuda.empty_cache()
    for name in ("quant_matmul_scale_bf16", "ffn_scale_bf16"):
        r = results[name]
        log(f"[kernel] {name}: {r['ms']:.4f} ms (device {r['device_ms']:.4f} against "
            f"{r['f32_device_ms']:.4f} with f32 scales), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


# ---------------------------------------------------------------------------
# GQA speculation: the decode / chunk attention for any T x GQA group, and
# TinyLlama-1.1B (group 8) served end to end


def check_split_form(label: str, parts: dict, hd: int, form: int) -> None:
    """Fail unless every split kernel that attention_split_combine saw is
    the `form`-row form at head dim hd (its template arguments in the
    profiler's name, <hd, form> or the walk's <hd, form, write>); where the
    profiler saw none a line says so (the launch counts by form still check
    it)."""
    want = f"<{hd}, {form}"                # the walk's instantiations add <…, WRITE>
    names = parts["split_kernel"]
    if not names:
        log(f"[check] {label}: torch.profiler recorded no split kernel; its form is checked "
            f"by the launch counts by form only")
    elif not all(want + ">" in k or want + "," in k for k in names):
        raise SystemExit(f"FAILED {label}: split kernel {names}, not the {form}-row form {want}")


def on_form(counts: dict, forms: dict, body: str, form: int, label: str, fn):
    """on_body, and fail unless the launch also ran the `form`-row form of
    that body, by `forms` (a wrapper's launches by body and the row form the
    C entry reports it launched). Returns fn()."""
    before = {(b, f): n for b, by in forms.items() for f, n in by.items()}
    out = on_body(counts, body, label, fn)
    ran = {k: forms[k[0]][k[1]] - n for k, n in before.items()}
    if ran != {k: int(k == (body, form)) for k in before}:
        raise SystemExit(f"FAILED {label}: launches by (body, row form) {ran}, not one in "
                         f"the {body} body's {form}-row form")
    return out


def phase_kernels_gqa(torch, results: dict) -> None:
    """The decode / chunk attention at GQA groups past the 8-row form (K4,
    K7, K9, K10 on bf16 / int8 caches; K12's decode and chunk forms on bf16
    / int8 pools of 128-row pages): rep 8 x T 1 / 2 / 4 / 8 (8-64 query rows
    a kv head), rep 3 x T 3 (9, a partial m16 block) and rep 16 x T 1 / 8
    (16 and 128: two row groups), hd 64 and 128, against the plain versions
    (rel TOL per (slot, query, head)) with planted edge rows, each launch on
    the body and row form the counts say it ran; chunk rows against the
    decode rows at their positions, bit for bit, at rep 3 / 8 / 16 on all
    four caches; the shared bytes the occupancy API reports for each form
    against form_smem. Then, at TinyLlama's shape (8 slots, 4 kv heads,
    hd 64, S 2048, the layer cycling over 8), K10 and K12's chunk form on
    both caches at T 4 and 8 (32 and 64 rows; K10 on the bf16 cache at T 2
    too, the 16-row form): CUDA-event and device ms (split + combine, the
    profiled split kernel's form), plain ms, bound, and SDPA with a boolean
    mask over the repeated kv heads (bf16 dense); the same for the T = 1
    launch (K4 / K7 / K12 decode, the 8-row form) over the same rows."""
    import torch.nn.functional as F

    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kvw
    from rama_tpu_torch.ops.kernels import paged_attention as pga

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    gc = torch.Generator().manual_seed(16)
    bf = torch.bfloat16

    def rx(*shape, dtype=bf):
        return torch.randn(shape, device=dev, generator=g).to(dtype)

    def q8_of(k, v):
        (k8, ks), (v8, vs) = kvw.kv_quant_rows(k.float()), kvw.kv_quant_rows(v.float())
        return k8, v8, ks, vs

    # kind: (dense or paged, int8, decode wrapper, its plain, chunk wrapper, its plain)
    kinds = {
        "dense bf16": (False, False, da.decode_attention, da.decode_attention_plain,
                       da.chunk_attention, da.chunk_attention_plain),
        "dense int8": (False, True, da.decode_attention_q8, da.decode_attention_q8_plain,
                       da.chunk_attention_q8, da.chunk_attention_q8_plain),
        "paged bf16": (True, False, pga.paged_decode_attention,
                       pga.paged_decode_attention_plain, pga.paged_chunk_attention,
                       pga.paged_chunk_attention_plain),
        "paged int8": (True, True, pga.paged_decode_attention_q8,
                       pga.paged_decode_attention_q8_plain, pga.paged_chunk_attention_q8,
                       pga.paged_chunk_attention_q8_plain)}

    # -- every form against its plain version, and chunk rows against decode rows
    B, nkv, S, ps, mp = 8, 2, 300, 128, 3
    for hd in (64, 128):
        for rep, t in GQA_FORMS:
            nh, (form, groups) = nkv * rep, da.row_form(t, rep)
            p0 = torch.tensor([0, 61, max(0, 65 - t), 127, 128, 200, S - 2, S - t],
                              dtype=torch.int32, device=dev)
            tables, npages = paged_tables(torch, [int(p) + t for p in p0], ps, mp, 4, gc)
            tables = tables.to(dev)
            dense = [rx(2, B, nkv, S, hd), rx(2, B, nkv, S, hd)]
            pool = [rx(2, npages, nkv, ps, hd), rx(2, npages, nkv, ps, hd)]
            caches = {"dense bf16": dense, "dense int8": q8_of(*dense), "paged bf16": pool,
                      "paged int8": q8_of(*pool)}
            q = rx(B, t, nh, hd)
            for kind, (paged, q8, dec, dec_plain, chk, chk_plain) in kinds.items():
                c = caches[kind]
                extra = (tables,) if paged else ()
                counts = (pga if paged else da).launches_by_body
                forms = (pga if paged else da).launches_by_form
                body = "walk" if q8 else "mma"
                if t == 1:
                    fn, plain, qq = dec, dec_plain, q[:, 0].contiguous()
                else:
                    fn, plain, qq = chk, chk_plain, q
                split = pga.split_rows(ps) if paged else da.CHUNK
                lim = mp * ps if paged else S
                edges = sorted({e for c0 in range(split, lim, split) for e in (c0 - 1, c0)})
                for planted in (False, True):
                    if planted and paged:
                        plant_paged_edges(q, c, tables, p0, 1, edges, kvw if q8 else None)
                    elif planted:
                        plant_chunk_edges(q, c, p0, 1, edges, kvw if q8 else None)
                    label = (f"{fn.__name__} {kind} rep={rep} T={t} hd={hd} ({t * rep} rows: "
                             f"{form}-row form x {groups}){' planted edges' if planted else ''}")
                    got = on_form(counts, forms, body, form, label,
                                  lambda: fn(qq, *c, p0, *extra, 1))
                    compare(torch, label, got, plain(qq, *c, p0, *extra, 1), per=hd)
                if q8:   # the walk launch that writes the chunk's rows (K11 / K13 (a))
                    kn, vn = rx(B, t, nkv, hd), rx(B, t, nkv, hd)
                    check_fused_form(
                        torch, f"{fn.__name__} + rows {kind} rep={rep} T={t} hd={hd} ("
                        f"{form}-row form x {groups})", c, q, p0, tables if paged else None,
                        kn, vn, 1, form=form)
                if t > 1 and rep in (3, 8, 16):
                    chunk = fn(q, *c, p0, *extra, 1)
                    for i in range(t):
                        one = dec(q[:, i].contiguous(), *c, p0 + i, *extra, 1)
                        if not torch.equal(chunk[:, i], one):
                            raise SystemExit(f"FAILED {kind} rep={rep} T={t} hd={hd}: chunk "
                                             f"query {i} is not the decode row bit for bit")
                    log(f"[check] {chk.__name__} {kind} rep={rep} T={t} hd={hd}: every chunk "
                        f"row equals the decode row at its position, bit for bit")
                if t == 1 and not paged:   # K9: the same launch over one layer's cache
                    flat = da.decode_attention_flat_q8 if q8 else da.decode_attention_flat
                    one = [x[1] for x in c]
                    label = f"{flat.__name__} rep={rep} hd={hd} ({rep} rows: {form}-row form)"
                    got = on_form(da.launches_by_body, da.launches_by_form, body, form, label,
                                  lambda: flat(qq, *one, p0))
                    compare(torch, label, got, dec_plain(qq, *c, p0, 1), per=hd)
                smem = da.occupancy(t, nh, nkv, hd, q8)["smem_bytes"]
                if smem != da.form_smem(body, form, hd):
                    raise SystemExit(f"FAILED {kind} rep={rep} T={t} hd={hd}: the occupancy "
                                     f"API reports {smem} shared bytes, the {form}-row form "
                                     f"asks for {da.form_smem(body, form, hd)}")
            del dense, pool, caches
    # the SIMT body's row groups of 8 (fp32): rep 8 x T 3 = 24 rows
    f32 = torch.float32
    qf, pf = rx(3, 3, 16, 64, dtype=f32), torch.tensor([0, 61, 93], dtype=torch.int32, device=dev)
    kf, vf = rx(2, 3, 2, 96, 64, dtype=f32), rx(2, 3, 2, 96, 64, dtype=f32)
    name = "chunk_attention fp32 rep=8 T=3 hd=64 (24 rows: SIMT row groups of 8)"
    compare(torch, name, on_body(da.launches_by_body, "simt", name,
                                 lambda: da.chunk_attention(qf, kf, vf, pf, 1)),
            da.chunk_attention_plain(qf, kf, vf, pf, 1), per=64)
    for hd in (48, 64, 128):
        for body, q8 in (("mma", False), ("walk", True)):
            occ = {f: da.occupancy(f, 1, 1, hd, q8) for f in da.FORMS}
            log(f"[occupancy] {body} hd={hd}: " + "; ".join(
                f"{f} rows {o['ctas_per_sm']} CTAs an SM, {o['registers']} registers, "
                f"{o['smem_bytes']} B" for f, o in occ.items()))
    torch.cuda.empty_cache()

    # -- timed at TinyLlama's shape -------------------------------------------------
    cfg = tinyllama_config(ModelConfig)
    nh, nkv, hd, L, S, B = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 8, cfg.seq_len, 8
    rep = nh // nkv
    ps, mp = 128, cfg.seq_len // 128
    starts = [0, 61, 128, 255, 511, 1000, 1500, S - 8]
    tables, npages = paged_tables(torch, [min(p + 8, S) for p in starts], ps, mp, 4, gc)
    tables = tables.to(dev)
    dense = [rx(L, B, nkv, S, hd), rx(L, B, nkv, S, hd)]
    pool = [rx(L, npages, nkv, ps, hd), rx(L, npages, nkv, ps, hd)]
    caches = {"dense bf16": dense, "dense int8": q8_of(*dense), "paged bf16": pool,
              "paged int8": q8_of(*pool)}
    # SDPA's operands: the bf16 cache with each kv head repeated over its group
    rep_kv = [x.repeat_interleave(rep, dim=2) for x in dense]

    def sdpa_ms(q, p0, t: int, lay) -> tuple[float, float]:
        """CUDA-event and device ms of one SDPA call with a boolean mask over
        the repeated kv heads: the library time of K10 / K4 on the bf16
        cache, q (B, T, nh, hd)."""
        vis = da._visible(p0, t, S)[:, None]                     # (B, 1, T, S)

        def sdpa():
            l = lay.next()
            return F.scaled_dot_product_attention(q.transpose(1, 2), rep_kv[0][l],
                                                  rep_kv[1][l], attn_mask=vis)

        return time_ms(torch, sdpa), device_ms_per_call(torch, sdpa)

    def time_form(kind: str, t: int) -> dict:
        paged, q8, dec, dec_plain, chk, chk_plain = kinds[kind]
        c = caches[kind]
        extra = (tables,) if paged else ()
        form, groups = da.row_form(t, rep)
        p0 = torch.tensor([min(p, S - t) for p in starts], dtype=torch.int32, device=dev)
        q = rx(B, t, nh, hd)
        label = f"{chk.__name__} TinyLlama {kind} T={t} ({t * rep} rows)"
        err = compare(torch, f"{label} timed inputs (layer 0)", chk(q, *c, p0, *extra, 0),
                      chk_plain(q, *c, p0, *extra, 0), per=hd)
        lay = Layered(L)
        t_k = time_ms(torch, lambda: chk(q, *c, p0, *extra, lay.next()))
        t_p = time_ms(torch, lambda: chk_plain(q, *c, p0, *extra, lay.next()), reps=5)
        row_bytes = 2 * hd + 8 if q8 else 2 * hd * 2
        nb, ops = attention_bytes_ops(p0, t, S, nkv, nh, hd, row_bytes, q.numel() * 2)
        b_ms, b_by = bound_ms(nb + (tables.numel() * 4 if paged else 0), ops)
        # the decode step (K4 / K7 / K12 decode: the 8-row form) over the same
        # rows: the last query's, with its plain version, bound and SDPA
        q1, last = rx(B, nh, hd), (p0 + t - 1).clamp(max=S - 1)
        t_one = time_ms(torch, lambda: dec(q1, *c, last, *extra, lay.next()))
        nb1, ops1 = attention_bytes_ops(last, 1, S, nkv, nh, hd, row_bytes, q1.numel() * 2)
        one = dict(ms=t_one, plain_ms=time_ms(torch, lambda: dec_plain(q1, *c, last, *extra,
                                                                       lay.next()), reps=5))
        one["bound_ms"], one["bound_by"] = bound_ms(nb1 + (tables.numel() * 4 if paged else 0),
                                                    ops1)
        one["library_ms"] = one["library_device_ms"] = None
        if not (paged or q8):
            one["library_ms"], one["library_device_ms"] = sdpa_ms(q1[:, None], last, 1, lay)
        parts = dict(
            chunk=with_share(attention_split_combine(
                torch, lambda: chk(q, *c, p0, *extra, lay.next())), b_ms),
            one_query=attention_split_combine(torch, lambda: dec(q1, *c, last, *extra,
                                                                 lay.next())),
            chunk_occupancy=da.occupancy(t, nh, nkv, hd, q8),
            one_query_occupancy=da.occupancy(1, nh, nkv, hd, q8))
        body = "walk" if q8 else "mma"
        check_split_body(label, parts["chunk"], body)
        check_split_form(label, parts["chunk"], hd, form)
        check_split_form(f"{dec.__name__} TinyLlama {kind}", parts["one_query"], hd, 8)
        if q8:
            check_walk_grid(da, label, parts["chunk"], p0, t, mp * ps if paged else S, nkv, hd,
                            ps if paged else None, rep=rep)
        parts["split_over_one_query"] = (parts["chunk"]["split_ms"] / parts["one_query"]["split_ms"]
                                         if parts["one_query"]["split_ms"] else None)
        t_lib, note = None, ("no single PyTorch call attends through a page table" if paged
                             else "no single PyTorch call attends over an int8 cache with row "
                                  "scales (dequantize + SDPA is two)" if q8 else None)
        if not (paged or q8):
            t_lib, parts["library_device_ms"] = sdpa_ms(q, p0, t, lay)
        log(f"[time] {label}: {t_k:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{nb / 1e6:.1f} MB), library {t_lib} (device {parts.get('library_device_ms')}); "
            f"{dec.__name__} on the same rows {json.dumps(one)} (bound from {nb1 / 1e6:.1f} "
            f"MB); breakdown {json.dumps(parts)}")
        return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                    library_ms=t_lib, library_note=note, one_query=one, breakdown=parts,
                    shape=f"q ({B}, {t}, {nh}, {hd}) bf16 ({t * rep} rows a kv head: the "
                          f"{form}-row form), {kind} cache ({L}, "
                          f"{f'{npages}, {nkv}, {ps}' if paged else f'{B}, {nkv}, {S}'}, {hd})"
                          f", pos0 {p0.tolist()}")

    for name, kind, line in (("chunk_attention_gqa", "dense bf16", "decode_attention.py:640"),
                             ("chunk_attention_q8_gqa", "dense int8", "decode_attention.py:730"),
                             ("paged_chunk_attention_q8_gqa", "paged int8",
                              "paged_attention.py:179")):
        results[name] = dict(name=name, route="cuda",
                             source="rama_tpu_torch/csrc/decode_attention.cu",
                             replaces=f"rama_tpu/ops/pallas/{line}", **time_form(kind, 8),
                             t4=time_form(kind, 4))
    # the 16-row form (rep 8 x T 2: spec_tick 1; or a group of 2 at T 8), on
    # no TinyLlama path: timed once, on the bf16 cache
    results["chunk_attention_gqa"]["t2"] = time_form("dense bf16", 2)
    # K12's chunk form on a bf16 pool (no GQA serving path runs it): timed
    # beside K10's record
    results["chunk_attention_gqa"]["paged"] = dict(
        replaces="rama_tpu/ops/pallas/paged_attention.py:156", t8=time_form("paged bf16", 8),
        t4=time_form("paged bf16", 4))
    del dense, pool, caches, rep_kv
    torch.cuda.empty_cache()
    kernels_k5_gqa(torch, results)
    for name in ("chunk_attention_gqa", "chunk_attention_q8_gqa", "paged_chunk_attention_q8_gqa",
                 "prefill_attention_gqa"):
        r = results[name]
        log(f"[kernel] {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library {r['library_ms']}")


def k5_plens(t: int, bq: int) -> list:
    """Five slots' prompt lengths for K5 at T t over q tiles of bq
    positions: T, the first tile edge bq and bq +- 1, and the last whole
    tile's edge, each clipped to 1 .. T."""
    return [min(max(p, 1), t) for p in (t, bq, bq + 1, bq - 1, (t // bq) * bq)]


def kernels_k5_gqa(torch, results: dict) -> None:
    """K5 at GQA groups that do not divide 64 (the "gqa" form): rep 3 / 5 /
    6 / 7 / 9 / 12 over 2 kv heads and 65 over 1 (two head slices), hd 64
    and 128, bf16 (the tensor-core body) and fp32 (SIMT), T 1 / 9 / 63 / 64
    / 65 / 512, plen on the q tiles' position edges (k5_plens), value rows
    planted on those edges and the 64-key tile edges; every group 1 .. 65
    once (bf16, hd 64, T 17); then Yi-34B's 8 x 512 admission shape (56
    heads over 8 kv heads) timed beside the "div64" form of the same kv
    rows and positions (64 heads over 8: group 8): the
    `prefill_attention_gqa` record."""
    from rama_tpu_torch.ops.kernels import prefill_attention as pa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)

    def rx(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, device=dev, generator=g).to(dtype)

    errs = []
    for rep in (3, 5, 6, 7, 9, 12, 65):
        nkv = 1 if rep > 64 else 2
        bq = pa.tile_rows(rep)[2]
        for hd in (64, 128):
            for dt in (torch.bfloat16, torch.float32):
                for t in (1, 9, 63, 64, 65, 512):
                    plens = k5_plens(t, bq)
                    qp = rx(len(plens), t, nkv * rep, hd, dtype=dt)
                    kp, vp = (rx(len(plens), nkv, t + 3, hd, dtype=dt) for _ in range(2))
                    edges = {e for m in range(bq, t + 1, bq) for e in (m - 1, m)} | {
                        e for m in range(64, t + 1, 64) for e in (m - 1, m)}
                    plant_prefill_edges(vp, plens, edges)
                    pl = torch.tensor(plens, dtype=torch.int32, device=dev)
                    errs.append(k5_check(torch, pa, f"rep={rep} nkv={nkv} hd={hd} {dt} T={t} "
                                         f"plen={plens} planted edges", qp, kp, vp, pl))
    for rep in range(1, 66):   # every group the wrapper takes, 1 .. 65
        qp, kp, vp = rx(2, 17, 2 * rep, 64), rx(2, 2, 20, 64), rx(2, 2, 20, 64)
        pl = torch.tensor([17, 9], dtype=torch.int32, device=dev)
        errs.append(k5_check(torch, pa, f"rep={rep} T=17", qp, kp, vp, pl))
    # Yi-34B's admission: 8 prompts of 512 rows, plen as the 7B record's
    plens = [512, 300, 450, 129, 256, 511, 77, 384]
    pl = torch.tensor(plens, dtype=torch.int32, device=dev)
    kp, vp = rx(8, 8, 512, 128), rx(8, 8, 512, 128)
    yi = k5_time(torch, pa, "Yi-34B B=8 T=512 group 7", rx(8, 512, 56, 128), kp, vp, pl)
    rep8 = k5_time(torch, pa, "B=8 T=512 group 8 (div64 form)", rx(8, 512, 64, 128), kp, vp, pl)
    results["prefill_attention_gqa"] = dict(
        name="prefill_attention_gqa", route="cuda",
        source="rama_tpu_torch/csrc/prefill_attention.cu",
        replaces="rama_tpu/ops/pallas/prefill_attention.py:107",
        **{**yi, "max_abs_err": max(errs + [yi["max_abs_err"]])}, rep8=rep8)
    del kp, vp
    torch.cuda.empty_cache()


def phase_model_gqa(torch, cfg, params) -> None:
    """TinyLlama-1.1B int8 logits through the kernels against the plain
    path, rel TOL per row, on a bf16 and an int8 cache of seq_len rows: 2
    slots prefilled with a prompt, a decode step at 8, forward_chunk at T
    4 (32 query rows a kv head) from 9 and T 8 (64) from 13; then, with
    rows 21 .. S - 1 of both caches filled with copies of the plain
    cache's rows 0-20 (as model_kv8), chunks of 8 from 1000 and 2040."""
    from rama_tpu_torch.models.llama import (KVCache, QuantKVCache, decode_step, forward_chunk,
                                             prefill)
    from rama_tpu_torch.ops.kernels import decode_attention as da

    dev = torch.device("cuda")
    S = cfg.seq_len
    toks = torch.tensor([[1, 9038, 2501, 263, 931, 29892, 727, 471]] * 2, device=dev)
    words = torch.tensor([[29871, 1576, 338, 263, 450, 4123, 471, 727],
                          [450, 4123, 471, 727, 29871, 1576, 338, 263]], device=dev)
    for cls in (KVCache, QuantKVCache):
        caches = [cls.create(cfg, 2, S, device=dev) for _ in range(2)]
        names = ("k", "v", "ks", "vs") if cls is QuantKVCache else ("k", "v")
        with torch.no_grad():
            lk, _ = prefill(params, cfg, toks, caches[0], last_only=True)
            lp, _ = prefill(params, cfg, toks, caches[1], last_only=True, plain=True)
            compare(torch, f"TinyLlama int8 logits prefill on {cls.__name__} (kernels vs plain)",
                    lk[:, -1], lp[:, -1])
            tok = torch.argmax(lp[:, -1], dim=-1)
            pos = torch.full((2,), 8, device=dev)
            n0 = da.launches_write_rows_q8
            lk, _ = decode_step(params, cfg, tok, pos, caches[0])
            fused = da.launches_write_rows_q8 - n0
            if fused != (cfg.n_layers if cls is QuantKVCache else 0):
                raise SystemExit(f"FAILED TinyLlama decode step on {cls.__name__}: {fused} K7 "
                                 f"launches wrote the step's rows (K6 in the walk), not one a "
                                 f"layer of an int8 cache")
            lp, _ = decode_step(params, cfg, tok, pos, caches[1], plain=True)
            compare(torch, f"TinyLlama int8 logits decode step at 8 on {cls.__name__} "
                    f"(kernels vs plain)", lk, lp)
            for t, starts in ((4, [9, 9]), (8, [13, 13]), (8, [1000, S - 8])):
                if starts[0] == 1000:
                    tile = torch.arange(S - 21, device=dev) % 21
                    for name in names:
                        rows = getattr(caches[1], name).index_select(3, tile)
                        for c in caches:
                            getattr(c, name)[:, :, :, 21:] = rows
                pos0 = torch.tensor(starts, dtype=torch.int32, device=dev)
                lk, _ = forward_chunk(params, cfg, words[:, :t], pos0, caches[0])
                lp, _ = forward_chunk(params, cfg, words[:, :t], pos0, caches[1], plain=True)
                compare(torch, f"TinyLlama int8 forward_chunk T={t} ({t * cfg.n_rep} rows a kv "
                        f"head) on {cls.__name__} pos0={starts} (kernels vs plain)", lk, lp)
        del caches
        torch.cuda.empty_cache()


def phase_model_yi(torch, cfg, params, dev=None) -> None:
    """Yi-34B int8 logits through the kernels against the plain path, rel
    TOL per row, on a bf16 cache of 64 rows: a padded prefill of 8 prompts
    of up to 40 tokens (plen 40, and 9, 10, 17, 18, 27, 28, 36: the "gqa"
    form's q tiles of 9 positions, each edge and one past; the engine's
    admission, rows past plen writing the last row), the logits at each
    prompt's last row; then a decode step at each slot's plen and
    forward_chunk at T 4 (28 query rows a kv head: the 32-row chunk form)
    after it; then the plain cache's rows quantized into two int8 caches
    and a decode step on each (on the card K7 in its 8-row form at group 7,
    which writes the step's rows itself: one fused write a layer). On
    `dev`, the card unless a test passes the CPU."""
    from rama_tpu_torch.models.llama import (KVCache, QuantKVCache, decode_step, forward,
                                             forward_chunk, kv_quant_rows)
    from rama_tpu_torch.ops.kernels import decode_attention as da

    dev = dev or torch.device("cuda")
    lens = torch.tensor([40, 9, 10, 17, 18, 27, 28, 36], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(34)
    toks = torch.randint(3, cfg.vocab_size, (8, 40), device=dev, generator=g)
    idx = torch.arange(40, device=dev)[None, :]
    pos_index = torch.where(idx < lens[:, None], idx, 39)
    caches = [KVCache.create(cfg, 8, 64, device=dev) for _ in range(2)]
    with torch.no_grad():
        lk, lp = (forward(params, cfg, toks, pos_index, c, plen=lens,
                          logit_rows=lens.long() - 1, plain=plain)[0]
                  for c, plain in zip(caches, (False, True)))
        compare(torch, f"Yi-34B int8 logits of a padded prefill of 8 prompts, plen "
                f"{lens.tolist()} (kernels vs plain)", lk[:, 0], lp[:, 0])
        tok = torch.argmax(lp[:, 0], dim=-1)
        lk, lp = (decode_step(params, cfg, tok, lens.long(), c, plain=plain)[0]
                  for c, plain in zip(caches, (False, True)))
        compare(torch, "Yi-34B int8 logits decode step at plen (kernels vs plain)", lk, lp)
        words = torch.randint(3, cfg.vocab_size, (8, 4), device=dev, generator=g)
        lk, lp = (forward_chunk(params, cfg, words, lens + 1, c, plain=plain)[0]
                  for c, plain in zip(caches, (False, True)))
        compare(torch, f"Yi-34B int8 forward_chunk T=4 ({4 * cfg.n_rep} rows a kv head) from "
                f"plen + 1 (kernels vs plain)", lk, lp)
        q8 = [QuantKVCache.create(cfg, 8, 64, device=dev) for _ in range(2)]
        for c in q8:
            for rows, q, sc in ((caches[1].k, c.k, c.ks), (caches[1].v, c.v, c.vs)):
                r8, rs = kv_quant_rows(rows)
                q.copy_(r8)
                sc.copy_(rs)
        tok = torch.argmax(lp[:, -1], dim=-1)
        n0 = da.launches_write_rows_q8
        lk, lp = (decode_step(params, cfg, tok, lens.long() + 5, c, plain=plain)[0]
                  for c, plain in zip(q8, (False, True)))
        compare(torch, "Yi-34B int8 logits decode step at plen + 5 on an int8 cache (kernels "
                "vs plain)", lk, lp)
        fused = da.launches_write_rows_q8 - n0
        if dev.type == "cuda" and fused != cfg.n_layers:
            raise SystemExit(f"FAILED Yi-34B decode step on an int8 cache: {fused} K7 launches "
                             f"wrote the step's rows (K6 in the walk), not one a layer")
    del caches, q8
    torch.cuda.empty_cache()


def profile_yi(torch, cfg, params) -> dict:
    """Yi-34B: one 8 x 512 admission (profile_prefill: K5's and the
    GEMM's device ms and share), then an 8-slot decode step and a verify
    round of 4 (28 query rows a kv head) at pos 64 of a 128-row bf16 cache
    (phase_profile, the device's events alone). Returns {"admission",
    "step", "round"}."""
    out = {"admission": profile_prefill(torch, cfg, params, label="Yi-34B int8")}
    for what, chunk in (("step", 1), ("round", SPEC_TICK + 1)):
        out[what] = phase_profile(torch, cfg, params, tag="profile_prefill_yi", chunk=chunk)
    log(f"[profile_prefill_yi] a verify round of {SPEC_TICK + 1} "
        f"{out['round']['device_ms']:.3f} device ms against a plain step "
        f"{out['step']['device_ms']:.3f}: "
        f"{out['round']['device_ms'] / max(out['step']['device_ms'], 1e-9):.3f}x")
    return out


def phase_model_ml(torch, cfg, params, tokenizer, dev=None) -> None:
    """Mistral-Large-Instruct-2407 int4 logits through the kernels against
    the plain path (which dequantizes one layer's weight at a time), rel TOL
    per row, at full depth on bf16 caches of 64 rows: a padded prefill of 8
    prompts of up to 40 tokens (plen 40, and 4, 5, 6, 10, 11, 29, 30: K5's
    "gqa" form holds 5 positions of the 12 heads a CTA, each q-tile edge
    and one past), the logits at each prompt's last row; a decode step at
    each slot's plen (K4 in its 16-row form); the same decode step under
    RAMA_ATTN_BLOCK 1 and 2 (K14 once a layer, every launch in the 16-row
    form), against the plain path under the same mode and the unfused plain
    step. Then a greedy generate_text of 32 tokens (the context cut to
    ML_MAX_LEN) must not be degenerate."""
    import dataclasses

    from rama_tpu_torch.models import llama
    from rama_tpu_torch.models.llama import KVCache, decode_step, forward
    from rama_tpu_torch.ops.kernels import attn_block as ab
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.runtime.generate import generate_text

    dev = dev or torch.device("cuda")
    lens = torch.tensor([40, 4, 5, 6, 10, 11, 29, 30], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(88)
    toks = torch.randint(3, cfg.vocab_size, (8, 40), device=dev, generator=g)
    idx = torch.arange(40, device=dev)[None, :]
    pos_index = torch.where(idx < lens[:, None], idx, 39)
    form = da.row_form(1, cfg.n_rep)[0]
    saved = llama.ATTN_BLOCK
    llama.ATTN_BLOCK = 0
    base = [KVCache.create(cfg, 8, 64, device=dev) for _ in range(2)]
    try:
        with torch.no_grad():
            lk, lp = (forward(params, cfg, toks, pos_index, c, plen=lens,
                              logit_rows=lens.long() - 1, plain=plain)[0]
                      for c, plain in zip(base, (False, True)))
            compare(torch, f"Mistral-Large int4 logits of a padded prefill of 8 prompts, plen "
                    f"{lens.tolist()} (kernels vs plain)", lk[:, 0], lp[:, 0])
            tok = torch.argmax(lp[:, 0], dim=-1)
            pos = lens.long()

            def step(mode, plain, c):
                llama.ATTN_BLOCK = mode
                cache = KVCache(k=c.k.clone(), v=c.v.clone())
                logits = decode_step(params, cfg, tok, pos, cache, plain=plain)[0]
                del cache
                return logits

            ref = step(0, True, base[1])
            n4 = (da.launches, da.launches_by_form["mma"][form])
            got = step(0, False, base[0])
            n = (da.launches - n4[0], da.launches_by_form["mma"][form] - n4[1])
            if n != (cfg.n_layers, cfg.n_layers):
                raise SystemExit(f"FAILED model_ml: K4 launched {n[0]} times in a decode step, "
                                 f"{n[1]} in its {form}-row form")
            compare(torch, f"Mistral-Large int4 logits decode step at plen (kernels vs plain, "
                    f"K4 {form}-row form)", got, ref)
            for mode in (1, 2):
                name = "attn_block_layered_int4" if mode == 2 else "attn_rope_write_layered"
                before = (ab.launches[name], ab.launches_by_form["mma"][form], da.launches)
                got = step(mode, False, base[0])
                n = (ab.launches[name] - before[0], ab.launches_by_form["mma"][form] - before[1],
                     da.launches - before[2])
                if n != (cfg.n_layers, cfg.n_layers, 0):
                    raise SystemExit(f"FAILED model_ml: {name} launched {n[0]} times in a "
                                     f"decode step, {n[1]} in the {form}-row form, K4 {n[2]}")
                compare(torch, f"Mistral-Large int4 logits decode step, attention block {mode} "
                        f"(kernels vs plain)", got, step(mode, True, base[1]))
                compare(torch, f"Mistral-Large int4 logits decode step, attention block {mode} "
                        f"(kernels vs the unfused plain path)", got, ref)
    finally:
        llama.ATTN_BLOCK = saved
        del base
        torch.cuda.empty_cache()
    t0 = time.time()
    text, ids = generate_text(params, dataclasses.replace(cfg, seq_len=ML_MAX_LEN), tokenizer,
                              "Once upon a time", steps=32, temperature=0.0)
    gen = ids[len(tokenizer.encode("Once upon a time")):]
    log(f"[model_ml] greedy generate_text: {len(ids)} ids in {time.time() - t0:.2f} s; "
        f"generated {gen[:16]}...")
    if len(set(gen)) < 2:
        raise SystemExit(f"FAILED model_ml: degenerate greedy trajectory {gen}")


def profile_ml_ab(torch, cfg, params) -> dict:
    """Mistral-Large int4: device ms (by kernel: K14's split / combine and
    K1's wo beside K4's 16-row form), host ms and the device busy share per
    8-slot decode step under RAMA_ATTN_BLOCK 0, 1 and 2, at positions 64
    and 480 of a 512-row bf16 cache (the serving paths' max_len), in one
    run."""
    from rama_tpu_torch.models import llama
    from rama_tpu_torch.models.llama import KVCache

    cache = KVCache.create(cfg, 8, ML_MAX_LEN, device=torch.device("cuda"))
    table = {}
    saved = llama.ATTN_BLOCK
    try:
        for mode in (0, 1, 2):
            llama.ATTN_BLOCK = mode
            for start in (64, 480):
                table[f"mode {mode} pos {start}"] = phase_profile(
                    torch, cfg, params, tag=f"profile_ml_ab mode {mode}", cache=cache,
                    start=start)
    finally:
        llama.ATTN_BLOCK = saved
    del cache
    torch.cuda.empty_cache()
    log(f"[profile_ml_ab] per 8-slot decode step: {json.dumps(table)}")
    return table


def phase_spec_gqa_self(torch, cfg, params, tokenizer, start_count=lambda: None) -> None:
    """TinyLlama as its own draft at spec_tick GQA_SPEC_TICK (verify rounds
    of T 8: 64 query rows a kv head against the draft's 8-row decode
    steps), greedy, 2 slots x 16 tokens: the accept rate must be >= 0.9
    (PERF.md §2's gate), after a spec-off run of the same requests."""
    t0 = time.time()
    off, on, stats = self_draft(cfg, params, tokenizer, start_count, spec_tick=GQA_SPEC_TICK)
    firsts = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), None)
              for x, y in zip(on, off)]
    log(f"[spec_gqa_self] TinyLlama as its own draft at T {GQA_SPEC_TICK + 1}: accept rate "
        f"{stats['spec_accept_rate']}, first position differing from spec off per stream "
        f"{firsts} (None: equal), {time.time() - t0:.1f} s")
    if not (stats["spec_accept_rate"] or 0) >= 0.9:
        raise SystemExit(f"FAILED spec_gqa_self: accept rate {stats['spec_accept_rate']} < 0.9")


def phase_model_b64(torch, cfg, params) -> None:
    """Llama-2-7B int8 logits at 64 slots through the kernels against the
    plain path, rel TOL per row, on a bf16 cache of 64 rows: a prefill of 64
    prompts of 8 tokens, a decode step at 8 (K3 at M = 64: its "one" form,
    one launch a layer) and forward_chunk at T 4 from 9 (M = 256: the
    "rows" form, four row blocks, one launch a layer)."""
    from rama_tpu_torch.models.llama import KVCache, decode_step, forward_chunk, prefill
    from rama_tpu_torch.ops.kernels import ffn as ffn_mod

    dev = torch.device("cuda")
    b = B64_SLOTS
    g = torch.Generator(device=dev).manual_seed(64)
    toks = torch.randint(3, cfg.vocab_size, (b, 8), device=dev, generator=g)
    caches = [KVCache.create(cfg, b, 64, device=dev) for _ in range(2)]
    with torch.no_grad():
        lk, lp = (prefill(params, cfg, toks, c, last_only=True, plain=plain)[0]
                  for c, plain in zip(caches, (False, True)))
        compare(torch, f"7B int8 logits prefill of {b} prompts (kernels vs plain)", lk[:, -1],
                lp[:, -1])
        tok = torch.argmax(lp[:, -1], dim=-1)
        for what, form, fn in (
                ("decode step at 8", "one",
                 lambda c, plain: decode_step(params, cfg, tok, torch.full((b,), 8, device=dev),
                                              c, plain=plain)[0]),
                ("forward_chunk T=4 from 9", "rows",
                 lambda c, plain: forward_chunk(params, cfg, toks[:, :4],
                                                torch.full((b,), 9, dtype=torch.int32,
                                                           device=dev), c, plain=plain)[0])):
            before = dict(ffn_mod.launches_by_form)
            lk = fn(caches[0], False)
            ran = {f: ffn_mod.launches_by_form[f] - before[f] for f in before}
            if ran != {f: cfg.n_layers * (f == form) for f in before}:
                raise SystemExit(f"FAILED model_b64 {what}: K3 launches by form {ran}, expected "
                                 f"{cfg.n_layers} on {form}")
            compare(torch, f"7B int8 logits {what} at {b} slots, K3 {form} form (kernels vs "
                    f"plain)", lk, fn(caches[1], True))
    del caches
    torch.cuda.empty_cache()


def profile_b64(torch, cfg, params) -> dict:
    """Llama-2-7B int8 at 64 slots: decode steps (K3 at M = 64) and verify
    rounds of 4 (M = 256: K3's rows form, the GEMM for wqkv / wo / lm_head)
    at pos 64 of a 128-row bf16 cache (phase_profile, the device's events
    alone): device ms, K3's and K1's ms and share. Returns {"step",
    "round"}."""
    from rama_tpu_torch.models.llama import KVCache

    cache = KVCache.create(cfg, B64_SLOTS, 128, device=torch.device("cuda"))
    out = {what: phase_profile(torch, cfg, params, tag="profile_b64", cache=cache, chunk=chunk,
                               slots=B64_SLOTS)
           for what, chunk in (("step", 1), ("round", SPEC_TICK + 1))}
    step, rnd = out["step"], out["round"]
    log(f"[profile_b64] {B64_SLOTS} slots: a step {step['device_ms']:.3f} device ms (K3 "
        f"{step['k3_ms']:.3f} = {step['k3_share']:.4f}, K1 {step['k1_ms']:.3f} = "
        f"{step['k1_share']:.4f}); a verify round of {SPEC_TICK + 1} {rnd['device_ms']:.3f} "
        f"(K3 {rnd['k3_ms']:.3f} = {rnd['k3_share']:.4f}, K1 {rnd['k1_ms']:.3f} = "
        f"{rnd['k1_share']:.4f}): {rnd['device_ms'] / max(step['device_ms'], 1e-9):.3f}x")
    del cache
    torch.cuda.empty_cache()
    return out


def profile_gqa_spec(torch, cfg, params) -> dict:
    """TinyLlama: a verify round of T 8 (64 query rows a kv head) against a
    plain decode step, 8 slots on a bf16 cache of seq_len rows, at pos 64
    and pos 1024 (phase_profile, the device's events alone). Returns {"pos": {"step": ..., "round":
    ...}}."""
    from rama_tpu_torch.models.llama import KVCache

    cache = KVCache.create(cfg, 8, cfg.seq_len, device=torch.device("cuda"))
    out = {}
    for start in (64, 1024):
        out[str(start)] = {what: phase_profile(torch, cfg, params, tag="profile_gqa_spec",
                                               cache=cache, start=start, chunk=chunk)
                           for what, chunk in (("step", 1), ("round", GQA_SPEC_TICK + 1))}
        step, rnd = out[str(start)]["step"], out[str(start)]["round"]
        log(f"[profile_gqa_spec] pos {start}: a verify round of {GQA_SPEC_TICK + 1} "
            f"{rnd['device_ms']:.3f} device ms (attention {rnd['attn_ms']:.4f}; K3 "
            f"{rnd['k3_ms']:.3f} = {rnd['k3_share']:.4f}, K1 {rnd['k1_ms']:.3f} = "
            f"{rnd['k1_share']:.4f}) against a plain step {step['device_ms']:.3f} (attention "
            f"{step['attn_ms']:.4f}; K3 {step['k3_ms']:.3f} = {step['k3_share']:.4f}, K1 "
            f"{step['k1_ms']:.3f} = {step['k1_share']:.4f}): "
            f"{rnd['device_ms'] / max(step['device_ms'], 1e-9):.3f}x")
    del cache
    torch.cuda.empty_cache()
    return out



def phase_kernels_kv8(torch, results: dict) -> None:
    """The int8 KV cache's kernels vs their plain versions: K6 (row writer)
    and K8 (strip inserter) exactly, K7 (int8 decode attention) within TOL
    per (slot, head); at the 7B shapes of an 8-slot 4096-row cache and at
    the tiny / stories15M shapes."""
    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kvw

    dev = torch.device("cuda")
    cfg = seven_b_config(ModelConfig)
    g = torch.Generator(device=dev).manual_seed(6)
    bf, f32 = torch.bfloat16, torch.float32
    L, nh, nkv, hd, B, S = (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 8,
                            KV8_MAX_LEN)

    def rx(*shape, dtype=bf):
        return torch.randn(shape, device=dev, generator=g).to(dtype)

    def rcache(l, b, n, s, d):
        """Random int8 bytes and scales (the writers' checks)."""
        return [torch.randint(-127, 128, (l, b, n, s, d), dtype=torch.int8, device=dev,
                              generator=g) for _ in range(2)] + [
            torch.rand((l, b, n, s), device=dev, generator=g) for _ in range(2)]

    def qcache(l, b, n, s, d):
        return quantized_cache(torch, kvw, rx, l, b, n, s, d)

    def rows(*shape, dtype=bf):
        """Rows of mixed magnitude with a zero row and a row of .5 ties."""
        x = rx(*shape, dtype=f32) * (torch.rand(shape[:-1] + (1,), device=dev, generator=g)
                                     * 30 + 1e-3)
        flat = x.view(-1, shape[-1])
        flat[0] = 0
        flat[1] = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5, 4.5],
                               device=dev).repeat(shape[-1] // 8)
        return x.to(dtype)

    def same(name, got, want) -> float:
        """Exact: every int8 byte and f32 scale of the cache."""
        diff = [i for i, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)]
        log(f"[check] {name}: {'exact' if not diff else f'tensors {diff} differ'}")
        if diff:
            raise SystemExit(f"FAILED {name}: cache tensors {diff} (k8, v8, ks, vs) differ "
                             f"from the plain version's")
        return 0.0

    # -- K6: write_kv_rows_q8 ----------------------------------------------------
    c1 = rcache(L, B, nkv, S, hd)
    c2 = [t.clone() for t in c1]
    pos = torch.tensor([0, 31, 32, S - 1, 1000, 2047, 2048, S + 4], dtype=torch.int32,
                       device=dev)                      # S + 4: a finished slot's overshoot
    for dt in (bf, f32):
        k, v = rows(B, nkv, hd, dtype=dt), rows(B, nkv, hd, dtype=dt)
        for l in (0, L - 1):
            kvw.write_kv_rows_q8(*c1, k, v, pos, l)
            kvw.write_kv_rows_q8_plain(*c2, k, v, pos, l)
            err = same(f"write_kv_rows_q8 B={B} nkv={nkv} S={S} layer={l} pos={pos.tolist()} {dt}",
                       c1, c2)
    for cname, (b_, n_, s_, d_) in {"tiny": (3, 2, 48, 16), "stories15M": (5, 6, 64, 48)}.items():
        t1 = rcache(3, b_, n_, s_, d_)
        t2 = [t.clone() for t in t1]
        pt = torch.tensor([0, 31, s_ - 1, 5, 32][:b_], dtype=torch.int32, device=dev)
        for dt in (bf, f32):
            k, v = rows(b_, n_, d_, dtype=dt), rows(b_, n_, d_, dtype=dt)
            kvw.write_kv_rows_q8(*t1, k, v, pt, 2)
            kvw.write_kv_rows_q8_plain(*t2, k, v, pt, 2)
            same(f"write_kv_rows_q8 {cname} hd={d_} {dt}", t1, t2)
    k, v = rows(B, nkv, hd), rows(B, nkv, hd)
    lay = Layered(L)
    t_k = time_ms(torch, lambda: kvw.write_kv_rows_q8(*c1, k, v, pos, lay.next()))
    k6_dev = graph_device_ms(torch, {"k6": lambda: kvw.write_kv_rows_q8(*c1, k, v, pos,
                                                                        lay.next())})["k6"]
    t_p = time_ms(torch, lambda: kvw.write_kv_rows_q8_plain(*c2, k, v, pos, lay.next()))
    n_el = 2 * B * nkv * hd
    b_ms, b_by = bound_ms(write_bytes(B, 1, nkv, hd), 3 * n_el)
    log(f"[time] write_kv_rows_q8 B={B}: {t_k:.4f} ms (device {k6_dev:.4f}, CUDA events over a "
        f"graph of 20 launches), plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    results["write_kv_rows_q8"] = dict(
        name="write_kv_rows_q8", route="cuda", source="rama_tpu_torch/csrc/kv_write.cu",
        replaces="rama_tpu/ops/pallas/kv_write.py:49", max_abs_err=err, ms=t_k,
        device_ms=k6_dev, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"k/v rows (8, 32, 128) bf16 -> cache (32, 8, 32, {S}, 128) int8 + scales, "
              f"pos {pos.tolist()}")

    # -- K8: write_kv_strips_q8 --------------------------------------------------
    # the streaming body (bf16 at hd 48 / 64 / 128) and the warp-a-row body
    # forced on the same inputs, each byte for byte against the plain version
    # (every int8 byte and f32 scale of the cache): the 7B serving bucket
    # (8 x 16: runs of 4 kv heads), an 8 x 512 admission (runs of 64 rows),
    # t_ins 300 of T 512 with n = 3 < K, S = 1000 (no multiple of 64),
    # TinyLlama's hd 64 and stories15M's hd 48 (short strips: several heads
    # a CTA), a duplicate slot (identical strips) and slots -1 and B (written
    # nowhere: the cache's bytes must not move)
    del c2
    torch.cuda.empty_cache()

    def k8_check(label, c, k, v, slots, t_ins, bodies=("stream", "rows")):
        base = [x.clone() for x in c]
        want = [x.clone() for x in c]
        kvw.write_kv_strips_q8_plain(*want, k, v, slots, t_ins)
        hd_, B_ = c[0].shape[4], c[0].shape[1]
        for body in bodies:
            n0 = kvw.strips_launches_by_body[body]
            kvw.write_kv_strips_q8(*c, k, v, slots, t_ins,
                                   _body=None if body == kvw.prefill_body_for(k.dtype, hd_)
                                   else body)
            if kvw.strips_launches_by_body[body] != n0 + 1:
                raise SystemExit(f"FAILED write_kv_strips_q8 {label}: no launch on the {body} "
                                 f"body ({kvw.strips_launches_by_body})")
            same(f"write_kv_strips_q8 [{body}] {label} slots={slots.tolist()} t_ins={t_ins}",
                 c, want)
            keep = [b_ for b_ in range(B_) if b_ not in slots.tolist()]
            if keep and any(not torch.equal(x[:, keep], y[:, keep]) for x, y in zip(c, base)):
                raise SystemExit(f"FAILED write_kv_strips_q8 [{body}] {label}: a slot no strip "
                                 f"names moved")
            for x, y in zip(c, base):
                x.copy_(y)
        del base, want
        return 0.0

    slots = torch.tensor([5, 2, 7, 0, 3, 6, 1, 4], dtype=torch.int32, device=dev)
    for T, t_ins, n in ((16, 16, 8), (512, 512, 8), (512, 300, 3)):
        k, v = rows(L, B, nkv, T, hd), rows(L, B, nkv, T, hd)
        err = k8_check(f"7B L={L} K={B} T={T} S={S}", c1, k, v, slots[:n], t_ins)
        del k, v
    edge = {   # (layers, slots, kv heads, S, T, t_ins, head_dim, slots)
        "S=1000": (4, 4, 32, 1000, 1000, 1000, 128, [2, 0, 3]),
        "S=1000 t_ins=999": (4, 4, 32, 1000, 1000, 999, 128, [1, 3]),
        "TinyLlama hd=64": (4, 8, 4, 2048, 64, 40, 64, [6, 1, 3, 0]),
        "stories15M hd=48": (6, 4, 6, 256, 16, 16, 48, [3, 1, 0]),
        "duplicate slot": (4, 8, 32, 512, 16, 16, 128, [4, 1, 1, 6]),
        "slots -1 and B": (4, 8, 32, 512, 64, 64, 128, [-1, 2, 8, 5]),
    }
    for label, (l_, b_, n_, s_, T, t_ins, d_, sl) in edge.items():
        c = rcache(l_, b_, n_, s_, d_)
        k, v = rows(l_, len(sl), n_, T, d_), rows(l_, len(sl), n_, T, d_)
        for j in range(1, len(sl)):
            if sl[j] == sl[j - 1]:                      # identical strips
                k[:, j], v[:, j] = k[:, j - 1], v[:, j - 1]
        k8_check(label, c, k, v, torch.tensor(sl, dtype=torch.int32, device=dev), t_ins)
        del c, k, v
    for cname, (l_, n_, s_, d_) in {"tiny": (3, 2, 48, 16), "stories15M": (6, 6, 64, 48)}.items():
        t1 = rcache(l_, 4, n_, s_, d_)
        k, v = rows(l_, 3, n_, 16, d_, dtype=f32), rows(l_, 3, n_, 16, d_, dtype=f32)
        v[:, 2], k[:, 2] = v[:, 1], k[:, 1]
        k8_check(f"{cname} hd={d_} fp32", t1, k, v,
                 torch.tensor([3, 1, 1], dtype=torch.int32, device=dev), 16, bodies=("rows",))
    # a replay from a CUDA graph writes the eager launch's bytes
    c = rcache(4, B, nkv, 512, hd)
    k, v = rows(4, B, nkv, 40, hd), rows(4, B, nkv, 40, hd)
    eager, graph_c = [x.clone() for x in c], [x.clone() for x in c]
    kvw.write_kv_strips_q8(*eager, k, v, slots[:5], 40)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kvw.write_kv_strips_q8(*graph_c, k, v, slots[:5], 40)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kvw.write_kv_strips_q8(*graph_c, k, v, slots[:5], 40)
    for x, y in zip(graph_c, c):
        x.copy_(y)
    graph.replay()
    torch.cuda.synchronize()
    same("write_kv_strips_q8 [stream] replayed from a CUDA graph", graph_c, eager)
    del c, k, v, eager, graph_c, graph
    # timed at the serving bucket (16 rows) and at an 8 x 512 admission: the
    # streaming body beside the warp-a-row body (the parent's) on the same
    # inputs, graphs of 20 in turns
    timed = {}
    for T in (16, 512):
        k, v = rows(L, B, nkv, T, hd), rows(L, B, nkv, T, hd)
        stream = lambda: kvw.write_kv_strips_q8(*c1, k, v, slots, T)   # noqa: E731
        rows_body = lambda: kvw.write_kv_strips_q8(*c1, k, v, slots, T,  # noqa: E731
                                                   _body="rows")
        dev_ms = graph_device_ms(torch, {"stream_ms": stream, "rows_ms": rows_body})
        t_k = time_ms(torch, stream)
        t_r = time_ms(torch, rows_body)
        t_p = time_ms(torch, lambda: kvw.write_kv_strips_q8_plain(*c1, k, v, slots, T),
                      reps=3 if T > 16 else 5)
        n_el = 2 * L * B * nkv * T * hd
        nbytes = n_el * 2 + n_el + 2 * L * B * nkv * T * 4 + slots.numel() * 4
        b_ms, b_by = bound_ms(nbytes, 3 * n_el)
        log(f"[time] write_kv_strips_q8 T={T}: {t_k:.4f} ms (device {dev_ms['stream_ms']:.4f}, "
            f"{b_ms / dev_ms['stream_ms']:.2f} of the bound), the warp-a-row body {t_r:.4f} ms "
            f"(device {dev_ms['rows_ms']:.4f}, {b_ms / dev_ms['rows_ms']:.2f}), plain "
            f"{t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}) for {nbytes / 1e6:.1f} MB")
        timed[T] = dict(
            max_abs_err=err, ms=t_k, device_ms=dev_ms["stream_ms"], plain_ms=t_p,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            breakdown=dict(bound_share=b_ms / dev_ms["stream_ms"]),
            rows_body=dict(ms=t_r, device_ms=dev_ms["rows_ms"],
                           bound_share=b_ms / dev_ms["rows_ms"]),
            shape=f"strips ({L}, {B}, {nkv}, {T}, {hd}) bf16 -> slots {slots.tolist()} of the "
                  f"({L}, {B}, {nkv}, {S}, {hd}) int8 cache")
        del k, v
        torch.cuda.empty_cache()
    results["write_kv_strips_q8"] = dict(
        name="write_kv_strips_q8", route="cuda", source="rama_tpu_torch/csrc/kv_write.cu",
        replaces="rama_tpu/ops/pallas/kv_write.py:221",
        library_note="no single PyTorch call quantizes strips and scatters them into slots",
        **timed[16], t512=timed[512])
    del c1
    torch.cuda.empty_cache()

    # -- K7: decode_attention_q8 -------------------------------------------------
    def attn_checks(c, q, pos, layers, label, split_edges):
        for planted in (False, True):
            for l in layers:
                if planted:
                    plant_decode_edges_q8(kvw, q, c[0], c[2], pos, l, split_edges)
                name = (f"decode_attention_q8 {label} layer={l} pos={pos.tolist()}"
                        f"{' planted edges' if planted else ''}")
                compare(torch, name,
                        on_body(da.launches_by_body, "walk", name,
                                lambda: da.decode_attention_q8(q, *c, pos, l)),
                        da.decode_attention_q8_plain(q, *c, pos, l), per=q.shape[-1])

    def time_attn(c, q, pos, n_layers) -> dict:
        err = compare(torch, f"decode_attention_q8 timed inputs S={c[0].shape[3]} (layer 0)",
                      da.decode_attention_q8(q, *c, pos, 0),
                      da.decode_attention_q8_plain(q, *c, pos, 0), per=q.shape[-1])
        lay = Layered(n_layers)
        t_k = time_ms(torch, lambda: da.decode_attention_q8(q, *c, pos, lay.next()))
        t_p = time_ms(torch, lambda: da.decode_attention_q8_plain(q, *c, pos, lay.next()),
                      reps=5)
        s_ = c[0].shape[3]
        n_rows = int((pos.clamp(0, s_ - 1) + 1).sum())
        nb = n_rows * nkv * (2 * hd + 2 * 4) + 2 * q.numel() * 2
        b_ms, b_by = bound_ms(nb, n_rows * nh * hd * 4)

        def k7():
            return da.decode_attention_q8(q, *c, pos, lay.next())

        # split and combine device ms (the split kernel must be dattn_walk),
        # the grid, the occupancy, and G swept on the same inputs
        parts = with_share(attention_split_combine(torch, k7), b_ms)
        check_split_body(f"decode_attention_q8 S={s_}", parts, "walk")
        check_walk_grid(da, f"decode_attention_q8 S={s_}", parts, pos, 1, s_, nkv, hd)
        parts["occupancy"] = da.occupancy(1, nh, nkv, hd, True)
        # G swept past the plan's (the wrapper's launch with another G)
        parts["sweep_tiles"] = {g: with_share(attention_split_combine(
            torch, lambda: da._launch(q[:, None], c, pos, lay.next(), "decode_attention_q8",
                                      tiles=g)), b_ms) for g in (1, 2, 4, 8)}
        log(f"[time] decode_attention_q8 S={s_} breakdown {json.dumps(parts)}")
        return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                    library_ms=None, breakdown=parts,
                    shape=f"q (8, 32, 128) bf16, int8 cache ({n_layers}, 8, 32, {s_}, 128) + "
                          f"f32 row scales, pos {pos.tolist()}")

    q = rx(B, nh, hd)
    pos4 = torch.tensor([0, 255, 256, 1023, 63, 64, 511, 700], dtype=torch.int32, device=dev)
    c = qcache(L, B, nkv, 1024, hd)
    attn_checks(c, q, pos4, (0, L - 1), "B=8 S=1024", (63, 64, 255, 256, 511, 512, 1023))
    c = qcache(L, B, nkv, 1024, hd)                     # timed on unplanted rows
    results["decode_attention_q8"] = dict(
        name="decode_attention_q8", route="cuda",
        source="rama_tpu_torch/csrc/decode_attention.cu",
        replaces="rama_tpu/ops/pallas/decode_attention.py:556", **time_attn(c, q, pos4, L))
    del c
    torch.cuda.empty_cache()
    pos_long = torch.tensor([0, 63, 64, 255, 1023, 2047, 4000, 4095], dtype=torch.int32,
                            device=dev)
    c = qcache(4, B, nkv, S, hd)
    attn_checks(c, q, pos_long, (0, 3), f"B=8 S={S}",
                (63, 64, 1023, 1024, 2047, 2048, 3967, 3968, 4031, 4032, 4095))
    c = qcache(4, B, nkv, S, hd)
    results["decode_attention_q8"]["s4096"] = time_attn(c, q, pos_long, 4)
    del c
    # GQA rep 2 (tiny), 4 and 1 (stories15M's hd 48), fp32 and bf16 q
    for nh_s, nkv_s, hd_s in ((4, 2, 16), (8, 2, 16), (6, 6, 48), (8, 2, 128)):
        for dt in (bf, f32):
            cs = qcache(2, 3, nkv_s, 80, hd_s)
            qs = rx(3, nh_s, hd_s, dtype=dt)
            ps = torch.tensor([0, 64, 79], dtype=torch.int32, device=dev)
            body = da.body_for(dt, hd_s, q8=True)
            name = f"decode_attention_q8 rep={nh_s // nkv_s} hd={hd_s} {dt} [{body}]"
            compare(torch, name, on_body(da.launches_by_body, body, name,
                                         lambda: da.decode_attention_q8(qs, *cs, ps, 1)),
                    da.decode_attention_q8_plain(qs, *cs, ps, 1), per=hd_s)

    # -- K6 inside K7: the decode step's rows written by the walk launch -----------
    # positions on the 64-row tile edges, S - 1 and a finished slot's
    # overshoot (S, S + 3: K6's rule, the row on S - 1); planted: the cache's
    # edge rows carry keys aligned with q, and so does the new row of slot 0
    c = qcache(2, B, nkv, S, hd)
    pos_w = torch.tensor([0, 63, 64, 1023, 2047, S - 1, S, S + 3], dtype=torch.int32,
                         device=dev)
    q1 = rx(B, 1, nh, hd)
    for planted in (False, True):
        kn, vn = rows(B, 1, nkv, hd), rows(B, 1, nkv, hd)
        if planted:
            plant_decode_edges_q8(kvw, q1[:, 0], c[0], c[2], pos_w, 1,
                                  (63, 64, 1023, 1024, 2047, 2048, S - 1))
            kn[0, 0] = group_key(q1[0, 0] * 0.5, nkv).to(bf)
        for l in (0, 1):
            check_fused_form(torch, f"decode_attention_q8 + rows (K6 in K7) S={S} layer={l} "
                             f"pos={pos_w.tolist()}{' planted edges' if planted else ''}", c, q1,
                             pos_w, None, kn, vn, l, decode=True)
    del c
    # timed at serve_kv8's shape: 8 slots, 4096 rows, 4 layers cycled
    c = qcache(4, B, nkv, S, hd)
    q1, kn, vn = rx(B, 1, nh, hd), rx(B, 1, nkv, hd), rx(B, 1, nkv, hd)
    err = check_fused_form(torch, f"decode_attention_q8 + rows (K6 in K7) timed inputs S={S}", c,
                           q1, pos_long, None, kn, vn, 0, decode=True)
    lay = Layered(4)
    fused, pair, plain = fused_write_forms(False, 1, decode=True)
    args = (q1, pos_long, None, kn, vn)
    dev_ms = fused_write_times(
        torch, f"K6 in K7 S={S}",
        lambda: da.decode_attention_q8(q1[:, 0], *c, pos_long, lay.next()),
        lambda: fused(c, *args, lay.next()), lambda: pair(c, *args, lay.next()),
        lambda: kvw.write_kv_rows_q8(*c, kn[:, 0], vn[:, 0], pos_long, lay.next()))
    t_f = time_ms(torch, lambda: fused(c, *args, lay.next()))
    t_fp = time_ms(torch, lambda: plain(c, *args, lay.next()), reps=5)
    nb, ops = attention_bytes_ops(pos_long, 1, S, nkv, nh, hd, 2 * hd + 8, q1.numel() * 2,
                                  written=True)
    n_el = 2 * B * nkv * hd
    fb_ms, fb_by = bound_ms(nb + write_bytes(B, 1, nkv, hd), ops + 3 * n_el)
    log(f"[time] decode_attention_q8 + rows (K6 in K7) S={S}: {t_f:.4f} ms (device "
        f"{dev_ms['fused_ms']:.4f}), plain {t_fp:.4f} ms, bound {fb_ms:.4f} ms ({fb_by})")
    k6 = results["write_kv_rows_q8"]
    results["write_kv_rows_q8"] = dict(
        name="write_kv_rows_q8", route="cuda", source="rama_tpu_torch/csrc/decode_attention.cu",
        replaces="rama_tpu/ops/pallas/kv_write.py:49", max_abs_err=err, ms=t_f,
        device_ms=dev_ms["fused_ms"], plain_ms=t_fp, bound_ms=fb_ms, bound_by=fb_by,
        library_ms=None,
        library_note="the rows are written inside K7's int8 walk launch (dattn_walk, K6's "
                     "row rule); no single PyTorch call quantizes rows, scatters them and "
                     "attends over an int8 cache",
        breakdown=dict(dev_ms, write_bound_ms=k6["bound_ms"]),
        standalone=dict(k6, same_call_device_ms=dev_ms["writer_ms"]),
        shape=f"q ({B}, {nh}, {hd}) bf16 and k/v rows ({B}, {nkv}, {hd}) bf16 -> int8 cache "
              f"(4, {B}, {nkv}, {S}, {hd}) + scales, pos {pos_long.tolist()}")
    del c
    torch.cuda.empty_cache()
    for name in ("write_kv_rows_q8", "write_kv_strips_q8", "decode_attention_q8"):
        r = results[name]
        log(f"[kernel] {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    r = results["decode_attention_q8"]["s4096"]
    log(f"[kernel] decode_attention_q8 S={S}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def attention_bytes_ops(pos0, t: int, s: int, nkv: int, nh: int, hd: int, row_bytes: float,
                        q_bytes: float, written: bool = False) -> tuple[float, float]:
    """Bytes and flops of T-query chunk attention for this run's positions:
    each slot reads its K and V rows 0 .. min(pos0 + T - 1, S - 1) once
    (row_bytes a row and kv head, K and V together), q in and out once;
    query t does 4 flops per visible row and head dim. `written`: the same
    launch writes the chunk's rows pos0 .. pos0 + T - 1 (their bytes are
    counted by write_bytes), so it reads none of them back."""
    p = pos0.long().cpu()
    rows = (p + t - 1).clamp(0, s - 1) + 1
    if written:
        rows = rows - ((p + t).clamp(max=s) - p.clamp(max=s)).clamp(min=0)
    seen = sum(int(((p + i).clamp(0, s - 1) + 1).sum()) for i in range(t))
    return float(rows.sum()) * nkv * row_bytes + 2 * q_bytes, seen * nh * hd * 4.0


def attention_split_combine(torch, fn, reps: int = 10, tries: int = 3) -> dict:
    """Device ms per launch of the decode / chunk attention's two kernels,
    the split kernel (either body) and the combine pass, by torch.profiler
    over `reps` calls of fn, with the split kernel's name as the profiler
    gives it, and the grids it was launched with (`split_grid`, read from
    the session's trace; `split_ctas` their CTAs where every launch had one
    grid). A session that records no split kernel (the profiler sometimes
    records no device event) is repeated, up to `tries`; after that the
    times are 0, the name and grid lists empty and `split_ctas` None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {"split_ms": 0.0, "combine_ms": 0.0, "split_kernel": [], "split_grid": [],
               "split_ctas": None}
        for ev in prof.key_averages():
            dt = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            if any(k in ev.key for k in ATTN_SPLIT_KERNELS):
                out["split_ms"] += dt / 1e3 / reps
                out["split_kernel"].append(ev.key.split("(")[0])
            elif "dattn_combine" in ev.key:
                out["combine_ms"] += dt / 1e3 / reps
        if out["split_kernel"]:
            with tempfile.TemporaryDirectory() as d:
                prof.export_chrome_trace(os.path.join(d, "trace.json"))
                with open(os.path.join(d, "trace.json")) as f:
                    out["split_grid"] = kernel_grids(json.load(f), ATTN_SPLIT_KERNELS)
            if len(out["split_grid"]) == 1:
                out["split_ctas"] = math.prod(out["split_grid"][0])
            break
    return out


def kernel_grids(trace: dict, names) -> list:
    """The distinct launch grids [x, y, z] of the kernels whose name holds
    one of `names` in a Chrome trace as torch.profiler exports it (a kernel
    event's args.grid), sorted."""
    grids = {tuple(ev["args"]["grid"]) for ev in trace.get("traceEvents", [])
             if ev.get("cat") == "kernel" and any(n in ev.get("name", "") for n in names)
             and "grid" in ev.get("args", {})}
    return [list(g) for g in sorted(grids)]


def check_split_body(label: str, parts: dict, body: str) -> None:
    """Fail unless every split kernel that attention_split_combine saw is
    `body`'s: dattn_mma for "mma", dattn_walk for "walk", dattn_split for
    "simt". Where the
    profiler saw none (no device event in any session) a line says so; the
    launch counts by body still check the body."""
    want = {"mma": "dattn_mma<", "walk": "dattn_walk<", "simt": "dattn_split<"}[body]
    names = parts["split_kernel"]
    if not names:
        log(f"[check] {label}: torch.profiler recorded no split kernel; its body is "
            f"checked by the launch counts only")
    elif not all(want in k for k in names):
        raise SystemExit(f"FAILED {label}: split kernel {names}, not {want}...>")


def walk_work(da, pos0, t: int, s: int, nkv: int, ps: int | None = None) -> dict:
    """Worked out from the positions, not measured: the plan (tile, G,
    nsplit) of a walk launch of T queries a slot from pos0 over s cache
    rows (a pool of ps-row pages), its (slot, split, kv head) items that
    hold a visible row, and the CTAs of a grid of one CTA a tile
    (ceil(s / tile) x nkv x B), of which those with a visible row."""
    plan = da.split_plan(s, ps, walk=True)
    lasts = [max(0, min(p + t - 1, s - 1)) for p in pos0.tolist()]
    tiles = [last // plan.tile + 1 for last in lasts]
    return dict(tile=plan.tile, tiles=plan.tiles, nsplit=plan.nsplit,
                splits_with_work=sum(-(-n // plan.tiles) for n in tiles) * nkv,
                one_cta_a_tile=-(-s // plan.tile) * nkv * len(lasts),
                one_cta_a_tile_with_work=sum(tiles) * nkv)


def check_walk_grid(da, label: str, parts: dict, pos0, t: int, s: int, nkv: int, hd: int,
                    ps: int | None = None, rep: int = 1) -> None:
    """Fail unless the split grid torch.profiler recorded (parts of
    attention_split_combine) has the CTAs the wrapper asks for (walk_ctas
    over one wave of the launched form, times nkv * row groups); log them
    beside walk_work's computed figures. Where no grid was recorded a line
    says so."""
    work = walk_work(da, pos0, t, s, nkv, ps)
    form, groups = da.row_form(t, rep)
    want = da.walk_ctas(len(pos0), nkv * groups, work["nsplit"],
                        da.walk_wave(0, hd, form)) * nkv * groups
    got = parts["split_ctas"]
    if got is None:
        log(f"[grid] {label}: torch.profiler recorded no single split grid "
            f"({parts['split_grid']}); the wrapper asks for {want} CTAs")
    elif got != want:
        raise SystemExit(f"FAILED {label}: split grid {parts['split_grid']} launched {got} "
                         f"CTAs, the wrapper asks for {want}")
    log(f"[grid] {label}: {'not measured' if got is None else got} CTAs launched (profiled grid {parts['split_grid']}) for "
        f"{work['splits_with_work']} splits with work (computed from the positions, G "
        f"{work['tiles']}); one CTA a {work['tile']}-row tile would launch "
        f"{work['one_cta_a_tile']}, {work['one_cta_a_tile_with_work']} with work (computed)")


def with_share(parts: dict, b_ms: float) -> dict:
    """attention_split_combine's times with the bound's share of split +
    combine beside them."""
    total = parts["split_ms"] + parts["combine_ms"]
    return {**parts, "bound_share": b_ms / total if total else None}


def on_body(counts: dict, body: str, label: str, fn):
    """Run fn (one kernel launch) and fail unless it launched once, on
    `body`, by `counts` (a wrapper's launches by body). Returns fn()."""
    before = dict(counts)
    out = fn()
    ran = {b: counts[b] - before[b] for b in counts}
    if ran != {b: int(b == body) for b in counts}:
        raise SystemExit(f"FAILED {label}: launches by body {ran}, not one on {body}")
    return out


def device_ms_per_call(torch, fn, reps: int = 10, tries: int = 3) -> float:
    """Device ms per call of fn: the time of every kernel it launched, by
    torch.profiler over `reps` calls (the host's enqueue time excluded).
    A session that records no device event at all (seen once in a long
    run) is repeated; after `tries` such sessions the CUDA-event time of
    the calls is returned instead, and a line says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for ev in prof.key_averages():
            if ev.device_type.name == "CUDA":
                total += (getattr(ev, "device_time_total", None)
                          or getattr(ev, "cuda_time_total", 0))
        if total > 0:
            return total / 1e3 / reps
    log(f"[device] torch.profiler recorded no device time in {tries} sessions: "
        f"CUDA-event time used in place of device time")
    return time_ms(torch, fn, reps=reps)


def device_ms_by_kernel(torch, fn, reps: int = 10, tries: int = 3) -> dict:
    """Device ms per call of each kernel fn launches, by the kernel's name
    as torch.profiler gives it (its template arguments included), over
    `reps` calls; a session that records no device event is repeated, up
    to `tries` (then the dict is empty)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out: dict = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            dt = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            if ev.device_type.name == "CUDA" and dt:
                key = ev.key.split("(")[0]
                out[key] = out.get(key, 0.0) + dt / 1e3 / reps
        if out:
            break
    return out


def graph_device_ms(torch, fns: dict, n: int = 20, turns: int = 2) -> dict:
    """Device ms a call of each fn of `fns` ({name: fn}): CUDA events around
    the replay of a CUDA graph of n calls of it (captured after a warm-up
    call on the capture stream), so no host time lies between the
    launches; the graphs replayed in turns (a, b, c, c, b, a for 2 turns),
    each fn's the mean of its replays."""
    graphs = {}
    for name, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(n):
                fn()
        graphs[name].replay()
    torch.cuda.synchronize()
    out = dict.fromkeys(graphs, 0.0)
    order = list(graphs)
    for i in range(turns):
        for name in (order if i % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[name].replay()
            end.record()
            end.synchronize()
            out[name] += start.elapsed_time(end) / n / turns
    del graphs
    return out


def fused_write_forms(paged: bool, t: int, decode: bool = False):
    """(fused, pair, plain) of the int8 walk that writes a chunk's or a
    step's new rows, each f(cache copy cc, q (B, T, nh, hd), pos0, tables
    (None: dense), kn / vn (B, T, nkv, hd), layer): the wrapper given k_new
    / v_new (K10 _q8; K7 for the dense decode step, `decode`, T 1; K12's
    int8 decode form at T 1, its chunk form above), the standalone writer
    (K11 / K6 / K13 (a)) followed by the same wrapper without them, and
    the plain version."""
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kvw
    from rama_tpu_torch.ops.kernels import paged_attention as pga

    if decode:
        return (lambda cc, q, p0, tb, kn, vn, l: da.decode_attention_q8(
                    q[:, 0], *cc, p0, l, k_new=kn[:, 0], v_new=vn[:, 0]),
                lambda cc, q, p0, tb, kn, vn, l: (
                    kvw.write_kv_rows_q8(*cc, kn[:, 0], vn[:, 0], p0, l),
                    da.decode_attention_q8(q[:, 0], *cc, p0, l))[1],
                lambda cc, q, p0, tb, kn, vn, l: da.decode_attention_q8_plain(
                    q[:, 0], *cc, p0, l, kn[:, 0], vn[:, 0]))
    if not paged:
        return (lambda cc, q, p0, tb, kn, vn, l: da.chunk_attention_q8(
                    q, *cc, p0, l, k_new=kn, v_new=vn),
                lambda cc, q, p0, tb, kn, vn, l: (
                    kvw.write_kv_chunk_q8(*cc, kn, vn, p0, l),
                    da.chunk_attention_q8(q, *cc, p0, l))[1],
                lambda cc, q, p0, tb, kn, vn, l: da.chunk_attention_q8_plain(
                    q, *cc, p0, l, kn, vn))
    if t == 1:
        return (lambda cc, q, p0, tb, kn, vn, l: pga.paged_decode_attention_q8(
                    q[:, 0], *cc, p0, tb, l, k_new=kn[:, 0], v_new=vn[:, 0]),
                lambda cc, q, p0, tb, kn, vn, l: (
                    kvw.write_kv_paged_q8(*cc, kn, vn, p0, tb, l),
                    pga.paged_decode_attention_q8(q[:, 0], *cc, p0, tb, l))[1],
                lambda cc, q, p0, tb, kn, vn, l: pga.paged_decode_attention_q8_plain(
                    q[:, 0], *cc, p0, tb, l, kn[:, 0], vn[:, 0]))
    return (lambda cc, q, p0, tb, kn, vn, l: pga.paged_chunk_attention_q8(
                q, *cc, p0, tb, l, k_new=kn, v_new=vn),
            lambda cc, q, p0, tb, kn, vn, l: (
                kvw.write_kv_paged_q8(*cc, kn, vn, p0, tb, l),
                pga.paged_chunk_attention_q8(q, *cc, p0, tb, l))[1],
            lambda cc, q, p0, tb, kn, vn, l: pga.paged_chunk_attention_q8_plain(
                q, *cc, p0, tb, l, kn, vn))


def check_fused_form(torch, label: str, caches, q, p0, tables, kn, vn, layer: int,
                     form: int | None = None, decode: bool = False) -> float:
    """The int8 walk launch that writes a chunk's or step's new rows kn / vn
    (fused_write_forms; dense when tables is None; the dense decode step's
    K7, by K6's rule, with `decode`), on a copy of `caches`, against the
    standalone writer followed by the walk without them (pair): outputs
    bit for bit, cache bytes and scales byte for byte; and against the
    plain version (the plain writer, then the plain attention) within TOL
    per row, the cache exactly. The fused call must run once on the walk
    body (in `form` when given), count one fused write and launch no
    standalone writer. Returns the max |err| against the plain version."""
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kvw
    from rama_tpu_torch.ops.kernels import paged_attention as pga

    paged = tables is not None
    fused, pair, plain = fused_write_forms(paged, q.shape[1], decode)
    mod, writer, counter = ((pga, "write_kv_paged_q8", "launches_write_q8") if paged else
                            (da, "write_kv_rows_q8", "launches_write_rows_q8") if decode else
                            (da, "write_kv_chunk_q8", "launches_write_q8"))
    c_f, c_p, c_r = ([x.clone() for x in caches] for _ in range(3))
    n0, w0 = getattr(mod, counter), kvw.launches[writer]
    call = lambda: fused(c_f, q, p0, tables, kn, vn, layer)   # noqa: E731
    if form is None:
        got = on_body(mod.launches_by_body, "walk", label, call)
    else:
        got = on_form(mod.launches_by_body, mod.launches_by_form, "walk", form, label, call)
    if (getattr(mod, counter) - n0, kvw.launches[writer] - w0) != (1, 0):
        raise SystemExit(f"FAILED {label}: the fused call counted "
                         f"{getattr(mod, counter) - n0} fused writes and "
                         f"{kvw.launches[writer] - w0} standalone writer launches, not 1 and 0")
    want = pair(c_p, q, p0, tables, kn, vn, layer)
    diff = [i for i, (a, b) in enumerate(zip(c_f, c_p)) if not torch.equal(a, b)]
    if not torch.equal(got, want) or diff:
        raise SystemExit(f"FAILED {label}: the fused launch differs from the standalone writer "
                         f"followed by the walk (outputs equal: {torch.equal(got, want)}, cache "
                         f"tensors {diff} of (k8, v8, ks, vs) differ)")
    err = compare(torch, f"{label} against the plain writer then the plain attention", got,
                  plain(c_r, q, p0, tables, kn, vn, layer), per=q.shape[-1])
    diff = [i for i, (a, b) in enumerate(zip(c_f, c_r)) if not torch.equal(a, b)]
    if diff:
        raise SystemExit(f"FAILED {label}: cache tensors {diff} differ from the plain writer's")
    log(f"[check] {label}: the fused launch equals the writer then the walk bit for bit "
        f"(outputs) and byte for byte (cache), the plain writer's cache exactly")
    return err


def fused_write_times(torch, label: str, walk, fused, pair, writer) -> dict:
    """Device ms (graph_device_ms, in turns) of the walk alone, the walk
    that writes the rows (the fused launch), the standalone writer followed
    by the walk, and the writer alone, on the same inputs; logged with the
    fused launch's cost over the walk's."""
    ms = graph_device_ms(torch, {"walk_ms": walk, "fused_ms": fused,
                                 "writer_then_walk_ms": pair, "writer_ms": writer})
    log(f"[time] {label} device ms (CUDA events over a graph of 20 launches, in turns): "
        f"{json.dumps(ms)}; the fused launch over the walk alone "
        f"{(ms['fused_ms'] - ms['walk_ms']) * 1e3:.2f} us, the pair over the fused launch "
        f"{(ms['writer_then_walk_ms'] - ms['fused_ms']) * 1e3:.2f} us")
    return ms


def write_bytes(b: int, t: int, nkv: int, hd: int) -> float:
    """Bytes a chunk's row write moves: bf16 K and V rows in, int8 rows and
    f32 scales out, the positions."""
    n_el = 2 * b * t * nkv * hd
    return n_el * 2 + n_el + 2 * b * t * nkv * 4 + b * 4


def phase_kernels_spec(torch, results: dict) -> None:
    """The speculation slice's kernels vs their plain versions: K10 on a
    bf16 and an int8 cache within TOL per (slot, query, head), with planted
    edges; K11 exactly; K4 at the stories15M draft's head_dim 48. Times by
    CUDA events, with K4 and K6 on the same rows beside them."""
    import torch.nn.functional as F

    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kvw

    dev = torch.device("cuda")
    cfg = seven_b_config(ModelConfig)
    g = torch.Generator(device=dev).manual_seed(8)
    bf, f32 = torch.bfloat16, torch.float32
    L, nh, nkv, hd, B = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 8
    T = SPEC_TICK + 1

    def rx(*shape, dtype=bf):
        return torch.randn(shape, device=dev, generator=g).to(dtype)

    def qcache(l, s):
        return quantized_cache(torch, kvw, rx, l, B, nkv, s, hd)

    def starts(s, t):
        """Ragged chunk starts: 0, a chunk straddling the 64-row split (61),
        one ending on it, 128, 700, one running past S, the last that fits."""
        return torch.tensor([0, 61, 65 - t, 128, 512 - t, 700, s - 2, s - t], dtype=torch.int32,
                            device=dev)

    def check(label, cache, s, layers, q8):
        split_edges = [e for c in range(64, s, 64) for e in (c - 1, c)] + [s - 1]
        kernel = da.chunk_attention_q8 if q8 else da.chunk_attention
        plain = da.chunk_attention_q8_plain if q8 else da.chunk_attention_plain
        for t in (2, 4, 8):
            q = rx(B, t, nh, hd)
            pos0 = starts(s, t)
            for planted in (False, True):
                for l in layers:
                    if planted:
                        plant_chunk_edges(q, cache, pos0, l, split_edges, kvw if q8 else None)
                    name = (f"{kernel.__name__} {label} T={t} layer={l} pos0={pos0.tolist()}"
                            f"{' planted edges' if planted else ''}")
                    got = on_body(da.launches_by_body, "walk" if q8 else "mma", name,
                                  lambda: kernel(q, *cache, pos0, l))
                    compare(torch, name, got, plain(q, *cache, pos0, l), per=hd)

    def time_chunk(q8, cache, s, n_layers, t, pos0) -> dict:
        kernel = da.chunk_attention_q8 if q8 else da.chunk_attention
        plain = da.chunk_attention_q8_plain if q8 else da.chunk_attention_plain
        q = rx(B, t, nh, hd)
        err = compare(torch, f"{kernel.__name__} timed inputs S={s} T={t} (layer 0)",
                      kernel(q, *cache, pos0, 0), plain(q, *cache, pos0, 0), per=hd)
        lay = Layered(n_layers)
        t_k = time_ms(torch, lambda: kernel(q, *cache, pos0, lay.next()))
        t_p = time_ms(torch, lambda: plain(q, *cache, pos0, lay.next()), reps=5)
        # K4 / K7 over the same rows: one query a slot at the chunk's last position
        q1, last = rx(B, nh, hd), (pos0 + t - 1).clamp(max=s - 1)
        one = da.decode_attention_q8 if q8 else da.decode_attention
        t_one = time_ms(torch, lambda: one(q1, *cache, last, lay.next()))
        nb, ops = attention_bytes_ops(pos0, t, s, nkv, nh, hd,
                                      2 * hd + 8 if q8 else 2 * hd * 2, q.numel() * 2)
        b_ms, b_by = bound_ms(nb, ops)
        # where the time goes: split kernel against combine pass, and the
        # split kernel's residency, for the chunk and for one query a slot
        parts = dict(
            chunk=with_share(attention_split_combine(
                torch, lambda: kernel(q, *cache, pos0, lay.next())), b_ms),
            one_query=attention_split_combine(torch, lambda: one(q1, *cache, last, lay.next())),
            chunk_occupancy=da.occupancy(t, nh, nkv, hd, q8),
            one_query_occupancy=da.occupancy(1, nh, nkv, hd, q8))
        body = "walk" if q8 else "mma"
        check_split_body(f"{kernel.__name__} S={s} T={t}", parts["chunk"], body)
        check_split_body(f"{one.__name__} S={s}", parts["one_query"], body)
        if q8:
            check_walk_grid(da, f"{kernel.__name__} S={s} T={t}", parts["chunk"], pos0, t, s,
                            nkv, hd)
            check_walk_grid(da, f"{one.__name__} S={s}", parts["one_query"], last, 1, s, nkv, hd)
        # the chunk split's device time over the T = 1 split's on the same rows
        parts["split_over_one_query"] = (parts["chunk"]["split_ms"] / parts["one_query"]["split_ms"]
                                         if parts["one_query"]["split_ms"] else None)
        log(f"[time] {kernel.__name__} S={s} T={t} breakdown {json.dumps(parts)}")
        t_lib, note = None, ("no single PyTorch call attends over an int8 cache with row "
                             "scales (dequantize + SDPA is two)" if q8 else None)
        if not q8:
            vis = da._visible(pos0, t, s)[:, None]                   # (B, 1, T, S)

            def sdpa():
                l = lay.next()
                return F.scaled_dot_product_attention(q.transpose(1, 2), cache[0][l],
                                                      cache[1][l], attn_mask=vis)

            t_lib = time_ms(torch, sdpa)
            parts["library_device_ms"] = device_ms_per_call(torch, sdpa)
        log(f"[time] {kernel.__name__} S={s} T={t}: {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), library {t_lib} (device "
            f"{parts.get('library_device_ms')}); {one.__name__} on the same rows "
            f"{t_one:.4f} ms")
        return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                    library_ms=t_lib, library_note=note, same_rows_one_query_ms=t_one,
                    breakdown=parts,
                    shape=f"q ({B}, {t}, {nh}, {hd}) bf16, {'int8 + f32 row scales' if q8 else 'bf16'}"
                          f" cache ({n_layers}, {B}, {nkv}, {s}, {hd}), pos0 {pos0.tolist()}")

    # -- K10 on a bf16 cache -------------------------------------------------------
    S = 1024
    kc, vc = rx(L, B, nkv, S, hd), rx(L, B, nkv, S, hd)
    check(f"B={B} S={S}", (kc, vc), S, (0, L - 1), q8=False)
    kc, vc = rx(L, B, nkv, S, hd), rx(L, B, nkv, S, hd)      # timed on unplanted rows
    timed = torch.tensor([0, 61, 128, 255, 511, 700, 900, S - T], dtype=torch.int32, device=dev)
    results["chunk_attention"] = dict(
        name="chunk_attention", route="cuda", source="rama_tpu_torch/csrc/decode_attention.cu",
        replaces="rama_tpu/ops/pallas/decode_attention.py:640",
        **time_chunk(False, (kc, vc), S, L, T, timed))
    results["chunk_attention"]["t8"] = time_chunk(False, (kc, vc), S, L, 8,
                                                  (timed - 4).clamp(min=0))
    del kc, vc
    torch.cuda.empty_cache()

    # -- K10 on an int8 cache ------------------------------------------------------
    c = qcache(L, S)
    check(f"B={B} S={S}", c, S, (0, L - 1), q8=True)
    c = qcache(L, S)
    results["chunk_attention_q8"] = dict(
        name="chunk_attention_q8", route="cuda", source="rama_tpu_torch/csrc/decode_attention.cu",
        replaces="rama_tpu/ops/pallas/decode_attention.py:730",
        **time_chunk(True, c, S, L, T, timed))
    del c
    torch.cuda.empty_cache()
    c = qcache(4, KV8_MAX_LEN)
    check(f"B={B} S={KV8_MAX_LEN}", c, KV8_MAX_LEN, (0, 3), q8=True)
    long_starts = torch.tensor([0, 63, 1021, 2047, 3000, 4000, 4090, KV8_MAX_LEN - T],
                               dtype=torch.int32, device=dev)
    results["chunk_attention_q8"]["s4096"] = time_chunk(True, c, KV8_MAX_LEN, 4, T, long_starts)
    del c
    torch.cuda.empty_cache()
    # GQA rep 2 and 4 (rows T * rep up to the kernel's 8), stories15M's hd 48,
    # hd 64, fp32 and bf16 q, both caches; bf16 at hd 48 / 64 / 128 on the
    # tensor-core body, fp32 and hd 16 on the SIMT body
    for nh_s, nkv_s, hd_s, t in ((4, 2, 16, 4), (8, 2, 16, 2), (6, 6, 48, 8), (8, 1, 128, 1),
                                 (8, 4, 64, 4), (4, 1, 64, 2), (4, 4, 64, 2)):
        for dt in (bf, f32):
            body = "mma" if dt == bf and hd_s != 16 else "simt"
            body8 = da.body_for(dt, hd_s, q8=True)
            ps = torch.tensor([0, 61, 77], dtype=torch.int32, device=dev)
            qs = rx(3, t, nh_s, hd_s, dtype=dt)
            kd, vd = rx(2, 3, nkv_s, 80, hd_s, dtype=dt), rx(2, 3, nkv_s, 80, hd_s, dtype=dt)
            name = f"chunk_attention rep={nh_s // nkv_s} hd={hd_s} T={t} {dt} [{body}]"
            compare(torch, name, on_body(da.launches_by_body, body, name,
                                         lambda: da.chunk_attention(qs, kd, vd, ps, 1)),
                    da.chunk_attention_plain(qs, kd, vd, ps, 1), per=hd_s)
            k8s, kss = kvw.kv_quant_rows(kd.float())
            v8s, vss = kvw.kv_quant_rows(vd.float())
            name = f"chunk_attention_q8 rep={nh_s // nkv_s} hd={hd_s} T={t} {dt} [{body8}]"
            compare(torch, name, on_body(da.launches_by_body, body8, name,
                                         lambda: da.chunk_attention_q8(qs, k8s, v8s, kss, vss,
                                                                       ps, 1)),
                    da.chunk_attention_q8_plain(qs, k8s, v8s, kss, vss, ps, 1), per=hd_s)
    # T 3 x GQA 8/2: 12 query rows a kv head, the 16-row form
    qs, ps = rx(3, 3, 8, hd), torch.tensor([0, 61, 77], dtype=torch.int32, device=dev)
    kd, vd = rx(2, 3, 2, 80, hd), rx(2, 3, 2, 80, hd)
    name = "chunk_attention T=3 x GQA 8/2 (12 rows: the 16-row form)"
    compare(torch, name, on_form(da.launches_by_body, da.launches_by_form, "mma", 16, name,
                                 lambda: da.chunk_attention(qs, kd, vd, ps, 1)),
            da.chunk_attention_plain(qs, kd, vd, ps, 1), per=hd)

    # -- K11: write_kv_chunk_q8 ----------------------------------------------------
    def rows(*shape, dtype=bf):
        """Rows of mixed magnitude with a zero row and a row of .5 ties."""
        x = rx(*shape, dtype=f32) * (torch.rand(shape[:-1] + (1,), device=dev, generator=g)
                                     * 30 + 1e-3)
        flat = x.view(-1, shape[-1])
        flat[0] = 0
        flat[1] = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5, 4.5],
                               device=dev).repeat(shape[-1] // 8)
        return x.to(dtype)

    def rcache(l, b, n, s, d):
        return [torch.randint(-127, 128, (l, b, n, s, d), dtype=torch.int8, device=dev,
                              generator=g) for _ in range(2)] + [
            torch.rand((l, b, n, s), device=dev, generator=g) for _ in range(2)]

    def same(name, got, want) -> float:
        diff = [i for i, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)]
        log(f"[check] {name}: {'exact' if not diff else f'tensors {diff} differ'}")
        if diff:
            raise SystemExit(f"FAILED {name}: cache tensors {diff} (k8, v8, ks, vs) differ "
                             f"from the plain version's")
        return 0.0

    S = KV8_MAX_LEN
    c1 = rcache(4, B, nkv, S, hd)
    c2 = [x.clone() for x in c1]
    for t in (2, 4, 8):
        # a 32-row window straddle (30), a 128-column scale tile straddle
        # (126), a chunk reaching S (S - 2) and one wholly past it
        pos0 = torch.tensor([0, 30, 61, 126, 1000, S - t, S - 2, S + 3], dtype=torch.int32,
                            device=dev)
        for dt in (bf, f32):
            k, v = rows(B, t, nkv, hd, dtype=dt), rows(B, t, nkv, hd, dtype=dt)
            for l in (0, 3):
                kvw.write_kv_chunk_q8(*c1, k, v, pos0, l)
                kvw.write_kv_chunk_q8_plain(*c2, k, v, pos0, l)
                err = same(f"write_kv_chunk_q8 T={t} layer={l} pos0={pos0.tolist()} {dt}", c1, c2)
    for cname, (b_, n_, s_, d_) in {"tiny": (3, 2, 48, 16), "stories15M": (5, 6, 64, 48)}.items():
        t1 = rcache(3, b_, n_, s_, d_)
        t2 = [x.clone() for x in t1]
        pt = torch.tensor([0, 30, s_ - 2, 5, 61][:b_], dtype=torch.int32, device=dev)
        for dt in (bf, f32):
            k, v = rows(b_, 3, n_, d_, dtype=dt), rows(b_, 3, n_, d_, dtype=dt)
            kvw.write_kv_chunk_q8(*t1, k, v, pt, 2)
            kvw.write_kv_chunk_q8_plain(*t2, k, v, pt, 2)
            same(f"write_kv_chunk_q8 {cname} hd={d_} {dt}", t1, t2)
    pos0 = torch.tensor([0, 30, 61, 126, 1000, 2000, 3000, S - T], dtype=torch.int32,
                        device=dev)
    k, v = rows(B, T, nkv, hd), rows(B, T, nkv, hd)
    lay = Layered(4)
    t_k = time_ms(torch, lambda: kvw.write_kv_chunk_q8(*c1, k, v, pos0, lay.next()))
    t_p = time_ms(torch, lambda: kvw.write_kv_chunk_q8_plain(*c2, k, v, pos0, lay.next()))
    k1, v1 = k[:, -1].contiguous(), v[:, -1].contiguous()
    t_k6 = time_ms(torch, lambda: kvw.write_kv_rows_q8(*c1, k1, v1, pos0, lay.next()))
    n_el = 2 * B * T * nkv * hd
    b_ms, b_by = bound_ms(write_bytes(B, T, nkv, hd), 3 * n_el)
    log(f"[time] write_kv_chunk_q8 (standalone) T={T}: {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}); write_kv_rows_q8 (one row a slot) {t_k6:.4f} ms")
    standalone = dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                      k6_same_run_ms=t_k6, source="rama_tpu_torch/csrc/kv_write.cu",
                      shape=f"k/v rows ({B}, {T}, {nkv}, {hd}) bf16 -> cache (4, {B}, {nkv}, "
                            f"{S}, {hd}) int8 + scales, pos0 {pos0.tolist()}")
    del c1, c2
    torch.cuda.empty_cache()

    # -- K11 inside K10: a verify chunk's rows written by the walk launch ---------------
    c = qcache(2, S)
    split_edges = [e for c0 in range(64, S, 64) for e in (c0 - 1, c0)] + [S - 1]
    for t in (1, 2, 4, 8):
        q, pos0 = rx(B, t, nh, hd), starts(S, t)
        for planted in (False, True):
            kn, vn = rx(B, t, nkv, hd), rx(B, t, nkv, hd)
            if planted:   # the chunk's own rows carry the planted keys of its positions
                plant_chunk_edges(q, c, pos0, 1, split_edges, kvw)
                for (b, r), key in chunk_edge_keys(q, pos0, S, ()).items():
                    if r - int(pos0[b]) < t:
                        kn[b, r - int(pos0[b])] = group_key(key, nkv).to(bf)
            for l in (0, 1):
                check_fused_form(torch, f"chunk_attention_q8 + rows (K11 in K10) S={S} T={t} "
                                 f"layer={l} pos0={pos0.tolist()}"
                                 f"{' planted edges' if planted else ''}", c, q, pos0, None, kn,
                                 vn, l)
    del c
    # timed at serve_spec_kv8's shape: 8 slots, T 4, 4096 rows, 4 layers cycled
    c = qcache(4, S)
    q, kn, vn = rx(B, T, nh, hd), rx(B, T, nkv, hd), rx(B, T, nkv, hd)
    err = check_fused_form(torch, f"chunk_attention_q8 + rows (K11 in K10) timed inputs S={S} "
                           f"T={T}", c, q, long_starts, None, kn, vn, 0)
    lay = Layered(4)
    fused, pair, plain = fused_write_forms(False, T)
    args = (q, long_starts, None, kn, vn)
    dev_ms = fused_write_times(
        torch, f"K11 in K10 S={S} T={T}",
        lambda: da.chunk_attention_q8(q, *c, long_starts, lay.next()),
        lambda: fused(c, *args, lay.next()), lambda: pair(c, *args, lay.next()),
        lambda: kvw.write_kv_chunk_q8(*c, kn, vn, long_starts, lay.next()))
    t_f = time_ms(torch, lambda: fused(c, *args, lay.next()))
    t_p = time_ms(torch, lambda: plain(c, *args, lay.next()), reps=5)
    nb, ops = attention_bytes_ops(long_starts, T, S, nkv, nh, hd, 2 * hd + 8, q.numel() * 2,
                                  written=True)
    b_ms, b_by = bound_ms(nb + write_bytes(B, T, nkv, hd), ops + 3 * n_el)
    standalone["device_ms"] = dev_ms["writer_ms"]
    log(f"[time] chunk_attention_q8 + rows (K11 in K10) S={S} T={T}: {t_f:.4f} ms (device "
        f"{dev_ms['fused_ms']:.4f}), plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    results["write_kv_chunk_q8"] = dict(
        name="write_kv_chunk_q8", route="cuda", source="rama_tpu_torch/csrc/decode_attention.cu",
        replaces="rama_tpu/ops/pallas/kv_write.py:136", max_abs_err=err, ms=t_f,
        device_ms=dev_ms["fused_ms"], plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
        library_ms=None,
        library_note="the rows are written inside K10's int8 walk launch (dattn_walk); no "
                     "single PyTorch call quantizes rows, scatters them and attends over an "
                     "int8 cache",
        breakdown=dict(dev_ms, write_bound_ms=standalone["bound_ms"]), standalone=standalone,
        shape=f"q ({B}, {T}, {nh}, {hd}) bf16 and k/v rows ({B}, {T}, {nkv}, {hd}) bf16 -> "
              f"int8 cache (4, {B}, {nkv}, {S}, {hd}) + scales, pos0 {long_starts.tolist()}")
    del c
    torch.cuda.empty_cache()

    # -- K4 at the draft's head_dim 48 (stories15M: 6 heads, rep 1) ---------------
    qd = rx(B, 6, 48)
    kd, vd = rx(2, B, 6, 1024, 48), rx(2, B, 6, 1024, 48)
    pd = torch.tensor([0, 63, 64, 255, 700, 1000, 1022, 1023], dtype=torch.int32, device=dev)
    for planted in (False, True):
        if planted:
            plant_decode_edges(qd, kd, pd, 1, (63, 64, 511, 512, 1023))
        for dt in (bf, f32):
            compare(torch, f"decode_attention stories15M hd=48 {dt}"
                    f"{' planted edges' if planted else ''}",
                    da.decode_attention(qd.to(dt), kd.to(dt), vd.to(dt), pd, 1),
                    da.decode_attention_plain(qd.to(dt), kd.to(dt), vd.to(dt), pd, 1), per=48)
    for name in ("chunk_attention", "chunk_attention_q8", "write_kv_chunk_q8"):
        r = results[name]
        log(f"[kernel] {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library {r['library_ms']}")


def paged_tables(torch, ends, ps: int, mp: int, spare: int, g):
    """Page tables (B, mp) int32 over a pool of sum(ceil(ends / ps)) + spare
    pages: slot b owns ceil(ends[b] / ps) pages in shuffled order; its
    entries past them are -1, or, every other slot, a page of the pool's
    spare ones (stale). Returns (tables on the CPU, pool pages)."""
    used = [min(-(-e // ps), mp) for e in ends]
    npages = sum(used) + spare
    perm = torch.randperm(npages, generator=g).tolist()
    tables = torch.full((len(ends), mp), -1, dtype=torch.int32)
    for b, u in enumerate(used):
        tables[b, :u] = torch.tensor(perm[:u], dtype=torch.int32)
        perm = perm[u:]
        if u < mp and b % 2:
            tables[b, u:] = perm[-1]
    return tables, npages


def plant_paged_edges(q, pools, tables, pos0, layer: int, rows, kvw=None) -> None:
    """chunk_edge_keys (q (B, T, nh, hd)) planted into layer `layer` of a
    pool (k, v) or int8 pool (k8, v8, ks, vs) through the page tables, on
    the rows of each slot's own pages only."""
    ps, mp = pools[0].shape[3], tables.shape[1]
    owned = [int((tables[b] >= 0).sum()) * ps for b in range(tables.shape[0])]
    for (b, r), key in chunk_edge_keys(q, pos0, mp * ps, rows).items():
        if r >= owned[b]:
            continue
        key = group_key(key, pools[0].shape[2])
        page, off = int(tables[b, r // ps]), r % ps
        if kvw is None:
            pools[0][layer, page, :, off] = key.to(pools[0].dtype)
        else:
            pools[0][layer, page, :, off], pools[2][layer, page, :, off] = kvw.kv_quant_rows(
                key.float())


def phase_kernels_paged(torch, results: dict) -> None:
    """The paged slice's kernels vs their plain versions, on 7B shapes (32
    heads, head_dim 128, 8 slots, pages of 128 rows, mp 32: max_len 4096)
    over a shuffled pool: K12's four forms (rel TOL per (slot, query, head),
    the 1e-2 bar logged) at positions on page edges, T 1 and 4 (8 on the
    bf16 pool), with planted edges, and against the dense K4 / K7 / K10 over
    the gathered view of the same rows (bit for bit where the 64-row splits
    coincide); one 16-row-page case (16-row splits); K13's two writers
    exact, rows past a slot's table clipped into its last page. CUDA-event
    times, the layer cycling, beside the dense kernels on the same rows."""
    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kvw
    from rama_tpu_torch.ops.kernels import paged_attention as pga

    dev = torch.device("cuda")
    cfg = seven_b_config(ModelConfig)
    g = torch.Generator(device=dev).manual_seed(9)
    gc = torch.Generator().manual_seed(9)
    bf, f32 = torch.bfloat16, torch.float32
    nh, nkv, hd, B, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 8, 4
    S = KV8_MAX_LEN
    positions = [0, 127, 128, 255, 1000, 2047, 3000, 4092]
    note = "no single PyTorch call attends through a page table"

    def rx(*shape, dtype=bf):
        return torch.randn(shape, device=dev, generator=g).to(dtype)

    def pools_for(t, ps):
        """bf16 and int8 pools of L layers for chunks of t at `positions`
        (each slot's pages cover its rows through pos0 + t - 1)."""
        mp = S // ps
        p0 = torch.tensor([min(p, S - 1) for p in positions], dtype=torch.int32)
        tables, npages = paged_tables(torch, [min(int(p) + t, S) for p in p0], ps, mp, 8, gc)
        kv = [rx(L, npages, nkv, ps, hd) for _ in range(2)]
        q8 = [None] * 4
        q8[0], q8[2] = kvw.kv_quant_rows(kv[0].float())
        q8[1], q8[3] = kvw.kv_quant_rows(kv[1].float())
        return p0.to(dev), tables.to(dev), kv, q8

    def dense_of(pools, tables):
        return [torch.stack([pga.gather_pages(x[l], tables) for l in range(L)]).contiguous()
                for x in pools]

    forms = {  # name: (paged kernel, plain, dense kernel, int8, decode)
        "paged_decode_attention": (pga.paged_decode_attention, pga.paged_decode_attention_plain,
                                   da.decode_attention, False, True),
        "paged_decode_attention_q8": (pga.paged_decode_attention_q8,
                                      pga.paged_decode_attention_q8_plain,
                                      da.decode_attention_q8, True, True),
        "paged_chunk_attention": (pga.paged_chunk_attention, pga.paged_chunk_attention_plain,
                                  da.chunk_attention, False, False),
        "paged_chunk_attention_q8": (pga.paged_chunk_attention_q8,
                                     pga.paged_chunk_attention_q8_plain,
                                     da.chunk_attention_q8, True, False),
    }
    replaces = {"paged_decode_attention": 105, "paged_decode_attention_q8": 133,
                "paged_chunk_attention": 156, "paged_chunk_attention_q8": 179}

    def check_and_time(name, t, ps, timed: bool) -> dict | None:
        kernel, plain, dense_k, q8, decode = forms[name]
        p0, tables, kv, q8p = pools_for(t, ps)
        pools = q8p if q8 else kv
        dense = dense_of(pools, tables)
        split = pga.split_rows(ps)
        edges = sorted({e for c in range(split, S, split) for e in (c - 1, c)} | {S - 1})
        q = rx(B, t, nh, hd)
        qq = q[:, 0].contiguous() if decode else q
        label = f"{name} ps={ps} T={t} pos0={p0.tolist()}"
        body = "walk" if q8 else "mma"
        gap, same = 0.0, True
        for planted in (False, True):
            for l in (0, L - 1):
                if planted:
                    plant_paged_edges(q, pools, tables, p0, l, edges, kvw if q8 else None)
                    dense = dense_of(pools, tables)
                name_l = f"{label} layer={l}{' planted edges' if planted else ''}"
                got = on_body(pga.launches_by_body, body, name_l,   # bf16 at hd 128
                              lambda: kernel(qq, *pools, p0, tables, l))
                compare(torch, name_l, got, plain(qq, *pools, p0, tables, l), per=hd, bar=1e-2)
                ref = dense_k(qq, *dense, p0, l)
                compare(torch, f"{label} layer={l} against the dense kernel over the same rows",
                        got, ref, per=hd)
                same = same and torch.equal(got, ref)
                gap = max(gap, float((got.float() - ref.float()).abs().max()))
        log(f"[check] {label}: against the dense kernel over the same rows "
            f"{'bit for bit' if same else f'max |gap| {gap:.3e}'} (64-row splits "
            f"{'coincide' if split == da.CHUNK else f'against {split}-row splits'})")
        if not timed:
            return None
        # timed on unplanted pools, the layer cycling
        p0, tables, kv, q8p = pools_for(t, ps)
        pools = q8p if q8 else kv
        dense = dense_of(pools, tables)
        err = compare(torch, f"{label} timed inputs (layer 0)", kernel(qq, *pools, p0, tables, 0),
                      plain(qq, *pools, p0, tables, 0), per=hd)
        lay = Layered(L)
        t_k = time_ms(torch, lambda: kernel(qq, *pools, p0, tables, lay.next()))
        t_p = time_ms(torch, lambda: plain(qq, *pools, p0, tables, lay.next()), reps=5)
        t_d = time_ms(torch, lambda: dense_k(qq, *dense, p0, lay.next()))
        nb, ops = attention_bytes_ops(p0, t, S, nkv, nh, hd, 2 * hd + 8 if q8 else 2 * hd * 2,
                                      q.numel() * 2)
        b_ms, b_by = bound_ms(nb + tables.numel() * 4, ops)
        parts = dict(paged=with_share(attention_split_combine(
                         torch, lambda: kernel(qq, *pools, p0, tables, lay.next())), b_ms),
                     dense_same_rows=attention_split_combine(
                         torch, lambda: dense_k(qq, *dense, p0, lay.next())),
                     occupancy=da.occupancy(t, nh, nkv, hd, q8, chunk=split))
        for form in ("paged", "dense_same_rows"):
            check_split_body(f"{label} {form}", parts[form], body)
        if q8:
            check_walk_grid(da, label, parts["paged"], p0, t, S, nkv, hd, ps)
            check_walk_grid(da, f"{label} dense_same_rows", parts["dense_same_rows"], p0, t,
                            dense[0].shape[3], nkv, hd)
        log(f"[time] {label}: {t_k:.4f} ms, plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
            f"dense kernel over the same rows {t_d:.4f} ms; breakdown {json.dumps(parts)}")
        return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                    library_ms=None, library_note=note, dense_same_rows_ms=t_d,
                    dense_gap=0.0 if same else gap, breakdown=parts,
                    shape=f"q ({B}, {t}, {nh}, {hd}) bf16, {'int8 + f32 row scales' if q8 else 'bf16'}"
                          f" pool ({L}, {kv[0].shape[1]}, {nkv}, {ps}, {hd}), page tables "
                          f"({B}, {S // ps}), pos0 {p0.tolist()}")

    for name in forms:
        decode = forms[name][4]
        ts = (1,) if decode else ((4, 8) if not forms[name][3] else (4,))
        for t in ts:
            r = check_and_time(name, t, PAGE_SIZE, timed=True)
            if name not in results:
                results[name] = dict(name=name, route="cuda",
                                     source="rama_tpu_torch/csrc/decode_attention.cu",
                                     replaces=f"rama_tpu/ops/pallas/paged_attention.py:"
                                              f"{replaces[name]}", **r)
            else:
                results[name][f"t{t}"] = r
        torch.cuda.empty_cache()
    # 16-row pages: 16-row splits (and 4x the partials)
    results["paged_decode_attention"]["ps16"] = check_and_time("paged_decode_attention", 1, 16,
                                                               timed=True)
    check_and_time("paged_chunk_attention_q8", 4, 16, timed=False)
    torch.cuda.empty_cache()
    # hd 64 and 48 at GQA rep 2 / 1 over pages of 32 / 24 rows (splits of 32 /
    # 24 rows: the latter ends in a half-used 16-row block), both pools, bf16
    # on the tensor-core body and fp32 on the SIMT body
    for nh_s, nkv_s, hd_s, t, ps_s in ((8, 4, 64, 4, 32), (6, 6, 48, 8, 24)):
        pos_s = [0, ps_s - 1, 3 * ps_s + 5, 5 * ps_s - t]
        tb, npg = paged_tables(torch, [p + t for p in pos_s], ps_s, 5, 3, gc)
        tb, p0s = tb.to(dev), torch.tensor(pos_s, dtype=torch.int32, device=dev)
        for dt in (bf, f32):
            kv = [rx(2, npg, nkv_s, ps_s, hd_s, dtype=dt) for _ in range(2)]
            (k8s, kss), (v8s, vss) = (kvw.kv_quant_rows(x.float()) for x in kv)
            qs = rx(4, t, nh_s, hd_s, dtype=dt)
            for fn, plain, pools, body in (
                    (pga.paged_chunk_attention, pga.paged_chunk_attention_plain, kv,
                     "mma" if dt == bf else "simt"),
                    (pga.paged_chunk_attention_q8, pga.paged_chunk_attention_q8_plain,
                     (k8s, v8s, kss, vss), da.body_for(dt, hd_s, q8=True))):
                name = (f"{fn.__name__} rep={nh_s // nkv_s} hd={hd_s} ps={ps_s} T={t} {dt} "
                        f"[{body}]")
                compare(torch, name, on_body(pga.launches_by_body, body, name,
                                             lambda: fn(qs, *pools, p0s, tb, 1)),
                        plain(qs, *pools, p0s, tb, 1), per=hd_s)

    # -- K13 (a): write_kv_paged_q8 -------------------------------------------------
    def rows(*shape, dtype=bf):
        """Rows of mixed magnitude with a zero row and a row of .5 ties."""
        x = rx(*shape, dtype=f32) * (torch.rand(shape[:-1] + (1,), device=dev, generator=g)
                                     * 30 + 1e-3)
        flat = x.view(-1, shape[-1])
        flat[0] = 0
        flat[1] = torch.tensor([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5, 4.5],
                               device=dev).repeat(shape[-1] // 8)
        return x.to(dtype)

    def same(name, got, want) -> float:
        diff = [i for i, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)]
        log(f"[check] {name}: {'exact' if not diff else f'tensors {diff} differ'}")
        if diff:
            raise SystemExit(f"FAILED {name}: pool tensors {diff} (k8, v8, ks, vs) differ "
                             f"from the plain version's")
        return 0.0

    def rpool(l, npages, ps, n=nkv, d=hd):
        """Random int8 bytes and scales (the writers' checks)."""
        return [torch.randint(-127, 128, (l, npages, n, ps, d), dtype=torch.int8, device=dev,
                              generator=g) for _ in range(2)] + [
            torch.rand((l, npages, n, ps), device=dev, generator=g) for _ in range(2)]

    mp = S // PAGE_SIZE
    for t in (1, 4, 8):
        # 4092 + t - 1 runs past the slot's 32 pages for t > 4: rows clip into page 31
        p0 = torch.tensor(positions, dtype=torch.int32)
        tables, npages = paged_tables(torch, [min(int(p) + t, S) for p in p0], PAGE_SIZE, mp,
                                      4, gc)
        c1 = rpool(L, npages, PAGE_SIZE)
        c2 = [x.clone() for x in c1]
        for dt in (bf, f32):
            k, v = rows(B, t, nkv, hd, dtype=dt), rows(B, t, nkv, hd, dtype=dt)
            for l in (0, L - 1):
                kvw.write_kv_paged_q8(*c1, k, v, p0.to(dev), tables.to(dev), l)
                kvw.write_kv_paged_q8_plain(*c2, k, v, p0.to(dev), tables.to(dev), l)
                err = same(f"write_kv_paged_q8 T={t} layer={l} pos0={p0.tolist()} {dt}", c1, c2)
    for cname, (n_, d_, ps_) in {"tiny": (2, 16, 16), "stories15M": (6, 48, 32)}.items():
        tb, npg = paged_tables(torch, [3, 40, 17], ps_, 4, 2, gc)
        t1 = rpool(2, npg, ps_, n_, d_)
        t2 = [x.clone() for x in t1]
        for dt in (bf, f32):
            k, v = rows(3, 3, n_, d_, dtype=dt), rows(3, 3, n_, d_, dtype=dt)
            pt = torch.tensor([0, 37, 14], dtype=torch.int32, device=dev)
            kvw.write_kv_paged_q8(*t1, k, v, pt, tb.to(dev), 1)
            kvw.write_kv_paged_q8_plain(*t2, k, v, pt, tb.to(dev), 1)
            same(f"write_kv_paged_q8 {cname} hd={d_} ps={ps_} {dt}", t1, t2)
    # -- K13 (a) inside K12: the step's or chunk's rows written by the walk launch ----
    # every slot's pages its own, shuffled; 4092 + t - 1 runs past the table
    # for t > 4 (rows clipped into the slot's page 31, where its queries read
    # them); planted: the chunk's own rows carry the planted keys
    for t in (1, 4, 8):
        p0, tables, _, pools = pools_for(t, PAGE_SIZE)
        edges = sorted({e for c0 in range(64, S, 64) for e in (c0 - 1, c0)} | {S - 1})
        q = rx(B, t, nh, hd)
        for planted in (False, True):
            kn, vn = rx(B, t, nkv, hd), rx(B, t, nkv, hd)
            if planted:
                plant_paged_edges(q, pools, tables, p0, L - 1, edges, kvw)
                for (b, r), key in chunk_edge_keys(q, p0, S, ()).items():
                    if r - int(p0[b]) < t:
                        kn[b, r - int(p0[b])] = group_key(key, nkv).to(bf)
            for l in (0, L - 1):
                check_fused_form(torch, f"{'paged_decode' if t == 1 else 'paged_chunk'}"
                                 f"_attention_q8 + rows (K13 (a) in K12) ps={PAGE_SIZE} T={t} "
                                 f"layer={l} pos0={p0.tolist()}"
                                 f"{' planted edges' if planted else ''}", pools, q, p0, tables,
                                 kn, vn, l)
    # timed at serve_paged_kv8's (T 1) and serve_spec_paged_kv8's (T 4) shapes: the
    # walk alone, the fused launch, the standalone writer then the walk, the writer
    # alone (K13 (a)), and K6 / K11 on a dense cache of the same rows
    timed = {}
    dense8 = [torch.zeros((L, B, nkv, S, hd), dtype=torch.int8, device=dev) for _ in range(2)] + [
        torch.zeros((L, B, nkv, S), device=dev) for _ in range(2)]
    for t in (1, 4):
        p0 = torch.tensor(positions[:-1] + [S - t], dtype=torch.int32)
        tables, npages = paged_tables(torch, [int(p) + t for p in p0], PAGE_SIZE, mp, 4, gc)
        (k8_, ks_), (v8_, vs_) = (kvw.kv_quant_rows(rx(L, npages, nkv, PAGE_SIZE, hd, dtype=f32))
                                  for _ in range(2))
        c1 = [k8_, v8_, ks_, vs_]
        k, v = rows(B, t, nkv, hd), rows(B, t, nkv, hd)
        q = rx(B, t, nh, hd)
        p0, tables = p0.to(dev), tables.to(dev)
        fused, pair, plain = fused_write_forms(True, t)
        label = f"K13 (a) in K12 T={t}"
        err = check_fused_form(torch, f"{label} timed inputs (layer 0)", c1, q, p0, tables, k, v, 0)
        lay = Layered(L)
        walk = ((lambda: pga.paged_decode_attention_q8(q[:, 0], *c1, p0, tables, lay.next()))
                if t == 1 else
                (lambda: pga.paged_chunk_attention_q8(q, *c1, p0, tables, lay.next())))
        dev_ms = fused_write_times(
            torch, label, walk, lambda: fused(c1, q, p0, tables, k, v, lay.next()),
            lambda: pair(c1, q, p0, tables, k, v, lay.next()),
            lambda: kvw.write_kv_paged_q8(*c1, k, v, p0, tables, lay.next()))
        t_f = time_ms(torch, lambda: fused(c1, q, p0, tables, k, v, lay.next()))
        t_fp = time_ms(torch, lambda: plain(c1, q, p0, tables, k, v, lay.next()), reps=5)
        t_k = time_ms(torch, lambda: kvw.write_kv_paged_q8(*c1, k, v, p0, tables, lay.next()))
        t_p = time_ms(torch, lambda: kvw.write_kv_paged_q8_plain(*c1, k, v, p0, tables,
                                                                 lay.next()))
        if t == 1:
            k1, v1 = k[:, 0].contiguous(), v[:, 0].contiguous()
            t_d = time_ms(torch, lambda: kvw.write_kv_rows_q8(*dense8, k1, v1, p0, lay.next()))
        else:
            t_d = time_ms(torch, lambda: kvw.write_kv_chunk_q8(*dense8, k, v, p0, lay.next()))
        n_el = 2 * B * t * nkv * hd
        w_ms, w_by = bound_ms(write_bytes(B, t, nkv, hd) + tables.numel() * 4, 3 * n_el)
        nb, ops = attention_bytes_ops(p0, t, S, nkv, nh, hd, 2 * hd + 8, q.numel() * 2,
                                      written=True)
        b_ms, b_by = bound_ms(nb + write_bytes(B, t, nkv, hd) + tables.numel() * 4,
                              ops + 3 * n_el)
        log(f"[time] {label}: {t_f:.4f} ms (device {dev_ms['fused_ms']:.4f}), plain "
            f"{t_fp:.4f} ms, bound {b_ms:.4f} ms ({b_by}); write_kv_paged_q8 (standalone) "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {w_ms:.4f} ms ({w_by}); "
            f"{'K6' if t == 1 else 'K11'} on a dense cache, same rows {t_d:.4f} ms")
        timed[t] = dict(
            max_abs_err=err, ms=t_f, device_ms=dev_ms["fused_ms"], plain_ms=t_fp, bound_ms=b_ms,
            bound_by=b_by, library_ms=None,
            library_note="the rows are written inside K12's int8 walk launch (dattn_walk); no "
                         "single PyTorch call quantizes rows, scatters them through a page "
                         "table and attends",
            breakdown=dict(dev_ms, write_bound_ms=w_ms),
            standalone=dict(max_abs_err=0.0, ms=t_k, device_ms=dev_ms["writer_ms"], plain_ms=t_p,
                            bound_ms=w_ms, bound_by=w_by, dense_same_rows_ms=t_d,
                            source="rama_tpu_torch/csrc/kv_write.cu"),
            shape=f"q ({B}, {t}, {nh}, {hd}) bf16 and k/v rows ({B}, {t}, {nkv}, {hd}) bf16 -> "
                  f"int8 pool ({L}, {npages}, {nkv}, {PAGE_SIZE}, {hd}) + scales, pos0 "
                  f"{p0.tolist()}")
        del c1, k8_, v8_, ks_, vs_
    results["write_kv_paged_q8"] = dict(
        name="write_kv_paged_q8", route="cuda", source="rama_tpu_torch/csrc/decode_attention.cu",
        replaces="rama_tpu/ops/pallas/kv_write.py:395", **timed[1], t4=timed[4])
    del c2, dense8
    torch.cuda.empty_cache()

    # -- K13 (b): write_kv_prefill_paged_q8 ------------------------------------------
    # the streaming body (bf16 at hd 128) at the serving pages (128 rows), at
    # 16- and 64-row pages (runs of a whole page), an odd t_ins and n < K,
    # and a table entry past the pool (clamped to its last page); the
    # warp-a-row body forced on the same inputs; both exact
    Lm = cfg.n_layers

    def k13b_check(label, T, t_ins, n, ps, bodies=("stream",), clamp_entry=False):
        tables, npages = paged_tables(torch, [t_ins] * n, ps, -(-S // ps), 4, gc)
        if clamp_entry:   # one page more, which only the clamped entry reaches
            npages += 1
            tables[0, 0] = npages + 5
        k, v = rows(Lm, B, nkv, T, hd), rows(Lm, B, nkv, T, hd)
        for body in bodies:
            c1 = rpool(Lm, npages, ps)
            c2 = [x.clone() for x in c1]
            n0 = kvw.launches_by_body[body]
            kvw.write_kv_prefill_paged_q8(*c1, k, v, tables.to(dev), t_ins,
                                          _body=None if body == "stream" else body)
            if kvw.launches_by_body[body] != n0 + 1:
                raise SystemExit(f"FAILED write_kv_prefill_paged_q8 {label}: no launch on the "
                                 f"{body} body ({kvw.launches_by_body})")
            kvw.write_kv_prefill_paged_q8_plain(*c2, k, v, tables.to(dev), t_ins)
            same(f"write_kv_prefill_paged_q8 [{body}] {label} L={Lm} K={B} T={T} "
                 f"t_ins={t_ins} n={n} ps={ps}", c1, c2)
            del c1, c2

    for T, t_ins, n in ((16, 16, 8), (512, 512, 8), (512, 300, 3)):
        k13b_check("", T, t_ins, n, PAGE_SIZE, bodies=("stream", "rows"))
    for ps_, t_ins, n in ((16, 333, 5), (64, 129, 7), (128, 77, 8)):
        k13b_check("odd t_ins", 512, t_ins, n, ps_, clamp_entry=ps_ == 128)
    for cname, (n_, d_, ps_) in {"tiny": (2, 16, 16), "stories15M": (6, 48, 32),
                                 "TinyLlama": (4, 64, 128)}.items():
        tb, npg = paged_tables(torch, [40, 40], ps_, 4, 2, gc)
        t1 = rpool(3, npg, ps_, n_, d_)
        t2 = [x.clone() for x in t1]
        for dt in (bf, f32):
            k, v = rows(3, 3, n_, 64, d_, dtype=dt), rows(3, 3, n_, 64, d_, dtype=dt)
            body = kvw.prefill_body_for(dt, d_)
            n0 = kvw.launches_by_body[body]
            kvw.write_kv_prefill_paged_q8(*t1, k, v, tb.to(dev), 40)
            kvw.write_kv_prefill_paged_q8_plain(*t2, k, v, tb.to(dev), 40)
            if kvw.launches_by_body[body] != n0 + 1:
                raise SystemExit(f"FAILED write_kv_prefill_paged_q8 {cname} {dt}: no launch on "
                                 f"the {body} body ({kvw.launches_by_body})")
            same(f"write_kv_prefill_paged_q8 [{body}] {cname} hd={d_} ps={ps_} {dt}", t1, t2)
    # timed at the serving bucket (16 rows) and at an 8 x 512 admission: the
    # streaming body beside the warp-a-row body (the parent's) on the same inputs
    timed = {}
    for T in (16, 512):
        tables, npages = paged_tables(torch, [T] * B, PAGE_SIZE, mp, 4, gc)
        tables = tables.to(dev)
        c1 = rpool(Lm, npages, PAGE_SIZE)
        k, v = rows(Lm, B, nkv, T, hd), rows(Lm, B, nkv, T, hd)
        stream = lambda: kvw.write_kv_prefill_paged_q8(*c1, k, v, tables, T)   # noqa: E731
        rows_body = lambda: kvw.write_kv_prefill_paged_q8(  # noqa: E731
            *c1, k, v, tables, T, _body="rows")
        dev_ms = graph_device_ms(torch, {"stream_ms": stream, "rows_ms": rows_body})
        t_k = time_ms(torch, stream)
        t_r = time_ms(torch, rows_body)
        t_p = time_ms(torch, lambda: kvw.write_kv_prefill_paged_q8_plain(*c1, k, v, tables, T),
                      reps=3 if T > 16 else 5)
        del c1
        n_el = 2 * Lm * B * nkv * T * hd
        b_ms, b_by = bound_ms(n_el * 2 + n_el + 2 * Lm * B * nkv * T * 4 + tables.numel() * 4,
                              3 * n_el)
        t_d = None
        if T == 16:
            dense8 = [torch.zeros((Lm, B, nkv, 64, hd), dtype=torch.int8, device=dev)
                      for _ in range(2)] + [torch.zeros((Lm, B, nkv, 64), device=dev)
                                            for _ in range(2)]
            slots = torch.arange(B, dtype=torch.int32, device=dev)
            t_d = time_ms(torch, lambda: kvw.write_kv_strips_q8(*dense8, k, v, slots, T))
            del dense8
        log(f"[time] write_kv_prefill_paged_q8 T={T}: {t_k:.4f} ms (device "
            f"{dev_ms['stream_ms']:.4f}, {b_ms / dev_ms['stream_ms']:.2f} of the bound), "
            f"the warp-a-row body {t_r:.4f} ms (device {dev_ms['rows_ms']:.4f}, "
            f"{b_ms / dev_ms['rows_ms']:.2f}), plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
            + (f"; K8 on a dense cache, same rows {t_d:.4f} ms" if t_d is not None else ""))
        timed[T] = dict(
            max_abs_err=0.0, ms=t_k, device_ms=dev_ms["stream_ms"], plain_ms=t_p, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, dense_same_rows_ms=t_d,
            breakdown=dict(bound_share=b_ms / dev_ms["stream_ms"]),
            rows_body=dict(ms=t_r, device_ms=dev_ms["rows_ms"],
                           bound_share=b_ms / dev_ms["rows_ms"]),
            shape=f"strips ({Lm}, {B}, {nkv}, {T}, {hd}) bf16 -> {B} slots' pages of a ({Lm}, "
                  f"{npages}, {nkv}, {PAGE_SIZE}, {hd}) int8 pool")
        del k, v
        torch.cuda.empty_cache()
    results["write_kv_prefill_paged_q8"] = dict(
        name="write_kv_prefill_paged_q8", route="cuda", source="rama_tpu_torch/csrc/kv_write.cu",
        replaces="rama_tpu/ops/pallas/kv_write.py:303",
        library_note="no single PyTorch call quantizes strips and scatters them through page "
                     "tables", **timed[16], t512=timed[512])
    for name in (*forms, "write_kv_paged_q8", "write_kv_prefill_paged_q8"):
        r = results[name]
        dense = r.get("dense_same_rows_ms") or r["standalone"]["dense_same_rows_ms"]
        log(f"[kernel] {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), dense kernel on the same rows "
            f"{dense:.4f} ms, library n/a")


def cache_ulp(torch, x):
    """The spacing of numbers of x's dtype at each |x|, bfloat16: 2^(e - 8)
    for |x| in [2^(e-1), 2^e) (float32: 2^(e - 24))."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       e - (8 if x.dtype == torch.bfloat16 else 24))


def check_written_rows(torch, label: str, got, want, before, pos, layer: int) -> None:
    """Kernel 14's cache writes against its plain version's: row pos
    (clamped to S - 1) of every (slot, kv head) of `layer` — the v row bit
    for bit, the roped k row within one ulp of the cache dtype (fp32 RoPE
    rounds the same; the bar allows a contracted FMA) — and every other row
    of both caches unchanged. got / want / before are (k, v) caches."""
    s = before[0].shape[3]
    b = torch.arange(pos.shape[0], device=pos.device)
    p = pos.long().clamp(0, s - 1)
    gk, wk = got[0][layer, b, :, p].float(), want[0][layer, b, :, p]
    if not torch.equal(got[1][layer, b, :, p], want[1][layer, b, :, p]):
        raise SystemExit(f"FAILED {label}: the written v row differs from the plain version's")
    gap = (gk - wk.float()).abs()
    if bool((gap > cache_ulp(torch, wk)).any()):
        raise SystemExit(f"FAILED {label}: the written k row is more than one ulp from the "
                         f"plain version's (max |gap| {float(gap.max()):.3e})")
    for g, w0 in zip(got, before):
        rest = g.clone()
        rest[layer, b, :, p] = w0[layer, b, :, p]
        if not torch.equal(rest, w0):
            raise SystemExit(f"FAILED {label}: a cache row other than pos changed")
    log(f"[check] {label}: written rows v exact, k max |gap| {float(gap.max()):.3e} "
        f"(<= 1 ulp), other rows unchanged")


def phase_kernels_attn(torch, results: dict) -> None:
    """Kernel 9 (T = 1 attention over one layer's cache, bf16 and int8) and
    kernel 14 (the fused attention block: light, and full with int8 and
    int4 wo) against their plain versions at the 7B decode shapes, with
    planted edge rows and positions 0, the 64-row split edges, S - 1 and S +
    3 (clamped), each bf16 K14 launch on its tensor-core body; K14's cache
    writes against the plain version's (check_written_rows). CUDA-event
    times: K9 beside K4 / K7 over the same rows, K14 beside the unfused
    composition of the same step (apply_rope x 2, the row write, K4, and
    for the full form K1's wo), A B B A in one call; device ms: SDPA beside
    K9, K14 (and by kernel) at S 1024 and 4096 beside K4 on the same rows."""
    import torch.nn.functional as F

    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models.llama import KVCache, _rope_tables, _write_kv, apply_rope
    from rama_tpu_torch.ops.kernels import attn_block as ab
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import kv_write as kvw
    from rama_tpu_torch.ops.kernels import quant_matmul as qm
    from rama_tpu_torch.ops.quant import QuantizedTensor

    dev = torch.device("cuda")
    cfg = seven_b_config(ModelConfig)
    g = torch.Generator(device=dev).manual_seed(10)
    bf = torch.bfloat16
    L, nh, nkv, hd, B, S, D = (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 8,
                               cfg.seq_len, cfg.dim)

    def rx(*shape, dtype=bf):
        return torch.randn(shape, device=dev, generator=g).to(dtype)

    def abba(fa, fb) -> tuple[float, float]:
        """CUDA-event ms of fa and fb, timed a, b, b, a."""
        a1, b1, b2, a2 = time_ms(torch, fa), time_ms(torch, fb), time_ms(torch, fb), \
            time_ms(torch, fa)
        return (a1 + a2) / 2, (b1 + b2) / 2

    pos4 = torch.tensor([0, 255, 256, 1023, 63, 64, 511, 700], dtype=torch.int32, device=dev)
    q = rx(B, nh, hd)
    vis = (torch.arange(S, device=dev)[None, :] <= pos4[:, None].long())[:, None, None, :]
    rows4 = int((pos4.clamp(0, S - 1) + 1).sum())

    # -- K9: decode_attention_flat, bf16 -------------------------------------
    kc, vc = rx(L, B, nkv, S, hd), rx(L, B, nkv, S, hd)
    splits = (63, 64, 255, 256, 511, 512, 767, 768, 1023)
    for planted in (False, True):
        for l in (0, L - 1):
            if planted:
                plant_decode_edges(q, kc, pos4, l, splits)
            compare(torch, f"decode_attention_flat B=8 S=1024 layer={l} pos={pos4.tolist()}"
                    f"{' planted edges' if planted else ''}",
                    da.decode_attention_flat(q, kc[l], vc[l], pos4),
                    da.decode_attention_flat_plain(q, kc[l], vc[l], pos4), per=hd)
    err = compare(torch, "decode_attention_flat timed inputs (layer 0)",
                  da.decode_attention_flat(q, kc[0], vc[0], pos4),
                  da.decode_attention_flat_plain(q, kc[0], vc[0], pos4), per=hd)
    lay = Layered(L)

    def k9():
        l = lay.next()
        return da.decode_attention_flat(q, kc[l], vc[l], pos4)

    def k4():
        return da.decode_attention(q, kc, vc, pos4, lay.next())

    t4, t_k = abba(k4, k9)
    dev_ms = {"k9_device_ms": device_ms_per_call(torch, k9),
              "k4_device_ms": device_ms_per_call(torch, k4)}

    def k9_plain():
        l = lay.next()
        return da.decode_attention_flat_plain(q, kc[l], vc[l], pos4)

    def sdpa():
        l = lay.next()
        return F.scaled_dot_product_attention(q[:, :, None, :], kc[l], vc[l], attn_mask=vis)

    t_p, t_lib = time_ms(torch, k9_plain, reps=5), time_ms(torch, sdpa)
    dev_ms["library_device_ms"] = device_ms_per_call(torch, sdpa)
    b_ms, b_by = bound_ms(rows4 * nkv * hd * 2 * 2 + 2 * q.numel() * 2, rows4 * nh * hd * 4)
    results["decode_attention_flat"] = dict(
        name="decode_attention_flat", route="cuda",
        source="rama_tpu_torch/csrc/decode_attention.cu",
        replaces="rama_tpu/ops/pallas/decode_attention.py:830", max_abs_err=err, ms=t_k,
        plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_lib, k4_same_run_ms=t4,
        breakdown=dev_ms,
        shape=f"q (8, 32, 128) bf16, one layer (8, 32, 1024, 128) of a 32-layer cache, "
              f"pos {pos4.tolist()}")

    # -- K9: decode_attention_flat_q8 ----------------------------------------
    pos_long = torch.tensor([0, 63, 64, 255, 1023, 2047, 4000, 4095], dtype=torch.int32,
                            device=dev)
    del kc, vc
    torch.cuda.empty_cache()
    for s_, n_l, pos, edges in ((S, 8, pos4, (63, 64, 255, 256, 511, 512, 1023)),
                                (KV8_MAX_LEN, 4, pos_long,
                                 (63, 64, 1023, 1024, 2047, 2048, 3967, 3968, 4095))):
        c = quantized_cache(torch, kvw, rx, n_l, B, nkv, s_, hd)
        for planted in (False, True):
            for l in (0, n_l - 1):
                if planted:
                    plant_decode_edges_q8(kvw, q, c[0], c[2], pos, l, edges)
                lc = [t[l] for t in c]
                name = (f"decode_attention_flat_q8 S={s_} layer={l} pos={pos.tolist()}"
                        f"{' planted edges' if planted else ''}")
                compare(torch, name, on_body(da.launches_by_body, "walk", name,
                                             lambda: da.decode_attention_flat_q8(q, *lc, pos)),
                        da.decode_attention_flat_q8_plain(q, *lc, pos), per=hd)
        err = compare(torch, f"decode_attention_flat_q8 timed inputs S={s_} (layer 0)",
                      da.decode_attention_flat_q8(q, *[t[0] for t in c], pos),
                      da.decode_attention_flat_q8_plain(q, *[t[0] for t in c], pos), per=hd)
        lay = Layered(n_l)

        def k9q(fn=da.decode_attention_flat_q8):
            l = lay.next()
            return fn(q, *[t[l] for t in c], pos)

        def k7():
            return da.decode_attention_q8(q, *c, pos, lay.next())

        t7, t_k = abba(k7, k9q)
        dev_ms = {"k9_device_ms": device_ms_per_call(torch, k9q),
                  "k7_device_ms": device_ms_per_call(torch, k7)}
        t_p = time_ms(torch, lambda: k9q(da.decode_attention_flat_q8_plain), reps=5)
        n_rows = int((pos.clamp(0, s_ - 1) + 1).sum())
        b_ms, b_by = bound_ms(n_rows * nkv * (2 * hd + 2 * 4) + 2 * q.numel() * 2,
                              n_rows * nh * hd * 4)
        dev_ms["k9_parts"] = with_share(attention_split_combine(torch, k9q), b_ms)
        check_split_body(f"decode_attention_flat_q8 S={s_}", dev_ms["k9_parts"], "walk")
        rec = dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None, k7_same_run_ms=t7, breakdown=dev_ms,
                   shape=f"q (8, 32, 128) bf16, one layer (8, 32, {s_}, 128) int8 + f32 row "
                         f"scales of a {n_l}-layer cache, pos {pos.tolist()}")
        if s_ == S:
            results["decode_attention_flat_q8"] = dict(
                name="decode_attention_flat_q8", route="cuda",
                source="rama_tpu_torch/csrc/decode_attention.cu",
                replaces="rama_tpu/ops/pallas/decode_attention.py:398", **rec)
        else:
            results["decode_attention_flat_q8"]["s4096"] = rec
        del c
        torch.cuda.empty_cache()

    # -- K14: attn_rope_write_layered / attn_block_layered --------------------
    cos_t, sin_t = _rope_tables(cfg, dev, seq_len=KV8_MAX_LEN)
    pos_edge = torch.tensor([S + 3, 1, 64, 65, 127, 128, 1022, S - 1], dtype=torch.int32,
                            device=dev)
    # on and around the 64-row split edges, S - 1 and S + 3 (clamped)
    pos_split = torch.tensor([63, 64, 65, 127, 128, 129, S - 1, S + 3], dtype=torch.int32,
                             device=dev)
    tiles = (63, 64, 127, 128, 511, 512, 1021, 1022)      # the kernel's 64-row split edges
    wo8 = QuantizedTensor(
        q=torch.randint(-127, 128, (L, D, D), dtype=torch.int8, device=dev, generator=g),
        scales=(torch.rand((L, D // 64, D), device=dev, generator=g) + 0.5)
        / (73 * math.sqrt(D)), group_size=64, bits=8)
    wo4 = random_int4_qt(torch, L, D, D, 64, dev, g)
    forms = (("attn_rope_write_layered", None), ("attn_block_layered", wo8),
             ("attn_block_layered_int4", wo4))
    body = ab.body_for(bf)

    def call(name, fn_plain, wo, args, pos, l):
        fn = getattr(ab, name.replace("_int4", "") + ("_plain" if fn_plain else ""))
        return fn(*args, pos, l) if wo is None else fn(*args, wo, pos, l)

    for pos in (pos4, pos_edge, pos_split):
        p = pos.long().clamp(0, S - 1)
        cos, sin = cos_t[p], sin_t[p]
        c2, s2s = (t[:, None] for t in ab.rope_lane_tables(cos, sin))
        qr = ab._rope_lanes(q.float(), c2, s2s)             # what the block scores with
        kn, vn = rx(B, nkv, hd), rx(B, nkv, hd)
        kn[::2] = q[::2] * 0.5          # half the slots: the new row scores ~5.7 too
        base = [rx(2, B, nkv, S, hd), rx(2, B, nkv, S, hd)]
        for planted in (False, True):
            if planted:
                for bi, pp in enumerate(p.tolist()):
                    for r in {pp - 1, pp, pp + 1, *tiles}:
                        if 0 <= r < S:
                            base[0][1, bi, :, r] = (qr[bi] * 0.5).to(bf)
            for name, wo in forms:
                got_c = [t.clone() for t in base]
                want_c = [t.clone() for t in base]
                args = (q, kn, vn, cos, sin)
                label = (f"{name} B=8 S=1024 layer=1 pos={pos.tolist()}"
                         f"{' planted edges' if planted else ''}")
                got = on_body(ab.launches_by_body, body, label,
                              lambda: call(name, False, wo, (*args, *got_c), pos, 1))
                want = call(name, True, wo, (*args, *want_c), pos, 1)
                compare(torch, label, got, want, per=hd if wo is None else None)
                check_written_rows(torch, label, got_c, want_c, base, pos, 1)
        del base, got_c, want_c
    torch.cuda.empty_cache()

    # timed on K4's positions at S 1024 (32 layers) and on long positions at
    # S 4096 (4 layers), the layer cycling, beside K4 over the same rows and
    # (S 1024) the unfused composition of the same step
    for s_, n_l, pos in ((S, L, pos4), (KV8_MAX_LEN, 4, torch.tensor(
            [0, 63, 1021, 2047, 3000, 4000, 4090, 4092], dtype=torch.int32, device=dev))):
        p = pos.long()
        cos, sin = cos_t[p], sin_t[p]
        kn, vn = rx(B, nkv, hd), rx(B, nkv, hd)
        kc, vc = rx(n_l, B, nkv, s_, hd), rx(n_l, B, nkv, s_, hd)
        cache = KVCache(k=kc, v=vc)
        args = (q, kn, vn, cos, sin, kc, vc)
        lay = Layered(n_l)

        def k4():
            return da.decode_attention(q, kc, vc, pos, lay.next())

        k4_parts = attention_split_combine(torch, k4)
        k4_dev = device_ms_per_call(torch, k4)
        for name, wo in forms:
            err = compare(torch, f"{name} timed inputs S={s_} (layer 0)",
                          call(name, False, wo, args, pos, 0),
                          call(name, True, wo, (q, kn, vn, cos, sin, kc.clone(), vc.clone()),
                               pos, 0), per=hd if wo is None else None)
            wo_l = None if wo is None else QuantizedTensor(
                q=wo.q[:n_l], scales=wo.scales[:n_l], group_size=wo.group_size, bits=wo.bits)

            def fused(name=name, wo=wo_l):
                return call(name, False, wo, args, pos, lay.next())

            def unfused(wo=wo_l):
                l = lay.next()
                qr = apply_rope(q[:, None], cos[:, None], sin[:, None])
                kr = apply_rope(kn[:, None], cos[:, None], sin[:, None])
                _write_kv(cache, l, kr, vn[:, None], pos[:, None])
                att = da.decode_attention(qr[:, 0].contiguous(), kc, vc, pos, l)
                return att if wo is None else qm.quant_matmul(att, wo, l)

            dev_ms = {"device_ms": device_ms_per_call(torch, fused),
                      "by_kernel_ms": device_ms_by_kernel(torch, fused),
                      "k4_device_ms": k4_dev, "k4_split_combine_ms": k4_parts}
            dev_ms["over_k4"] = dev_ms["device_ms"] / k4_dev
            if wo is not None:   # the full form's aim: light + K1's wo at M = 8 + 0.010 ms
                x = rx(B, D)
                dev_ms["k1_wo_device_ms"] = device_ms_per_call(
                    torch, lambda wo=wo_l: qm.quant_matmul(x, wo, lay.next()))
                light = (results[forms[0][0]] if s_ == S else
                         results[forms[0][0]]["s4096"])["breakdown"]["device_ms"]
                dev_ms["light_plus_k1_wo_ms"] = light + dev_ms["k1_wo_device_ms"]
            if s_ == S:
                t_u, t_k = abba(unfused, fused)
                dev_ms["unfused_device_ms"] = device_ms_per_call(torch, unfused)
            else:
                t_k = time_ms(torch, fused)
            # rows < pos of K and V read once, q / k / v and the (B, hd/2) f32
            # cos / sin rows in, the row written, att out (or wo[l] in and out)
            nb = (int(p.clamp(0, s_ - 1).sum()) * nkv * hd * 2 * 2
                  + (nh + 2 * nkv) * B * hd * 2 + B * hd * 4 + B * nkv * hd * 2 * 2
                  + B * nh * hd * 2)
            flops = int((p.clamp(0, s_ - 1) + 1).sum()) * nh * hd * 4
            if wo is not None:
                nb += matmul_bytes(wo, B) - B * (D + D) * 2
                flops += 2 * B * D * D
            b_ms, b_by = bound_ms(nb, flops)
            rec = dict(max_abs_err=err, ms=t_k, bound_ms=b_ms, bound_by=b_by,
                       breakdown=dev_ms,
                       shape=f"q (8, 32, 128) bf16, cache ({n_l}, 8, 32, {s_}, 128), pos "
                             f"{pos.tolist()}" + ("" if wo is None else
                                                  f", wo[l] (4096, 4096) int{wo.bits} gs 64"))
            if s_ != S:
                results[name]["s4096"] = rec
                continue
            # bf16: both forms run the light form's split and combine
            # kernels (the full form then K1's qmv_mma on att)
            dev_ms["kernels"] = ab.light_occupancy(nh, nkv, S)
            t_p = time_ms(torch, lambda name=name, wo=wo_l: call(
                name, True, wo, args, pos, lay.next()), reps=3)
            results[name] = dict(
                name=name, route="cuda", source="rama_tpu_torch/csrc/attn_block.cu",
                replaces="rama_tpu/ops/pallas/attn_block.py:" + ("360" if wo is None else "452"),
                plain_ms=t_p, library_ms=None, unfused_ms=t_u,
                library_note="n/a: no single PyTorch call ropes, writes a cache row and attends",
                **rec)
        del kc, vc, cache
        torch.cuda.empty_cache()
    for name in ("decode_attention_flat", "decode_attention_flat_q8",
                 "attn_rope_write_layered", "attn_block_layered", "attn_block_layered_int4"):
        r = results[name]
        extra = {k: round(r[k], 4) for k in ("k4_same_run_ms", "k7_same_run_ms", "unfused_ms")
                 if k in r}
        log(f"[kernel] {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) {json.dumps(extra)} "
            f"{json.dumps(r['breakdown'])}")
    for name in ("attn_rope_write_layered", "attn_block_layered", "attn_block_layered_int4"):
        r = results[name]["s4096"]
        log(f"[kernel] {name} S=4096: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) {json.dumps(r['breakdown'])}")
    r = results["decode_attention_flat_q8"]["s4096"]
    log(f"[kernel] decode_attention_flat_q8 S=4096: {r['ms']:.4f} ms (K7 {r['k7_same_run_ms']:.4f}"
        f"), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
        f"{json.dumps(r['breakdown'])}")
    kernels_attn_gqa(torch, results)


# K14's GQA groups past 8 (kernels_attn): the 16 / 32 / 64-row forms, row
# groups of 64 past 64 (65: a last group of one row); 12 is Mistral-Large's
AB_REPS = (9, 12, 16, 24, 48, 64, 65, 96)


def kernels_attn_gqa(torch, results: dict) -> None:
    """Kernel 14 at the GQA groups of AB_REPS (2 kv heads): both forms,
    int8 and int4 wo, each against its plain version per (slot, head) row
    (light) or output row (full), at B 8 over 512 rows and B 1 over 4096,
    positions on and beside the 64-row split edges and the keys there
    planted to score high, each launch on the mma body in form_for's row
    form, the written rows by check_written_rows. Then timed at
    Mistral-Large's shape (q (8, 96, 128), a cache (8, 8, 8, 512, 128) with
    the layer cycling, wo[l] (12288, 12288) int8 / int4 gs 64): CUDA-event
    and device ms by kernel beside K4's 16-row form on the same rows and
    beside light + K1's wo, the plain version's ms, the bound for this
    run's positions, the two kernels' occupancy. The attn_block_gqa record."""
    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models.llama import _rope_tables
    from rama_tpu_torch.ops.kernels import attn_block as ab
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import quant_matmul as qm
    from rama_tpu_torch.ops.quant import QuantizedTensor

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    bf, hd = torch.bfloat16, 128
    ml = mistral_large_config(ModelConfig)
    cos_t, sin_t = _rope_tables(ml, dev, seq_len=KV8_MAX_LEN)

    def rx(*shape):
        return torch.randn(shape, device=dev, generator=g).to(bf)

    def wo_pair(layers: int, k: int, n: int):
        w8 = QuantizedTensor(
            q=torch.randint(-127, 128, (layers, k, n), dtype=torch.int8, device=dev, generator=g),
            scales=(torch.rand((layers, k // 64, n), device=dev, generator=g) + 0.5)
            / (73 * math.sqrt(k)), group_size=64, bits=8)
        return w8, random_int4_qt(torch, layers, k, n, 64, dev, g)

    def call(name, plain, wo, args, pos, l):
        fn = getattr(ab, name.replace("_int4", "") + ("_plain" if plain else ""))
        return fn(*args, pos, l) if wo is None else fn(*args, wo, pos, l)

    def launch(label, name, wo, args, pos, l, form):
        before = ab.launches_by_form["mma"][form]
        out = on_body(ab.launches_by_body, "mma", label,
                      lambda: call(name, False, wo, args, pos, l))
        if ab.launches_by_form["mma"][form] != before + 1:
            raise SystemExit(f"FAILED {label}: not launched in the {form}-row form "
                             f"{ab.launches_by_form['mma']}")
        return out

    nkv = 2
    sweep = {}
    for rep in AB_REPS:
        nh = nkv * rep
        form, groups = ab.form_for(bf, rep)
        wo8, wo4 = wo_pair(2, nh * hd, 256)
        forms = (("attn_rope_write_layered", None), ("attn_block_layered", wo8),
                 ("attn_block_layered_int4", wo4))
        worst = 0.0
        for b, s_, plist in ((8, 512, [0, 63, 64, 65, 127, 128, 511, 515]),
                             (1, KV8_MAX_LEN, [4033])):
            pos = torch.tensor(plist, dtype=torch.int32, device=dev)
            p = pos.long().clamp(0, s_ - 1)
            cos, sin = cos_t[p], sin_t[p]
            c2, s2s = (t[:, None] for t in ab.rope_lane_tables(cos, sin))
            q = rx(b, nh, hd)
            qr = ab._rope_lanes(q.float(), c2, s2s).view(b, nkv, rep, hd)
            kn, vn = rx(b, nkv, hd), rx(b, nkv, hd)
            base = [rx(2, b, nkv, s_, hd), rx(2, b, nkv, s_, hd)]
            for bi, pp in enumerate(p.tolist()):   # keys that score high: the split edges
                for r in {pp - 1, pp + 1, 63, 64, 127, 128, pp // 64 * 64, pp // 64 * 64 - 1}:
                    if 0 <= r < s_ and r != pp:
                        base[0][1, bi, :, r] = (qr[bi, :, r % rep] * 0.5).to(bf)
            for name, wo in forms:
                got_c, want_c = [t.clone() for t in base], [t.clone() for t in base]
                label = (f"{name} GQA {rep} ({form}-row form x {groups}) B={b} S={s_} "
                         f"pos={plist} planted split edges")
                got = launch(label, name, wo, (q, kn, vn, cos, sin, *got_c), pos, 1, form)
                want = call(name, True, wo, (q, kn, vn, cos, sin, *want_c), pos, 1)
                err = compare(torch, label, got, want, per=hd if wo is None else None)
                worst = max(worst, err)
                check_written_rows(torch, label, got_c, want_c, base, pos, 1)
            del base, got_c, want_c
        sweep[str(rep)] = dict(form=form, groups=groups, max_abs_err=worst)
        del wo8, wo4
        torch.cuda.empty_cache()

    # timed at Mistral-Large's shape, the layer cycling over n_l layers
    n_l, B, S, nkv, nh = 8, 8, ML_MAX_LEN, ml.n_kv_heads, ml.n_heads
    form = ab.form_for(bf, nh // nkv)[0]
    pos = torch.tensor([0, 63, 64, 200, 300, 400, 480, 511], dtype=torch.int32, device=dev)
    p = pos.long()
    cos, sin = cos_t[p], sin_t[p]
    q, kn, vn = rx(B, nh, hd), rx(B, nkv, hd), rx(B, nkv, hd)
    kc, vc = rx(n_l, B, nkv, S, hd), rx(n_l, B, nkv, S, hd)
    wo8, wo4 = wo_pair(n_l, nh * hd, ml.dim)
    forms = (("attn_rope_write_layered", None), ("attn_block_layered", wo8),
             ("attn_block_layered_int4", wo4))
    args = (q, kn, vn, cos, sin, kc, vc)
    lay = Layered(n_l)

    def k4():
        return da.decode_attention(q, kc, vc, pos, lay.next())

    before = da.launches_by_form["mma"][form]
    k4()
    if da.launches_by_form["mma"][form] != before + 1:
        raise SystemExit(f"FAILED K4 at Mistral-Large's shape: not in its {form}-row form")
    k4_parts = attention_split_combine(torch, k4)
    k4_dev = device_ms_per_call(torch, k4)
    x = rx(B, ml.dim)
    breakdown = {"k4_device_ms": k4_dev, "k4_split_combine_ms": k4_parts,
                 "kernels": ab.light_occupancy(nh, nkv, S)}
    out = {}
    for name, wo in forms:
        label = f"{name} Mistral-Large shape GQA 12 B=8 S={S} pos={pos.tolist()}"
        err = compare(torch, label, launch(label, name, wo, args, pos, 0, form),
                      call(name, True, wo, (q, kn, vn, cos, sin, kc.clone(), vc.clone()), pos,
                           0), per=hd if wo is None else None)

        def fused(name=name, wo=wo):
            return call(name, False, wo, args, pos, lay.next())

        dev_ms = {"device_ms": device_ms_per_call(torch, fused),
                  "by_kernel_ms": device_ms_by_kernel(torch, fused)}
        dev_ms["over_k4"] = dev_ms["device_ms"] / k4_dev
        nb = (int(p.clamp(0, S - 1).sum()) * nkv * hd * 2 * 2 + (nh + 2 * nkv) * B * hd * 2
              + B * hd * 4 + B * nkv * hd * 2 * 2 + B * nh * hd * 2)
        flops = int((p.clamp(0, S - 1) + 1).sum()) * nh * hd * 4
        if wo is not None:
            dev_ms["k1_wo_device_ms"] = device_ms_per_call(
                torch, lambda wo=wo: qm.quant_matmul(x, wo, lay.next()))
            dev_ms["light_plus_k1_wo_ms"] = (out["attn_rope_write_layered"]["device_ms"]
                                             + dev_ms["k1_wo_device_ms"])
            nb += matmul_bytes(wo, B) - B * (ml.dim + ml.dim) * 2
            flops += 2 * B * ml.dim * ml.dim
        b_ms, b_by = bound_ms(nb, flops)
        t_k = time_ms(torch, fused)
        t_p = time_ms(torch, lambda name=name, wo=wo: call(name, True, wo, args, pos,
                                                         lay.next()), reps=3)
        out[name] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                         **dev_ms)
        log(f"[kernel] {label}: {t_k:.4f} ms, device {dev_ms['device_ms']:.4f} ms, plain "
            f"{t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}), K4 same rows {k4_dev:.4f} ms "
            f"{json.dumps(dev_ms)}")
    light = out["attn_rope_write_layered"]
    results["attn_block_gqa"] = dict(
        name="attn_block_gqa", route="cuda", source="rama_tpu_torch/csrc/attn_block.cu",
        replaces="rama_tpu/ops/pallas/attn_block.py:360", max_abs_err=light["max_abs_err"],
        ms=light["ms"], plain_ms=light["plain_ms"], bound_ms=light["bound_ms"],
        bound_by=light["bound_by"], library_ms=None,
        library_note="n/a: no single PyTorch call ropes, writes a cache row and attends",
        breakdown={**breakdown, "forms": out}, sweep=sweep,
        shape=f"q (8, 96, 128) bf16 (GQA 12: the {form}-row form), cache ({n_l}, 8, 8, {S}, "
              f"128), pos {pos.tolist()}; full: wo[l] (12288, 12288) int8 / int4 gs 64")
    log(f"[kernel] attn_block_gqa sweep {json.dumps(sweep)}")
    del kc, vc, wo8, wo4
    torch.cuda.empty_cache()


def phase_model(torch, cfg, params, label: str = "int8", dev=None) -> None:
    """Kernel-path logits vs the plain path on a prompt prefill + 2 steps
    (on `dev`, the card unless a test passes the CPU)."""
    from rama_tpu_torch.models.llama import KVCache, decode_step, prefill

    dev = dev or torch.device("cuda")
    toks = torch.tensor([[1, 9038, 2501, 263, 931, 29892, 727, 471]], device=dev)
    caches = [KVCache.create(cfg, 1, 64, device=dev) for _ in range(2)]
    with torch.no_grad():
        lk, _ = prefill(params, cfg, toks, caches[0], last_only=True)
        lp, _ = prefill(params, cfg, toks, caches[1], last_only=True, plain=True)
        compare(torch, f"7B {label} logits prefill (kernels vs plain)", lk[:, -1], lp[:, -1])
        tok = torch.argmax(lp[:, -1], dim=-1)
        for i in range(2):
            pos = torch.tensor([toks.shape[1] + i], device=dev)
            lk, _ = decode_step(params, cfg, tok, pos, caches[0])
            lp, _ = decode_step(params, cfg, tok, pos, caches[1], plain=True)
            compare(torch, f"7B {label} logits decode step {i} (kernels vs plain)", lk, lp)
            tok = torch.argmax(lp, dim=-1)


def rel_gap(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def phase_model_kv8(torch, cfg, params) -> None:
    """Kernel-path logits vs the plain path on an int8 KV cache of 4096 rows
    (params with RoPE tabulated to 4096): a prompt prefill, decode steps at
    positions 8 and 9, then, with rows 10 .. 4095 of both caches filled with
    copies of the plain cache's rows 0-9, at 1500 and 4000 (RoPE past the
    checkpoint's 1024). The gap to a bf16 cache through the kernels is
    printed for information."""
    from rama_tpu_torch.models.llama import KVCache, QuantKVCache, decode_step, prefill

    dev = torch.device("cuda")
    S = KV8_MAX_LEN
    if params["rope_cos"].shape[0] < S:
        raise SystemExit(f"FAILED model_kv8: RoPE tabulated to {params['rope_cos'].shape[0]}")
    toks = torch.tensor([[1, 9038, 2501, 263, 931, 29892, 727, 471]], device=dev)
    caches = [QuantKVCache.create(cfg, 1, S, device=dev) for _ in range(2)]
    dense = KVCache.create(cfg, 1, S, device=dev)
    with torch.no_grad():
        lk, _ = prefill(params, cfg, toks, caches[0], last_only=True)
        lp, _ = prefill(params, cfg, toks, caches[1], last_only=True, plain=True)
        ld, _ = prefill(params, cfg, toks, dense, last_only=True)
        compare(torch, "7B int8 KV logits prefill (kernels vs plain)", lk[:, -1], lp[:, -1])
        log(f"[model_kv8] prefill logits, int8 vs bf16 cache (kernels): rel "
            f"{rel_gap(torch, lk[:, -1], ld[:, -1]):.3e} (not gated)")
        tok = torch.argmax(lp[:, -1], dim=-1)
        for p in (8, 9, 1500, 4000):
            if p == 1500:
                # rows 10 .. S-1 of both caches: copies of the plain cache's
                # rows 0-9 (the model's own keys and values; random rows
                # would make each step's softmax a near-argmax over noise,
                # which turns the kernels' bf16 rounding into whole-token
                # jumps)
                tile = torch.arange(S - 10, device=dev) % 10
                for name in ("k", "v", "ks", "vs"):
                    rows = getattr(caches[1], name).index_select(3, tile)
                    for c in caches:
                        getattr(c, name)[:, :, :, 10:] = rows
            pos = torch.tensor([p], device=dev)
            lk, _ = decode_step(params, cfg, tok, pos, caches[0])
            lp, _ = decode_step(params, cfg, tok, pos, caches[1], plain=True)
            compare(torch, f"7B int8 KV logits decode at pos {p} (kernels vs plain)", lk, lp)
            if p < 10:
                ld, _ = decode_step(params, cfg, tok, pos, dense)
                log(f"[model_kv8] decode at pos {p}, int8 vs bf16 cache (kernels): rel "
                    f"{rel_gap(torch, lk, ld):.3e} (not gated)")
            tok = torch.argmax(lp, dim=-1)
    del caches, dense
    torch.cuda.empty_cache()


def phase_model_spec(torch, cfg, params) -> None:
    """7B int8 forward_chunk (T = SPEC_TICK + 1) through the kernels against
    the plain path, logits within TOL per row, on a bf16 and an int8 cache
    of 4096 rows (params with RoPE tabulated to 4096): 2 slots prefilled
    with a prompt, a chunk at position 8, then, with rows 12 .. 4095 of both
    caches filled with copies of the plain cache's rows 0-11 (as
    model_kv8), chunks starting at 61 and 1500, and at 1021 and 4092."""
    from rama_tpu_torch.models.llama import KVCache, QuantKVCache, forward_chunk, prefill

    dev = torch.device("cuda")
    S, T = KV8_MAX_LEN, SPEC_TICK + 1
    toks = torch.tensor([[1, 9038, 2501, 263, 931, 29892, 727, 471]] * 2, device=dev)
    chunk = torch.tensor([[29871, 1576, 338, 263], [450, 4123, 471, 727]], device=dev)[:, :T]
    for cls in (KVCache, QuantKVCache):
        caches = [cls.create(cfg, 2, S, device=dev) for _ in range(2)]
        names = ("k", "v", "ks", "vs") if cls is QuantKVCache else ("k", "v")
        with torch.no_grad():
            prefill(params, cfg, toks, caches[0], last_only=True)
            prefill(params, cfg, toks, caches[1], last_only=True, plain=True)
            for starts in ([8, 8], [61, 1500], [1021, 4092]):
                if starts[0] == 61:
                    tile = torch.arange(S - 12, device=dev) % 12
                    for name in names:
                        rows = getattr(caches[1], name).index_select(3, tile)
                        for c in caches:
                            getattr(c, name)[:, :, :, 12:] = rows
                pos0 = torch.tensor(starts, dtype=torch.int32, device=dev)
                lk, _ = forward_chunk(params, cfg, chunk, pos0, caches[0])
                lp, _ = forward_chunk(params, cfg, chunk, pos0, caches[1], plain=True)
                compare(torch, f"7B int8 forward_chunk T={T} on {cls.__name__} pos0={starts} "
                        f"(kernels vs plain)", lk, lp)
        del caches
        torch.cuda.empty_cache()


def phase_model_paged(torch, cfg, params) -> None:
    """7B int8 logits through the paged fused paths (K12 / K13, kernels)
    against the plain path on a dense cache holding the same rows, on a
    bf16 and an int8 pool of pages of PAGE_SIZE rows under shuffled tables
    (params with RoPE tabulated to 4096): 2 slots prefilled with a prompt
    (dense, plain) and copied into the pool, a decode step (T = 1) at 8 and
    a chunk (T = 4) at 9; then, with rows 13 .. 4095 of the dense cache
    filled with copies of its rows 0-12 and every row copied into the pool
    again, decode steps at 1500 / 4000 and chunks at 61 / 1500 and 1021 /
    4092. Gate rel TOL per row; the 3.5e-2 bar of T = 4 logged."""
    from rama_tpu_torch.models.llama import (KVCache, QuantKVCache, decode_step, forward_chunk,
                                             prefill)
    from rama_tpu_torch.ops.kernels.kv_write import put_strips_
    from rama_tpu_torch.runtime.paged import (PagedKVCache, QuantPagedKVCache,
                                              decode_step_paged, forward_paged)

    dev = torch.device("cuda")
    S, T, mp = KV8_MAX_LEN, SPEC_TICK + 1, KV8_MAX_LEN // PAGE_SIZE
    toks = torch.tensor([[1, 9038, 2501, 263, 931, 29892, 727, 471]] * 2, device=dev)
    chunk = torch.tensor([[29871, 1576, 338, 263], [450, 4123, 471, 727]], device=dev)[:, :T]
    tables = torch.randperm(2 * mp + 1, generator=torch.Generator().manual_seed(3))
    tables = tables[:2 * mp].view(2, mp).to(torch.int32).to(dev)
    names = {KVCache: ("k", "v"), QuantKVCache: ("k", "v", "ks", "vs")}
    for dense_cls, pool_cls in ((KVCache, PagedKVCache), (QuantKVCache, QuantPagedKVCache)):
        dense = dense_cls.create(cfg, 2, S, device=dev)
        pool = pool_cls.create(cfg, 2 * mp + 1, PAGE_SIZE, device=dev)

        def to_pool():
            for name in names[dense_cls]:
                put_strips_(getattr(pool, name), getattr(dense, name), tables, S)

        with torch.no_grad():
            lp, _ = prefill(params, cfg, toks, dense, last_only=True, plain=True)
            to_pool()
            tok = torch.argmax(lp[:, -1], dim=-1)
            for step in ([8, 8], [9, 9], [1500, 4000], [61, 1500], [1021, 4092]):
                if step[0] == 1500:
                    tile = torch.arange(S - 13, device=dev) % 13
                    for name in names[dense_cls]:
                        rows = getattr(dense, name).index_select(3, tile)
                        getattr(dense, name)[:, :, :, 13:] = rows
                    to_pool()
                pos = torch.tensor(step, dtype=torch.int32, device=dev)
                if step[0] in (8, 1500):
                    lk, _ = decode_step_paged(params, cfg, tok, pos, pool, tables)
                    lp, _ = decode_step(params, cfg, tok, pos, dense, plain=True)
                    what, bar = "decode step (T = 1)", None
                else:
                    cols = pos[:, None] + torch.arange(T, device=dev)[None, :]
                    lk, _ = forward_paged(params, cfg, chunk, cols, pool, tables)
                    lp, _ = forward_chunk(params, cfg, chunk, pos, dense, plain=True)
                    what, bar = f"chunk (T = {T})", 3.5e-2
                compare(torch, f"7B int8 paged {what} on {pool_cls.__name__} at {step} "
                        f"(kernels vs plain on a dense cache)", lk, lp, bar=bar)
                tok = torch.argmax(lp.reshape(2, -1, lp.shape[-1])[:, -1], dim=-1)
        del dense, pool
        torch.cuda.empty_cache()


SELF_DRAFT_PROMPTS = ("Once upon a time", "The little dog")
SELF_DRAFT_ENGINE = dict(max_batch_size=2, max_seq_len=1024, decode_tick=8)


def serve_greedy(cfg, params, tokenizer, ecfg, prompts, steps: int, draft=None):
    """The engine on `prompts`, greedy, `steps` tokens each: (the streams,
    the engine's stats); fails on a request or engine error."""
    from rama_tpu_torch.runtime.engine import Engine, Request

    eng = Engine(cfg, params, tokenizer, ecfg, draft=draft)
    eng.start()
    try:
        reqs = [Request(prompt=p, steps=steps, temperature=0.0) for p in prompts]
        for r in reqs:
            eng.submit(r)
        outs = []
        for r in reqs:
            toks = []
            while (t := r.queue.get(timeout=600)) is not None:
                toks.append(t)
            outs.append(toks)
    finally:
        eng.stop()
    if any(r.error for r in reqs) or eng.stats()["engine_errors"]:
        raise SystemExit(f"FAILED spec_draft: {[r.error for r in reqs]} {eng.stats()}")
    return outs, eng.stats()


def self_draft(cfg, params, tokenizer, start_count=lambda: None, spec_tick: int = SPEC_TICK):
    """The target as its own draft (a separate draft cache), greedy, 2
    slots x 16 tokens, never dormant, spec_tick drafts a round, after a
    spec-off run of the same requests (then `start_count()`): (spec-off
    streams, spec-on streams, the spec-on engine's stats)."""
    from rama_tpu_torch.config import EngineConfig

    off, _ = serve_greedy(cfg, params, tokenizer, EngineConfig(**SELF_DRAFT_ENGINE),
                          SELF_DRAFT_PROMPTS, 16)
    start_count()
    on, stats = serve_greedy(cfg, params, tokenizer,
                             EngineConfig(**SELF_DRAFT_ENGINE, spec_tick=spec_tick,
                                          spec_mode="draft", spec_min_accept=0.0),
                             SELF_DRAFT_PROMPTS, 16, draft=(cfg, params))
    return off, on, stats


def phase_spec_draft_ab(torch, cfg, params, tokenizer) -> dict:
    """The self-draft of spec_draft under RAMA_ATTN_BLOCK 1 and 2, once
    each: the draft's decode steps run kernel 14 (the fused block's
    numerics: an fp32 new row), the target's verification rounds K10, so a
    verified row is not the decode step's bit for bit. Logs each mode's
    accept rate and the first position where the streams leave spec off's
    under the same mode; no gate. Returns {mode: accept rate}."""
    from rama_tpu_torch.models import llama

    rates = {}
    saved = llama.ATTN_BLOCK
    try:
        for mode in (1, 2):
            llama.ATTN_BLOCK = mode
            t0 = time.time()
            off, on, stats = self_draft(cfg, params, tokenizer)
            firsts = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), None)
                      for x, y in zip(on, off)]
            rates[mode] = stats["spec_accept_rate"]
            log(f"[spec_draft_ab] RAMA_ATTN_BLOCK={mode}: target as its own draft, accept "
                f"rate {stats['spec_accept_rate']}, first position differing from spec off "
                f"per stream {firsts} (None: equal), {time.time() - t0:.1f} s")
    finally:
        llama.ATTN_BLOCK = saved
    return rates


def phase_spec_draft(torch, cfg, params, tokenizer, start_count=lambda: None) -> None:
    """Draft-mode speculation in the engine. (1) The target as its own draft
    (a separate draft cache), greedy, 2 slots x 16 tokens, never dormant:
    the accept rate must be >= 0.9 — K10's verification agrees with the
    T = 1 decode path — and the streams are compared with a spec-off run of
    the same requests, made first and followed by `start_count()`, so
    that the path's launch count holds only draft-mode runs. (2) A
    synthetic stories15M-shaped draft checkpoint loaded as the server's
    --spec-draft-model is: random weights accept ~0, so with 2 dormant
    ticks the run goes dormant (plain ticks through K4), resyncs the draft
    cache and probes again; every stream must end, and dormancy and a
    resync must have happened."""
    from rama_tpu_torch.checkpoint import save_v0
    from rama_tpu_torch.config import EngineConfig, ModelConfig
    from rama_tpu_torch.runtime import engine as eng_mod
    from rama_tpu_torch.cli import load_model

    def serve(ecfg, prompts, steps, draft=None):
        return serve_greedy(cfg, params, tokenizer, ecfg, prompts, steps, draft=draft)

    base = dict(SELF_DRAFT_ENGINE)
    prompts = list(SELF_DRAFT_PROMPTS)
    t0 = time.time()
    off, on, stats = self_draft(cfg, params, tokenizer, start_count)
    firsts = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), None)
              for x, y in zip(on, off)]
    log(f"[spec_draft] target as its own draft: accept rate {stats['spec_accept_rate']}, "
        f"first position differing from spec off per stream {firsts} (None: equal), "
        f"{time.time() - t0:.1f} s")
    if not (stats["spec_accept_rate"] or 0) >= 0.9:
        raise SystemExit(f"FAILED spec_draft: accept rate {stats['spec_accept_rate']} < 0.9")

    dcfg = ModelConfig(dim=288, hidden_dim=768, n_layers=6, n_heads=6, n_kv_heads=6,
                       vocab_size=32000, seq_len=256)
    rng = np.random.default_rng(6)
    L, D, H, V = dcfg.n_layers, dcfg.dim, dcfg.hidden_dim, dcfg.vocab_size

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    p = {"tok_embedding": w(V, D), "attn_norm": np.ones((L, D), np.float32),
         "wq": w(L, D, D), "wk": w(L, D, D), "wv": w(L, D, D), "wo": w(L, D, D),
         "ffn_norm": np.ones((L, D), np.float32), "w1": w(L, D, H), "w2": w(L, H, D),
         "w3": w(L, D, H), "final_norm": np.ones(D, np.float32)}
    saved = eng_mod._SPEC_DORMANT_TICKS
    eng_mod._SPEC_DORMANT_TICKS = 2
    try:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "draft_stories15M.bin")
            save_v0(path, dcfg, p)
            # dense bf16, as the server's load_engine loads --spec-draft-model
            draft = load_model(path, "none", "bfloat16", params["final_norm"].device)[:2]
        t0 = time.time()
        outs, stats = serve(EngineConfig(**{**base, "max_batch_size": 4}, spec_tick=SPEC_TICK,
                                         spec_mode="draft"),
                            prompts + ["In a far away land", "Tom and Lily"], 48, draft=draft)
    finally:
        eng_mod._SPEC_DORMANT_TICKS = saved
    log(f"[spec_draft] stories15M-shaped random draft: {[len(o) for o in outs]} tokens, "
        f"accept rate {stats['spec_accept_rate']}, dormancies {stats['spec_dormancies']}, "
        f"draft resyncs {stats['draft_resyncs']}, {time.time() - t0:.1f} s")
    if not all(outs) or stats["spec_dormancies"] < 1 or stats["draft_resyncs"] < 1:
        raise SystemExit(f"FAILED spec_draft: streams {[len(o) for o in outs]}, {stats}")


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


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in vars(cache).values())


def phase_serve(torch, cfg, params, tokenizer, card: str, tag: str = "serve",
                max_seq_len: int = 1024, kv_quant: str | None = None,
                spec_tick: int = 0, paged: bool = False,
                scale_dtype: str | None = None, slots: int = 8, warmup: int | None = None,
                compile_cache: str | None = None, start_count=lambda: None) -> dict:
    """The server around an engine of `slots` slots (8 by default): as many
    concurrent /gen of 32 tokens (greedy and sampled; past 8 the 8 prompts
    again with a number appended; a request answered 503, the engine's
    admission queue of 30 being full, is sent again after 0.25 s), every
    stream must end and /metrics count every token. With spec_tick, n-gram speculation that never goes dormant
    (spec_min_accept 0), so every tick is a spec tick, and the accept rate
    must be a number. Paged: a pool of PAGED_NUM_PAGES pages of PAGE_SIZE
    rows, every page free again after the run. scale_dtype "bf16": the
    engine stores every quantized leaf's scales in bf16 (checked). With
    `warmup` (a fresh process: nothing built or loaded yet), the engine
    builds into and loads from `compile_cache`, runs Engine.warmup(
    max_prompt=warmup) before start() (warm_up), then `start_count()`;
    after the run no library may have been built or loaded and every
    (k, T) prefill bucket served must have been warmed. Returns tok/s, TTFT
    p50 / max / of the first request sent, the accept rate and the greedy
    streams' text by prompt."""
    import aiohttp
    from aiohttp import web

    from rama_tpu_torch.config import EngineConfig
    from rama_tpu_torch.models.llama import KVCache, QuantKVCache
    from rama_tpu_torch.runtime.engine import Engine
    from rama_tpu_torch.runtime.paged import PagedKVCache, QuantPagedKVCache
    from rama_tpu_torch.server.app import build_app

    engine = Engine(cfg, params, tokenizer,
                    EngineConfig(max_batch_size=slots, max_seq_len=max_seq_len, decode_tick=8,
                                 kv_quant=kv_quant, spec_tick=spec_tick, spec_mode="ngram",
                                 spec_min_accept=0.0, paged_kv=paged, kv_page_size=PAGE_SIZE,
                                 kv_num_pages=PAGED_NUM_PAGES if paged else None,
                                 scale_dtype=scale_dtype, compile_cache=compile_cache))
    stored = {getattr(p, "scales", None) is not None and p.scales.dtype
              for p in engine.params.values()} - {False}
    if stored != {torch.bfloat16 if scale_dtype == "bf16" else torch.float32}:
        raise SystemExit(f"FAILED {tag}: scale_dtype={scale_dtype} serves weight scales "
                         f"stored as {stored}")
    want = ((QuantPagedKVCache if kv_quant == "int8" else PagedKVCache) if paged
            else (QuantKVCache if kv_quant == "int8" else KVCache))
    if type(engine.cache) is not want:
        raise SystemExit(f"FAILED {tag}: kv_quant={kv_quant} paged={paged} built "
                         f"{type(engine.cache)}")
    if paged:
        # a dense cache of the same slots and rows: K and V rows, int8 plus
        # a 4-byte scale or bf16
        row = cfg.n_kv_heads * (cfg.head_dim + 4 if kv_quant == "int8" else 2 * cfg.head_dim)
        dense = 2 * cfg.n_layers * slots * max_seq_len * row
        log(f"[{tag}] pool of {engine.cache.num_pages} pages x {PAGE_SIZE} rows: "
            f"{cache_bytes(engine.cache) / 1e9:.3f} GB; a dense cache of {slots} slots x "
            f"{max_seq_len} rows: {dense / 1e9:.3f} GB")
    warm = warm_up(engine, warmup, tag) if warmup is not None else None
    start_count()
    engine.start()
    prompts = ["Once upon a time", "The little dog", "In a far away land",
               "She opened the door", "Tom and Lily", "The sun was", "A big red ball",
               "One day"]
    prompts = [p if i < 8 else f"{p} {i}" for i in range(slots) for p in [prompts[i % 8]]]
    steps = 32

    busy = []   # 503s: the engine's admission queue (30 requests) was full

    async def one(session, url, prompt, temp):
        t0 = time.perf_counter()
        ttft, n, ended, text = None, 0, False, []
        while True:   # a client that retries a 503 after 0.25 s (TTFT counts the wait)
            resp = await session.get(url, params={"prompt": prompt, "steps": str(steps),
                                                  "temperature": str(temp)})
            if resp.status != 503:
                break
            resp.release()
            busy.append(prompt)
            await asyncio.sleep(0.25)
        async with resp:
            if resp.status != 200:
                raise SystemExit(f"FAILED {tag}: /gen status {resp.status}")
            async for raw in resp.content:
                line = raw.decode().rstrip("\n")
                if line.startswith("data: "):
                    n += 1
                    text.append(line[len("data: "):])
                    if ttft is None:
                        ttft = time.perf_counter() - t0
                elif line.startswith("event: error"):
                    raise SystemExit(f"FAILED {tag}: error event for {prompt!r}")
            ended = True
        return ttft, n, ended, "".join(text)

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
    if paged and engine.allocator.available() != PAGED_NUM_PAGES:
        raise SystemExit(f"FAILED {tag}: {engine.allocator.available()} of {PAGED_NUM_PAGES} "
                         f"pages free after the run")
    total = sum(n for _, n, _, _ in outs)
    if not all(ended and n > 0 for _, n, ended, _ in outs):
        raise SystemExit(f"FAILED {tag}: a stream did not finish {outs}")
    if stats["tokens_generated"] < total or stats["engine_errors"]:
        raise SystemExit(f"FAILED {tag}: /metrics {stats} vs {total} streamed")
    rate = stats["spec_accept_rate"]
    if spec_tick and not isinstance(rate, float):
        raise SystemExit(f"FAILED {tag}: spec_accept_rate {rate!r} is not a number")
    ttfts = sorted(t for t, _, _, _ in outs)
    summary = dict(tok_s=total / wall, ttft_p50_ms=ttfts[len(ttfts) // 2] * 1e3,
                   ttft_max_ms=ttfts[-1] * 1e3, ttft_first_ms=outs[0][0] * 1e3,
                   decode_tok_per_s=stats["decode_tok_per_s"],
                   spec_accept_rate=rate, decode_ticks=stats["decode_ticks"],
                   greedy={p: out[3] for i, (p, out) in enumerate(zip(prompts, outs))
                           if i % 2 == 0})
    if warm is not None:
        summary["warmup"] = warm_checked(warm, tag)
    if busy:
        log(f"[{tag}] {len(busy)} /gen answered 503 (admission queue full) and were retried")
    log(f"[{tag}] {len(outs)} concurrent /gen, {total} tokens in {wall:.3f} s: "
        f"{summary['tok_s']:.2f} tok/s aggregate; TTFT p50 {summary['ttft_p50_ms']:.1f} "
        f"ms max {summary['ttft_max_ms']:.1f} ms; decode_tok_per_s "
        f"{stats['decode_tok_per_s']:.2f}; spec_accept_rate {rate} ({card})")
    log(f"[{tag}] metrics phases {json.dumps(stats['phases'])}")
    return summary


def warm_up(engine, max_prompt: int, tag: str) -> dict:
    """Engine.warmup(max_prompt) on an engine of a process that has built
    and loaded no kernel library yet: no nvcc may run, every library must
    be loaded by the end of it, and the (k, T) prefill buckets it ran are
    kept; a spy on the engine's prefill then records every bucket served
    (warm_checked reads both)."""
    from rama_tpu_torch.ops.kernels import build

    if build.counts != {"builds": 0, "loads": 0}:
        raise SystemExit(f"FAILED {tag}: kernels built or loaded before warmup {build.counts}")
    buckets: list = []
    prefill = engine._dev_prefill_insert

    def spy(tokens, *args, **kw):
        buckets.append(tuple(tokens.shape))
        return prefill(tokens, *args, **kw)

    engine._dev_prefill_insert = spy
    w = engine.warmup(max_prompt=max_prompt)
    if build.counts != {"builds": 0, "loads": len(build.SOURCES)}:
        raise SystemExit(f"FAILED {tag}: warmup left {build.counts} nvcc runs / library loads; "
                         f"want 0 / {len(build.SOURCES)} (libraries in {build.BUILD_DIR})")
    warmed = sorted(set(buckets))
    buckets.clear()
    log(f"[{tag}] warmup: {w['programs']} programs in {w['seconds']:.1f}s (max_prompt "
        f"{max_prompt}; {len(build.SOURCES)} libraries loaded from {build.BUILD_DIR}, no nvcc "
        f"run; prefill buckets (k, T) {warmed})")
    return dict(programs=w["programs"], seconds=w["seconds"], warmed=warmed, served=buckets)


def warm_checked(warm: dict, tag: str) -> dict:
    """After a warmed engine served: no library built or loaded since the
    warmup, every (k, T) bucket served among the warmed ones."""
    from rama_tpu_torch.ops.kernels import build

    served = sorted(set(warm["served"]))
    if build.counts != {"builds": 0, "loads": len(build.SOURCES)}:
        raise SystemExit(f"FAILED {tag}: serving after warmup built or loaded a library "
                         f"{build.counts}")
    cold = [b for b in served if b not in warm["warmed"]]
    if not served or cold:
        raise SystemExit(f"FAILED {tag}: prefill buckets {cold} served cold (warmed "
                         f"{warm['warmed']}, served {served})")
    log(f"[{tag}] after warmup: served buckets {served}, all warmed; {build.counts}")
    return dict(warm, served=served, counts=dict(build.counts))


WARMUP_RESULT = "[serve_warmup-result] "   # the child's summary line


def phase_serve_warmup(torch, card: str, serving: dict) -> dict:
    """serve_kv8 in a fresh process after Engine.warmup: this run's built
    libraries copied into a new directory under build/, which the child's
    compile_cache names (warmup_child). Its greedy streams must equal
    serve_kv8's in this run; its launch counts (from the end of the warmup)
    come back with its summary."""
    from rama_tpu_torch.ops.kernels import build

    cache = ROOT / "build" / f"compile_cache_{os.getpid()}"
    shutil.rmtree(cache, ignore_errors=True)
    cache.mkdir(parents=True)
    for name in build.SOURCES:
        lib = build._lib_path(name)
        for f in (lib, lib.with_suffix(".log")):
            shutil.copy2(f, cache / f.name)
    torch.cuda.empty_cache()
    try:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--warmup-child",
                               str(cache)], capture_output=True, text=True, timeout=900)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith(WARMUP_RESULT):
            result = json.loads(line[len(WARMUP_RESULT):])
        else:
            log(f"  {line}")
    if proc.returncode or result is None:
        raise SystemExit(f"FAILED serve_warmup: the child exited {proc.returncode}: "
                         f"{proc.stderr[-4000:]}")
    plain = serving.get("serve_kv8")
    if plain is not None:
        differ = [p for p, text in result["greedy"].items() if plain["greedy"].get(p) != text]
        if differ:
            raise SystemExit(f"FAILED serve_warmup: greedy streams of {differ} differ from "
                             f"serve_kv8's: {result['greedy']} vs {plain['greedy']}")
        log(f"[serve_warmup] {len(result['greedy'])} greedy streams equal serve_kv8's")
    log(f"[serve_warmup] first request's TTFT {result['ttft_first_ms']:.1f} ms after warmup "
        f"(p50 {result['ttft_p50_ms']:.1f}, max {result['ttft_max_ms']:.1f}); serve_kv8 in "
        f"this run: " + (f"{plain['ttft_first_ms']:.1f} ms (p50 {plain['ttft_p50_ms']:.1f}, max "
                         f"{plain['ttft_max_ms']:.1f})" if plain else "not run") + f" ({card})")
    return result


def warmup_child(cache: str) -> int:
    """The fresh process of serve_warmup: the 7B int8 params from the seed
    of every path, then phase_serve with WARMUP_PATH's settings, its
    warmup and `cache` as compile_cache; prints its summary with the launch
    counts on a WARMUP_RESULT line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.ops.kernels import attn_block as ab
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import ffn as ffn_mod
    from rama_tpu_torch.ops.kernels import kv_write as kvw
    from rama_tpu_torch.ops.kernels import paged_attention as pga
    from rama_tpu_torch.ops.kernels import prefill_attention as pa
    from rama_tpu_torch.ops.kernels import quant_matmul as qm
    from rama_tpu_torch.tokenizer import Tokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    modules = (qm, ffn_mod, da, pa, kvw, pga, ab)
    cfg = seven_b_config(ModelConfig)
    t0 = time.time()
    params = random_params(torch, cfg, torch.device("cuda"), bits=8)
    torch.cuda.synchronize()
    log(f"[serve_warmup] child: Llama-2-7B int8 params on the card in {time.time() - t0:.1f} s")
    tokenizer = Tokenizer.from_file(ROOT / "tests" / "fixtures" / "tokenizer.bin", 32000)
    summary = phase_serve(torch, cfg, params, tokenizer, nvidia_smi_line(), tag="serve_warmup",
                          **WARMUP_PATH["serve"], warmup=WARMUP_PATH["warmup"],
                          compile_cache=cache, start_count=lambda: reset_launches(*modules))
    summary["launches"] = read_launches(*modules)
    print(WARMUP_RESULT + json.dumps(summary), flush=True)
    return 0


def pipe_prompts() -> list:
    """serve_pipe's 16 prompts: the serving paths' 8, then the same 8 with a
    number appended."""
    base = ["Once upon a time", "The little dog", "In a far away land", "She opened the door",
            "Tom and Lily", "The sun was", "A big red ball", "One day"]
    return base + [f"{p} {i + 8}" for i, p in enumerate(base)]


def profiled_device_s(torch, prof) -> float:
    """Seconds of every GPU activity a torch.profiler session recorded, read
    from its kineto events (no per-event parsing into FunctionEvents, which
    takes tens of seconds for the ~10^5 kernels of a served run), or from
    key_averages where the session keeps no kineto results."""
    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if res is not None:
        cuda = torch.autograd.DeviceType.CUDA
        return sum(e.duration_ns() for e in res.events() if e.device_type() == cuda) / 1e9
    return sum(getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
               for ev in prof.key_averages() if ev.device_type.name == "CUDA") / 1e6


def strict_dispatch(torch, eng, name: str, hook=None) -> None:
    """Wrap eng.<name> so that every call runs under
    torch.cuda.set_sync_debug_mode("error"): a sync inside raises, and the
    loop counts an engine error. hook(*args), if given, runs just before
    the dispatch and returns a function called with its result after it."""
    orig = getattr(eng, name)

    def call(*a):
        done = hook(*a) if hook else None
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = orig(*a)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        if done:
            done(out)
        return out

    setattr(eng, name, call)


def on_emit(eng, fn) -> None:
    """Call fn(slot, token) on every token the engine emits, before it
    streams it."""
    emit = eng._emit

    def record(slot, token):
        fn(slot, token)
        emit(slot, token)

    eng._emit = record


def serve_run(torch, eng, reqs, submit, profiled: bool) -> dict:
    """Start `eng`, call submit(t0) (which submits the requests, `reqs` all
    of them in the end), then stream every request to its end. `profiled`:
    the run under torch.profiler (CUDA events only). Returns the tokens
    streamed, the wall (t0 to the last stream's end), tok/s and, with
    `profiled`, the device kernel seconds."""
    from torch.profiler import ProfilerActivity, profile

    ctx = profile(activities=[ProfilerActivity.CUDA]) if profiled else contextlib.nullcontext()
    try:
        with ctx as prof:
            eng.start()
            t0 = time.perf_counter()
            submit(t0)
            total = 0
            for r in reqs:
                while r.queue.get(timeout=300) is not None:
                    total += 1
            wall = time.perf_counter() - t0
            eng.stop()
            torch.cuda.synchronize()
    finally:
        eng.stop()
    out = dict(total=total, wall_s=wall, tok_s=total / wall)
    if profiled:
        out["kernel_s"] = profiled_device_s(torch, prof)
    return out


def phase_seconds(eng, names) -> dict:
    """The engine's PhaseTimer totals of `names`, as <name>_s."""
    return {f"{k}_s": round(eng.phases.totals[k], 4) for k in names}


def pipe_run(torch, cfg, params, tokenizer, kw: dict, depth: int, warm: bool = False,
             profiled: bool = False) -> dict:
    """One serve_pipe run: an in-process Engine (PIPE_SERVE plus `kw`) at
    _PIPELINE_DEPTH `depth` serves 16 requests of PIPE_STEPS tokens (EOS
    does not end them), even ones greedy, odd ones sampled (temperature
    1.0, top-p 0.9). The first is submitted alone, the next 7 once it has
    its first token (while its first tick is being dispatched: they are
    admitted behind it) and the last 8 once the first 8 have theirs (they
    wait for free slots, and while they wait no tick chains). Every tick's
    dispatch, chained or not, and every admission dispatch runs under
    torch.cuda.set_sync_debug_mode("error"): a sync
    there raises, the loop counts an engine error, and the run fails.
    `warm`: Engine.warmup(max_prompt=16) first (untimed); `profiled`: the
    run under torch.profiler (CUDA events only). Returns the token ids by
    request, the wall (first submission to the last stream's end), tok/s,
    the TTFT p50 of requests 2-8 (admitted mid-stream) and of the last 8,
    the counts of successful chained dispatches and of admissions
    dispatched with a tick in flight, the engine's ticks, prefill groups
    and phase seconds (`breakdown`), and with `profiled` the device kernel
    seconds."""
    from rama_tpu_torch.config import EngineConfig
    from rama_tpu_torch.runtime import engine as eng_mod
    from rama_tpu_torch.runtime.engine import Engine, Request

    saved = eng_mod._PIPELINE_DEPTH
    eng_mod._PIPELINE_DEPTH = depth
    t_setup = time.perf_counter()
    eng = Engine(cfg, params, tokenizer, EngineConfig(**PIPE_SERVE, **kw))
    if warm:
        eng.warmup(max_prompt=16)
    t_setup = time.perf_counter() - t_setup
    counts = {"_dispatch_chained": 0, "_dispatch_spec_chained": 0, "_admit_dispatch": 0}

    def counted(name):
        def hook(*a):
            behind = bool(eng._inflight_q or eng._spec_inflight_q)
            jobs = len(eng._admit_jobs)

            def done(out):
                if out is not None or (name == "_admit_dispatch" and behind
                                       and len(eng._admit_jobs) > jobs):
                    counts[name] += 1
            return done
        return hook

    for name in counts:
        strict_dispatch(torch, eng, name, counted(name))
    for name in ("_dev_tick_async", "_dev_spec_tick"):     # fresh ticks too
        strict_dispatch(torch, eng, name)
    reqs = [Request(prompt=p, steps=PIPE_STEPS, temperature=0.0 if i % 2 == 0 else 1.0,
                    top_p=0.9, stop_at_eos=False) for i, p in enumerate(pipe_prompts())]
    ids = {id(r): [] for r in reqs}
    on_emit(eng, lambda slot, token: ids[id(slot.request)].append(token))

    def submit(t0):
        def submit_after(part, firsts):
            """Submit `part` once every request of `firsts` has its first token."""
            while not all(r.first_token_at for r in firsts):
                if time.perf_counter() - t0 > 300:
                    raise SystemExit(f"FAILED serve_pipe: no first token in 300 s {kw}")
                time.sleep(0.001)
            for r in part:
                r.submitted_at = time.time()
                eng.submit(r)

        submit_after(reqs[:1], [])
        submit_after(reqs[1:8], reqs[:1])
        submit_after(reqs[8:], reqs[:8])

    try:
        run = serve_run(torch, eng, reqs, submit, profiled)
    finally:
        eng_mod._PIPELINE_DEPTH = saved
    total = run.pop("total")
    errors = eng.stats()["engine_errors"]
    if errors or any(r.error for r in reqs) or total != 16 * PIPE_STEPS:
        raise SystemExit(f"FAILED serve_pipe: depth {depth} {kw}: engine_errors {errors}, "
                         f"request errors {[r.error for r in reqs]}, {total} tokens of "
                         f"{16 * PIPE_STEPS}")

    def p50(rs):
        t = sorted((r.first_token_at - r.submitted_at) * 1e3 for r in rs)
        return t[len(t) // 2]

    out = dict(ids=[ids[id(r)] for r in reqs], **run, setup_s=t_setup,
               ttft_mid_ms=p50(reqs[1:8]), ttft_second_ms=p50(reqs[8:]),
               chained=counts["_dispatch_chained"], spec_chained=counts["_dispatch_spec_chained"],
               async_admissions=counts["_admit_dispatch"])
    out["breakdown"] = dict(ticks=eng.metrics["decode_ticks"],
                            prefills=eng.phases.counts["prefill"],
                            **phase_seconds(eng, ("dispatch", "fetch", "emit", "admit",
                                                  "prefill")))
    del eng
    gc.collect()
    return out


def phase_serve_pipe(torch, cfg, params, tokenizer, card: str) -> dict:
    """The pipelined loop at Llama-2-7B int8's full width and depth on the
    int8 KV cache at max_len 4096, 8 slots, ticks of 8: three engines
    (plain, n-gram spec_tick 3, the paged int8 pool of PAGED_NUM_PAGES
    pages), each run (pipe_run) at _PIPELINE_DEPTH 1 / 3 / 3 / 1 in turns
    with the profiler off (the first run after an untimed warmup), then at
    3 under the profiler (the depth moves no device work: every run serves
    the same ticks and prefill groups, logged by run, so its kernel time
    is every run's). Per engine: every run must give every
    request the same token ids (greedy and sampled: draws are keyed by slot
    key and position); the depth-3 runs must have chained at least one plain
    tick (plain, paged) or spec tick (spec) and dispatched at least one
    admission behind a tick in flight; no run may count an engine error (a
    sync inside a tick's or an admission's dispatch is one). Logs tok/s, the
    device busy share (profiler kernel time over the profiler-off wall of
    the same depth) and the TTFT p50 of the mid-stream admissions by depth
    (no gate on them). Returns them by engine."""
    from rama_tpu_torch.models.llama import _rope_tables, fuse_params

    # fused once, RoPE to the cache length: every engine serves these as given
    served = fuse_params(dict(params), cfg)
    served["rope_cos"], served["rope_sin"] = _rope_tables(cfg, params["final_norm"].device,
                                                          seq_len=KV8_MAX_LEN)
    summary = {}
    for name, kw in PIPE_ENGINES:
        t0 = time.time()
        runs = [pipe_run(torch, cfg, served, tokenizer, kw, d, warm=i == 0)
                for i, d in enumerate(PIPE_TURNS)]
        profiled = pipe_run(torch, cfg, served, tokenizer, kw, 3, profiled=True)
        differ = [i for i, r in enumerate(runs + [profiled]) if r["ids"] != runs[0]["ids"]]
        if differ:
            raise SystemExit(f"FAILED serve_pipe: {name}: the token ids of runs {differ} "
                             f"(depths {PIPE_TURNS} + profiled 3) differ from the first's")
        deep = [r for r, d in zip(runs, PIPE_TURNS) if d == 3]
        chained = sum(r["spec_chained" if "spec_tick" in kw else "chained"] for r in deep)
        admits = sum(r["async_admissions"] for r in deep)
        if chained < 1 or admits < 1:
            raise SystemExit(f"FAILED serve_pipe: {name}: at depth 3 {chained} chained "
                             f"dispatches, {admits} admissions behind a tick in flight; "
                             f"want >= 1 of each")
        for i, r in enumerate(runs + [profiled]):
            log(f"[serve_pipe] {name} run {i + 1} depth "
                f"{(PIPE_TURNS + (3,))[i]}{' profiled' if i >= len(runs) else ''}: setup "
                f"{r['setup_s']:.3f} s, wall "
                f"{r['wall_s']:.3f} s, {r['tok_s']:.2f} tok/s, {json.dumps(r['breakdown'])}"
                + (f", device kernel time {r['kernel_s']:.3f} s" if "kernel_s" in r else ""))
        by = {}
        for d in (1, 3):
            turns = [r for r, dd in zip(runs, PIPE_TURNS) if dd == d]
            wall = sum(r["wall_s"] for r in turns) / len(turns)
            by[d] = dict(tok_s=[r["tok_s"] for r in turns],
                         busy=profiled["kernel_s"] / wall,
                         ttft_mid_ms=[r["ttft_mid_ms"] for r in turns],
                         ttft_second_ms=[r["ttft_second_ms"] for r in turns],
                         chained=[r["chained"] + r["spec_chained"] for r in turns],
                         async_admissions=[r["async_admissions"] for r in turns])
        summary[name] = by
        log(f"[serve_pipe] {name}: 16 x {PIPE_STEPS} tokens, ids equal in all "
            f"{len(runs) + 1} runs; tok/s depth 1 {by[1]['tok_s']} depth 3 {by[3]['tok_s']} "
            f"(turns {PIPE_TURNS}); device busy share depth 1 {by[1]['busy']:.4f} depth 3 "
            f"{by[3]['busy']:.4f} (kernel time of the profiled run); TTFT p50 of the "
            f"mid-stream admissions (requests 2-8) ms "
            f"depth 1 {by[1]['ttft_mid_ms']} depth 3 {by[3]['ttft_mid_ms']}, of the last 8 "
            f"depth 1 {by[1]['ttft_second_ms']} depth 3 {by[3]['ttft_second_ms']}; chained "
            f"dispatches depth 3 {by[3]['chained']}, admissions behind a tick depth 3 "
            f"{by[3]['async_admissions']}; no sync in a tick or admission dispatch; "
            f"{time.time() - t0:.1f} s ({card})")
    return summary


class PreEncoded:
    """A tokenizer whose encode returns given ids for given texts (and
    delegates everything else): the long prompts' ids are a passage's ids
    repeated, handed to the engine without the pure-Python BPE, which takes
    ~18 s a 3000-token text."""

    def __init__(self, tokenizer, known: dict):
        self._tok, self._known = tokenizer, known

    def encode(self, text, *a, **kw):
        return list(self._known[text]) if text in self._known else self._tok.encode(text, *a, **kw)

    def __getattr__(self, name):
        return getattr(self._tok, name)


CHUNK_PASSAGE = ("Once upon a time, there was a little girl named Lily. She loved to play "
                 "outside in the sunshine with her dog Max. One day they found a big red ball "
                 "in the park and played with it until the sun went down. ")


def repeated_prompts(tokenizer, lengths) -> tuple:
    """(texts, PreEncoded tokenizer) for prompts of the given token counts:
    the passage's ids repeated and cut to each count."""
    ids = tokenizer.encode(CHUNK_PASSAGE, strict=False)
    known = {f"{CHUNK_PASSAGE.strip()} [{n} tokens]": (ids * (n // len(ids) + 1))[:n]
             for n in lengths}
    return tuple(known), PreEncoded(tokenizer, known)


def slot_rows(torch, eng, i: int, plen: int):
    """Slot i's cache rows 0..plen-1 as bf16 (L, nkv, plen, hd) k and v,
    dequantized on an int8 cache, read through its page-table row on a
    pool."""
    c = eng.cache
    quant = hasattr(c, "ks")

    def rows(a):
        if not eng.paged:
            return a[:, i, :, :plen]
        g = a[:, torch.as_tensor(eng.page_tables[i], device=a.device).long()].transpose(1, 2)
        return g.reshape(g.shape[0], g.shape[1], -1, *g.shape[4:])[:, :, :plen]

    k, v = rows(c.k), rows(c.v)
    if quant:
        k, v = k.float() * rows(c.ks)[..., None], v.float() * rows(c.vs)[..., None]
    # a copy, never a view of the live cache (later ticks write the slot)
    return k.to(torch.bfloat16, copy=True), v.to(torch.bfloat16, copy=True)


FINISH_WRITERS = ("write_kv_strips_q8", "write_kv_prefill_paged_q8")   # K8, K13 (b)


def check_chunk_launches(before: dict, after: dict, k5: int) -> None:
    """A chunk's quant_matmul launches (counts by body before and after it)
    all on the tensor-core bodies, at least one, and no K5 launch."""
    body = {k: after[k] - n for k, n in before.items()}
    if body["gemv"] or body["simt"] or not (body["mma"] + body["mmv"]) or k5:
        raise SystemExit(f"FAILED serve_chunk: a chunk's quant_matmul launches by body "
                         f"{body}, K5 launches {k5}: every chunk product on the tensor-core "
                         f"bodies, no K5 launch")


def check_finish_launches(got: dict, writer: str | None, kw: dict) -> None:
    """A finisher's strip-writer launches: one of `writer` (K8 on an int8
    cache, K13 (b) on an int8 pool), none of the other, none on bf16."""
    want = {k: int(k == writer) for k in FINISH_WRITERS}
    if got != want:
        raise SystemExit(f"FAILED serve_chunk: a finisher launched {got}, want {want} ({kw})")


def chunk_run(torch, cfg, params, tokenizer, kw: dict, chunked: bool, modules,
              profiled: bool = False) -> dict:
    """One serve_chunk run: an in-process Engine (CHUNK_SERVE plus `kw`, with
    CHUNK_MODE when `chunked`) serves the six short requests, then on their
    first tokens the two long prompts. Every tick, admission, chunk and
    finisher dispatch runs under torch.cuda.set_sync_debug_mode("error")
    (a sync raises inside the loop, which counts an engine error). Checks,
    as they happen: every chunk's quant_matmul launches on the tensor-core
    bodies and none of K5; each finisher one K8 (int8 cache) or K13 (b)
    (int8 pool) launch, none on a bf16 cache. Returns the ids by request,
    each long prompt's first-token logits (the job's `last`, or the direct
    prefill's) and its slot's rows at its first token, the wall, tok/s,
    the long prompts' TTFT, the largest emission gap of a short stream
    while a long prompt admits, chunks / jobs / chunks behind a tick, the
    engine's phase seconds, and with `profiled` the device kernel seconds."""
    from rama_tpu_torch.config import EngineConfig
    from rama_tpu_torch.runtime.engine import Engine, Request

    qm, _, _, pa, kvw, _, _ = modules
    texts, tok = repeated_prompts(tokenizer, CHUNK_LONG)
    eng = Engine(cfg, params, tok, EngineConfig(**CHUNK_SERVE, **kw,
                                                **(CHUNK_MODE if chunked else {})))
    counts = dict(chunks=0, behind=0, jobs=0)
    lasts, rows = {}, {}
    writer = ("write_kv_prefill_paged_q8" if eng.paged else
              "write_kv_strips_q8" if eng.kv_quant else None)

    def timed(name, check=None):
        def hook(*a):
            before = (dict(qm.launches_by_body), pa.launches, dict(kvw.launches))
            behind = bool(eng._inflight_q or eng._spec_inflight_q)
            if name == "_dev_pf_finish":
                job = a[0]
                for j, e in enumerate(job["entries"]):
                    lasts[len(e[3]) - 1] = job["last"][j].clone()
            t0 = time.perf_counter()

            def done(out):
                timeline.append((name, t0, time.perf_counter()))
                if check:
                    check(before, behind)
            return done
        return hook

    timeline = []       # (method, host start, host end) of each dispatch and tick fetch
    process = eng._process_inflight

    def timed_process(inf):
        t0 = time.perf_counter()
        process(inf)
        timeline.append(("_process_inflight", t0, time.perf_counter()))

    eng._process_inflight = timed_process

    on_card = eng.device.type == "cuda"   # a CPU tensor's plain version counts no launch

    def chunk_check(before, behind):
        if on_card:
            check_chunk_launches(before[0], qm.launches_by_body, pa.launches - before[1])
        counts["chunks"] += 1
        counts["behind"] += behind

    def finish_check(before, behind):
        if on_card:
            check_finish_launches({k: kvw.launches[k] - before[2][k] for k in FINISH_WRITERS},
                                  writer, kw)
        counts["jobs"] += 1

    for name, check in (("_dev_tick_async", None), ("_admit_dispatch", None),
                        ("_dev_pf_chunk", chunk_check), ("_dev_pf_finish", finish_check)):
        strict_dispatch(torch, eng, name, timed(name, check))
    scratch = eng._prefill_scratch

    def direct_last(params_, cfg_, tokens, lens):
        """A direct prefill: each long prompt's row of its last logits."""
        last, sc = scratch(params_, cfg_, tokens, lens)
        for j, n in enumerate(pads[-1]):
            if n - 1 in CHUNK_LONG:
                lasts[int(n) - 1] = last[j, 0].clone()
        return last, sc

    eng._prefill_scratch = direct_last
    pad_entries, pads = eng._pad_entries, []

    def padded(entries):
        out = pad_entries(entries)
        pads.append(out[1])                       # the group's true lengths, on the host
        return out

    eng._pad_entries = padded
    reqs = [Request(prompt=p, steps=CHUNK_SHORT_STEPS, temperature=0.0 if i % 2 == 0 else 1.0,
                    top_p=0.9, stop_at_eos=False) for i, p in enumerate(CHUNK_SHORT)]
    longs = [Request(prompt=t, steps=CHUNK_LONG_STEPS, temperature=0.0, stop_at_eos=False)
             for t in texts]
    ids = {id(r): [] for r in reqs + longs}
    times = {id(r): [] for r in reqs}
    long_ids = {id(r) for r in longs}

    def record(slot, token):
        req = slot.request
        if id(req) in long_ids and not ids[id(req)]:
            n = len(req.prompt_ids)
            rows[n] = slot_rows(torch, eng, eng.slots.index(slot), n + 1)
        ids[id(req)].append(token)
        if id(req) in times:
            times[id(req)].append(time.perf_counter())

    on_emit(eng, record)
    t_long = None

    def submit(t0):
        nonlocal t_long
        for r in reqs:
            eng.submit(r)
        while not all(r.first_token_at for r in reqs):
            if time.perf_counter() - t0 > 300:
                raise SystemExit(f"FAILED serve_chunk: no first token in 300 s {kw}")
            time.sleep(0.001)
        t_long = time.perf_counter()
        for r in longs:
            r.submitted_at = time.time()
            eng.submit(r)

    run = serve_run(torch, eng, reqs + longs, submit, profiled)
    total = run.pop("total")
    errors = eng.stats()["engine_errors"]
    want = len(reqs) * CHUNK_SHORT_STEPS + len(longs) * CHUNK_LONG_STEPS
    if errors or any(r.error for r in reqs + longs) or total != want or \
            eng.stats()["tokens_generated"] != want:
        raise SystemExit(f"FAILED serve_chunk: {kw} chunked {chunked}: engine_errors {errors}, "
                         f"request errors {[r.error for r in reqs + longs]}, {total} tokens "
                         f"streamed, {eng.stats()['tokens_generated']} counted, of {want}")
    t_done = max(r.first_token_at for r in longs) - time.time() + time.perf_counter()
    gap, a, b = max(((b - a, a, b) for r in reqs for a, b in zip(times[id(r)], times[id(r)][1:])
                     if b > t_long and a < t_done), default=(0.0, 0.0, 0.0))
    # what the host did inside the largest gap: calls and seconds by method
    in_gap = {}
    for name, t0, t1 in timeline:
        if t1 > a and t0 < b:
            n, sec = in_gap.get(name, (0, 0.0))
            in_gap[name] = (n + 1, round(sec + min(t1, b) - max(t0, a), 4))
    out = dict(ids=[ids[id(r)] for r in reqs], lasts=lasts, rows=rows, **run,
               ttft_long_ms=[(r.first_token_at - r.submitted_at) * 1e3 for r in longs],
               max_gap_ms=gap * 1e3, in_gap=in_gap, **counts,
               breakdown=phase_seconds(eng, ("dispatch", "fetch", "emit", "admit", "prefill",
                                             "pf_chunk")))
    if chunked and not counts["jobs"] or set(lasts) != set(CHUNK_LONG):
        raise SystemExit(f"FAILED serve_chunk: {counts['jobs']} jobs, the logits of "
                         f"{sorted(lasts)} long prompts taken ({kw}, chunked {chunked})")
    del eng
    gc.collect()
    return out


def chunk_cost(torch, cfg, params) -> dict:
    """A chunk of 256 at off 0 and at off 2048 of a (1, 4096) job (CUDA
    events over 3 reps after a warm one; device ms by torch.profiler),
    beside its 32 layers' masked attention alone on the same shapes: the
    device share a K10-style kernel over only the rows < off + C could
    take."""
    from rama_tpu_torch.models.llama import KVCache, _attention
    from rama_tpu_torch.runtime.engine import _prefill_chunk_step

    dev = params["final_norm"].device
    g = torch.Generator(device=dev).manual_seed(0)
    t_pad, c = KV8_MAX_LEN, CHUNK_MODE["prefill_chunk"]
    scratch = KVCache.create(cfg, 1, t_pad, device=dev)
    scratch.k.normal_(generator=g)
    scratch.v.normal_(generator=g)
    lens = torch.tensor([CHUNK_LONG[0] + 1], device=dev)
    last = torch.zeros(1, cfg.vocab_size, device=dev)
    out = {}
    for off in (0, t_pad // 2):
        tokens = torch.randint(3, cfg.vocab_size, (1, c), device=dev, generator=g)

        def chunk():
            _prefill_chunk_step(params, cfg, tokens, lens, off, scratch, last)

        chunk_ms = time_ms(torch, chunk, reps=3, warmup=1)
        q = torch.randn(1, c, cfg.n_heads, cfg.head_dim, device=dev, generator=g,
                        dtype=torch.bfloat16)
        pos = off + torch.arange(c, device=dev)[None]
        mask = torch.arange(t_pad, device=dev)[None, None, :] <= pos[:, :, None]

        def attention():
            for l in range(cfg.n_layers):
                _attention(q, scratch.k[l], scratch.v[l], mask)

        attn_ms = time_ms(torch, attention, reps=3, warmup=1)
        chunk_dev, attn_dev = (device_ms_per_call(torch, fn, reps=3) for fn in (chunk, attention))
        out[f"off{off}"] = dict(chunk_ms=chunk_ms, attention_ms=attn_ms,
                                chunk_device_ms=chunk_dev, attention_device_ms=attn_dev,
                                attention_device_share=attn_dev / chunk_dev)
    del scratch
    return out


def phase_serve_chunk(torch, cfg, params, tokenizer, card: str, modules) -> dict:
    """Chunked prefill at Llama-2-7B int8's full width and depth on three
    engines (CHUNK_ENGINES), each run (chunk_run) with prefill_chunk 0 and
    256 in ABBA turns (CHUNK_TURNS; the second B and A profiled). Per
    engine: the short streams' ids equal in all four runs; the chunked
    runs' long-prompt logits and slot rows within TOL of the direct runs'
    (the first direct run's); >= 1 chunk behind a tick in flight. Logs
    tok/s, the long prompts' TTFT, the largest short-stream emission gap
    while a long prompt admits, chunks / jobs / behind and the busy share
    by mode (no gate). Returns them by engine."""
    from rama_tpu_torch.models.llama import _rope_tables, fuse_params

    served = fuse_params(dict(params), cfg)
    served["rope_cos"], served["rope_sin"] = _rope_tables(cfg, params["final_norm"].device,
                                                          seq_len=KV8_MAX_LEN)
    summary = {}
    for name, kw in CHUNK_ENGINES:
        t0 = time.time()
        runs, ref = [], None
        for i, chunked in enumerate(CHUNK_TURNS):
            r = chunk_run(torch, cfg, served, tokenizer, kw, chunked, modules, profiled=i >= 2)
            if not chunked and ref is None:
                ref = r
            elif chunked:
                for n in CHUNK_LONG:
                    compare(torch, f"serve_chunk {name}: {n}-token prompt first-token logits "
                            f"(the job's last vs the direct prefill's)", r["lasts"][n][None],
                            ref["lasts"][n][None])
                    for kv, got, want in zip("kv", r["rows"][n], ref["rows"][n]):
                        compare(torch, f"serve_chunk {name}: {n}-token prompt slot {kv} rows "
                                f"after the finisher vs the direct admission's, by (layer, "
                                f"kv head)", got, want, per=got.shape[-2] * got.shape[-1])
            if r is not ref:
                del r["lasts"], r["rows"]
            runs.append(r)
            torch.cuda.empty_cache()
        del ref["lasts"], ref["rows"]
        differ = [i for i, r in enumerate(runs) if r["ids"] != runs[0]["ids"]]
        if differ:
            raise SystemExit(f"FAILED serve_chunk: {name}: the short streams' ids of runs "
                             f"{differ} (chunked {CHUNK_TURNS}) differ from the first's")
        behind = sum(r["behind"] for r, c in zip(runs, CHUNK_TURNS) if c)
        if behind < 1:
            raise SystemExit(f"FAILED serve_chunk: {name}: no non-final chunk was dispatched "
                             f"behind a tick in flight")
        for i, r in enumerate(runs):
            log(f"[serve_chunk] {name} run {i + 1} chunked {CHUNK_TURNS[i]}"
                f"{' profiled' if i >= 2 else ''}: wall {r['wall_s']:.3f} s, "
                f"{r['tok_s']:.2f} tok/s, long TTFT ms {[round(x, 1) for x in r['ttft_long_ms']]}, "
                f"max short-stream gap while a long prompt admits {r['max_gap_ms']:.1f} ms "
                f"(inside it, calls and host s by method: {json.dumps(r['in_gap'])}), "
                f"chunks {r['chunks']} jobs {r['jobs']} behind a tick {r['behind']}, "
                f"{json.dumps(r['breakdown'])}"
                + (f", device kernel time {r['kernel_s']:.3f} s" if "kernel_s" in r else ""))
        by = {}
        for mode in (False, True):
            turns = [r for r, c in zip(runs, CHUNK_TURNS) if c == mode]
            off, prof = turns[0], turns[1]
            by["chunked" if mode else "direct"] = dict(
                tok_s=[r["tok_s"] for r in turns], ttft_long_ms=[r["ttft_long_ms"] for r in turns],
                max_gap_ms=[r["max_gap_ms"] for r in turns], in_gap=[r["in_gap"] for r in turns],
                chunks=[r["chunks"] for r in turns], jobs=[r["jobs"] for r in turns],
                behind=[r["behind"] for r in turns], busy=prof["kernel_s"] / off["wall_s"],
                breakdown=[r["breakdown"] for r in turns])
        summary[name] = by
        log(f"[serve_chunk] {name}: {json.dumps(by)}; short ids equal in all 4 runs, long "
            f"logits and rows within {TOL}; {time.time() - t0:.1f} s ({card})")
    del served
    return summary


def profile_chunk(torch, cfg, params, card: str) -> dict:
    """chunk_cost on the served params (RoPE tabulated to KV8_MAX_LEN), run
    in the chunked path's profile slot: after its launches were read, so
    these direct chunk steps count in no record of the main path."""
    from rama_tpu_torch.models.llama import _rope_tables, fuse_params

    served = fuse_params(dict(params), cfg)
    served["rope_cos"], served["rope_sin"] = _rope_tables(cfg, params["final_norm"].device,
                                                          seq_len=KV8_MAX_LEN)
    out = chunk_cost(torch, cfg, served)
    log(f"[profile_chunk] chunk cost (CUDA events): {json.dumps(out)} ({card})")
    del served
    return out


def phase_chat(torch, cfg, params, tokenizer, card: str) -> dict:
    """Three greedy turns of a ChatSession on the card (bf16 cache of the
    model's context): each turn's last-prefill logits against the plain
    path on a copy of the cache as it was, and the running position after
    each turn against the templates' lengths plus the emitted tokens."""
    import copy

    from rama_tpu_torch.models.llama import KVCache
    from rama_tpu_torch.runtime.chat import ChatSession

    s = ChatSession(params, cfg, tokenizer, temperature=0.0, system=CHAT_SYSTEM)
    prefill, lens = s._prefill_chunk, []

    def checked(ids):
        ref = copy.copy(s)
        ref.cache, ref.plain = KVCache(k=s.cache.k.clone(), v=s.cache.v.clone()), True
        want = ChatSession._prefill_chunk(ref, ids)
        got = prefill(ids)
        compare(torch, f"chat turn {s.turns + 1} ({len(ids)}-token template at pos "
                f"{s.pos - len(ids)}) last-prefill logits (kernels vs plain)", got[None],
                want[None])
        lens.append(len(ids))
        del ref
        return got

    s._prefill_chunk = checked
    out, emitted = [], 0
    for text in CHAT_TURNS:
        t0 = time.perf_counter()
        pieces = list(s.turn(text, max_new=32))
        torch.cuda.synchronize()
        emitted += len(pieces)
        if s.pos != sum(lens) + emitted:
            raise SystemExit(f"FAILED chat: position {s.pos} after turn {s.turns}, want the "
                             f"templates' {sum(lens)} + the emitted {emitted}")
        out.append(dict(template=lens[-1], tokens=len(pieces),
                        seconds=time.perf_counter() - t0, reply="".join(pieces)[:60]))
    log(f"[chat] {json.dumps(out)}; position {s.pos} ({card})")
    return dict(turns=out, pos=s.pos)


def phase_eval(torch, cfg, params, tokenizer, card: str) -> dict:
    """perplexity over EVAL_TOKENS tokens (window 512, batch 4) with the
    kernels and with the plain path: the full logits its first batch scores
    with (each window's rows) within TOL of the plain path's, row by row,
    and the two nll values within EVAL_NLL_GAP (rel)."""
    import rama_tpu_torch.eval as ev

    (text,), tok = repeated_prompts(tokenizer, (EVAL_TOKENS,))
    out, firsts, prefill = {}, {}, ev.prefill

    def kept(name):
        def run(*a, **kw):
            logits, cache = prefill(*a, **kw)
            firsts.setdefault(name, logits)
            return logits, cache
        return run

    for name, plain in (("kernels", False), ("plain", True)):
        ev.prefill = kept(name)
        try:
            t0 = time.perf_counter()
            out[name] = ev.perplexity(params, cfg, tok, text, window=EVAL_WINDOW,
                                      batch=EVAL_BATCH, plain=plain)
            torch.cuda.synchronize()
            out[name]["seconds"] = time.perf_counter() - t0
        finally:
            ev.prefill = prefill
    out["logits_max_abs_err"] = compare(
        torch, f"eval: the first batch's full logits {tuple(firsts['plain'].shape)} "
        f"(kernels vs plain)", firsts["kernels"], firsts["plain"])
    del firsts
    gap = abs(out["kernels"]["nll"] - out["plain"]["nll"]) / abs(out["plain"]["nll"])
    out["nll_rel_gap"] = gap
    log(f"[eval] {json.dumps(out)} ({card})")
    if not math.isfinite(out["kernels"]["perplexity"]) or gap > EVAL_NLL_GAP:
        raise SystemExit(f"FAILED eval: nll {out['kernels']['nll']} with the kernels, "
                         f"{out['plain']['nll']} plain: rel gap {gap:.3e} > {EVAL_NLL_GAP}")
    return out


def step_weight_bytes(params) -> float:
    """Bytes of weights and scales one decode step streams: every layer of
    the quantized matrices and the classifier, each value and scale read
    once (4 bytes a scale stored in f32, 2 in bf16); the embedding, one row
    a token, is left out."""
    return sum(p.q.numel() * p.q.element_size() + p.scales.numel() * p.scales.element_size()
               for name, p in params.items()
               if name != "tok_embedding" and hasattr(p, "scales"))


def phase_profile(torch, cfg, params, tag: str = "profile", cache=None,
                  start: int = 64, chunk: int = 1, tables=None, slots: int = 8) -> dict:
    """torch.profiler over 8 decode steps at `slots` slots (8 by default;
    positions start .. start+7; by default on a 128-row bf16 cache; a page
    pool through `tables`) — or, with chunk > 1, 8 verify rounds of `chunk` consecutive
    tokens a slot through forward_chunk (positions start .. start + 8 chunk
    - 1): host wall per step with and without the profiler, device kernel
    time per step by kernel, device busy share (against the wall with the
    profiler off, which no profiler setting moves), K3's and K1's device time and share of it, the attention's
    device time (split kernel and combine), and the step's weight and
    scale bytes with their byte bound (step_weight_bytes). Returns
    device_ms, host_ms (profiler off), host_ms_profiled, busy (the device
    busy share), k3_ms, k1_ms, attn_ms and attn_split_ms per step, k3_share,
    k1_share and weight_gb. The profiler records the device's events alone
    (host operators cost 10-20 s a profile at 7B to 88 layers and inflated
    the profiled wall)."""
    from torch.profiler import ProfilerActivity, profile

    from rama_tpu_torch.models.llama import KVCache, decode_step, forward_chunk
    from rama_tpu_torch.runtime.paged import decode_step_paged

    dev = torch.device("cuda")
    if cache is None:
        cache = KVCache.create(cfg, slots, 128, device=dev)
    tok = (torch.arange(slots * chunk, device=dev) + 100).view(slots, chunk)

    def step(tok, p):
        pos = torch.full((slots,), p, device=dev)
        if tables is not None:
            logits, _ = decode_step_paged(params, cfg, tok[:, 0], pos, cache, tables)
        elif chunk == 1:
            logits, _ = decode_step(params, cfg, tok[:, 0], pos, cache)
        else:
            logits, _ = forward_chunk(params, cfg, tok, pos, cache)
        return torch.argmax(logits, dim=-1).view(slots, chunk)

    with torch.no_grad():
        for i in range(2):  # warm
            step(tok, start - 2 * chunk + i * chunk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(8):  # the same steps without the profiler's overhead
            step(tok, start + i * chunk)
        torch.cuda.synchronize()
        wall_off = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(8):
                tok = step(tok, start + i * chunk)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if dt and ev.device_type.name == "CUDA":
            rows.append((dt, ev.key, ev.count))
    busy_us = sum(r[0] for r in rows)
    # K3: both phases of the tensor-core body, or the SIMT w13 kernel (whose
    # w2 GEMV shares qmv_kernel with K1 and is not counted here)
    k3_us = sum(r[0] for r in rows if "ffn_mma" in r[1] or "ffn_w13" in r[1])
    # K1 / K2: every quant_matmul body (the swap-AB body at M <= 32, the
    # GEMM above, the fp32 bodies; K14 mode 2's fused wo is attn_block's)
    k1_us = sum(r[0] for r in rows if any(b in r[1] for b in K1_KERNELS))
    # the decode / chunk attention: its split kernel (either body) and combine
    attn_us = sum(r[0] for r in rows if "dattn_" in r[1])
    split_us = sum(r[0] for r in rows if any(k in r[1] for k in ATTN_SPLIT_KERNELS))
    # K14's split and combine kernels (its mode-2 wo is K1's)
    ab_split_us = sum(r[0] for r in rows if "ab_split_kernel" in r[1])
    ab_comb_us = sum(r[0] for r in rows if "ab_combine_kernel" in r[1])
    what = "decode steps" if chunk == 1 else f"verify rounds of {chunk}"
    wbytes = step_weight_bytes(params)
    log(f"[{tag}] weights and scales a step {wbytes / 1e9:.3f} GB: byte bound "
        f"{wbytes / HBM_BYTES_PER_S * 1e3:.3f} ms")
    log(f"[{tag}] {type(cache).__name__} {slots} slots x 8 {what} at pos {start}.."
        f"{start + 8 * chunk - 1}: host wall "
        f"{wall / 8 * 1e3:.3f} ms/step (profiler on, device events only), "
        f"{wall_off / 8 * 1e3:.3f} ms/step "
        f"(profiler off); device kernel time {busy_us / 8 / 1e3:.3f} ms/step; "
        f"device busy share {busy_us / 1e6 / wall_off:.3f} (of the wall with the profiler "
        f"off); K3 (ffn) {k3_us / 8 / 1e3:.3f} "
        f"ms/step = {k3_us / max(busy_us, 1e-9):.4f} of the device time; K1 (quant_matmul) "
        f"{k1_us / 8 / 1e3:.3f} ms/step = {k1_us / max(busy_us, 1e-9):.4f}; attention "
        f"{attn_us / 8 / 1e3:.4f} ms/step (split {split_us / 8 / 1e3:.4f}); K14 split "
        f"{ab_split_us / 8 / 1e3:.4f} combine {ab_comb_us / 8 / 1e3:.4f} ms/step")
    ranked = sorted(rows, reverse=True)
    for dt, key, count in ranked[:12] + [r for r in ranked[12:] if "rama::" in r[1]]:
        log(f"[{tag}]   {dt / 8 / 1e3:.4f} ms/step  x{count // 8:<4d} {key[:90]}")
    if not rows:
        log(f"[{tag}] the profiler recorded no device time")
    return dict(device_ms=busy_us / 8 / 1e3, host_ms=wall_off / 8 * 1e3,
                host_ms_profiled=wall / 8 * 1e3, busy=busy_us / 1e6 / wall_off,
                k3_ms=k3_us / 8 / 1e3, k3_share=k3_us / max(busy_us, 1e-9),
                k1_ms=k1_us / 8 / 1e3, k1_share=k1_us / max(busy_us, 1e-9),
                attn_ms=attn_us / 8 / 1e3, attn_split_ms=split_us / 8 / 1e3,
                ab_split_ms=ab_split_us / 8 / 1e3, ab_combine_ms=ab_comb_us / 8 / 1e3,
                weight_gb=wbytes / 1e9)


def profile_prefill(torch, cfg, params, label: str = "7B int8") -> dict:
    """One admission of 8 prompts of 512 tokens through llama.prefill on a
    bf16 cache of 1024 rows (the `label` model's, 7B by default):
    torch.profiler's device ms by kernel over one admission, with K5's
    share and the tensor-core GEMM's (its weight
    products at M = 4096: wqkv, wo, w13, w2 of every layer) and TFLOP/s,
    then the device ms of a second one (CUDA events). Returns device_ms,
    profiled_device_ms, k5_ms, k5_share, gemm_ms, gemm_share and
    gemm_tflops."""
    from torch.profiler import ProfilerActivity, profile

    from rama_tpu_torch.models.llama import KVCache, prefill

    dev = torch.device("cuda")
    cache = KVCache.create(cfg, 8, 1024, device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(3, cfg.vocab_size, (8, 512), device=dev, generator=g)
    with torch.no_grad():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prefill(params, cfg, tokens, cache, last_only=True)
            torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, _ = prefill(params, cfg, tokens, cache, last_only=True)
        end.record()
        end.synchronize()
    if logits.shape != (8, 1, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"FAILED profile_prefill: logits {tuple(logits.shape)}, finite "
                         f"{bool(torch.isfinite(logits).all())}")
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if dt and ev.device_type.name == "CUDA":
            rows.append((dt, ev.key, ev.count))
    if not rows:
        raise SystemExit("FAILED profile_prefill: the profiler recorded no device time")
    busy_ms = sum(r[0] for r in rows) / 1e3
    k5_ms = sum(dt for dt, key, _ in rows if "pattn" in key) / 1e3
    gemm_ms = sum(dt for dt, key, _ in rows if "qmm_mma" in key) / 1e3
    gemm_flops = prefill_gemm_flops(cfg, tokens.numel())
    ms = start.elapsed_time(end)
    log(f"[profile_prefill] {label} admission of 8 x 512 tokens (bf16 cache of 1024 rows): "
        f"{ms:.3f} ms (CUDA events); profiled admission {busy_ms:.3f} ms of device kernel "
        f"time, K5 {k5_ms:.3f} ms = {k5_ms / busy_ms:.4f} of it, the tensor-core GEMM "
        f"{gemm_ms:.3f} ms = {gemm_ms / busy_ms:.4f} of it "
        f"({gemm_flops / 1e12:.2f} TFLOP at {gemm_flops / max(gemm_ms, 1e-9) / 1e9:.1f} TFLOP/s)")
    for dt, key, count in sorted(rows, reverse=True)[:12]:
        log(f"[profile_prefill]   {dt / 1e3:.4f} ms  x{count:<5d} {key[:90]}")
    if gemm_ms == 0:
        raise SystemExit("FAILED profile_prefill: no qmm_mma kernel in the admission's trace")
    return dict(device_ms=ms, profiled_device_ms=busy_ms, k5_ms=k5_ms,
                k5_share=k5_ms / busy_ms, gemm_ms=gemm_ms, gemm_share=gemm_ms / busy_ms,
                gemm_tflops=gemm_flops / gemm_ms / 1e9)


def prefill_gemm_flops(cfg, rows: int) -> float:
    """Operations of a prefill's layer weight products over `rows` tokens:
    2 x rows x (wqkv + wo + w13 + w2 weights) per layer."""
    per_layer = cfg.dim * ((cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim + cfg.dim
                           + 3 * cfg.hidden_dim)
    return 2.0 * rows * per_layer * cfg.n_layers


def profile_paged(torch, cfg, params) -> None:
    """Device ms per 8-slot decode step on a bf16 and an int8 page pool
    (8 x 32 pages of PAGE_SIZE rows under shuffled tables: the rows of an
    8-slot dense cache at max_len 4096) at positions 64 and 2048, beside
    the dense cache's step in the same run (RoPE tabulated to 4096), each
    with the attention's device ms (split kernel and combine) a step."""
    from rama_tpu_torch.models.llama import KVCache, QuantKVCache, _rope_tables
    from rama_tpu_torch.runtime.paged import PagedKVCache, QuantPagedKVCache

    dev = torch.device("cuda")
    long = dict(params)
    long["rope_cos"], long["rope_sin"] = _rope_tables(cfg, dev, seq_len=KV8_MAX_LEN)
    mp = KV8_MAX_LEN // PAGE_SIZE
    tables = torch.randperm(8 * mp, generator=torch.Generator().manual_seed(4))
    tables = tables.view(8, mp).to(torch.int32).to(dev)
    table = {}
    for dense_cls, pool_cls in ((KVCache, PagedKVCache), (QuantKVCache, QuantPagedKVCache)):
        for label, make, tb in (
                ("dense", lambda: dense_cls.create(cfg, 8, KV8_MAX_LEN, device=dev), None),
                ("paged", lambda: pool_cls.create(cfg, 8 * mp + 1, PAGE_SIZE, device=dev),
                 tables)):
            cache = make()
            for start in (64, 2048):
                r = phase_profile(torch, cfg, long, tag="profile_paged", cache=cache,
                                  start=start, tables=tb)
                table[f"{pool_cls.__name__} {label} pos {start}"] = {
                    k: r[k] for k in ("device_ms", "attn_ms", "attn_split_ms")}
            del cache
            torch.cuda.empty_cache()
    log(f"[profile_paged] device ms per 8-slot decode step (attention; its split kernel): "
        f"{json.dumps(table)}")


def phase_model_attn(torch, cfg, params, bits: int, dev=None) -> None:
    """7B decode-step logits through the fused attention block (kernel 14,
    modes 1 and 2) against the plain path under the same mode and against
    the plain unfused path (mode 0), at 8 slots on a 1024-row bf16 cache
    filled past the prompt with copies of its rows, positions up to S - 1
    and one past the cache (clamped); with the int8 params also the generic
    layer at T = 1 (kernel 9): a one-token prefill a slot and forward with
    logit_rows, kernels against plain, on a bf16 and an int8 cache."""
    from rama_tpu_torch.models import llama
    from rama_tpu_torch.models.llama import (KVCache, QuantKVCache, decode_step, forward,
                                             prefill)
    from rama_tpu_torch.ops.kernels import attn_block as ab

    dev = dev or torch.device("cuda")
    b, s = 8, cfg.seq_len
    toks = (torch.arange(b * 8, device=dev).view(b, 8) * 389 + 11) % cfg.vocab_size
    base = KVCache.create(cfg, b, s, device=dev)
    saved = llama.ATTN_BLOCK
    with torch.no_grad():
        llama.ATTN_BLOCK = 0
        prefill(params, cfg, toks, base, plain=True)
        for t in (base.k, base.v):            # rows 8 .. S-1: copies of rows 0 .. 7
            t[:, :, :, 8:] = t[:, :, :, :8].repeat(1, 1, 1, (s - 8) // 8, 1)
        tok = toks[:, 0]
        pos = torch.tensor([8, 9, 63, 64, 500, 1000, s - 1, s + 3], device=dev)

        def run(mode, plain):
            llama.ATTN_BLOCK = mode
            cache = KVCache(k=base.k.clone(), v=base.v.clone())
            logits, _ = decode_step(params, cfg, tok, pos, cache, plain=plain)
            del cache
            return logits

        try:
            ref = run(0, True)
            body = ab.body_for(params["attn_norm"].dtype)   # the activations' dtype
            for mode in (1, 2):
                name = "attn_block_layered" if mode == 2 else "attn_rope_write_layered"
                name += "_int4" if mode == 2 and bits == 4 else ""
                before, on_body_before = ab.launches[name], ab.launches_by_body[body]
                got = run(mode, False)
                n = (ab.launches[name] - before, ab.launches_by_body[body] - on_body_before)
                if n != (cfg.n_layers, cfg.n_layers):
                    raise SystemExit(f"FAILED model_attn: {name} launched {n[0]} times in a "
                                     f"decode step, {n[1]} on the {body} body")
                compare(torch, f"7B int{bits} logits decode step, attention block {mode} "
                        f"pos={pos.tolist()} (kernels vs plain)", got, run(mode, True))
                compare(torch, f"7B int{bits} logits decode step, attention block {mode} "
                        f"(kernels vs the unfused plain path)", got, ref)
        finally:
            llama.ATTN_BLOCK = saved
        del base
        torch.cuda.empty_cache()
        if bits != 8:
            return
        for cache_cls in (KVCache, QuantKVCache):
            caches = [cache_cls.create(cfg, b, s, device=dev) for _ in range(2)]
            label = f"7B int8 {cache_cls.__name__}"
            outs = [prefill(params, cfg, toks[:, :1], c, last_only=True, plain=plain)[0]
                    for c, plain in zip(caches, (False, True))]
            compare(torch, f"{label} logits one-token prefill (kernels vs plain)", *outs)
            rows = torch.zeros(b, dtype=torch.long, device=dev)
            p1 = torch.ones((b, 1), dtype=torch.long, device=dev)
            outs = [forward(params, cfg, toks[:, 1:2], p1, c, logit_rows=rows, plain=plain)[0]
                    for c, plain in zip(caches, (False, True))]
            compare(torch, f"{label} logits forward(logit_rows) T=1 at pos 1 (kernels vs "
                    f"plain)", *outs)
            del caches
            torch.cuda.empty_cache()


def phase_prefill_t1(torch, cfg, params, dev=None) -> None:
    """The generic layer at T = 1 through the library entry points: prefill
    of a one-token prompt a slot and forward with logit_rows at T = 1, at 8
    slots on a bf16 and an int8 cache of 1024 rows, with the plain T = 1
    attention (the masked einsum, the whole-layer dequantization) made to
    raise: kernel 9 must launch once a layer of every call."""
    from rama_tpu_torch.models import llama
    from rama_tpu_torch.models.llama import KVCache, QuantKVCache, forward, prefill
    from rama_tpu_torch.ops.kernels import decode_attention as da

    dev = dev or torch.device("cuda")
    b = 8
    toks = (torch.arange(b * 2, device=dev).view(b, 2) * 577 + 3) % cfg.vocab_size

    def boom(*a, **k):
        raise SystemExit("FAILED prefill_t1: a T = 1 call reached the plain attention path")

    saved = llama._attention, llama._dequant_kv
    llama._attention = llama._dequant_kv = boom
    try:
        with torch.no_grad():
            for cache_cls, counter in ((KVCache, "launches_flat"),
                                       (QuantKVCache, "launches_flat_q8")):
                cache = cache_cls.create(cfg, b, cfg.seq_len, device=dev)
                calls = (
                    lambda: prefill(params, cfg, toks[:, :1], cache, last_only=True)[0],
                    lambda: forward(params, cfg, toks[:, 1:], torch.ones((b, 1), device=dev),
                                    cache, logit_rows=torch.zeros(b, device=dev))[0])
                for what, fn in zip(("one-token prefill", "forward(logit_rows) T=1"), calls):
                    before = getattr(da, counter)
                    logits = fn()
                    n = getattr(da, counter) - before
                    if n != cfg.n_layers or logits.shape != (b, 1, cfg.vocab_size) or not bool(
                            torch.isfinite(logits).all()):
                        raise SystemExit(f"FAILED prefill_t1 {cache_cls.__name__} {what}: "
                                         f"{n} launches of kernel 9, logits "
                                         f"{tuple(logits.shape)}")
                    log(f"[prefill_t1] {cache_cls.__name__} {what}: kernel 9 launched {n} "
                        f"times, logits finite {tuple(logits.shape)}")
                del cache
    finally:
        llama._attention, llama._dequant_kv = saved
    torch.cuda.empty_cache()


def profile_ab(torch, cfg, params) -> dict:
    """Device ms, host ms and the device busy share per 8-slot decode step
    under RAMA_ATTN_BLOCK 0, 1 and 2, at positions 64 and 2048 of a
    4096-row bf16 cache (RoPE tabulated to 4096), in one run."""
    from rama_tpu_torch.models import llama
    from rama_tpu_torch.models.llama import KVCache, _rope_tables

    dev = torch.device("cuda")
    long = dict(params)
    long["rope_cos"], long["rope_sin"] = _rope_tables(cfg, dev, seq_len=KV8_MAX_LEN)
    cache = KVCache.create(cfg, 8, KV8_MAX_LEN, device=dev)
    table = {}
    saved = llama.ATTN_BLOCK
    try:
        for mode in (0, 1, 2):
            llama.ATTN_BLOCK = mode
            for start in (64, 2048):
                table[f"mode {mode} pos {start}"] = phase_profile(
                    torch, cfg, long, tag=f"profile_ab mode {mode}", cache=cache, start=start)
    finally:
        llama.ATTN_BLOCK = saved
    del cache
    torch.cuda.empty_cache()
    log(f"[profile_ab] per 8-slot decode step: {json.dumps(table)}")
    return table


def phase_cli(torch) -> None:
    """The CLI on a synthetic stories15M-shaped checkpoint: a v2 file (int8
    as stored), a v0 file quantized to int4 at load, and the v2 file with
    its scales stored in bf16 (--scale-dtype bf16), the v2 file through
    `generate -o chat` (two user lines, then exit: two replies) and `eval`
    (one JSON line, a finite perplexity); then a v2 file of
    TinyLlama-1.1B's width cut to 2 layers (tied classifier: a 22-layer v0
    file would be 4.4 GB of fp32) through `generate --spec ngram` at the
    CLI's default --spec-k 8 (64 query rows a kv head)."""
    from rama_tpu_torch.checkpoint import save_v0, save_v2
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
        v2, v0 = os.path.join(d, "synthetic_v2.bin"), os.path.join(d, "synthetic_v0.bin")
        save_v2(v2, cfg, p, group_size=64)
        save_v0(v0, cfg, p)
        for path, flags in ((v2, ["--quant", "auto"]), (v0, ["--quant", "int4"]),
                            (v2, ["--quant", "auto", "--scale-dtype", "bf16"])):
            cmd = [sys.executable, "-m", "rama_tpu_torch.cli", "generate", "-m", path,
                   "-t", str(ROOT / "tests" / "fixtures" / "tokenizer.bin"), "-p",
                   "Once upon a time", "-s", "32", "-r", "0", *flags, "--device", "cuda"]
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT)
            log(f"[cli] {' '.join(flags)} rc {out.returncode}; stderr tail: "
                f"{out.stderr.strip()[-300:]}")
            if out.returncode != 0:
                raise SystemExit(f"FAILED cli {' '.join(flags)}: {out.stderr[-2000:]}")
        tok = str(ROOT / "tests" / "fixtures" / "tokenizer.bin")
        # the chat loop on stdin: two user lines, then exit
        out = subprocess.run([sys.executable, "-m", "rama_tpu_torch.cli", "generate", "-m", v2,
                              "-t", tok, "-o", "chat", "-p", "You are terse.", "-s", "16", "-r",
                              "0", "--device", "cuda"],
                             input="Hello there\nTell me a story\nexit\n", capture_output=True,
                             text=True, timeout=300, cwd=ROOT)
        replies = out.stdout.count("Assistant: ")
        log(f"[cli] -o chat rc {out.returncode}, {replies} replies; stdout tail: "
            f"{out.stdout.strip()[-300:]!r}")
        if out.returncode != 0 or replies != 2:
            raise SystemExit(f"FAILED cli -o chat: rc {out.returncode}, {replies} replies: "
                             f"{out.stdout[-1000:]} {out.stderr[-2000:]}")
        # eval on a text file (the default --dtype float32)
        text = os.path.join(d, "text.txt")
        with open(text, "w") as f:
            f.write("Once upon a time, there was a little girl named Lily. She loved to play "
                    "outside in the sunshine. One day she saw a big red ball in the park. " * 4)
        out = subprocess.run([sys.executable, "-m", "rama_tpu_torch.cli", "eval", "-m", v2, "-t",
                              tok, "--text", text, "--window", "64", "--batch", "2",
                              "--device", "cuda"],
                             capture_output=True, text=True, timeout=300, cwd=ROOT)
        lines = out.stdout.strip().splitlines()
        got = json.loads(lines[0]) if out.returncode == 0 and len(lines) == 1 else {}
        log(f"[cli] eval rc {out.returncode}: {out.stdout.strip()[-300:]}")
        if not math.isfinite(got.get("perplexity", math.nan)):
            raise SystemExit(f"FAILED cli eval: rc {out.returncode}, stdout {out.stdout[-1000:]} "
                             f"{out.stderr[-2000:]}")

    tcfg = tinyllama_config(ModelConfig, n_layers=2).replace(shared_classifier=True)
    L, D, H, KV = tcfg.n_layers, tcfg.dim, tcfg.hidden_dim, tcfg.kv_dim

    def wt(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    p = {"tok_embedding": wt(tcfg.vocab_size, D), "attn_norm": np.ones((L, D), np.float32),
         "wq": wt(L, D, D), "wk": wt(L, D, KV), "wv": wt(L, D, KV), "wo": wt(L, D, D),
         "ffn_norm": np.ones((L, D), np.float32), "w1": wt(L, D, H), "w2": wt(L, H, D),
         "w3": wt(L, D, H), "final_norm": np.ones(D, np.float32)}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tinyllama_width_2_layers_v2.bin")
        t0 = time.time()
        save_v2(path, tcfg, p, group_size=64)
        del p
        cmd = [sys.executable, "-m", "rama_tpu_torch.cli", "generate", "-m", path,
               "-t", str(ROOT / "tests" / "fixtures" / "tokenizer.bin"), "-p",
               "Once upon a time", "-s", "32", "-r", "0", "--quant", "auto", "--spec", "ngram",
               "--device", "cuda"]
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT)
        log(f"[cli] TinyLlama width, 2 layers, --spec ngram (file written in "
            f"{time.time() - t0:.1f} s with the run) rc {out.returncode}; stderr tail: "
            f"{out.stderr.strip()[-300:]}")
        if out.returncode != 0 or "[spec] rounds=" not in out.stderr:
            raise SystemExit(f"FAILED cli TinyLlama --spec ngram: {out.stderr[-2000:]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    ap.add_argument("--warmup-child", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.warmup_child:   # serve_warmup's fresh process
        return warmup_child(args.warmup_child)
    phases = args.phases.split(",")
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; the phases are {','.join(ALL_PHASES)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models import llama
    from rama_tpu_torch.models.llama import KVCache, QuantKVCache, _rope_tables
    from rama_tpu_torch.ops.kernels import attn_block as ab
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import ffn as ffn_mod
    from rama_tpu_torch.ops.kernels import kv_write as kvw
    from rama_tpu_torch.ops.kernels import paged_attention as pga
    from rama_tpu_torch.ops.kernels import prefill_attention as pa
    from rama_tpu_torch.ops.kernels import quant_matmul as qm
    from rama_tpu_torch.ops.quant import cast_scales
    from rama_tpu_torch.tokenizer import Tokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    card = nvidia_smi_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}: "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    if "build" in phases:
        with clock("build"):
            phase_build()
    results: dict = {}
    for name, phase in (("kernels", phase_kernels), ("kernels4", phase_kernels_int4),
                        ("kernels_kv8", phase_kernels_kv8), ("kernels_spec", phase_kernels_spec),
                        ("kernels_paged", phase_kernels_paged),
                        ("kernels_attn", phase_kernels_attn), ("kernels_s16", phase_kernels_s16),
                        ("kernels_gqa", phase_kernels_gqa)):
        if name in phases:
            with clock(name):
                phase(torch, results)
            torch.cuda.empty_cache()
    modules = (qm, ffn_mod, da, pa, kvw, pga, ab)
    fixture = ROOT / "tests" / "fixtures" / "tokenizer.bin"
    tokenizer = Tokenizer.from_file(fixture, 32000)
    models = {"7b": ("Llama-2-7B", seven_b_config(ModelConfig)),
              "tinyllama": ("TinyLlama-1.1B", tinyllama_config(ModelConfig)),
              "yi": ("Yi-34B", yi34b_config(ModelConfig)),
              "ml": ("Mistral-Large-Instruct-2407", mistral_large_config(ModelConfig))}
    # Yi-34B's 64000 ids, Mistral-Large's 32768: the fixture's pieces and
    # made-up ones past them
    tmp = tempfile.TemporaryDirectory()
    tokenizers = {key: Tokenizer.from_file(write_wide_tokenizer(
        fixture, Path(tmp.name) / f"tokenizer{n}.bin", n), n)
        for key, n in (("yi", 64000), ("ml", 32768))}
    dev = torch.device("cuda")
    params, params_key = None, None
    serving: dict = {}
    profiles: dict = {}
    for path in PATHS:
        if not (set(path["phases"]) | set(path.get("after", ()))) & set(phases):
            continue
        bits, label = path["bits"], path["label"]
        model_name, cfg = models[path.get("model", "7b")]
        path_tokenizer = tokenizers.get(path.get("model"), tokenizer)
        llama.ATTN_BLOCK = path.get("attn_block", 0)   # as RAMA_ATTN_BLOCK sets it at import
        if params_key != (model_name, bits):   # the int8 KV and spec paths reuse the int8 params
            if params_key:
                log(f"[memory] {params_key[0]} int{params_key[1]} paths: peak "
                    f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
            # free the last model, its caches and scratch before the next is made
            params = None
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            log(f"[memory] before the {model_name} int{bits} params: "
                f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
            t0 = time.time()
            with clock(f"params {model_name} int{bits}"):
                params, params_key = random_params(torch, cfg, dev, bits=bits), (model_name, bits)
                torch.cuda.synchronize()
            log(f"[model] {model_name} int{bits} params on the card in {time.time() - t0:.1f} "
                f"s, {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        model, *main_path, profile = path["phases"]
        long_models = {"model_kv8": phase_model_kv8, "model_spec": phase_model_spec,
                       "model_paged": phase_model_paged}
        with clock(model if model in phases else f"{label}: no model check"):
            if model in long_models and model in phases:
                # RoPE to the 4096-row cache, as the engine retabulates it
                long = dict(params)
                long["rope_cos"], long["rope_sin"] = _rope_tables(cfg, dev, seq_len=KV8_MAX_LEN)
                long_models[model](torch, cfg, long)
                del long
            elif model == "model_attn" and model in phases:
                phase_model_attn(torch, cfg, params, bits)
            elif model == "model_gqa" and model in phases:
                phase_model_gqa(torch, cfg, params)
            elif model == "model_yi" and model in phases:
                phase_model_yi(torch, cfg, params)
            elif model == "model_ml" and model in phases:
                phase_model_ml(torch, cfg, params, path_tokenizer)
            elif model == "model_b64" and model in phases:
                phase_model_b64(torch, cfg, params)
            elif model == "model4_s16" and model in phases:
                phase_model(torch, cfg, cast_scales(params), f"int{bits} bf16-scale")
            elif model in phases:
                phase_model(torch, cfg, params, f"int{bits}")
        reset_launches(*modules)
        launches = None
        for ph in (p for p in main_path if p in phases):
            with clock(ph):
                if ph == "serve_warmup":   # counted in its own process
                    serving[ph] = phase_serve_warmup(torch, card, serving)
                    launches = serving[ph].pop("launches")
                elif ph == "generate":
                    phase_generate(torch, cfg, params, tokenizer)
                elif ph == "prefill_t1":
                    phase_prefill_t1(torch, cfg, params)
                elif ph == "serve_pipe":
                    serving[ph] = phase_serve_pipe(torch, cfg, params, tokenizer, card)
                elif ph == "serve_chunk":
                    serving[ph] = phase_serve_chunk(torch, cfg, params, tokenizer, card, modules)
                elif ph == "chat":
                    serving[ph] = phase_chat(torch, cfg, params, tokenizer, card)
                elif ph == "eval":
                    serving[ph] = phase_eval(torch, cfg, params, tokenizer, card)
                elif ph == "spec_draft":
                    phase_spec_draft(torch, cfg, params, tokenizer,
                                     start_count=lambda: reset_launches(*modules))
                elif ph == "spec_gqa_self":
                    phase_spec_gqa_self(torch, cfg, params, tokenizer,
                                        start_count=lambda: reset_launches(*modules))
                else:
                    serving[ph] = phase_serve(torch, cfg, params, path_tokenizer, card, tag=ph,
                                              **path["serve"])
        for spec_tag, plain_tag in (("serve_spec", "serve"), ("serve_spec_kv8", "serve_kv8"),
                                    ("serve_paged", "serve"), ("serve_paged_kv8", "serve_kv8"),
                                    ("serve_spec_paged", "serve_spec"),
                                    ("serve_spec_paged_kv8", "serve_spec_kv8"),
                                    ("serve_ab1", "serve"), ("serve_ab2", "serve"),
                                    ("serve4_s16", "serve4"), ("serve4_ab2", "serve4"),
                                    ("serve_gqa_spec", "serve_gqa"),
                                    ("serve_gqa_spec_kv8", "serve_gqa"),
                                    ("serve_gqa_spec_paged_kv8", "serve_gqa"),
                                    ("serve_yi_kv8", "serve_yi"), ("serve_yi_spec", "serve_yi"),
                                    ("serve_yi_ab2", "serve_yi"), ("serve_b64", "serve"),
                                    ("serve_b64_spec", "serve_b64"),
                                    ("serve_ml_ab1", "serve_ml"), ("serve_ml_ab2", "serve_ml"),
                                    ("serve_warmup", "serve_kv8")):
            if spec_tag in main_path and spec_tag in serving:
                log(f"[{spec_tag}] against {plain_tag} in this run: "
                    f"{json.dumps({spec_tag: serving[spec_tag], plain_tag: serving.get(plain_tag)})}")
        if launches is None:
            launches = read_launches(*modules)
        log(f"[launches] {label} main path ({' + '.join(main_path)}): {launches}")
        if set(main_path) <= set(phases):
            check_launches(path, launches)
        for name, key in {**path["record"], **path["forbid"]}.items():
            if RECORD_OF.get(name, name) in results:
                results[RECORD_OF.get(name, name)][key] = launches[name]
                if name in BODY_COUNTS:
                    prefix, bodies = BODY_COUNTS[name]
                    results[name].setdefault("launches_by_body", {})[key] = {
                        body: launches[f"{prefix}_{body}"] for body in bodies}
                if name in FORM_COUNTS:
                    results[name].setdefault("launches_by_form", {})[key] = {
                        body: {f: launches[f"{FORM_COUNTS[name]}_{body}_rows{f}"]
                               for f in da.FORMS} for body in da.launches_by_form}
                if name in (*AB_KERNELS, "attn_block_gqa"):   # K14's calls by form
                    results[name].setdefault("launches_by_form", {})[key] = {
                        body: {f: launches[f"attn_block_{body}_rows{f}"] for f in forms}
                        for body, forms in ab.launches_by_form.items()}
                if name in ("ffn", "ffn_int4"):   # K3's calls by form, both bits together
                    results[name].setdefault("launches_by_form", {})[key] = {
                        form: launches[f"ffn_{form}"] for form in ffn_mod.launches_by_form}
        with clock(profile if profile in phases else f"{label}: after the main path"):
            if profile == "profile_kv8" and profile in phases:
                long = dict(params)
                long["rope_cos"], long["rope_sin"] = _rope_tables(cfg, dev, seq_len=KV8_MAX_LEN)
                cache = QuantKVCache.create(cfg, 8, KV8_MAX_LEN, device=dev)
                for start in (64, 2048):
                    phase_profile(torch, cfg, long, tag=profile, cache=cache, start=start)
                del cache, long
            elif profile == "profile_paged" and profile in phases:
                profile_paged(torch, cfg, params)
            elif profile == "profile_chunk" and profile in phases:
                profiles[profile] = profile_chunk(torch, cfg, params, card)
            elif profile == "spec_draft_ab" and profile in phases:
                phase_spec_draft_ab(torch, cfg, params, tokenizer)
            elif profile == "profile_ab" and profile in phases:
                profile_ab(torch, cfg, params)
            elif profile == "profile_ml_ab" and profile in phases:
                profiles[profile] = profile_ml_ab(torch, cfg, params)
                if "attn_block_gqa" in results:
                    results["attn_block_gqa"]["profile"] = profiles[profile]
            elif profile == "profile_gqa_spec" and profile in phases:
                profiles[profile] = profile_gqa_spec(torch, cfg, params)
            elif profile == "profile_b64" and profile in phases:
                profiles[profile] = profile_b64(torch, cfg, params)
            elif profile == "profile_prefill_yi" and profile in phases:
                profiles[profile] = profile_yi(torch, cfg, params)
                if "prefill_attention_gqa" in results:
                    results["prefill_attention_gqa"]["admission"] = \
                        profiles[profile]["admission"]
            elif profile == "profile_spec" and profile in phases:
                # a verify round (T = SPEC_TICK + 1) against a plain step, both caches
                for cache_cls in (None, QuantKVCache):
                    for chunk in (1, SPEC_TICK + 1):
                        cache = cache_cls and cache_cls.create(cfg, 8, 128, device=dev)
                        phase_profile(torch, cfg, params, tag=profile, cache=cache, chunk=chunk)
                        del cache
                # the same at pos 2048 of a 4096-row cache (RoPE tabulated to 4096)
                long = dict(params)
                long["rope_cos"], long["rope_sin"] = _rope_tables(cfg, dev, seq_len=KV8_MAX_LEN)
                for cache_cls in (KVCache, QuantKVCache):
                    cache = cache_cls.create(cfg, 8, KV8_MAX_LEN, device=dev)
                    for chunk in (1, SPEC_TICK + 1):
                        phase_profile(torch, cfg, long, tag=profile, cache=cache, start=2048,
                                      chunk=chunk)
                    del cache
                    torch.cuda.empty_cache()
                del long
            elif profile == "profile4_s16" and profile in phases:
                profiles[profile] = phase_profile(torch, cfg, cast_scales(params), tag=profile)
                log(f"[{profile}] against profile4 in this run: "
                    f"{json.dumps({k: profiles.get(k) for k in ('profile4_s16', 'profile4')})}")
            elif profile in phases:
                profiles[profile] = phase_profile(torch, cfg, params, tag=profile)
            if "model_s16" in path.get("after", ()) and "model_s16" in phases:
                phase_model(torch, cfg, cast_scales(params), f"int{bits} bf16-scale")
            if "profile_prefill" in path.get("after", ()) and "profile_prefill" in phases:
                torch.cuda.empty_cache()
                admission = profile_prefill(torch, cfg, params)
                for name in ("prefill_attention", "quant_matmul_mma"):
                    if name in results:
                        results[name]["admission"] = admission
        torch.cuda.empty_cache()
    llama.ATTN_BLOCK = 0
    if params_key:
        log(f"[memory] {params_key[0]} int{params_key[1]} paths: peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
    del params
    tmp.cleanup()
    torch.cuda.empty_cache()
    if "cli" in phases:
        with clock("cli"):
            phase_cli(torch)
    log(f"[phases] wall seconds {json.dumps(PHASE_S)}")
    log(f"[done] {time.time() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "library_note", "shape",
            "long_prompt", "t4096", "admission", "s4096", "t4", "t8", "ps16",
            "same_rows_one_query_ms", "dense_same_rows_ms", "dense_gap", "breakdown",
            "k6_same_run_ms",
            "launches_int4_path", "launches_kv8_path", "launches_spec_path",
            "launches_spec_draft_path", "launches_spec_kv8_path", "launches_paged_path",
            "launches_paged_kv8_path", "launches_spec_paged_path",
            "launches_spec_paged_kv8_path", "k4_same_run_ms", "k7_same_run_ms", "unfused_ms",
            "launches_ab1_path", "launches_ab2_path", "launches_prefill_t1_path",
            "launches_ab2_int4_path", "launches_s16_path", "launches_gqa_path",
            "launches_gqa_spec_path", "launches_gqa_spec_kv8_path",
            "launches_gqa_spec_paged_kv8_path", "launches_gqa_self_path", "launches_yi_path",
            "launches_yi_kv8_path", "launches_yi_spec_path", "launches_yi_ab2_path",
            "launches_b64_path", "launches_b64_spec_path", "launches_ml_path",
            "launches_ml_ab1_path", "launches_ml_ab2_path", "profile", "sweep", "any_m",
            "tinyllama", "rep8",
            "launches_by_body",
            "launches_by_form", "gemm", "by_m", "mmv", "device_ms", "f32_device_ms", "s16",
            "t2", "one_query", "paged", "standalone", "standalone_launches",
            "standalone_launches_yi_kv8_path", "rows_body", "rows_body_launches", "t512",
            "launches_warmup_path", "stream_body_launches", "launches_pipe_path",
            "standalone_launches_pipe_path", "rows_body_launches_pipe_path",
            "launches_chunk_path", "standalone_launches_chunk_path",
            "rows_body_launches_chunk_path", "launches_chat_path", "launches_eval_path")
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys} for r in results.values()]}))
    print(nvidia_smi_line())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    # not every kernel was checked and launched: no "ok" for a subset
    line, rc = final_line(phases, device)
    print(json.dumps(line))
    return rc


if __name__ == "__main__":
    sys.exit(main())
