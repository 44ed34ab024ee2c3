"""chip_smoke.py's checks, on the CPU: the per-group comparison fails a
kernel that drops one edge row of one slot (bf16 and int8 caches), the
planted edges make such a drop large, a subset of phases never reads as a
full run, the launch record fails a main path that skipped one of its
kernels, ran one it must not, or ran the fused attention block another
number of times than the fused FFN, the written-row check of kernel 14
fails a changed row, the int4 params it makes on the card have
quantize_int4's layout, and the model_attn / prefill_t1 phases run on a
tiny head_dim-128 model (the kernels' plain versions, counted)."""

import importlib.util
import pathlib
import sys
import time

import pytest
import torch

from rama_tpu_torch.ops.kernels import kv_write as kvw
from rama_tpu_torch.ops.kernels.decode_attention import (decode_attention_plain,
                                                         decode_attention_q8_plain)
from rama_tpu_torch.ops.kernels.prefill_attention import prefill_attention_plain

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _decode_inputs(b=3, nh=8, s=320, hd=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, nh, hd, generator=g)
    kc = torch.randn(1, b, nh, s, hd, generator=g)
    vc = torch.randn(1, b, nh, s, hd, generator=g)
    return q, kc, vc


@pytest.mark.parametrize("planted", [False, True])
def test_compare_fails_a_dropped_edge_row_of_one_slot(smoke, planted):
    """Slot 0 sees one row (its output is a raw v row, the largest), slot 2
    averages 257: dropping row 256 of slot 2 passes the whole-tensor ratio
    but not the per-head one. Tolerance: chip_smoke.TOL (rel 0.05)."""
    q, kc, vc = _decode_inputs()
    pos = torch.tensor([0, 63, 256], dtype=torch.int32)
    if planted:
        smoke.plant_decode_edges(q, kc, pos, 0, (63, 64, 255, 256))
    want = decode_attention_plain(q, kc, vc, pos, 0)
    smoke.compare(torch, "same function", want.clone(), want, per=128)
    k_drop = kc.clone()
    k_drop[0, 2, :, 256] = -1e4 * q[2]           # row 256 of slot 2 gets weight 0
    got = decode_attention_plain(q, k_drop, vc, pos, 0)
    whole = float((got - want).abs().max() / want.abs().max())
    assert planted or whole < smoke.TOL           # the old check let it through
    with pytest.raises(SystemExit, match="rel err"):
        smoke.compare(torch, "dropped row", got, want, per=128)


def test_compare_fails_a_prefill_key_read_past_plen(smoke):
    """A kernel that lets rows >= plen see key plen fails once value rows
    at the edges are planted."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 96, 2, 16, generator=g), torch.randn(1, 2, 96, 16, generator=g),
               torch.randn(1, 2, 96, 16, generator=g))
    plens = [70]
    smoke.plant_prefill_edges(v, plens, (31, 32, 63, 64))
    want = prefill_attention_plain(q, k, v, torch.tensor(plens))
    got = prefill_attention_plain(q, k, v, torch.tensor([71]))
    with pytest.raises(SystemExit, match="rel err"):
        smoke.compare(torch, "read past plen", got, want, per=16)


def test_unknown_phase_is_refused(smoke, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--phases", "build,kernel"])
    with pytest.raises(SystemExit) as exc:
        smoke.main()
    assert exc.value.code == 2


def test_random_int4_params_have_quantize_int4_layout(smoke):
    """The int4 params chip_smoke draws on the card (here on the CPU, at a
    shrunken width that keeps 7B's group sizes and interleave tile): int4
    layer weights with quantize_int4's group sizes, nibbles in [-7, 7],
    int8 embedding and classifier; the plain forward gives finite logits."""
    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models.llama import KVCache, decode_step, prefill
    from rama_tpu_torch.ops.quant import unpack_int4

    cfg = ModelConfig(dim=1024, hidden_dim=768, n_layers=1, n_heads=8, n_kv_heads=8,
                      vocab_size=512, seq_len=16, shared_classifier=False)
    p = smoke.random_params(torch, cfg, torch.device("cpu"), bits=4)
    assert {n: (p[n].bits, p[n].group_size) for n in ("wqkv", "wo", "w13", "w2")} == \
        {"wqkv": (4, 64), "wo": (4, 64), "w13": (4, 64), "w2": (4, 16)}
    assert p["w13"].il == 256 and p["wcls"].bits == 8
    assert p["w2"].q.shape == (1, 384, 1024) and p["w2"].scales.shape == (1, 48, 1024)
    vals = unpack_int4(p["w13"].q, 64)
    assert int(vals.min()) == -7 and int(vals.max()) == 7
    cache = KVCache.create(cfg, 2, 16, dtype=torch.bfloat16, device="cpu")
    logits, cache = prefill(p, cfg, torch.tensor([[1, 5, 9], [1, 7, 3]]), cache,
                            last_only=True)
    step, _ = decode_step(p, cfg, torch.tensor([4, 2]), torch.tensor([3, 3]), cache)
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()
    assert float(step.std()) > 0.1  # weights of ~N(0, 1/K) keep activations alive


def _modules():
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import ffn
    from rama_tpu_torch.ops.kernels import paged_attention as pga
    from rama_tpu_torch.ops.kernels import prefill_attention as pa
    from rama_tpu_torch.ops.kernels import attn_block as ab
    from rama_tpu_torch.ops.kernels import quant_matmul as qm

    return qm, ffn, da, pa, kvw, pga, ab


@pytest.fixture
def counters():
    """The launch counters of every wrapper, restored after the test."""
    qm, ffn, da, pa, kw, pga, ab = mods = _modules()
    saved = (dict(qm.launches), dict(ffn.launches), dict(kw.launches), dict(pga.launches),
             dict(ab.launches), da.launches, da.launches_q8, pa.launches, da.launches_flat,
             da.launches_flat_q8)
    bodies = (dict(pa.launches_by_body), dict(qm.launches_by_body), dict(ffn.launches_by_body),
              dict(da.launches_by_body), dict(pga.launches_by_body), dict(ab.launches_by_body))
    k5_forms, k3_forms = dict(pa.launches_by_form), dict(ffn.launches_by_form)
    k14_forms = {body: dict(forms) for body, forms in ab.launches_by_form.items()}
    yield mods
    for body, forms in k14_forms.items():
        ab.launches_by_form[body].update(forms)
    pa.launches_by_form.update(k5_forms)
    ffn.launches_by_form.update(k3_forms)
    ab.launches_by_body.update(bodies[5])
    pa.launches_by_body.update(bodies[0])
    qm.launches_by_body.update(bodies[1])
    ffn.launches_by_body.update(bodies[2])
    da.launches_by_body.update(bodies[3])
    pga.launches_by_body.update(bodies[4])
    qm.launches.update(saved[0])
    ffn.launches.update(saved[1])
    kw.launches.update(saved[2])
    pga.launches.update(saved[3])
    ab.launches.update(saved[4])
    (da.launches, da.launches_q8, pa.launches, da.launches_flat,
     da.launches_flat_q8) = saved[5:]


def test_launch_counters_read_and_reset(smoke, counters):
    """The counts the main paths are judged by: one per wrapper and weight
    bits or cache, set to 0 before each path."""
    qm, ffn, da, pa, kw, pga, ab = counters
    qm.launches[4], ffn.launches[8], da.launches = 3, 2, 1
    pga.launches["paged_chunk_attention_q8"] = 9
    da.launches_q8, kw.launches["write_kv_strips_q8"] = 5, 7
    got = smoke.read_launches(*counters)
    assert got["quant_matmul_int4"] == 3 and got["ffn"] == 2 and got["decode_attention"] == 1
    assert got["decode_attention_q8"] == 5 and got["write_kv_strips_q8"] == 7
    assert got["paged_chunk_attention_q8"] == 9
    for path in smoke.PATHS:
        assert set(got) >= set(path["record"]) | set(path["forbid"])
    smoke.reset_launches(*counters)
    assert not any(smoke.read_launches(*counters).values())


def _kv8_launches(smoke, **over):
    got = {k: 4 for k in smoke.KV8_PATH["record"]}
    got.update({k: 0 for k in smoke.KV8_PATH["forbid"]})
    return {**got, **over}


def test_kv8_path_passes_with_its_kernels_and_no_bf16_attention(smoke):
    """K6 runs inside every K7 launch on this path: its own launch (the
    standalone writer) is forbidden there, as the bf16 decode attention and
    K8's warp-a-row body (every K8 launch takes the streaming one)."""
    smoke.check_launches(smoke.KV8_PATH, _kv8_launches(smoke))
    assert smoke.KV8_PATH["forbid"] == {"decode_attention": "launches_kv8_path",
                                        "write_kv_rows_q8": "standalone_launches",
                                        "write_kv_strips_q8_rows": "rows_body_launches"}


@pytest.mark.parametrize("name", ["write_kv_rows_q8", "decode_attention_q8",
                                  "write_kv_strips_q8", "quant_matmul", "ffn",
                                  "prefill_attention"])
def test_kv8_path_fails_when_one_of_its_kernels_never_launched(smoke, name):
    """K6 (write_kv_rows_q8) runs on this path inside the K7 launches that
    write the step's rows: its count there is write_kv_rows_q8_fused."""
    name = {"write_kv_rows_q8": "write_kv_rows_q8_fused"}.get(name, name)
    with pytest.raises(SystemExit, match="never launched on the int8 KV main path"):
        smoke.check_launches(smoke.KV8_PATH, _kv8_launches(smoke, **{name: 0}))


def test_kv8_path_fails_when_the_bf16_decode_attention_launched(smoke):
    with pytest.raises(SystemExit, match=r"\['decode_attention'\] launched on the int8 KV"):
        smoke.check_launches(smoke.KV8_PATH, _kv8_launches(smoke, decode_attention=1))
    # the int8 path needs that kernel: there it is a record, not a stray
    smoke.check_launches(smoke.INT8_PATH, {k: 1 for k in smoke.INT8_PATH["record"]})


def test_kv8_phases_are_known_and_a_subset_is_not_ok(smoke):
    for ph in ("kernels_kv8", "model_kv8", "serve_kv8", "profile_kv8"):
        assert ph in smoke.ALL_PHASES
    assert smoke.KV8_PATH["phases"] == ("model_kv8", "serve_kv8", "profile_kv8")
    dev = {"platform": "gpu", "kind": "x", "count": 1}
    line, rc = smoke.final_line(tuple(p for p in smoke.ALL_PHASES if p != "serve_kv8"), dev)
    assert line == {"ok": False, "skipped_phases": ["serve_kv8"], "device": dev}
    assert rc == smoke.PARTIAL_RC != 0
    assert smoke.final_line(smoke.ALL_PHASES, dev) == ({"ok": True, "device": dev}, 0)


def test_compare_fails_a_dropped_edge_row_of_an_int8_cache(smoke):
    """The int8 cache's planted key rows (q * 0.5, quantized) make a kernel
    that drops one visible edge row of one slot fail the per-head check.
    Tolerance: chip_smoke.TOL (rel 0.05)."""
    g = torch.Generator().manual_seed(4)
    b, nh, s, hd = 3, 4, 320, 128
    q = torch.randn(b, nh, hd, generator=g)
    k8, ks = kvw.kv_quant_rows(torch.randn(1, b, nh, s, hd, generator=g))
    v8, vs = kvw.kv_quant_rows(torch.randn(1, b, nh, s, hd, generator=g))
    pos = torch.tensor([0, 63, 256], dtype=torch.int32)
    smoke.plant_decode_edges_q8(kvw, q, k8, ks, pos, 0, (63, 64, 255, 256))
    assert torch.equal(k8[0, 2, :, 256], kvw.kv_quant_rows(q[2] * 0.5)[0])
    want = decode_attention_q8_plain(q, k8, v8, ks, vs, pos, 0)
    smoke.compare(torch, "same function", want.clone(), want, per=hd)
    ks_drop = ks.clone()
    ks_drop[0, 2, :, 256] = -1e4                  # row 256 of slot 2 gets weight 0
    got = decode_attention_q8_plain(q, k8, v8, ks_drop, vs, pos, 0)
    with pytest.raises(SystemExit, match="rel err"):
        smoke.compare(torch, "dropped row", got, want, per=hd)


SPEC_KERNELS = ("chunk_attention", "chunk_attention_q8", "write_kv_chunk_q8")


def _recorded(smoke) -> set:
    """The kernels records whose "launches" a main path sets (a count kept
    in another kernel's record, RECORD_OF, under that record's name)."""
    return {smoke.RECORD_OF.get(name, name) for path in smoke.PATHS
            for name, key in path["record"].items() if key == "launches"}


def test_every_kernel_has_a_main_path_that_records_its_launches(smoke, counters):
    """The kernels record takes each kernel's launches from a main path:
    the speculation slice's three kernels from the n-gram spec paths (K11's
    from the walk launches that write the verify rounds' rows)."""
    recorded = _recorded(smoke)
    assert set(SPEC_KERNELS) <= recorded
    assert smoke.SPEC_PATH["record"]["chunk_attention"] == "launches"
    assert smoke.SPEC_KV8_PATH["record"]["chunk_attention_q8"] == "launches"
    assert smoke.SPEC_KV8_PATH["record"]["write_kv_chunk_q8_fused"] == "launches"
    assert smoke.RECORD_OF["write_kv_chunk_q8_fused"] == "write_kv_chunk_q8"
    got = smoke.read_launches(*counters)
    assert set(got) >= {n for p in smoke.PATHS for n in p["record"]} | set(SPEC_KERNELS)


def _spec_kv8_launches(smoke, **over):
    got = {k: 4 for k in smoke.SPEC_KV8_PATH["record"]}
    got.update({k: 0 for k in smoke.SPEC_KV8_PATH["forbid"]})
    return {**got, **over}


@pytest.mark.parametrize("name", ["chunk_attention_q8", "write_kv_chunk_q8",
                                  "write_kv_strips_q8", "quant_matmul", "ffn",
                                  "prefill_attention"])
def test_spec_kv8_path_fails_when_one_of_its_kernels_never_launched(smoke, name):
    """K11 (write_kv_chunk_q8) runs on this path inside the walk launches
    that write the rows: its count there is write_kv_chunk_q8_fused."""
    name = {"write_kv_chunk_q8": "write_kv_chunk_q8_fused"}.get(name, name)
    smoke.check_launches(smoke.SPEC_KV8_PATH, _spec_kv8_launches(smoke))
    with pytest.raises(SystemExit, match="never launched on the speculation int8 KV"):
        smoke.check_launches(smoke.SPEC_KV8_PATH, _spec_kv8_launches(smoke, **{name: 0}))


@pytest.mark.parametrize("path_name,walk,fused,writer", [
    ("KV8_PATH", "decode_attention_q8", "write_kv_rows_q8_fused", "write_kv_rows_q8"),
    ("YI_KV8_PATH", "decode_attention_q8", "write_kv_rows_q8_fused", "write_kv_rows_q8"),
    ("SPEC_KV8_PATH", "chunk_attention_q8", "write_kv_chunk_q8_fused", "write_kv_chunk_q8"),
    ("GQA_SPEC_KV8_PATH", "chunk_attention_q8", "write_kv_chunk_q8_fused", "write_kv_chunk_q8"),
    ("PAGED_KV8_PATH", "paged_decode_attention_q8", "write_kv_paged_q8_fused",
     "write_kv_paged_q8"),
    ("SPEC_PAGED_KV8_PATH", "paged_chunk_attention_q8", "write_kv_paged_q8_fused",
     "write_kv_paged_q8"),
    ("GQA_SPEC_PAGED_KV8_PATH", "paged_chunk_attention_q8", "write_kv_paged_q8_fused",
     "write_kv_paged_q8")])
def test_int8_paths_fail_unless_every_walk_launch_writes_its_rows(smoke, path_name, walk,
                                                                  fused, writer):
    """On the int8 decode, verify and paged paths every walk launch writes
    its rows (the fused count equals the walk's), the standalone writer
    (K6 / K11 / K13 (a)) never launches, and that count goes to the
    writer's kernels record."""
    path = getattr(smoke, path_name)
    ok = {**{k: 3 for k in path["record"]}, **{k: 0 for k in path["forbid"]}}
    smoke.check_launches(path, ok)
    assert fused in path["record"] and path["equal"][fused] == walk
    assert smoke.RECORD_OF[fused] == writer and writer in path["forbid"]
    with pytest.raises(SystemExit, match=rf"\['{writer}'\] launched on the {path['label']}"):
        smoke.check_launches(path, {**ok, writer: 1})
    with pytest.raises(SystemExit, match="launches of the kernel"):
        smoke.check_launches(path, {**ok, fused: 2})
    assert "write_kv_rows_q8" not in smoke.KV8_PATH["record"]


def test_spec_kv8_path_fails_when_the_bf16_decode_attention_launched(smoke):
    with pytest.raises(SystemExit, match=r"\['decode_attention'\] launched on the speculation"):
        smoke.check_launches(smoke.SPEC_KV8_PATH, _spec_kv8_launches(smoke, decode_attention=2))


def test_spec_path_needs_the_bf16_chunk_attention(smoke):
    """n-gram serving verifies a chunk every tick: K10 must launch there,
    and the T = 1 decode attention must not."""
    ok = {**{k: 1 for k in smoke.SPEC_PATH["record"]}, "decode_attention": 0}
    smoke.check_launches(smoke.SPEC_PATH, ok)
    with pytest.raises(SystemExit, match=r"\['chunk_attention'\] never launched"):
        smoke.check_launches(smoke.SPEC_PATH, {**ok, "chunk_attention": 0})
    with pytest.raises(SystemExit, match=r"\['decode_attention'\] launched on the speculation"):
        smoke.check_launches(smoke.SPEC_PATH, {**ok, "decode_attention": 1})


@pytest.mark.parametrize("name", ["chunk_attention", "decode_attention", "quant_matmul",
                                  "ffn", "prefill_attention"])
def test_draft_spec_path_fails_when_one_of_its_kernels_never_launched(smoke, name):
    """Draft-model speculation runs K10 to verify and the T = 1 decode
    attention for the draft's steps and the dormant plain ticks."""
    ok = {k: 1 for k in smoke.SPEC_DRAFT_PATH["record"]}
    smoke.check_launches(smoke.SPEC_DRAFT_PATH, ok)
    with pytest.raises(SystemExit, match="never launched on the draft speculation main path"):
        smoke.check_launches(smoke.SPEC_DRAFT_PATH, {**ok, name: 0})


def test_spec_draft_counts_only_its_draft_mode_runs(smoke, monkeypatch):
    """spec_draft's spec-off baseline runs before the launch counters are
    set to 0: the path's count holds the two draft-mode runs only."""
    from rama_tpu_torch import checkpoint, cli
    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.runtime import engine as eng_mod

    events = []

    class FakeEngine:
        def __init__(self, cfg, params, tokenizer, ecfg, draft=None):
            events.append("draft" if ecfg.spec_tick else "off")

        def start(self):
            pass

        def stop(self):
            pass

        def submit(self, req):
            for tok in ("a", "b", None):
                req.queue.put(tok)

        def stats(self):
            return {"spec_accept_rate": 1.0, "spec_dormancies": 1, "draft_resyncs": 1,
                    "engine_errors": 0}

    monkeypatch.setattr(eng_mod, "Engine", FakeEngine)
    monkeypatch.setattr(checkpoint, "save_v0", lambda *a, **k: None)
    monkeypatch.setattr(cli, "load_model", lambda *a, **k: (None, None, None))
    smoke.phase_spec_draft(torch, smoke.seven_b_config(ModelConfig), {"final_norm": torch.zeros(1)}, None,
                           start_count=lambda: events.append("count from 0"))
    assert events == ["off", "count from 0", "draft", "draft"]


def test_spec_draft_ab_runs_the_self_draft_under_modes_1_and_2(smoke, monkeypatch):
    """spec_draft_ab runs spec_draft's self-draft (spec off, then the target
    as its own draft) under RAMA_ATTN_BLOCK 1 and then 2, gates nothing,
    returns each mode's accept rate and restores the mode."""
    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models import llama
    from rama_tpu_torch.runtime import engine as eng_mod

    events, rates = [], iter([0.5, 0.75])

    class FakeEngine:
        def __init__(self, cfg, params, tokenizer, ecfg, draft=None):
            events.append((llama.ATTN_BLOCK, "draft" if ecfg.spec_tick else "off"))
            self.rate = next(rates) if ecfg.spec_tick else None

        def start(self):
            pass

        def stop(self):
            pass

        def submit(self, req):
            for tok in ("a", "b", None):
                req.queue.put(tok)

        def stats(self):
            return {"spec_accept_rate": self.rate, "engine_errors": 0}

    monkeypatch.setattr(eng_mod, "Engine", FakeEngine)
    monkeypatch.setattr(llama, "ATTN_BLOCK", 0)
    got = smoke.phase_spec_draft_ab(torch, smoke.seven_b_config(ModelConfig), {}, None)
    assert got == {1: 0.5, 2: 0.75}
    assert events == [(1, "off"), (1, "draft"), (2, "off"), (2, "draft")]
    assert llama.ATTN_BLOCK == 0


def test_spec_phases_are_known_and_a_subset_is_not_ok(smoke):
    for ph in ("kernels_spec", "model_spec", "serve_spec", "spec_draft", "spec_draft_ab",
               "profile_spec", "serve_spec_kv8"):
        assert ph in smoke.ALL_PHASES
    assert smoke.SPEC_PATH["phases"] == ("model_spec", "serve_spec", "profile_spec")
    # the self-draft under RAMA_ATTN_BLOCK 1 / 2 runs after the path's count is read
    assert smoke.SPEC_DRAFT_PATH["phases"] == (None, "spec_draft", "spec_draft_ab")
    assert smoke.SPEC_KV8_PATH["serve"]["kv_quant"] == "int8"
    dev = {"platform": "gpu", "kind": "x", "count": 1}
    line, rc = smoke.final_line(tuple(p for p in smoke.ALL_PHASES if p != "spec_draft"), dev)
    assert line["ok"] is False and line["skipped_phases"] == ["spec_draft"] and rc != 0


def test_chunk_edge_keys_plant_both_sides_of_each_limit(smoke):
    """Row pos0 + j holds 0.5 (q[j-1] + q[j]): query t scores high on its
    last visible row and on the first row past its limit."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 3, 4, 16, generator=g)
    keys = smoke.chunk_edge_keys(q, torch.tensor([5, 62]), 64, (31, 32))
    torch.testing.assert_close(keys[(0, 5)], q[0, 0] * 0.5)
    torch.testing.assert_close(keys[(0, 7)], (q[0, 1] + q[0, 2]) * 0.5)
    torch.testing.assert_close(keys[(0, 8)], q[0, 2] * 0.5)
    torch.testing.assert_close(keys[(1, 31)], q[1, 0] * 0.5)
    assert (1, 64) not in keys and (1, 63) in keys     # rows past S are not planted


@pytest.mark.parametrize("q8", [False, True])
def test_compare_fails_a_chunk_query_that_reads_one_row_past_its_limit(smoke, q8):
    """With the chunk's edges planted, a kernel letting query t of one slot
    see row pos0 + t + 1 fails the per-(slot, query, head) check, on a bf16
    and an int8 cache. Tolerance: chip_smoke.TOL (rel 0.05)."""
    from rama_tpu_torch.ops.kernels import decode_attention as da

    g = torch.Generator().manual_seed(5)
    b, t, nh, s, hd = 3, 4, 4, 192, 128
    q = torch.randn(b, t, nh, hd, generator=g)
    k, v = torch.randn(1, b, nh, s, hd, generator=g), torch.randn(1, b, nh, s, hd, generator=g)
    cache = [*kvw.kv_quant_rows(k), *kvw.kv_quant_rows(v)] if q8 else [k, v]
    if q8:
        cache = [cache[0], cache[2], cache[1], cache[3]]          # k8, v8, ks, vs
    pos0 = torch.tensor([0, 61, 126], dtype=torch.int32)
    smoke.plant_chunk_edges(q, cache, pos0, 0, (63, 64, 127, 128), kvw if q8 else None)
    fn = da.chunk_attention_q8_plain if q8 else da.chunk_attention_plain
    want = fn(q, *cache, pos0, 0)
    smoke.compare(torch, "same function", want.clone(), want, per=hd)
    # query 1 of slot 1 sees one row more: its own output, from a chunk
    # started one row later
    late = fn(q, *cache, pos0 + 1, 0)
    got = want.clone()
    got[1, 1] = late[1, 1]
    with pytest.raises(SystemExit, match="rel err"):
        smoke.compare(torch, "one row past", got, want, per=hd)


PAGED_KERNELS = ("paged_decode_attention", "paged_decode_attention_q8", "paged_chunk_attention",
                 "paged_chunk_attention_q8", "write_kv_paged_q8", "write_kv_prefill_paged_q8")


def test_paged_phases_are_known_and_a_subset_is_not_ok(smoke):
    for ph in ("kernels_paged", "model_paged", "serve_paged", "profile_paged",
               "serve_paged_kv8", "serve_spec_paged", "serve_spec_paged_kv8"):
        assert ph in smoke.ALL_PHASES
    assert smoke.PAGED_PATH["phases"] == ("model_paged", "serve_paged", "profile_paged")
    for path in (smoke.PAGED_PATH, smoke.PAGED_KV8_PATH, smoke.SPEC_PAGED_PATH,
                 smoke.SPEC_PAGED_KV8_PATH):
        assert path["serve"]["paged"] and path["serve"]["max_seq_len"] == 4096
        assert path in smoke.PATHS
    dev = {"platform": "gpu", "kind": "x", "count": 1}
    line, rc = smoke.final_line(tuple(p for p in smoke.ALL_PHASES if p != "serve_paged_kv8"),
                                dev)
    assert line["ok"] is False and line["skipped_phases"] == ["serve_paged_kv8"] and rc != 0


def test_every_paged_kernel_records_its_launches_on_a_paged_path(smoke, counters):
    """Each of K12's four forms and K13's two writers takes its "launches"
    from a paged serving path, and the counters read them."""
    recorded = _recorded(smoke)
    assert set(PAGED_KERNELS) <= recorded
    assert set(smoke.read_launches(*counters)) >= set(PAGED_KERNELS)
    smoke.reset_launches(*counters)
    assert not any(smoke.read_launches(*counters).values())


@pytest.mark.parametrize("path_name,must,must_not", [
    ("PAGED_PATH", "paged_decode_attention", ["decode_attention", "chunk_attention"]),
    ("PAGED_KV8_PATH", "write_kv_prefill_paged_q8",
     ["write_kv_rows_q8", "decode_attention_q8", "write_kv_strips_q8", "decode_attention",
      "write_kv_prefill_paged_q8_rows"]),
    ("SPEC_PAGED_PATH", "paged_chunk_attention",
     ["decode_attention", "chunk_attention", "paged_decode_attention"]),
    ("SPEC_PAGED_KV8_PATH", "paged_chunk_attention_q8",
     ["decode_attention_q8", "chunk_attention_q8", "write_kv_chunk_q8", "write_kv_strips_q8"]),
])
def test_paged_paths_fail_on_a_missing_or_a_forbidden_kernel(smoke, path_name, must, must_not):
    """The paged paths launch K12 / K13 where the dense paths launch K4,
    K7, K10, K6, K8 and K11, and fail if one of theirs never launched or a
    dense kernel did."""
    path = getattr(smoke, path_name)
    ok = {**{k: 3 for k in path["record"]}, **{k: 0 for k in path["forbid"]}}
    smoke.check_launches(path, ok)
    with pytest.raises(SystemExit, match=f"never launched on the {path['label']} main"):
        smoke.check_launches(path, {**ok, must: 0})
    for name in must_not:
        assert name in path["forbid"]
        with pytest.raises(SystemExit, match=rf"\['{name}'\] launched on the {path['label']}"):
            smoke.check_launches(path, {**ok, name: 1})


def _quantized_leaf(sdtype):
    from rama_tpu_torch.ops.quant import QuantizedTensor

    return QuantizedTensor(q=torch.zeros(1, 64, 8, dtype=torch.int8),
                           scales=torch.ones(1, 1, 8, dtype=sdtype), group_size=64)


@pytest.mark.parametrize("free", [64, 63])
def test_paged_serve_fails_unless_every_page_is_free_again(smoke, monkeypatch, free):
    """phase_serve on a paged engine holds the allocator to all
    PAGED_NUM_PAGES pages free after the run (an engine stand-in that
    streams two tokens a request)."""
    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.runtime import engine as eng_mod
    from rama_tpu_torch.runtime.paged import PagedKVCache
    # phase_serve imports the server module: import it first, so that it
    # binds the real Engine and not the stand-in below (a later test of the
    # same worker builds engines through it)
    from rama_tpu_torch.server import app  # noqa: F401

    cfg = ModelConfig(dim=64, hidden_dim=96, n_layers=1, n_heads=4, n_kv_heads=4,
                      vocab_size=8, seq_len=32)

    class FakeAllocator:
        def available(self):
            return free

    class FakeEngine:
        def __init__(self, cfg, params, tokenizer, ecfg, draft=None):
            assert ecfg.paged_kv and ecfg.kv_num_pages == smoke.PAGED_NUM_PAGES
            self.cache = PagedKVCache.create(cfg, 2, 8, device="cpu")
            self.allocator, self.n = FakeAllocator(), 0
            self.params = {"wqkv": _quantized_leaf(torch.float32)}

        def start(self):
            pass

        def stop(self):
            pass

        def submit(self, req, timeout=None):
            for tok in ("a", "b", None):
                req.queue.put(tok)
            self.n += 2

        def stats(self):
            return {"tokens_generated": self.n, "engine_errors": 0, "decode_tok_per_s": 1.0,
                    "spec_accept_rate": None, "decode_ticks": 1, "phases": {}}

    monkeypatch.setattr(eng_mod, "Engine", FakeEngine)
    if free == smoke.PAGED_NUM_PAGES:
        smoke.phase_serve(torch, cfg, None, None, "card", tag="serve_paged", paged=True)
    else:
        with pytest.raises(SystemExit, match="63 of 64 pages free"):
            smoke.phase_serve(torch, cfg, None, None, "card", tag="serve_paged", paged=True)


ATTN_KERNELS = ("decode_attention_flat", "decode_attention_flat_q8", "attn_rope_write_layered",
                "attn_block_layered", "attn_block_layered_int4")


def test_attention_phases_are_known_and_a_subset_is_not_ok(smoke):
    for ph in ("kernels_attn", "model_attn", "serve_ab1", "serve_ab2", "profile_ab",
               "prefill_t1", "serve4_ab2"):
        assert ph in smoke.ALL_PHASES
    assert smoke.AB1_PATH["attn_block"] == 1 and smoke.AB2_PATH["attn_block"] == 2
    assert smoke.AB2_INT4_PATH["bits"] == 4 and smoke.AB2_INT4_PATH["attn_block"] == 2
    assert "attn_block" not in smoke.INT8_PATH        # the default paths run mode 0
    dev = {"platform": "gpu", "kind": "x", "count": 1}
    line, rc = smoke.final_line(tuple(p for p in smoke.ALL_PHASES if p != "serve4_ab2"), dev)
    assert line["ok"] is False and line["skipped_phases"] == ["serve4_ab2"] and rc != 0


def test_every_attention_kernel_records_its_launches_on_a_main_path(smoke, counters):
    recorded = {name for path in smoke.PATHS for name, key in path["record"].items()
                if key == "launches"}
    assert set(ATTN_KERNELS) <= recorded
    got = smoke.read_launches(*counters)
    assert set(got) >= set(ATTN_KERNELS)
    qm, ffn, da, pa, kw, pga, ab = counters
    da.launches_flat, ab.launches["attn_block_layered_int4"] = 4, 6
    got = smoke.read_launches(*counters)
    assert got["decode_attention_flat"] == 4 and got["attn_block_layered_int4"] == 6
    smoke.reset_launches(*counters)
    assert not any(smoke.read_launches(*counters).values())


@pytest.mark.parametrize("path_name,fused,ffn", [("AB1_PATH", "attn_rope_write_layered", "ffn"),
                                                 ("AB2_PATH", "attn_block_layered", "ffn"),
                                                 ("AB2_INT4_PATH", "attn_block_layered_int4",
                                                  "ffn_int4")])
def test_attention_block_paths_fail_without_k14_with_k4_or_uneven(smoke, path_name, fused, ffn):
    """Under RAMA_ATTN_BLOCK 1 / 2 the decode step launches K14 once a layer
    (as often as the fused FFN) and K4 never."""
    path = getattr(smoke, path_name)
    ok = {**{k: 64 for k in path["record"]}, **{k: 0 for k in path["forbid"]}}
    smoke.check_launches(path, ok)
    with pytest.raises(SystemExit, match=f"never launched on the {path['label']} main"):
        smoke.check_launches(path, {**ok, fused: 0})
    with pytest.raises(SystemExit, match=r"\['decode_attention'\] launched"):
        smoke.check_launches(path, {**ok, "decode_attention": 32})
    with pytest.raises(SystemExit, match="launches of the kernel"):
        smoke.check_launches(path, {**ok, fused: 32, ffn: 64})


@pytest.mark.parametrize("path_name", ["AB1_PATH", "AB2_PATH", "AB2_INT4_PATH"])
def test_attention_block_paths_fail_on_the_simt_body(smoke, path_name):
    """Every bf16 launch of the fused attention block runs split
    tensor-core attention: one launch counted on its SIMT body fails the
    path."""
    path = getattr(smoke, path_name)
    ok = {**{k: 64 for k in path["record"]}, **{k: 0 for k in path["forbid"]},
          "attn_block_mma": 64, "attn_block_simt": 0}
    smoke.check_launches(path, ok)
    with pytest.raises(SystemExit, match="took the SIMT body, not split tensor-core"):
        smoke.check_launches(path, {**ok, "attn_block_mma": 63, "attn_block_simt": 1})
    # a path without the fused block does not read its counts
    smoke.check_launches(smoke.PREFILL_T1_PATH, {
        **{k: 32 for k in smoke.PREFILL_T1_PATH["record"]},
        **{k: 0 for k in smoke.PREFILL_T1_PATH["forbid"]}, "attn_block_simt": 5})


def test_attention_block_launches_are_read_and_reset_by_body(smoke, counters):
    ab = counters[-1]
    ab.launches_by_body.update(mma=5, simt=2)
    got = smoke.read_launches(*counters)
    assert (got["attn_block_mma"], got["attn_block_simt"]) == (5, 2)
    for name in smoke.AB_KERNELS:
        assert smoke.BODY_COUNTS[name] == ("attn_block", ("mma", "simt"))
    smoke.reset_launches(*counters)
    assert ab.launches_by_body == {"mma": 0, "simt": 0}


def test_prefill_t1_path_needs_both_k9_forms_and_no_other_attention(smoke):
    path = smoke.PREFILL_T1_PATH
    ok = {**{k: 32 for k in path["record"]}, **{k: 0 for k in path["forbid"]}}
    smoke.check_launches(path, ok)
    for name in ("decode_attention_flat", "decode_attention_flat_q8"):
        with pytest.raises(SystemExit, match="never launched on the T = 1 prefill"):
            smoke.check_launches(path, {**ok, name: 0})
    for name in ("decode_attention", "decode_attention_q8", "prefill_attention"):
        with pytest.raises(SystemExit, match=rf"\['{name}'\] launched"):
            smoke.check_launches(path, {**ok, name: 1})


def _written(seed=0, dtype=torch.bfloat16):
    from rama_tpu_torch.ops.kernels import attn_block as ab

    g = torch.Generator().manual_seed(seed)
    b, nkv, s, hd = 3, 2, 16, 128
    q, kn, vn = (torch.randn(b, n, hd, generator=g).to(dtype) for n in (nkv, nkv, nkv))
    before = [torch.randn(2, b, nkv, s, hd, generator=g).to(dtype) for _ in range(2)]
    pos = torch.tensor([0, 7, s + 3], dtype=torch.int32)
    cos, sin = torch.rand(b, hd // 2, generator=g), torch.rand(b, hd // 2, generator=g)
    want = [t.clone() for t in before]
    ab.attn_rope_write_layered_plain(q, kn, vn, cos, sin, *want, pos, 1)
    return want, before, pos


def test_check_written_rows_passes_the_plain_writes(smoke):
    want, before, pos = _written()
    smoke.check_written_rows(torch, "same writes", [t.clone() for t in want], want, before,
                             pos, 1)
    got = [t.clone() for t in want]                   # one ulp on a k element: still fine
    x = got[0][1, 1, 0, 7, 5]
    got[0][1, 1, 0, 7, 5] = x + smoke.cache_ulp(torch, x.view(1))[0].to(x.dtype) * (
        1 if x >= 0 else -1)
    smoke.check_written_rows(torch, "one ulp", got, want, before, pos, 1)


@pytest.mark.parametrize("fault", ["v row", "k row", "other row", "other layer"])
def test_check_written_rows_fails_a_changed_row(smoke, fault):
    want, before, pos = _written(seed=3)
    got = [t.clone() for t in want]
    if fault == "v row":        # the last row: pos s + 3 clamps to s - 1
        got[1][1, 2, 1, 15, 0] += 0.0625
    elif fault == "k row":
        got[0][1, 0, 1, 0, 9] *= 1.5
    elif fault == "other row":
        got[0][1, 1, 0, 8, 0] += 1
    else:
        got[1][0, 1, 0, 7, 0] += 1
    with pytest.raises(SystemExit, match="FAILED"):
        smoke.check_written_rows(torch, fault, got, want, before, pos, 1)


def _tiny_hd128(bits=8):
    import numpy as np

    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models.llama import fuse_params, quantize_params

    cfg = ModelConfig(dim=256, hidden_dim=176, n_layers=2, n_heads=2, n_kv_heads=2,
                      vocab_size=128, seq_len=32)
    rng = np.random.default_rng(2)
    L, D, H, V = 2, 256, 176, 128
    p = {n: (rng.standard_normal(s) * 0.05).astype(np.float32) for n, s in {
        "tok_embedding": (V, D), "wq": (L, D, D), "wk": (L, D, D), "wv": (L, D, D),
        "wo": (L, D, D), "w1": (L, D, H), "w2": (L, H, D), "w3": (L, D, H)}.items()}
    p.update(attn_norm=np.ones((L, D), np.float32), ffn_norm=np.ones((L, D), np.float32),
             final_norm=np.ones(D, np.float32))
    return cfg, fuse_params(quantize_params(cfg, p, bits=bits, group_size=16,
                                            dtype=torch.float32, device="cpu"), cfg)


def _count_plain(monkeypatch, mod, name, counter):
    """Make the CPU dispatch of a kernel wrapper count like its launches."""
    real = getattr(mod, name + "_plain")

    def counted(*a, **k):
        setattr(mod, counter, getattr(mod, counter) + 1)
        return real(*a, **k)

    monkeypatch.setattr(mod, name + "_plain", counted)


@pytest.mark.parametrize("bits", [8, 4])
def test_model_attn_phase_on_a_tiny_model(smoke, monkeypatch, counters, bits):
    """phase_model_attn's checks on the CPU (plain against plain, the fused
    block's one call a layer counted through its plain version)."""
    from rama_tpu_torch.models import llama
    from rama_tpu_torch.ops.kernels import attn_block as ab

    calls = {"n": 0}

    def count(name):
        real = getattr(ab, name + "_plain")

        def counted(*a, **k):
            wo_bits = a[7].bits if name == "attn_block_layered" else 8
            ab.launches[name + ("_int4" if wo_bits == 4 else "")] += 1
            ab.launches_by_body[ab.body_for(a[0].dtype)] += 1
            calls["n"] += 1
            return real(*a, **k)

        return counted

    for name in ("attn_rope_write_layered", "attn_block_layered"):
        monkeypatch.setattr(ab, name + "_plain", count(name))
    monkeypatch.setattr(llama, "ATTN_BLOCK", 0)
    cfg, params = _tiny_hd128(bits)
    smoke.phase_model_attn(torch, cfg, params, bits, dev=torch.device("cpu"))
    assert calls["n"] == 2 * cfg.n_layers    # modes 1 and 2 on the kernel path (the wrappers)
    assert llama.ATTN_BLOCK == 0


def test_prefill_t1_phase_counts_k9_and_never_reaches_plain_attention(smoke, monkeypatch,
                                                                     counters):
    from rama_tpu_torch.models import llama
    from rama_tpu_torch.ops.kernels import decode_attention as da

    _count_plain(monkeypatch, da, "decode_attention_flat", "launches_flat")
    _count_plain(monkeypatch, da, "decode_attention_flat_q8", "launches_flat_q8")
    cfg, params = _tiny_hd128()
    before = da.launches_flat, da.launches_flat_q8
    smoke.phase_prefill_t1(torch, cfg, params, dev=torch.device("cpu"))
    assert (da.launches_flat - before[0], da.launches_flat_q8 - before[1]) == (4, 4)
    assert llama._attention.__name__ == "_attention"   # restored
    # a T = 1 call that reached the plain attention fails the phase
    monkeypatch.setattr(llama, "_KERNELS", llama._PLAIN)
    monkeypatch.setattr(llama._PLAIN, "decode_attention_flat",
                        lambda q, k, v, pos: llama._attention(q[:, None], k, v, None)[:, 0])
    with pytest.raises(SystemExit, match="plain attention path"):
        smoke.phase_prefill_t1(torch, cfg, params, dev=torch.device("cpu"))


def test_k5_launch_counts_by_body_are_read_and_reset(smoke, counters):
    pa = counters[3]
    pa.launches, pa.launches_by_body["mma"], pa.launches_by_body["simt"] = 5, 3, 2
    got = smoke.read_launches(*counters)
    assert (got["prefill_attention"], got["prefill_attention_mma"],
            got["prefill_attention_simt"]) == (5, 3, 2)
    smoke.reset_launches(*counters)
    assert pa.launches_by_body == {"mma": 0, "simt": 0}


@pytest.mark.parametrize("path_name", ["INT8_PATH", "KV8_PATH", "SPEC_PATH", "SPEC_DRAFT_PATH",
                                       "PAGED_PATH", "AB2_PATH", "INT4_PATH"])
def test_a_7b_path_fails_when_k5_took_the_simt_body(smoke, path_name):
    """Every K5 launch of a 7B main path (bf16, hd 128) is on the tensor-core
    body: one launch on the SIMT body fails the path."""
    path = getattr(smoke, path_name)
    assert "prefill_attention" in path["record"]
    ok = {**{k: 64 for k in path["record"]}, **{k: 0 for k in path["forbid"]},
          "prefill_attention_mma": 64, "prefill_attention_simt": 0}
    smoke.check_launches(path, ok)
    bad = {**ok, "prefill_attention_mma": 63, "prefill_attention_simt": 1}
    with pytest.raises(SystemExit, match="took the SIMT body"):
        smoke.check_launches(path, bad)


def test_a_path_without_k5_ignores_the_body_counts(smoke):
    path = smoke.PREFILL_T1_PATH
    ok = {**{k: 32 for k in path["record"]}, **{k: 0 for k in path["forbid"]},
          "prefill_attention_mma": 0, "prefill_attention_simt": 0}
    smoke.check_launches(path, ok)


def test_profile_prefill_is_a_known_phase_and_a_subset_is_not_ok(smoke):
    assert "profile_prefill" in smoke.ALL_PHASES
    assert "profile_prefill" in smoke.INT8_PATH["after"]
    dev = {"platform": "gpu", "kind": "x", "count": 1}
    line, rc = smoke.final_line(tuple(p for p in smoke.ALL_PHASES if p != "profile_prefill"),
                                dev)
    assert line == {"ok": False, "skipped_phases": ["profile_prefill"], "device": dev}
    assert rc == smoke.PARTIAL_RC != 0


def test_quant_matmul_launch_counts_by_body_are_read_and_reset(smoke, counters):
    qm = counters[0]
    qm.launches[8], qm.launches[4] = 7, 2
    qm.launches_by_body.update(mmv=5, gemv=4, mma=3, simt=2)
    got = smoke.read_launches(*counters)
    assert (got["quant_matmul"], got["quant_matmul_int4"], got["quant_matmul_mmv"],
            got["quant_matmul_gemv"], got["quant_matmul_mma"],
            got["quant_matmul_simt"]) == (7, 2, 5, 4, 3, 2)
    smoke.reset_launches(*counters)
    assert qm.launches_by_body == {"mmv": 0, "gemv": 0, "mma": 0, "simt": 0}


@pytest.mark.parametrize("path_name", ["INT8_PATH", "KV8_PATH", "SPEC_PATH", "SPEC_DRAFT_PATH",
                                       "SPEC_KV8_PATH", "PAGED_PATH", "PAGED_KV8_PATH",
                                       "SPEC_PAGED_PATH", "SPEC_PAGED_KV8_PATH", "AB1_PATH",
                                       "AB2_PATH", "PREFILL_T1_PATH", "INT4_PATH",
                                       "AB2_INT4_PATH"])
def test_a_path_fails_when_quant_matmul_took_the_simt_body(smoke, path_name):
    """Every path runs bf16 activations: a quant_matmul launch at M > 8 on
    the SIMT body (the fp32 tiled GEMM) fails the path."""
    path = getattr(smoke, path_name)
    assert path in smoke.PATHS
    ok = _quant_matmul_ok(path)
    smoke.check_launches(path, ok)
    with pytest.raises(SystemExit, match="quant_matmul launches .* took the SIMT body"):
        smoke.check_launches(path, {**ok, "quant_matmul_mma": 63, "quant_matmul_simt": 1})


def _quant_matmul_ok(path) -> dict:
    """Launch counts that pass `path`: every kernel it records launched 64
    times, quant_matmul on the swap-AB body at M <= 8 and the GEMM above."""
    ok = {**{k: 64 for k in path["record"]}, **{k: 0 for k in path["forbid"]},
          "prefill_attention_mma": 64, "prefill_attention_simt": 0,
          "quant_matmul_mmv": 64, "quant_matmul_gemv": 0, "quant_matmul_mma": 64,
          "quant_matmul_simt": 0}
    for k, ref in path.get("equal", {}).items():
        ok[k] = ok[ref]
    return ok


@pytest.mark.parametrize("path_name", ["INT8_PATH", "KV8_PATH", "SPEC_PATH", "SPEC_DRAFT_PATH",
                                       "SPEC_KV8_PATH", "PAGED_PATH", "PAGED_KV8_PATH",
                                       "SPEC_PAGED_PATH", "SPEC_PAGED_KV8_PATH", "AB1_PATH",
                                       "AB2_PATH", "PREFILL_T1_PATH", "INT4_PATH",
                                       "AB2_INT4_PATH"])
def test_a_path_fails_when_quant_matmul_took_the_gemv(smoke, path_name):
    """Every path runs bf16 activations: one quant_matmul launch on the
    CUDA-core GEMV (the fp32 body at M <= 8) fails the path, and every path
    records the swap-AB body's count beside quant_matmul's."""
    path = getattr(smoke, path_name)
    assert path["record"]["quant_matmul_mmv"] == path["record"]["quant_matmul"]
    ok = _quant_matmul_ok(path)
    smoke.check_launches(path, ok)
    with pytest.raises(SystemExit, match="quant_matmul launches .* took the CUDA-core GEMV"):
        smoke.check_launches(path, {**ok, "quant_matmul_mmv": 63, "quant_matmul_gemv": 1})
    with pytest.raises(SystemExit, match="never launched"):
        smoke.check_launches(path, {**ok, "quant_matmul_mmv": 0})


def test_ffn_launch_counts_by_body_are_read_and_reset(smoke, counters):
    ffn = counters[1]
    ffn.launches[8], ffn.launches[4] = 5, 3
    ffn.launches_by_body.update(mma=7, simt=1)
    got = smoke.read_launches(*counters)
    assert (got["ffn"], got["ffn_int4"], got["ffn_mma"], got["ffn_simt"]) == (5, 3, 7, 1)
    smoke.reset_launches(*counters)
    assert ffn.launches_by_body == {"mma": 0, "simt": 0}


@pytest.mark.parametrize("path_name", ["INT8_PATH", "KV8_PATH", "SPEC_PATH", "SPEC_DRAFT_PATH",
                                       "SPEC_KV8_PATH", "PAGED_PATH", "PAGED_KV8_PATH",
                                       "SPEC_PAGED_PATH", "SPEC_PAGED_KV8_PATH", "AB1_PATH",
                                       "AB2_PATH", "PREFILL_T1_PATH", "INT4_PATH",
                                       "AB2_INT4_PATH"])
def test_a_path_fails_when_ffn_took_the_simt_body(smoke, path_name):
    """Every path runs bf16 activations: one ffn launch on the SIMT body
    (the fp32 GEMVs) fails the path; all on mma pass."""
    path = getattr(smoke, path_name)
    ok = {**{k: 64 for k in path["record"]}, **{k: 0 for k in path["forbid"]},
          "prefill_attention_mma": 64, "prefill_attention_simt": 0, "quant_matmul_simt": 0,
          "quant_matmul_mma": 64, "ffn_mma": 64, "ffn_simt": 0}
    for k, ref in path.get("equal", {}).items():
        ok[k] = ok[ref]
    smoke.check_launches(path, ok)
    with pytest.raises(SystemExit, match="ffn launches .* took the SIMT body"):
        smoke.check_launches(path, {**ok, "ffn_mma": 63, "ffn_simt": 1})


def test_ffn_bytes_of_7b(smoke):
    """K3's bytes at 7B: w13 and w2 of one layer with their scales, x in and
    y out; h (M, H) stays on the chip. int8 gs 64: 143.9 MB at M = 8."""
    from rama_tpu_torch.ops.quant import QuantizedTensor

    def w(k, n, gs, bits):
        rows = k // 2 if bits == 4 else k
        return QuantizedTensor(q=torch.zeros(1, rows, n, dtype=torch.int8),
                               scales=torch.ones(1, k // gs, n), group_size=gs, bits=bits)

    got = smoke.ffn_bytes(w(4096, 22016, 64, 8), w(11008, 4096, 64, 8), 8)
    want = (4096 * 22016 + 64 * 22016 * 4 + 11008 * 4096 + 172 * 4096 * 4
            + 8 * 4096 * 2 * 2)
    assert got == want and round(got / 1e6, 1) == 143.9
    got4 = smoke.ffn_bytes(w(4096, 22016, 64, 4), w(11008, 4096, 16, 4), 32)
    assert got4 == (4096 * 22016 / 2 + 64 * 22016 * 4 + 11008 * 4096 / 2 + 688 * 4096 * 4
                    + 32 * 4096 * 2 * 2)


@pytest.mark.parametrize("path_name", ["INT8_PATH", "SPEC_PATH", "INT4_PATH"])
def test_paths_that_prefill_or_verify_need_the_tensor_core_gemm(smoke, path_name):
    """The int8, int4 and speculation paths record the GEMM's launches
    (prefill chunks, verify rounds of 8 x 4 rows) and fail without any."""
    path = getattr(smoke, path_name)
    assert "quant_matmul_mma" in path["record"]
    ok = {**{k: 64 for k in path["record"]}, **{k: 0 for k in path["forbid"]},
          "prefill_attention_mma": 64, "prefill_attention_simt": 0, "quant_matmul_simt": 0}
    smoke.check_launches(path, ok)
    with pytest.raises(SystemExit, match="never launched"):
        smoke.check_launches(path, {**ok, "quant_matmul_mma": 0})


def test_gemm_record_rate_bound_and_yardstick(smoke):
    """A timed GEMM shape: TFLOP/s on the device time, the bound of the
    larger of bytes (int8 weight + f32 scales + bf16 x, y) and operations,
    the dense yardstick kept beside it."""
    from rama_tpu_torch.ops.quant import QuantizedTensor

    def w(k, n, gs, bits):
        rows = k // 2 if bits == 4 else k
        return QuantizedTensor(q=torch.zeros(2, rows, n, dtype=torch.int8),
                               scales=torch.ones(2, k // gs, n), group_size=gs, bits=bits)

    wqkv = w(4096, 12288, 64, 8)
    big = smoke.gemm_record(wqkv, 4096, ms=2.0, device_ms=1.8, plain_ms=30.0, dense_ms=0.6,
                            dense_device_ms=0.5, err=1e-3)
    flops = 2.0 * 4096 * 4096 * 12288
    assert big["bound_by"] == "operations"
    assert big["bound_ms"] == pytest.approx(flops / smoke.BF16_FLOPS * 1e3)
    assert big["tflops"] == pytest.approx(flops / 1.8e-3 / 1e12)
    assert (big["dense_ms"], big["dense_device_ms"], big["plain_ms"], big["m"]) == (
        0.6, 0.5, 30.0, 4096)
    small = smoke.gemm_record(wqkv, 32, 0.1, 0.08, 1.0, 0.04, 0.035, 1e-3)
    nbytes = 4096 * 12288 + 64 * 12288 * 4 + 32 * (4096 + 12288) * 2
    assert small["bound_by"] == "bytes"
    assert small["bound_ms"] == pytest.approx(nbytes / smoke.HBM_BYTES_PER_S * 1e3)
    w2 = smoke.gemm_record(w(11008, 4096, 16, 4), 256, 0.3, 0.25, 2.0, 0.05, 0.045, 1e-3)
    assert w2["bound_ms"] == pytest.approx(max(
        (11008 * 4096 / 2 + 688 * 4096 * 4 + 256 * (11008 + 4096) * 2) / smoke.HBM_BYTES_PER_S,
        2.0 * 256 * 11008 * 4096 / smoke.BF16_FLOPS) * 1e3)


def test_prefill_gemm_flops_of_a_7b_admission(smoke):
    """The weight products of an 8 x 512 admission of Llama-2-7B: 53.05
    TFLOP (wqkv, wo, w13, w2 of 32 layers at M = 4096)."""
    from rama_tpu_torch.config import ModelConfig

    cfg = smoke.seven_b_config(ModelConfig)
    d, h = 4096, 11008
    assert smoke.prefill_gemm_flops(cfg, 4096) == 2.0 * 4096 * 32 * (
        d * 3 * d + d * d + d * 2 * h + h * d)
    assert smoke.mma_record({})["gemm"] == {}
    assert "gemm" in smoke.mma_record({"quant_matmul_mma": {"gemm": {"a": 1}}}) and \
        smoke.mma_record({"quant_matmul_mma": {"gemm": {"a": 1}}})["gemm"] == {"a": 1}


def test_decode_attention_launch_counts_by_body_are_read_and_reset(smoke, counters):
    """The decode-attention kernel's launches by body, dense (K4, K7, K9,
    K10) and paged (K12): read as {decode_attention, paged_attention}_{mma,
    walk, simt}, set to 0 with the other counters."""
    da, pga = counters[2], counters[5]
    da.launches_by_body.update(mma=6, walk=3, simt=1)
    pga.launches_by_body.update(mma=4, walk=5, simt=2)
    got = smoke.read_launches(*counters)
    assert (got["decode_attention_mma"], got["decode_attention_walk"],
            got["decode_attention_simt"], got["paged_attention_mma"],
            got["paged_attention_walk"], got["paged_attention_simt"]) == (6, 3, 1, 4, 5, 2)
    smoke.reset_launches(*counters)
    assert da.launches_by_body == pga.launches_by_body == {"mma": 0, "walk": 0, "simt": 0}


def _attention_ok(smoke, path) -> dict:
    """Launch counts that pass `path`, every decode-attention launch on a
    tensor-core body: over an int8 cache (the _q8 entries) the walk body."""
    ok = {**_quant_matmul_ok(path), "ffn_mma": 64, "ffn_simt": 0}
    for family, (names, _) in smoke.ATTN_FAMILIES.items():
        q8 = sum(ok.get(n, 0) for n in names if n.endswith("_q8"))
        ok.update({f"{family}_mma": 64, f"{family}_walk": q8, f"{family}_simt": 0})
    return ok


@pytest.mark.parametrize("path_name,family", [
    ("INT8_PATH", "decode_attention"), ("KV8_PATH", "decode_attention"),
    ("SPEC_PATH", "decode_attention"), ("SPEC_KV8_PATH", "decode_attention"),
    ("SPEC_DRAFT_PATH", "decode_attention"), ("PREFILL_T1_PATH", "decode_attention"),
    ("INT4_PATH", "decode_attention"), ("PAGED_PATH", "paged_attention"),
    ("PAGED_KV8_PATH", "paged_attention"), ("SPEC_PAGED_PATH", "paged_attention"),
    ("SPEC_PAGED_KV8_PATH", "paged_attention")])
def test_a_path_fails_when_an_attention_launch_took_the_simt_body(smoke, path_name, family):
    """Every decode-attention launch of a 7B path (bf16 at hd 128, the
    stories draft's 48), decode step or verification chunk, is on the
    tensor-core body: one launch on the SIMT body fails the path."""
    path = getattr(smoke, path_name)
    assert set(smoke.ATTN_FAMILIES[family][0]) & set(path["record"])
    ok = _attention_ok(smoke, path)
    smoke.check_launches(path, ok)
    with pytest.raises(SystemExit, match=f"{family} launches .* took the SIMT body"):
        smoke.check_launches(path, {**ok, f"{family}_mma": 63, f"{family}_simt": 1})


@pytest.mark.parametrize("path_name,family", [
    ("KV8_PATH", "decode_attention"), ("SPEC_KV8_PATH", "decode_attention"),
    ("PREFILL_T1_PATH", "decode_attention"), ("PAGED_KV8_PATH", "paged_attention"),
    ("SPEC_PAGED_KV8_PATH", "paged_attention")])
def test_an_int8_path_fails_when_an_int8_attention_launch_missed_the_walk_body(
        smoke, path_name, family):
    """On a path over an int8 cache every _q8 launch of the decode-attention
    kernel (K7, K9, K10, K12) runs the walk body: its walk launches must
    equal the _q8 launches, one fewer fails the path."""
    path = getattr(smoke, path_name)
    ok = _attention_ok(smoke, path)
    assert ok[f"{family}_walk"] > 0
    smoke.check_launches(path, ok)
    with pytest.raises(SystemExit, match=f"{family} launches over an int8 cache"):
        smoke.check_launches(path, {**ok, f"{family}_walk": ok[f"{family}_walk"] - 1,
                                    f"{family}_mma": ok[f"{family}_mma"] + 1})


def test_walk_grid_counts_ctas_against_splits_with_work(smoke, monkeypatch):
    """The grid check of a walk launch (chip_smoke's K12 _q8 check: 8 slots,
    4096 rows of 128-row pages, 32 kv heads): the profiled grid passes when
    it has the wrapper's CTAs (one wave over the kv heads, here 660
    resident CTAs: 20 a kv head) and fails otherwise; beside it, computed,
    the splits that hold a visible row and one CTA a 64-row tile (16,384,
    of which 5,408 have a row)."""
    from rama_tpu_torch.ops.kernels import decode_attention as da

    monkeypatch.setattr(da, "walk_wave", lambda index, hd, form=8: 660)
    pos = torch.tensor([0, 127, 128, 255, 1000, 2047, 3000, 4092], dtype=torch.int32)
    assert smoke.walk_work(da, pos, 1, 4096, 32, 128) == dict(
        tile=64, tiles=4, nsplit=16, splits_with_work=(1 + 1 + 1 + 1 + 4 + 8 + 12 + 16) * 32,
        one_cta_a_tile=16384, one_cta_a_tile_with_work=169 * 32)
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    smoke.check_walk_grid(da, "k12", {"split_grid": [[20, 32, 1]], "split_ctas": 640}, pos, 1,
                          4096, 32, 128, 128)
    assert "640 CTAs launched" in lines[-1] and "1408 splits with work (computed" in lines[-1]
    smoke.check_walk_grid(da, "k12", {"split_grid": [], "split_ctas": None}, pos, 1, 4096, 32,
                          128, 128)
    assert "recorded no single split grid" in lines[-2]
    with pytest.raises(SystemExit, match="launched 16384 CTAs, the wrapper asks for 640"):
        smoke.check_walk_grid(da, "k12", {"split_grid": [[16, 32, 8]], "split_ctas": 16384},
                              pos, 1, 4096, 32, 128, 128)
    assert smoke.with_share({"split_ms": 0.03, "combine_ms": 0.01}, 0.02)["bound_share"] == \
        pytest.approx(0.5)


def test_kernel_grids_reads_the_launched_grids_of_a_trace(smoke):
    """kernel_grids takes the distinct args.grid of the kernel events whose
    name holds a split kernel's, as torch.profiler's Chrome trace gives
    them; other kernels, CPU events and events without a grid are left
    out."""
    ev = lambda name, grid, cat="kernel": {"cat": cat, "name": name,  # noqa: E731
                                          "args": {"grid": grid} if grid else {}}
    trace = {"traceEvents": [
        ev("void dattn_walk<128>(bf16 const*)", [20, 32, 1]),
        ev("void dattn_walk<128>(bf16 const*)", [20, 32, 1]),
        ev("void dattn_mma<128, false>(bf16 const*)", [16, 32, 8]),
        ev("void dattn_combine_rows<bf16>(float*)", [64, 1, 1]),
        ev("dattn_walk", [3, 3, 3], cat="cpu_op"),
        ev("void dattn_split<float, float, 1, 1>()", None),
    ]}
    assert smoke.kernel_grids(trace, smoke.ATTN_SPLIT_KERNELS) == [[16, 32, 8], [20, 32, 1]]
    assert smoke.kernel_grids({}, smoke.ATTN_SPLIT_KERNELS) == []


def test_a_path_without_the_attention_kernel_ignores_its_body_counts(smoke):
    """The attention-block paths run K14, not the decode-attention kernel:
    its body counts (of another run, say) fail nothing there."""
    path = smoke.AB2_PATH
    smoke.check_launches(path, {**_attention_ok(smoke, path), "decode_attention_simt": 3,
                                "paged_attention_simt": 3})


def test_every_record_with_bodies_carries_launches_by_body(smoke):
    """The kernels line lists launches by body for the decode-attention
    kernel's entries, as for K5, K1 and K3: each such record names a count
    prefix and bodies that read_launches reads."""
    for name in ("decode_attention", "chunk_attention", "chunk_attention_q8",
                 "decode_attention_flat_q8", "paged_decode_attention", "paged_chunk_attention_q8",
                 "prefill_attention", "quant_matmul", "ffn"):
        prefix, bodies = smoke.BODY_COUNTS[name]
        assert "mma" in bodies and "simt" in bodies


def test_on_body_fails_a_launch_on_the_other_body(smoke):
    counts = {"mma": 0, "simt": 0}

    def launch(body):
        counts[body] += 1
        return body

    assert smoke.on_body(counts, "mma", "x", lambda: launch("mma")) == "mma"
    with pytest.raises(SystemExit, match="not one on mma"):
        smoke.on_body(counts, "mma", "x", lambda: launch("simt"))


@pytest.mark.parametrize("names,body,ok", [
    (["void rama::dattn_mma<128, false>"], "mma", True),
    (["void rama::dattn_mma<48, true>", "void rama::dattn_mma<48, false>"], "mma", True),
    (["void rama::dattn_split<__nv_bfloat16, __nv_bfloat16, 16, 1>"], "mma", False),
    (["void rama::dattn_split<float, float, 16, 4>"], "simt", True),
    (["void rama::dattn_mma<128, true>"], "simt", False),
    (["void rama::dattn_walk<128>"], "walk", True),
    (["void rama::dattn_mma<128>"], "walk", False),
    (["void rama::dattn_walk<64>"], "mma", False),
    ([], "mma", True)])
def test_check_split_body_reads_the_profiled_kernel_name(smoke, names, body, ok):
    """The split kernel the profiler saw must be the body's: dattn_mma,
    dattn_walk or dattn_split. (A session with no device event at all, names [], passes
    with a log line: the launch counts by body check the body there.)"""
    parts = {"split_kernel": names}
    if ok:
        smoke.check_split_body("x", parts, body)
    else:
        with pytest.raises(SystemExit, match="split kernel"):
            smoke.check_split_body("x", parts, body)


# -- bf16-stored weight scales ---------------------------------------------------

S16_PHASES = ("kernels_s16", "model_s16", "model4_s16", "serve4_s16", "profile4_s16")


def test_s16_phases_are_known_and_a_subset_is_not_ok(smoke):
    for ph in S16_PHASES:
        assert ph in smoke.ALL_PHASES
    assert smoke.INT4_S16_PATH in smoke.PATHS
    assert smoke.INT4_S16_PATH["phases"] == ("model4_s16", "serve4_s16", "profile4_s16")
    assert smoke.INT4_S16_PATH["serve"] == {"scale_dtype": "bf16"}
    assert "model_s16" in smoke.INT8_PATH["after"]
    # the bf16-scale path follows the f32 int4 one, on the same params
    assert smoke.PATHS.index(smoke.INT4_S16_PATH) == smoke.PATHS.index(smoke.INT4_PATH) + 1
    dev = {"platform": "gpu", "kind": "x", "count": 1}
    for ph in S16_PHASES:
        line, rc = smoke.final_line(tuple(p for p in smoke.ALL_PHASES if p != ph), dev)
        assert line == {"ok": False, "skipped_phases": [ph], "device": dev}
        assert rc == smoke.PARTIAL_RC != 0


def test_scale_counts_are_read_and_reset(smoke, counters):
    qm, ffn = counters[0], counters[1]
    saved = dict(qm.launches_by_scale), dict(ffn.launches_by_scale)
    try:
        qm.launches_by_scale.update(f32=3, bf16=5)
        ffn.launches_by_scale.update(f32=2, bf16=7)
        got = smoke.read_launches(*counters)
        assert (got["quant_matmul_scale_f32"], got["quant_matmul_scale_bf16"],
                got["ffn_scale_f32"], got["ffn_scale_bf16"]) == (3, 5, 2, 7)
        smoke.reset_launches(*counters)
        assert qm.launches_by_scale == ffn.launches_by_scale == {"f32": 0, "bf16": 0}
    finally:
        qm.launches_by_scale.update(saved[0])
        ffn.launches_by_scale.update(saved[1])


def _s16_ok(path, bf16: bool) -> dict:
    """Launch counts that pass `path`: every kernel it records 64 times,
    each K1 / K2 / K3 launch on a tensor-core body and reading the path's
    scale dtype."""
    ok = {**{k: 64 for k in path["record"]}, **{k: 0 for k in path["forbid"]},
          "prefill_attention_mma": 64, "prefill_attention_simt": 0,
          "quant_matmul_mmv": 64, "quant_matmul_gemv": 0, "quant_matmul_mma": 64,
          "quant_matmul_simt": 0, "ffn_mma": 64, "ffn_simt": 0,
          "quant_matmul_scale_f32": 0 if bf16 else 128, "quant_matmul_scale_bf16":
          128 if bf16 else 0, "ffn_scale_f32": 0 if bf16 else 64,
          "ffn_scale_bf16": 64 if bf16 else 0}
    for k, ref in path.get("equal", {}).items():
        ok[k] = ok[ref]
    return ok


def test_s16_path_needs_every_matmul_and_ffn_launch_on_bf16_scales(smoke):
    """On the bf16-scale path one K1 / K2 or K3 launch that read f32 scales
    fails the path, and so does a path without a bf16-scale launch of
    either; the records take the bf16-scale counts as their launches."""
    path = smoke.INT4_S16_PATH
    assert path["scales"] == "bf16"
    assert path["record"]["quant_matmul_scale_bf16"] == "launches"
    assert path["record"]["ffn_scale_bf16"] == "launches"
    ok = _s16_ok(path, bf16=True)
    smoke.check_launches(path, ok)
    for name in ("quant_matmul", "ffn"):
        with pytest.raises(SystemExit, match="read f32 weight scales"):
            smoke.check_launches(path, {**ok, f"{name}_scale_f32": 1})
    with pytest.raises(SystemExit, match="never launched"):
        smoke.check_launches(path, {**ok, "ffn_scale_bf16": 0})


@pytest.mark.parametrize("path_name", ["INT8_PATH", "KV8_PATH", "SPEC_PATH", "SPEC_DRAFT_PATH",
                                       "SPEC_KV8_PATH", "PAGED_PATH", "PAGED_KV8_PATH",
                                       "SPEC_PAGED_PATH", "SPEC_PAGED_KV8_PATH", "AB1_PATH",
                                       "AB2_PATH", "PREFILL_T1_PATH", "INT4_PATH",
                                       "AB2_INT4_PATH"])
def test_f32_scale_paths_fail_on_a_bf16_scale_launch(smoke, path_name):
    path = getattr(smoke, path_name)
    assert path.get("scales", "f32") == "f32"
    ok = _s16_ok(path, bf16=False)
    smoke.check_launches(path, ok)
    for name in ("quant_matmul", "ffn"):
        with pytest.raises(SystemExit, match="read bf16 weight scales"):
            smoke.check_launches(path, {**ok, f"{name}_scale_bf16": 1})


def test_bytes_count_two_byte_scales(smoke):
    """Bytes and bounds of the bf16-scale forms: the same weights with
    2-byte scales (7B int4 wqkv 28.6 -> 27.0 MB at M = 8; K3' int4 84.7 ->
    76.2 MB and K3 int8 143.9 -> 139.6 MB at M = 8)."""
    from rama_tpu_torch.ops.quant import QuantizedTensor, cast_scales

    def w(k, n, gs, bits, sdtype):
        rows = k // 2 if bits == 4 else k
        return QuantizedTensor(q=torch.zeros(1, rows, n, dtype=torch.int8),
                               scales=torch.ones(1, k // gs, n, dtype=sdtype), group_size=gs,
                               bits=bits)

    for sdtype, want in ((torch.float32, 28.6), (torch.bfloat16, 27.0)):
        assert round(smoke.matmul_bytes(w(4096, 12288, 64, 4, sdtype), 8) / 1e6, 1) == want
    got = [round(smoke.ffn_bytes(w(4096, 22016, 64, bits, sd), w(11008, 4096, gs2, bits, sd),
                                 m) / 1e6, 1)
           for bits, gs2, m in ((4, 16, 8), (8, 64, 8))
           for sd in (torch.float32, torch.bfloat16)]
    assert got == [84.7, 76.2, 143.9, 139.6]
    wb = cast_scales({"w": w(4096, 4096, 64, 8, torch.float32)}, torch.bfloat16)["w"]
    assert smoke.matmul_bytes(wb, 1) == 4096 * 4096 + 64 * 4096 * 2 + 1 * 8192 * 2


@pytest.mark.parametrize("fault", [None, "not bit for bit", "f32 launch", "other body"])
def test_check_s16_needs_a_bf16_launch_equal_to_the_f32_one(smoke, fault):
    """check_s16 passes one bf16-scale launch on the expected body that
    equals the same body on scales.float() bit for bit; it fails a launch
    that differs by one ulp, one counted as an f32-scale launch, and one on
    another body."""
    bodies, scales = {"mma": 0, "simt": 0}, {"f32": 0, "bf16": 0}
    want = torch.randn(4, 16, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)

    def call(s):
        bodies["simt" if fault == "other body" else "mma"] += 1
        scales["f32" if (s == "f32" or fault == "f32 launch") else "bf16"] += 1
        if s == "bf16" and fault == "not bit for bit":
            return want + want.abs() * 2 ** -7
        return want.clone()

    if fault is None:
        smoke.check_s16(torch, "fake", call, lambda: want.float(), bodies, "mma", scales)
        return
    with pytest.raises(SystemExit, match="bit for bit|bf16-scale launch|launches by body"):
        smoke.check_s16(torch, "fake", call, lambda: want.float(), bodies, "mma", scales)


@pytest.mark.parametrize("sdtype", [torch.bfloat16, torch.float32])
def test_s16_serve_checks_the_engine_serves_bf16_scales(smoke, monkeypatch, sdtype):
    """phase_serve hands scale_dtype to the engine and fails unless the
    engine's quantized params hold scales of that dtype (an engine stand-in
    that streams two tokens a request)."""
    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models.llama import KVCache
    from rama_tpu_torch.runtime import engine as eng_mod

    cfg = ModelConfig(dim=64, hidden_dim=96, n_layers=1, n_heads=4, n_kv_heads=4,
                      vocab_size=8, seq_len=32)
    seen = {}

    class FakeEngine:
        def __init__(self, cfg, params, tokenizer, ecfg, draft=None):
            seen["scale_dtype"] = ecfg.scale_dtype
            self.cache = KVCache.create(cfg, 2, 8, device="cpu")
            self.params = {"wqkv": _quantized_leaf(sdtype), "norm": torch.ones(4)}
            self.n = 0

        def start(self):
            pass

        def stop(self):
            pass

        def submit(self, req, timeout=None):
            for tok in ("a", "b", None):
                req.queue.put(tok)
            self.n += 2

        def stats(self):
            return {"tokens_generated": self.n, "engine_errors": 0, "decode_tok_per_s": 1.0,
                    "spec_accept_rate": None, "decode_ticks": 1, "phases": {}}

    monkeypatch.setattr(eng_mod, "Engine", FakeEngine)
    if sdtype == torch.bfloat16:
        smoke.phase_serve(torch, cfg, None, None, "card", tag="serve4_s16",
                          **smoke.INT4_S16_PATH["serve"])
        assert seen["scale_dtype"] == "bf16"
    else:
        with pytest.raises(SystemExit, match="serves weight scales stored as"):
            smoke.phase_serve(torch, cfg, None, None, "card", tag="serve4_s16",
                              **smoke.INT4_S16_PATH["serve"])


@pytest.mark.parametrize("bits", [8, 4])
def test_model_s16_phase_on_a_tiny_model(smoke, bits):
    """phase_model on a tiny model with bf16-stored scales (cast_scales, as
    model_s16 / model4_s16 run it) on the CPU: the kernel path (the plain
    versions here) against the plain path."""
    from rama_tpu_torch.ops.quant import cast_scales

    import numpy as np

    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models.llama import fuse_params, quantize_params

    # the phase's prompt holds Llama token ids: a 32000-token vocabulary
    cfg = ModelConfig(dim=64, hidden_dim=176, n_layers=1, n_heads=4, n_kv_heads=2,
                      vocab_size=32000, seq_len=64)
    rng = np.random.default_rng(4)
    D, H, V = 64, 176, 32000
    p = {n: (rng.standard_normal(sh) * 0.05).astype(np.float32) for n, sh in {
        "tok_embedding": (V, D), "wq": (1, D, D), "wk": (1, D, 32), "wv": (1, D, 32),
        "wo": (1, D, D), "w1": (1, D, H), "w2": (1, H, D), "w3": (1, D, H)}.items()}
    p.update(attn_norm=np.ones((1, D), np.float32), ffn_norm=np.ones((1, D), np.float32),
             final_norm=np.ones(D, np.float32))
    params = cast_scales(fuse_params(quantize_params(cfg, p, bits=bits, group_size=16,
                                                     dtype=torch.float32, device="cpu"), cfg))
    assert params["w2"].scales.dtype == params["wcls"].scales.dtype == torch.bfloat16
    smoke.phase_model(torch, cfg, params, f"tiny int{bits} bf16-scale", dev=torch.device("cpu"))


def test_step_weight_bytes_of_7b_with_f32_and_bf16_scales(smoke):
    """A 7B decode step streams 4.053 GB of int4 weights and f32 scales
    (int8 7.020 GB); with bf16 scales 3.711 GB (int8 6.814 GB): the layer
    matrices and the int8 classifier, the embedding left out. Meta tensors:
    shapes only."""
    from rama_tpu_torch.ops.quant import QuantizedEmbedding, QuantizedTensor

    D, H, V, L = 4096, 11008, 32000, 32

    def qt(k, n, gs, bits, sdtype, lead=(L,)):
        rows = k // 2 if bits == 4 else k
        return QuantizedTensor(q=torch.empty(*lead, rows, n, dtype=torch.int8, device="meta"),
                               scales=torch.empty(*lead, k // gs, n, dtype=sdtype,
                                                  device="meta"), group_size=gs, bits=bits)

    got = {}
    for bits, gs2 in ((4, 16), (8, 64)):
        for sdtype in (torch.float32, torch.bfloat16):
            params = {"wqkv": qt(D, 3 * D, 64, bits, sdtype), "wo": qt(D, D, 64, bits, sdtype),
                      "w13": qt(D, 2 * H, 64, bits, sdtype), "w2": qt(H, D, gs2, bits, sdtype),
                      "wcls": qt(D, V, 64, 8, sdtype, lead=()),
                      "tok_embedding": QuantizedEmbedding(
                          q=torch.empty(V, D, dtype=torch.int8, device="meta"),
                          scales=torch.empty(V, D // 64, dtype=sdtype, device="meta"),
                          group_size=64),
                      "final_norm": torch.empty(D, device="meta")}
            got[bits, sdtype] = round(smoke.step_weight_bytes(params) / 1e9, 3)
    assert got == {(4, torch.float32): 4.053, (4, torch.bfloat16): 3.711,
                   (8, torch.float32): 7.020, (8, torch.bfloat16): 6.814}



# -- GQA speculation: row forms, TinyLlama -----------------------------------------

GQA_PHASES = ("kernels_gqa", "model_gqa", "serve_gqa", "serve_gqa_spec", "profile_gqa_spec",
              "serve_gqa_spec_kv8", "serve_gqa_spec_paged_kv8", "spec_gqa_self")
GQA_PATHS = ("GQA_PATH", "GQA_SPEC_PATH", "GQA_SPEC_KV8_PATH", "GQA_SPEC_PAGED_KV8_PATH",
             "GQA_SELF_PATH")


def test_gqa_phases_are_known_and_a_subset_is_not_ok(smoke):
    for ph in GQA_PHASES:
        assert ph in smoke.ALL_PHASES
    assert smoke.ALL_PHASES[-1] == "cli"
    dev = {"platform": "gpu", "kind": "x", "count": 1}
    for ph in GQA_PHASES:
        line, rc = smoke.final_line(tuple(p for p in smoke.ALL_PHASES if p != ph), dev)
        assert line == {"ok": False, "skipped_phases": [ph], "device": dev}
        assert rc == smoke.PARTIAL_RC != 0


def test_tinyllama_is_the_published_shape(smoke):
    """TinyLlama-1.1B-Chat-v1.0's config.json: GQA group 8, head_dim 64;
    its verify rounds at spec_tick 7 are 64 query rows a kv head."""
    from rama_tpu_torch.config import ModelConfig

    cfg = smoke.tinyllama_config(ModelConfig)
    assert (cfg.dim, cfg.hidden_dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.vocab_size, cfg.seq_len, cfg.shared_classifier) == (
        2048, 5632, 22, 32, 4, 32000, 2048, False)
    assert cfg.n_rep == 8 and cfg.head_dim == 64
    assert (smoke.GQA_SPEC_TICK + 1) * cfg.n_rep == 64
    assert smoke.tinyllama_config(ModelConfig, n_layers=2).n_layers == 2
    for name in GQA_PATHS:
        path = getattr(smoke, name)
        assert path in smoke.PATHS and path["model"] == "tinyllama"


def _gqa_launches(smoke, path, **over):
    return {**{k: 4 for k in path["record"]}, **{k: 0 for k in path["forbid"]}, **over}


@pytest.mark.parametrize("name", ["GQA_SPEC_PATH", "GQA_SPEC_KV8_PATH",
                                  "GQA_SPEC_PAGED_KV8_PATH", "GQA_SELF_PATH"])
def test_gqa_spec_paths_need_every_chunk_launch_in_a_wide_form(smoke, name):
    """A GQA verify round runs its chunk attention in a form of more than 8
    rows (the `*_gqa` record's count by body and form): the path passes when every
    launch of the chunk wrapper did, and fails when one ran the 8-row form
    or when the wrapper never launched."""
    path = getattr(smoke, name)
    (gqa, wrapper), = [(k, v) for k, v in path["equal"].items() if k.endswith("_gqa")]
    smoke.check_launches(path, _gqa_launches(smoke, path))
    with pytest.raises(SystemExit, match="as often as"):
        smoke.check_launches(path, _gqa_launches(smoke, path, **{gqa: 3}))
    with pytest.raises(SystemExit, match="never launched"):
        smoke.check_launches(path, _gqa_launches(smoke, path, **{gqa: 0, wrapper: 0}))


def test_ffn_launch_counts_by_form_are_read_and_reset(smoke, counters):
    """K3's calls by form ("one": M <= 64 rows in one CTA; "rows": row
    blocks) are read as ffn_one / ffn_rows and set to 0 with the rest."""
    ffn = counters[1]
    ffn.launches_by_form.update(one=6, rows=2)
    got = smoke.read_launches(*counters)
    assert (got["ffn_one"], got["ffn_rows"]) == (6, 2)
    smoke.reset_launches(*counters)
    assert ffn.launches_by_form == {"one": 0, "rows": 0}


# path, K3's form on it, the count that K3 launches in that form must equal
# (one a layer of every step or verify round), the form it must not run
_K3_FORM_PATHS = [("B64_PATH", "ffn_one", "decode_attention", "ffn_rows"),
                  ("B64_SPEC_PATH", "ffn_rows", "chunk_attention", None),
                  ("GQA_SPEC_PATH", "ffn_one", "chunk_attention", "ffn_rows"),
                  ("GQA_SPEC_PAGED_KV8_PATH", "ffn_one", "paged_chunk_attention_q8",
                   "ffn_rows")]


@pytest.mark.parametrize("name,form,per,other", _K3_FORM_PATHS)
def test_wide_paths_need_k3_once_a_layer_of_every_step_in_its_form(smoke, name, form, per,
                                                                   other):
    """The 64-slot 7B paths (decode steps at M = 64: the "one" form; verify
    rounds of 4 at M = 256: "rows") and TinyLlama's rounds of 8 (M = 64,
    "one") pass when K3 launched in its form as often as the attention of
    the steps or rounds (once a layer); a step or round that took the split
    w13 / w2 route (one fewer) or a launch in the other form fails them."""
    path = getattr(smoke, name)
    assert path in smoke.PATHS and path["equal"][form] == per
    ok = {**_gqa_launches(smoke, path), "ffn_one": 0, "ffn_rows": 0, "decode_attention": 0}
    ok.update({form: 4, per: 4, **{k: 4 for k in path["record"]}})
    smoke.check_launches(path, ok)
    with pytest.raises(SystemExit, match="split w13 / w2 route"):
        smoke.check_launches(path, {**ok, form: 3})
    if other is not None:
        with pytest.raises(SystemExit, match="launched on"):
            smoke.check_launches(path, {**ok, other: 1})
    if name.startswith("B64"):
        assert "quant_matmul_mmv" not in path["record"] and path["serve"]["slots"] == 64


@pytest.mark.parametrize("name", ["INT8_PATH", "SPEC_PATH", "SPEC_PAGED_KV8_PATH"])
def test_a_7b_path_fails_on_a_decode_attention_launch_in_a_wide_form(smoke, name):
    """Every Llama-2-7B launch (rep 1, T <= 8) keeps the 8-row form: a
    count in another form fails the path; a GQA path may run them."""
    path = getattr(smoke, name)
    ok = {k: 4 for k in path["record"]} | {k: 0 for k in path["forbid"]}
    ok |= {"decode_attention_mma_rows8": 4, "decode_attention_walk_rows8": 4,
           "paged_attention_walk_rows8": 4}
    smoke.check_launches(path, ok)
    for wide in ("decode_attention_mma_rows16", "decode_attention_walk_rows32",
                 "paged_attention_walk_rows64"):
        with pytest.raises(SystemExit, match="8-row form"):
            smoke.check_launches(path, {**ok, wide: 1})
    gqa = smoke.GQA_SPEC_PATH
    smoke.check_launches(gqa, {**_gqa_launches(smoke, gqa), "decode_attention_mma_rows64": 4})


def test_launches_by_form_are_read_and_reset(smoke, counters):
    """The `*_gqa` records are separate counts: the dense wrappers' wide
    launches on the mma body (bf16 cache) and on the walk body (int8), and
    the paged wrappers' on the walk body."""
    _, _, da, _, _, pga, _ = counters
    da.launches_by_form["mma"].update({8: 1, 16: 2, 32: 3, 64: 4})
    da.launches_by_form["walk"].update({8: 7, 16: 0, 32: 5, 64: 0})
    pga.launches_by_form["mma"].update({8: 0, 16: 0, 32: 0, 64: 3})
    pga.launches_by_form["walk"].update({8: 5, 16: 0, 32: 0, 64: 6})
    got = smoke.read_launches(*counters)
    assert got["decode_attention_mma_rows16"] == 2 and got["paged_attention_walk_rows64"] == 6
    assert got["decode_attention_walk_rows8"] == 7
    assert got["chunk_attention_gqa"] == 9 and got["chunk_attention_q8_gqa"] == 5
    assert got["paged_chunk_attention_q8_gqa"] == 6
    smoke.reset_launches(*counters)
    for mod in (da, pga):
        assert not any(n for forms in mod.launches_by_form.values() for n in forms.values())
    for name in ("chunk_attention_gqa", "paged_chunk_attention_q8_gqa", "decode_attention"):
        assert name in smoke.FORM_COUNTS


def test_on_form_fails_a_launch_in_another_form(smoke):
    counts = {"mma": 0, "walk": 0, "simt": 0}
    forms = {"mma": {8: 0, 64: 0}, "walk": {8: 0, 64: 0}}

    def launch(form, body="mma"):
        counts["mma"] += 1
        forms[body][form] += 1
        return form

    assert smoke.on_form(counts, forms, "mma", 64, "x", lambda: launch(64)) == 64
    with pytest.raises(SystemExit, match="not one in the mma body's 64-row form"):
        smoke.on_form(counts, forms, "mma", 64, "x", lambda: launch(8))
    with pytest.raises(SystemExit, match="not one in the mma body's 64-row form"):
        smoke.on_form(counts, forms, "mma", 64, "x", lambda: launch(64, "walk"))


@pytest.mark.parametrize("names,ok", [
    (["void rama::dattn_mma<64, 64>"], True), (["void rama::dattn_walk<64, 64>"], True),
    (["void rama::dattn_mma<64, 8>"], False), (["void rama::dattn_mma<128, 64>"], False),
    ([], True), (["void rama::dattn_walk<64, 64, false>"], True),
    (["void rama::dattn_walk<64, 64, true>"], True), (["void rama::dattn_walk<64, 8, true>"], False)])
def test_check_split_form_reads_the_template_arguments(smoke, names, ok):
    parts = {"split_kernel": names}
    if ok:
        smoke.check_split_form("x", parts, 64, 64)
    else:
        with pytest.raises(SystemExit, match="64-row form"):
            smoke.check_split_form("x", parts, 64, 64)


@pytest.mark.parametrize("q8", [False, True])
def test_planted_gqa_edges_score_for_each_groups_first_head(smoke, q8):
    """plant_chunk_edges under GQA (8 heads over 2 kv heads) plants each
    group's first head's key: a kernel that reads one row past a query's
    limit moves that head's output by tens of percent (the plain version
    with the limit shifted by one fails compare), as at rep 1."""
    from rama_tpu_torch.ops.kernels import decode_attention as da

    g = torch.Generator().manual_seed(3)
    b, t, nh, nkv, s, hd = 2, 4, 8, 2, 96, 64
    q = torch.randn(b, t, nh, hd, generator=g)
    k, v = torch.randn(1, b, nkv, s, hd, generator=g), torch.randn(1, b, nkv, s, hd, generator=g)
    pos0 = torch.tensor([10, 60], dtype=torch.int32)
    key = smoke.group_key(q[0, 0], nkv)
    assert torch.equal(key, q[0, 0, ::4]) and smoke.group_key(q[0, 0, :2], 2) is not None
    if q8:
        (k8, ks), (v8, vs) = kvw.kv_quant_rows(k), kvw.kv_quant_rows(v)
        cache, plain = [k8, v8, ks, vs], da.chunk_attention_q8_plain
    else:
        cache, plain = [k, v], da.chunk_attention_plain
    smoke.plant_chunk_edges(q, cache, pos0, 0, [63, 64], kvw if q8 else None)
    want = plain(q, *cache, pos0, 0)
    smoke.compare(torch, "same", plain(q, *cache, pos0, 0), want, per=hd)
    with pytest.raises(SystemExit, match="rel err"):
        smoke.compare(torch, "one row past", plain(q, *cache, pos0 + 1, 0), want, per=hd)


# -- Yi-34B: kernel 5 at GQA group 7 ------------------------------------------------

YI_PHASES = ("model_yi", "serve_yi", "profile_prefill_yi", "serve_yi_kv8", "serve_yi_spec",
             "serve_yi_ab2")
YI_PATHS = ("YI_PATH", "YI_KV8_PATH", "YI_SPEC_PATH", "YI_AB2_PATH")


def test_yi_phases_are_known_and_a_subset_is_not_ok(smoke):
    assert smoke.ALL_PHASES[-1] == "cli"
    dev = {"platform": "gpu", "kind": "x", "count": 1}
    for ph in YI_PHASES:
        assert ph in smoke.ALL_PHASES
        line, rc = smoke.final_line(tuple(p for p in smoke.ALL_PHASES if p != ph), dev)
        assert line == {"ok": False, "skipped_phases": [ph], "device": dev}
        assert rc == smoke.PARTIAL_RC != 0
    assert {ph for name in YI_PATHS for ph in getattr(smoke, name)["phases"]} - {None} == set(
        YI_PHASES)


def test_yi34b_is_the_published_shape(smoke):
    """Yi-34B's config.json (HF 01-ai/Yi-34B): GQA group 7 (56 heads over 8),
    head_dim 128, vocab 64000, rope_theta 5e6, untied; its verify rounds at
    spec_tick 3 are 28 query rows a kv head (the 32-row chunk form)."""
    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.ops.kernels import decode_attention as da

    cfg = smoke.yi34b_config(ModelConfig)
    assert (cfg.dim, cfg.hidden_dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.vocab_size, cfg.seq_len, cfg.shared_classifier, cfg.rope_theta,
            cfg.norm_eps) == (7168, 20480, 60, 56, 8, 64000, 4096, False, 5e6, 1e-5)
    assert cfg.n_rep == 7 and cfg.head_dim == 128
    assert da.row_form(smoke.SPEC_TICK + 1, cfg.n_rep) == (32, 1)
    assert smoke.yi34b_config(ModelConfig, n_layers=2).n_layers == 2
    for name in YI_PATHS:
        path = getattr(smoke, name)
        assert path in smoke.PATHS and path["model"] == "yi"
        assert path["equal"]["prefill_attention_gqa"] == "prefill_attention"


def _yi_launches(path, **over):
    return {**{k: 4 for k in path["record"]}, **{k: 0 for k in path["forbid"]},
            "prefill_attention_mma": 4, "prefill_attention_simt": 0, **over}


@pytest.mark.parametrize("name", YI_PATHS)
def test_yi_paths_need_every_k5_launch_on_mma_in_the_gqa_form(smoke, name):
    """A Yi-34B path passes when every K5 launch ran the tensor-core body in
    its gqa form, and fails when one ran the div64 form (fewer gqa launches
    than K5 launches), the SIMT body, or when K5 never launched."""
    path = getattr(smoke, name)
    smoke.check_launches(path, _yi_launches(path))
    with pytest.raises(SystemExit, match="as often as"):
        smoke.check_launches(path, _yi_launches(path, prefill_attention_gqa=3))
    with pytest.raises(SystemExit, match="took the SIMT body"):
        smoke.check_launches(path, _yi_launches(path, prefill_attention_mma=3,
                                                prefill_attention_simt=1))
    with pytest.raises(SystemExit, match="never launched"):
        smoke.check_launches(path, _yi_launches(path, prefill_attention_gqa=0,
                                                prefill_attention=0))


@pytest.mark.parametrize("name", ["INT8_PATH", "KV8_PATH", "SPEC_PATH", "AB2_PATH", "GQA_PATH",
                                  "GQA_SPEC_KV8_PATH"])
def test_7b_and_tinyllama_paths_fail_on_a_k5_launch_in_the_gqa_form(smoke, name):
    """Llama-2-7B (group 1) and TinyLlama (group 8) run K5's div64 form: a
    gqa-form launch on their paths is a fault."""
    path = getattr(smoke, name)
    ok = _yi_launches(path, prefill_attention_gqa=0)
    smoke.check_launches(path, ok)
    with pytest.raises(SystemExit, match="does not divide 64"):
        smoke.check_launches(path, {**ok, "prefill_attention_gqa": 1})


def test_k5_launch_counts_by_form_are_read_and_reset(smoke, counters):
    pa = counters[3]
    pa.launches, pa.launches_by_form["div64"], pa.launches_by_form["gqa"] = 9, 4, 5
    assert smoke.read_launches(*counters)["prefill_attention_gqa"] == 5
    smoke.reset_launches(*counters)
    assert pa.launches_by_form == {"div64": 0, "gqa": 0}
    assert smoke.BODY_COUNTS["prefill_attention_gqa"][0] == "prefill_attention"


def test_wide_tokenizer_keeps_the_fixture_and_decodes_every_id(smoke, tmp_path):
    """Yi-34B's 64000-piece tokenizer file: the fixture's 32000 pieces and
    scores, then pieces that no merge takes; the serving prompts tokenize
    as with the fixture, and every id decodes."""
    from rama_tpu_torch.tokenizer import Tokenizer

    src = ROOT / "tests" / "fixtures" / "tokenizer.bin"
    base = Tokenizer.from_file(src, 32000)
    wide = Tokenizer.from_file(smoke.write_wide_tokenizer(src, tmp_path / "t.bin", 64000), 64000)
    assert wide.vocab[:32000] == base.vocab and wide.scores[:32000] == base.scores
    assert len(set(wide.vocab[32000:])) == 32000 and not set(wide.vocab[32000:]) & set(base.vocab)
    for prompt in ("Once upon a time", "The little dog", "In a far away land",
                   "She opened the door", "Tom and Lily", "The sun was", "A big red ball",
                   "One day", "<extra_5> and <extra_31999>"):
        assert wide.encode(prompt, strict=False) == base.encode(prompt, strict=False)
    assert all(isinstance(wide.decode_token(i), str) for i in range(64000))
    assert wide.decode_token(63999) == "<extra_31999>"


@pytest.mark.parametrize("t,bq", [(1, 9), (9, 9), (65, 9), (512, 21), (63, 1), (64, 5)])
def test_k5_plens_sit_on_the_q_tiles_edges(smoke, t, bq):
    plens = smoke.k5_plens(t, bq)
    assert all(1 <= p <= t for p in plens) and plens[0] == t
    assert min(bq, t) in plens and min(bq + 1, t) in plens and (t // bq) * bq in plens + [0]


def test_model_yi_phase_on_a_tiny_group7_model(smoke, monkeypatch, counters):
    """phase_model_yi's checks on the CPU on a group-7 model (7 heads over 1
    kv head, head_dim 64, 2 layers; plain against plain): its padded
    prefill reaches K5 once a layer."""
    import numpy as np

    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models.llama import fuse_params, quantize_params
    from rama_tpu_torch.ops.kernels import prefill_attention as pa

    cfg = ModelConfig(dim=448, hidden_dim=176, n_layers=2, n_heads=7, n_kv_heads=1,
                      vocab_size=128, seq_len=64)
    rng = np.random.default_rng(5)
    L, D, H, V = 2, 448, 176, 128
    p = {n: (rng.standard_normal(s) * 0.05).astype(np.float32) for n, s in {
        "tok_embedding": (V, D), "wq": (L, D, D), "wk": (L, D, 64), "wv": (L, D, 64),
        "wo": (L, D, D), "w1": (L, D, H), "w2": (L, H, D), "w3": (L, D, H)}.items()}
    p.update(attn_norm=np.ones((L, D), np.float32), ffn_norm=np.ones((L, D), np.float32),
             final_norm=np.ones(D, np.float32))
    params = fuse_params(quantize_params(cfg, p, bits=8, group_size=16, dtype=torch.float32,
                                         device="cpu"), cfg)
    _count_plain(monkeypatch, pa, "prefill_attention", "launches")
    before = pa.launches
    smoke.phase_model_yi(torch, cfg, params, dev=torch.device("cpu"))
    assert pa.launches - before == cfg.n_layers    # the kernel path's prefill, once a layer


# -- Mistral-Large-Instruct-2407: K14 at GQA group 12 --------------------------------

ML_PHASES = ("model_ml", "serve_ml", "serve_ml_ab1", "serve_ml_ab2", "profile_ml_ab")
ML_PATHS = ("ML_PATH", "ML_AB1_PATH", "ML_AB2_PATH")


def test_ml_phases_are_known_and_a_subset_is_not_ok(smoke):
    assert smoke.ALL_PHASES[-1] == "cli"
    dev = {"platform": "gpu", "kind": "x", "count": 1}
    for ph in ML_PHASES:
        assert ph in smoke.ALL_PHASES
        line, rc = smoke.final_line(tuple(p for p in smoke.ALL_PHASES if p != ph), dev)
        assert line == {"ok": False, "skipped_phases": [ph], "device": dev}
        assert rc == smoke.PARTIAL_RC != 0
    assert {ph for name in ML_PATHS for ph in getattr(smoke, name)["phases"]} - {None} == set(
        ML_PHASES)
    # after every other model: the Yi-34B paths' params are freed first
    order = [path.get("model", "7b") for path in smoke.PATHS]
    assert order[-3:] == ["ml"] * 3 and "ml" not in order[:-3]


def test_mistral_large_is_the_published_shape(smoke):
    """Mistral-Large-Instruct-2407's config.json: GQA group 12 (96 heads
    over 8), head_dim 128, 88 layers, vocab 32768, rope_theta 1e6, untied;
    its T = 1 decode attention and K14 run the 16-row form; every layer
    weight is int4 at gs 64, and the params (int4 bytes, f32 scales, the
    int8 embedding and classifier with their scales) come to ~69.4 GB."""
    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.ops.kernels import attn_block as ab
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.quant import pick_int4_group_size

    cfg = smoke.mistral_large_config(ModelConfig)
    assert (cfg.dim, cfg.hidden_dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.vocab_size, cfg.seq_len, cfg.shared_classifier, cfg.rope_theta,
            cfg.norm_eps) == (12288, 28672, 88, 96, 8, 32768, 131072, False, 1e6, 1e-5)
    assert cfg.n_rep == 12 and cfg.head_dim == 128
    assert da.row_form(1, cfg.n_rep) == (16, 1) == ab.form_for(torch.bfloat16, cfg.n_rep)
    D, H, L, V = cfg.dim, cfg.hidden_dim, cfg.n_layers, cfg.vocab_size
    shapes = ((D, (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim), (D, D), (D, 2 * H),
              (H, D))
    assert {pick_int4_group_size(k, 64) for k, _ in shapes} == {64}
    weights = sum(L * k * n // 2 + L * k // 64 * n * 4 for k, n in shapes)
    embed = 2 * (V * D + V * D // 64 * 4)
    assert 69.0e9 < weights + embed < 69.8e9
    assert smoke.mistral_large_config(ModelConfig, n_layers=2).n_layers == 2
    for name in ML_PATHS:
        path = getattr(smoke, name)
        assert path["model"] == "ml" and path["bits"] == 4
        assert path["serve"] == {"max_seq_len": smoke.ML_MAX_LEN} and smoke.ML_MAX_LEN == 512
        assert path["equal"]["prefill_attention_gqa"] == "prefill_attention"


def _ml_launches(path, **over):
    return {**{k: 88 for k in path["record"]}, **{k: 0 for k in path["forbid"]},
            "prefill_attention_mma": 88, "prefill_attention_simt": 0,
            "attn_block_mma": 88, "attn_block_mma_rows16": 88, **over}


def test_ml_path_needs_every_k4_launch_in_the_16_row_form(smoke):
    path = smoke.ML_PATH
    smoke.check_launches(path, _ml_launches(path))
    with pytest.raises(SystemExit, match="as often as"):
        smoke.check_launches(path, _ml_launches(path, decode_attention_mma_rows16=87))
    with pytest.raises(SystemExit, match="launched on the Mistral-Large int4 main"):
        smoke.check_launches(path, _ml_launches(path, decode_attention_mma_rows8=1))
    with pytest.raises(SystemExit, match="launched on the Mistral-Large int4 main"):
        smoke.check_launches(path, _ml_launches(path, attn_block_layered_int4=88))


@pytest.mark.parametrize("name,fused", [("ML_AB1_PATH", "attn_rope_write_layered"),
                                        ("ML_AB2_PATH", "attn_block_layered_int4")])
def test_ml_attention_block_paths_need_every_k14_launch_in_the_16_row_form(smoke, name, fused):
    """Under RAMA_ATTN_BLOCK 1 / 2 every Mistral-Large decode step runs K14
    once a layer (as often as K3), each launch in the 16-row form
    (attn_block_gqa and attn_block_mma_rows16 as many), K4 never, the SIMT
    body never."""
    path = getattr(smoke, name)
    smoke.check_launches(path, _ml_launches(path))
    for bad, match in (({"attn_block_gqa": 87}, "as often as"),
                       ({"attn_block_mma_rows16": 80}, "as often as"),
                       ({fused: 87}, "as often as"),
                       ({"decode_attention": 88}, r"\['decode_attention'\] launched"),
                       ({"attn_block_simt": 1}, "launched on the Mistral"),
                       ({fused: 0, "attn_block_gqa": 0, "attn_block_mma_rows16": 0,
                         "ffn_int4": 0}, "never launched")):
        with pytest.raises(SystemExit, match=match):
            smoke.check_launches(path, _ml_launches(path, **bad))


@pytest.mark.parametrize("name", ["AB1_PATH", "AB2_PATH", "AB2_INT4_PATH", "YI_AB2_PATH"])
def test_7b_and_yi_attention_block_paths_fail_on_a_k14_launch_in_a_wide_form(smoke, name):
    """Llama-2-7B (group 1) and Yi-34B (group 7) run K14's 8-row form, the
    parent's code: a launch in a form of more than 8 rows fails them."""
    path = getattr(smoke, name)
    ok = {**{k: 64 for k in path["record"]}, **{k: 0 for k in path["forbid"]},
          "prefill_attention_mma": 64, "prefill_attention_simt": 0}
    smoke.check_launches(path, ok)
    with pytest.raises(SystemExit, match=r"\['attn_block_gqa'\] launched"):
        smoke.check_launches(path, {**ok, "attn_block_gqa": 1})


def test_k14_launch_counts_by_form_are_read_and_reset(smoke, counters):
    ab = counters[-1]
    ab.launches_by_form["mma"].update({8: 3, 16: 88, 64: 2})
    ab.launches_by_form["simt"][8] = 4
    got = smoke.read_launches(*counters)
    assert (got["attn_block_mma_rows8"], got["attn_block_mma_rows16"],
            got["attn_block_mma_rows64"], got["attn_block_simt_rows8"]) == (3, 88, 2, 4)
    assert got["attn_block_gqa"] == 90      # the mma forms of more than 8 rows
    assert smoke.BODY_COUNTS["attn_block_gqa"] == ("attn_block", ("mma", "simt"))
    smoke.reset_launches(*counters)
    assert not any(n for forms in ab.launches_by_form.values() for n in forms.values())


def test_random_int4_weight_is_made_a_layer_at_a_time(smoke):
    """random_int4_qt fills the stacked tensors layer by layer: every layer
    drawn (no layer left as the empty tensor's bytes), nibbles in [-7, 7],
    scales in the ~N(0, 1/K) range."""
    from rama_tpu_torch.ops.quant import unpack_int4

    g = torch.Generator().manual_seed(3)
    w = smoke.random_int4_qt(torch, 3, 256, 128, 64, torch.device("cpu"), g)
    vals = unpack_int4(w.q, w.group_size)
    assert vals.shape == (3, 256, 128) and int(vals.min()) == -7 and int(vals.max()) == 7
    lo, hi = 0.5 / (smoke.INT4_STD * 16), 1.5 / (smoke.INT4_STD * 16)
    assert bool(((w.scales >= lo) & (w.scales <= hi)).all())
    assert all(float(vals[i].float().std()) > 3 for i in range(3))
    assert not torch.equal(w.q[0], w.q[1])


def test_model_ml_phase_on_a_tiny_group12_model(smoke, monkeypatch, counters):
    """phase_model_ml's checks on the CPU on a group-12 model (12 heads over
    1 kv head, head_dim 128, 2 layers, int4; plain against plain, the plain
    versions counted as the card's launches in the 16-row form): K5 once a
    layer, K4 once a layer of the mode-0 step, K14 once a layer under modes
    1 and 2, a non-degenerate greedy run."""
    import numpy as np

    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models import llama
    from rama_tpu_torch.models.llama import fuse_params, quantize_params
    from rama_tpu_torch.ops.kernels import attn_block as ab
    from rama_tpu_torch.ops.kernels import decode_attention as da
    from rama_tpu_torch.ops.kernels import prefill_attention as pa
    from rama_tpu_torch.tokenizer import Tokenizer

    cfg = ModelConfig(dim=1536, hidden_dim=176, n_layers=2, n_heads=12, n_kv_heads=1,
                      vocab_size=128, seq_len=64)
    rng = np.random.default_rng(12)
    L, D, H, V = 2, 1536, 176, 128
    p = {n: (rng.standard_normal(s) * 0.05).astype(np.float32) for n, s in {
        "tok_embedding": (V, D), "wq": (L, D, D), "wk": (L, D, 128), "wv": (L, D, 128),
        "wo": (L, D, D), "w1": (L, D, H), "w2": (L, H, D), "w3": (L, D, H)}.items()}
    p.update(attn_norm=np.ones((L, D), np.float32), ffn_norm=np.ones((L, D), np.float32),
             final_norm=np.ones(D, np.float32))
    params = fuse_params(quantize_params(cfg, p, bits=4, group_size=16, dtype=torch.float32,
                                         device="cpu"), cfg)
    chars = sorted(set("Once upon a time"))
    vocab = ["<unk>", "<s>", "</s>"] + chars + [f"x{i}" for i in range(V - 3 - len(chars))]
    tok = Tokenizer(vocab, [0.0] * V, max_token_length=4)

    def count(mod, name, key, by_form):
        real = getattr(mod, name + "_plain")

        def counted(*a, **k):
            if isinstance(mod.launches, dict):
                mod.launches[key(a)] += 1
            else:
                mod.launches += 1
            by_form["mma"][16] += 1
            return real(*a, **k)

        monkeypatch.setattr(mod, name + "_plain", counted)

    count(da, "decode_attention", None, da.launches_by_form)
    count(ab, "attn_rope_write_layered", lambda a: "attn_rope_write_layered",
          ab.launches_by_form)
    count(ab, "attn_block_layered", lambda a: "attn_block_layered" + (
        "_int4" if a[7].bits == 4 else ""), ab.launches_by_form)
    _count_plain(monkeypatch, pa, "prefill_attention", "launches")
    monkeypatch.setattr(llama, "ATTN_BLOCK", 0)
    before = pa.launches, da.launches, ab.launches["attn_block_layered_int4"]
    smoke.phase_model_ml(torch, cfg, params, tok, dev=torch.device("cpu"))
    assert pa.launches - before[0] >= cfg.n_layers     # the kernel path's prefill, a layer
    assert da.launches - before[1] >= cfg.n_layers
    assert ab.launches["attn_block_layered_int4"] - before[2] == cfg.n_layers
    assert llama.ATTN_BLOCK == 0


@pytest.mark.parametrize("written", [False, True])
def test_attention_bytes_count_a_launchs_own_new_rows_once(smoke, written):
    """A T-query chunk attention reads each slot's rows 0 .. min(pos0 + T -
    1, S - 1) once; where the same launch writes the chunk's rows
    (`written`, the int8 walk given k_new / v_new) their bytes are the
    writer's (write_bytes) and none of them is read back: rows at or past
    S are neither written nor read. Slots at 0, mid-cache, reaching S and
    wholly past it, T 4, S 64."""
    pos0 = torch.tensor([0, 10, 62, 70], dtype=torch.int32)
    nb, ops = smoke.attention_bytes_ops(pos0, 4, 64, 2, 4, 16, 40.0, 100.0, written=written)
    read = [4, 14, 64, 64]
    new = [4, 4, 2, 0]
    rows = sum(r - n for r, n in zip(read, new)) if written else sum(read)
    assert nb == rows * 2 * 40.0 + 200.0
    assert ops == sum(min(p + i, 63) + 1 for p in (0, 10, 62, 70) for i in range(4)) * 4 * 16 * 4


@pytest.mark.parametrize("path_name", ["KV8_PATH", "SPEC_KV8_PATH", "YI_KV8_PATH",
                                       "GQA_SPEC_KV8_PATH", "WARMUP_PATH"])
def test_dense_int8_paths_run_every_k8_launch_on_the_streaming_body(smoke, path_name):
    """On every dense int8-cache path K8 (write_kv_strips_q8) launches its
    streaming body only: its stream count equals its total, its warp-a-row
    body never launches, and both counts go to K8's record."""
    path = getattr(smoke, path_name)
    ok = {**{k: 3 for k in path["record"]}, **{k: 0 for k in path["forbid"]}}
    smoke.check_launches(path, ok)
    assert path["equal"]["write_kv_strips_q8_stream"] == "write_kv_strips_q8"
    assert smoke.RECORD_OF["write_kv_strips_q8_rows"] == "write_kv_strips_q8"
    assert smoke.BODY_COUNTS["write_kv_strips_q8"] == ("write_kv_strips_q8", ("stream", "rows"))
    with pytest.raises(SystemExit, match=r"\['write_kv_strips_q8_rows'\] launched"):
        smoke.check_launches(path, {**ok, "write_kv_strips_q8_rows": 1})
    with pytest.raises(SystemExit, match="launches of the kernel"):
        smoke.check_launches(path, {**ok, "write_kv_strips_q8_stream": 2})


def test_k8_counts_by_body_are_read_and_reset(smoke, counters):
    kvw.strips_launches_by_body.update(stream=5, rows=2)
    try:
        got = smoke.read_launches(*counters)
        assert (got["write_kv_strips_q8_stream"], got["write_kv_strips_q8_rows"]) == (5, 2)
        smoke.reset_launches(*counters)
        assert kvw.strips_launches_by_body == {"stream": 0, "rows": 0}
    finally:
        kvw.strips_launches_by_body.update(stream=0, rows=0)


def test_warmup_path_is_the_int8_kv_path_after_warmup(smoke):
    """serve_warmup serves serve_kv8's engine settings in a fresh process
    after warmup(max_prompt=64), judged by the int8 KV path's kernels."""
    w, kv8 = smoke.WARMUP_PATH, smoke.KV8_PATH
    assert w["phases"] == (None, "serve_warmup", None) and "serve_warmup" in smoke.ALL_PHASES
    assert w["serve"] == kv8["serve"] and w["warmup"] == 64
    assert set(w["record"]) == set(kv8["record"]) and set(w["forbid"]) == set(kv8["forbid"])
    assert w["equal"] == kv8["equal"]
    assert smoke.PATHS.index(w) == smoke.PATHS.index(kv8) + 1   # on the same params


def test_warm_up_and_warm_checked_on_a_cpu_engine(smoke, monkeypatch):
    """warm_up refuses a process that built or loaded a library before the
    warmup, and one whose warmup did not load every library; warm_checked
    refuses a library loaded after it and a prefill bucket served cold
    (on the CPU the loads are stood in for)."""
    from rama_tpu.testing.ref_model import random_params, tiny_config

    from _torch_port import torch_cfg
    from rama_tpu_torch.config import EngineConfig
    from rama_tpu_torch.models.llama import load_params
    from rama_tpu_torch.ops.kernels import build
    from rama_tpu_torch.runtime.engine import Engine, Request
    from rama_tpu_torch.tokenizer import Tokenizer

    jcfg = tiny_config(seq_len=64)
    cfg = torch_cfg(jcfg)
    params = load_params(cfg, random_params(jcfg, seed=3), dtype=torch.float32, device="cpu")
    vocab = ["<unk>", "<s>", "</s>"] + [f"t{i}" for i in range(cfg.vocab_size - 3)]
    tok = Tokenizer(vocab, [0.0] * cfg.vocab_size, max_token_length=4)
    counts = {"builds": 0, "loads": 0}
    monkeypatch.setattr(build, "counts", counts)
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=2))
    with pytest.raises(SystemExit, match="warmup left"):
        smoke.warm_up(eng, 20, "t")     # a CPU engine loads no library
    counts["loads"] = 1
    with pytest.raises(SystemExit, match="before warmup"):
        smoke.warm_up(Engine(cfg, params, tok, EngineConfig(max_batch_size=2)), 20, "t")
    counts["loads"] = 0
    eng = Engine(cfg, params, tok, EngineConfig(max_batch_size=2))
    warmup = eng.warmup

    def loading_warmup(max_prompt=None):   # as an engine on the card loads them
        counts["loads"] = len(build.SOURCES)
        return warmup(max_prompt)

    eng.warmup = loading_warmup
    warm = smoke.warm_up(eng, 20, "t")
    assert warm["warmed"] == [(2, 16), (2, 32)] and warm["programs"] == 6
    eng.start()
    try:
        req = eng.submit(Request(prompt="", steps=3, temperature=0.0))
        while req.queue.get(timeout=60) is not None:
            pass
    finally:
        eng.stop()
    assert smoke.warm_checked(dict(warm), "t")["served"] == [(2, 16)]
    with pytest.raises(SystemExit, match="served cold"):
        smoke.warm_checked(dict(warm, served=[(2, 16), (2, 64)]), "t")
    counts["loads"] += 1
    with pytest.raises(SystemExit, match="built or loaded a library"):
        smoke.warm_checked(dict(warm), "t")


def test_phase_serve_after_warmup_on_a_cpu_engine(smoke, monkeypatch, tmp_path):
    """serve_warmup's serving half on a tiny int8 engine on the CPU, at the
    path's settings (int8 cache, max_len 4096, warmup(max_prompt=64)): the
    engine gets the compile cache, the counts start after the warmup, and
    the summary carries the warmed and served buckets, the greedy streams
    and the first request's TTFT (the card's library loads stood in for)."""
    from rama_tpu.testing.ref_model import random_params, tiny_config

    from _torch_port import torch_cfg
    from rama_tpu_torch.models.llama import quantize_params
    from rama_tpu_torch.ops.kernels import build
    from rama_tpu_torch.runtime.engine import Engine
    from rama_tpu_torch.server import app  # noqa: F401  (binds the real Engine)
    from rama_tpu_torch.tokenizer import Tokenizer

    jcfg = tiny_config(vocab_size=32000, seq_len=64)
    cfg = torch_cfg(jcfg)
    params = quantize_params(cfg, random_params(jcfg, seed=2), bits=8, group_size=16,
                             dtype=torch.float32, device="cpu")
    tok = Tokenizer.from_file(ROOT / "tests" / "fixtures" / "tokenizer.bin", 32000)
    counts = {"builds": 0, "loads": 0}
    monkeypatch.setattr(build, "counts", counts)
    monkeypatch.setattr(build, "BUILD_DIR", build.DEFAULT_BUILD_DIR)
    warmup, started = Engine.warmup, []

    def loading_warmup(self, max_prompt=None):   # as an engine on the card loads them
        counts["loads"] = len(build.SOURCES)
        return warmup(self, max_prompt)

    monkeypatch.setattr(Engine, "warmup", loading_warmup)
    out = smoke.phase_serve(torch, cfg, params, tok, "card", tag="serve_warmup",
                            **smoke.WARMUP_PATH["serve"], warmup=smoke.WARMUP_PATH["warmup"],
                            compile_cache=str(tmp_path / "cache"),
                            start_count=lambda: started.append(counts["loads"]))
    assert started == [len(build.SOURCES)]
    assert build.BUILD_DIR == (tmp_path / "cache").resolve()
    w = out["warmup"]
    assert w["programs"] == 8 and w["warmed"] == [(8, 16), (8, 32), (8, 64), (8, 128)]
    assert w["served"] == [(8, 16)]
    assert len(out["greedy"]) == 4 and all(out["greedy"].values())
    assert out["ttft_first_ms"] > 0


def test_phase_serve_warmup_reads_the_child_and_holds_its_streams(smoke, monkeypatch,
                                                                  tmp_path):
    """The parent half: this run's libraries are copied into a fresh
    directory under build/ for the child, which is removed afterwards; the
    child's summary line is read back; its greedy streams must equal
    serve_kv8's."""
    import json
    import subprocess

    from rama_tpu_torch.ops.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "libs")
    (tmp_path / "libs").mkdir()
    for name in build.SOURCES:
        build._lib_path(name).write_text("lib")
        build._lib_path(name).with_suffix(".log").write_text("log")
    seen = {}
    child = {"greedy": {"Once upon a time": "abc"}, "ttft_first_ms": 5.0, "ttft_p50_ms": 6.0,
             "ttft_max_ms": 7.0, "launches": {"ffn": 3}}

    def run(cmd, **kw):
        cache = pathlib.Path(cmd[cmd.index("--warmup-child") + 1])
        seen["files"] = sorted(p.name for p in cache.iterdir())
        seen["cache"] = cache
        return subprocess.CompletedProcess(cmd, 0, "[serve_warmup] child line\n"
                                           + smoke.WARMUP_RESULT + json.dumps(child) + "\n", "")

    monkeypatch.setattr(smoke.subprocess, "run", run)
    plain = {"greedy": {"Once upon a time": "abc"}, "ttft_first_ms": 9.0, "ttft_p50_ms": 9.0,
             "ttft_max_ms": 9.0}
    got = smoke.phase_serve_warmup(torch, "card", {"serve_kv8": plain})
    assert got == child
    assert seen["cache"].parent == ROOT / "build" and not seen["cache"].exists()
    assert len(seen["files"]) == 2 * len(build.SOURCES)
    plain["greedy"]["Once upon a time"] = "abd"
    with pytest.raises(SystemExit, match="differ from serve_kv8's"):
        smoke.phase_serve_warmup(torch, "card", {"serve_kv8": plain})


def test_pipe_phase_is_known_and_a_subset_is_not_ok(smoke):
    assert "serve_pipe" in smoke.ALL_PHASES and smoke.ALL_PHASES[-1] == "cli"
    assert smoke.PIPE_PATH in smoke.PATHS and smoke.PIPE_PATH["phases"] == (None, "serve_pipe",
                                                                            None)
    dev = {"platform": "gpu", "kind": "x", "count": 1}
    line, rc = smoke.final_line(tuple(p for p in smoke.ALL_PHASES if p != "serve_pipe"), dev)
    assert line == {"ok": False, "skipped_phases": ["serve_pipe"], "device": dev}
    assert rc == smoke.PARTIAL_RC


def _pipe_launches(smoke, **over):
    path = smoke.PIPE_PATH
    got = {k: 4 for k in path["record"]}
    got.update({k: 0 for k in path["forbid"]})
    return {**got, **over}


@pytest.mark.parametrize("over,match", [
    ({"chunk_attention_q8": 0, "write_kv_chunk_q8_fused": 0}, "never launched"),
    ({"write_kv_prefill_paged_q8": 0}, "never launched"),
    ({"write_kv_rows_q8": 1}, "launched on the pipelined loop"),
    ({"write_kv_paged_q8": 2}, "launched on the pipelined loop"),
    ({"decode_attention": 1}, "launched on the pipelined loop"),
    ({"write_kv_chunk_q8_fused": 3}, "launches of the kernel"),
    ({"write_kv_strips_q8_stream": 3}, "launches of the kernel")])
def test_pipe_path_needs_the_three_engines_kernels(smoke, over, match):
    """serve_pipe's three engines run K7, K10 and K12 over int8 caches, each
    walk launch writing its rows, and K8 / K13 (b) on the streaming body."""
    smoke.check_launches(smoke.PIPE_PATH, _pipe_launches(smoke))
    with pytest.raises(SystemExit, match=match):
        smoke.check_launches(smoke.PIPE_PATH, _pipe_launches(smoke, **over))


def _tiny_int8_model():
    import numpy as np

    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models.llama import quantize_params
    from rama_tpu_torch.tokenizer import Tokenizer

    cfg = ModelConfig(dim=64, hidden_dim=176, n_layers=2, n_heads=4, n_kv_heads=2,
                      vocab_size=128, seq_len=64)
    rng = np.random.default_rng(3)
    L, D, H, V = 2, 64, 176, 128
    p = {n: (rng.standard_normal(s) * 0.1).astype(np.float32) for n, s in {
        "tok_embedding": (V, D), "wq": (L, D, D), "wk": (L, D, 32), "wv": (L, D, 32),
        "wo": (L, D, D), "w1": (L, D, H), "w2": (L, H, D), "w3": (L, D, H)}.items()}
    p.update(attn_norm=np.ones((L, D), np.float32), ffn_norm=np.ones((L, D), np.float32),
             final_norm=np.ones(D, np.float32))
    vocab = ["<unk>", "<s>", "</s>"] + [chr(97 + i % 26) + str(i // 26) * (i >= 26)
                                        for i in range(V - 3)]
    params = quantize_params(cfg, p, group_size=16, dtype=torch.float32, device="cpu")
    return cfg, params, Tokenizer(vocab, [0.0] * V)


def test_serve_pipe_phase_on_a_tiny_model(smoke, monkeypatch):
    """The phase's logic on the CPU (the card's sync debug mode, synchronize
    and profiler stubbed): each engine's ids agree across the six runs, the
    depth-3 runs chain and admit behind in-flight ticks, every tick and
    admission dispatch ran with the debug mode at "error", and a run that
    counts an engine error fails the phase."""
    import torch.profiler

    modes = []

    class Profile:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def key_averages(self):
            return []

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1] if modes else 0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: Profile())
    # the tiny model's n-gram drafts land more often than the 7B's random
    # weights' (accept ~0.02): one round a spec tick leaves a chain room
    # within the 32-token budgets
    engines = dict(smoke.PIPE_ENGINES)
    engines["spec"] = dict(engines["spec"], spec_rounds=1)
    monkeypatch.setattr(smoke, "PIPE_ENGINES", tuple(engines.items()))
    from rama_tpu_torch.runtime.engine import Engine

    def host_bound(name):
        """A tick's dispatch as slow as the card's host-bound one, so the
        next requests arrive while it is in flight, as there."""
        orig = getattr(Engine, name)

        def call(self, *a, **kw):
            time.sleep(0.02)
            return orig(self, *a, **kw)

        monkeypatch.setattr(Engine, name, call)

    for name in ("_dev_tick_async", "_dev_spec_tick"):
        host_bound(name)
    cfg, params, tok = _tiny_int8_model()
    summary = smoke.phase_serve_pipe(torch, cfg, params, tok, "cpu")
    assert set(summary) == {"plain", "spec", "paged"}
    for by in summary.values():
        assert all(n >= 1 for n in by[3]["chained"]) and not any(by[1]["chained"])
        assert sum(by[3]["async_admissions"]) >= 1 and len(by[1]["tok_s"]) == 2
    assert "error" in modes and modes[-1] == 0

    orig = Engine._dispatch_chained

    def syncing(self, inf):
        self.metrics["engine_errors"] += 1          # as a sync raising in the loop counts
        return orig(self, inf)

    monkeypatch.setattr(Engine, "_dispatch_chained", syncing)
    with pytest.raises(SystemExit, match="engine_errors"):
        smoke.pipe_run(torch, cfg, params, tok, {}, 3)
