"""rama_tpu_torch.parallel in one process: validate_tp, split_groups,
shard_params (rank r's leaves against rama_tpu's shard_params shard r on
the conftest's 8 CPU devices: dense, int8 and int4, the int8 w2 regroup at
Llama-2-7B's K = 11008 over tp 8, the int4 refusals), shard-then-fuse
against rama_tpu's fuse_params(params, cfg, tp), each rank's engine cache
against rama_tpu's shard_cache, and make_mesh's grid,
groups and refusals (a world of 8 ranks stood in for by a fake
torch.distributed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_params_to_torch, torch_cfg
from rama_tpu.models import llama as jl
from rama_tpu.ops.quant import QuantizedEmbedding as JQE
from rama_tpu.ops.quant import QuantizedTensor as JQT
from rama_tpu.ops.quant import quantize_int4 as jq4
from rama_tpu.ops.quant import quantize_int8 as jq8
from rama_tpu.ops.quant import split_groups as jsplit
from rama_tpu.parallel import tp as jtp
from rama_tpu.parallel.mesh import make_mesh as jmake_mesh
from rama_tpu.testing.ref_model import random_params, tiny_config
from rama_tpu_torch.models import llama as tl
from rama_tpu_torch.ops import quant as tq
from rama_tpu_torch.parallel import mesh as tmesh
from rama_tpu_torch.parallel import tp as ttp

torch.set_num_threads(1)


def _mesh(dp: int, tp: int, rank: int) -> tmesh.Mesh:
    """Rank `rank`'s view of a (dp, tp) grid, without a process group (the
    shard functions read only its coordinates and device)."""
    return tmesh.Mesh(ranks=np.arange(dp * tp).reshape(dp, tp), rank=rank,
                      device=torch.device("cpu"), backend=None, model_group=None,
                      data_group=None)


def _jax_shard(arr, device) -> np.ndarray:
    (data,) = [s.data for s in arr.addressable_shards if s.device == device]
    return np.asarray(data)


def _leaves(p) -> dict:
    """A port leaf as numpy arrays by field."""
    if isinstance(p, (tq.QuantizedTensor, tq.QuantizedEmbedding)):
        return {"q": p.q.numpy(), "scales": p.scales.float().numpy()}
    return {"w": p.float().numpy()}


def _jax_leaves(p, device) -> dict:
    if isinstance(p, (JQT, JQE)):
        return {"q": _jax_shard(p.q, device),
                "scales": _jax_shard(p.scales, device).astype(np.float32)}
    return {"w": _jax_shard(p, device).astype(np.float32)}


@pytest.mark.parametrize("tp", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("shape", [dict(), dict(n_kv_heads=1), dict(hidden_dim=180),
                                   dict(vocab_size=130), dict(dim=48, n_heads=4)])
def test_validate_tp_refuses_as_rama_tpu(tp, shape):
    jcfg = tiny_config(**shape)
    try:
        jtp.validate_tp(jcfg, tp)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        ttp.validate_tp(torch_cfg(jcfg), tp)
    else:
        with pytest.raises(ValueError) as got:
            ttp.validate_tp(torch_cfg(jcfg), tp)
        assert str(got.value) == want


@pytest.mark.parametrize("gs,new", [(64, 32), (64, 8), (32, 32), (48, 16)])
def test_split_groups_is_rama_tpus(gs, new):
    w = np.random.default_rng(gs + new).standard_normal((2, 96 * 2, 40)).astype(np.float32)
    jq = jsplit(jq8(w, gs), new)
    tq8 = tq.split_groups(tq.quantize_int8(w, gs), new)
    assert tq8.group_size == jq.group_size == new
    np.testing.assert_array_equal(tq8.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq8.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(tq.dequantize(tq8, torch.float32).numpy(),
                                  tq.dequantize(tq.quantize_int8(w, gs), torch.float32).numpy())


def test_split_groups_refuses_int4_and_a_coarser_group():
    w = np.random.default_rng(1).standard_normal((64, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="only supports int8"):
        tq.split_groups(tq.quantize_int4(w, 16), 8)
    with pytest.raises(ValueError, match="does not divide"):
        tq.split_groups(tq.quantize_int8(w, 16), 12)


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_config(seq_len=32)
    return jcfg, random_params(jcfg, seed=41)


def _jax_params(jcfg, np_params, quant):
    if quant:
        return jl.quantize_params(jcfg, np_params, bits=8 if quant == "int8" else 4,
                                  group_size=16, dtype=jnp.float32)
    return jl.load_params(jcfg, np_params, dtype=jnp.float32)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_shard_params_rank_r_is_rama_tpus_shard_r(tiny, quant, dp, tp):
    jcfg, np_params = tiny
    jp = _jax_params(jcfg, np_params, quant)
    jmesh = jmake_mesh(tp_size=tp, dp_size=dp, devices=jax.devices()[: dp * tp])
    jshard = jtp.shard_params(jp, jmesh)
    full = jax_params_to_torch(jcfg, jp)
    for rank in range(dp * tp):
        mesh = _mesh(dp, tp, rank)
        local = ttp.shard_params(full, torch_cfg(jcfg), mesh)
        device = jmesh.devices[mesh.data_index, mesh.model_index]
        assert set(local) == set(jshard)
        for name, leaf in local.items():
            got, want = _leaves(leaf), _jax_leaves(jshard[name], device)
            for field in want:
                np.testing.assert_array_equal(got[field], want[field], err_msg=f"{name}.{field}")
            if isinstance(leaf, tq.QuantizedTensor):
                assert (leaf.group_size, leaf.bits) == (jshard[name].group_size,
                                                        jshard[name].bits)


@pytest.mark.parametrize("rank", [0, 3, 7])
def test_w2_regroups_at_7b_k_over_tp8(rank):
    """tests/test_tp_flagship.py:138 on the port: w2's int8 scales regroup
    gs 64 -> 32 for tp 8 at K 11008, rank r's shard equal to JAX's, its
    dequantized rows those of the unsharded weight."""
    w = np.random.default_rng(3).standard_normal((1, 11008, 8)).astype(np.float32)
    jmesh = jmake_mesh(tp_size=8, dp_size=1, devices=jax.devices()[:8])
    want = jtp.shard_params({"w2": jq8(jnp.asarray(w), 64)}, jmesh)["w2"]
    full = tq.quantize_int8(w, 64)
    got = ttp.shard_params({"w2": full}, torch_cfg(tiny_config()), _mesh(1, 8, rank))["w2"]
    assert got.group_size == want.group_size == 32
    assert tuple(got.scales.shape) == (1, 1376 // 32, 8)
    device = jmesh.devices[0, rank]
    np.testing.assert_array_equal(got.q.numpy(), _jax_shard(want.q, device))
    np.testing.assert_array_equal(got.scales.numpy(), _jax_shard(want.scales, device))
    rows = slice(rank * 1376, (rank + 1) * 1376)
    np.testing.assert_array_equal(tq.dequantize(got, torch.float32).numpy(),
                                  tq.dequantize(full, torch.float32).numpy()[:, rows])


@pytest.mark.parametrize("gs", [64, 32])
def test_misaligned_int4_is_refused_as_rama_tpu(gs):
    """tests/test_tp_flagship.py:153 on the port: an int4 w2 whose packing
    blocks do not split into tp 8 shards of K 11008 is refused with JAX's
    error; the group size quantize_int4 picks shards."""
    w = np.random.default_rng(5).standard_normal((1, 11008, 8)).astype(np.float32)
    jmesh = jmake_mesh(tp_size=8, dp_size=1, devices=jax.devices()[:8])
    jqt = jq4(jnp.asarray(w), 64)                   # the picked, aligned group size
    tqt = tq.quantize_int4(w, 64)
    assert ttp.shard_params({"w2": tqt}, torch_cfg(tiny_config()), _mesh(1, 8, 0))["w2"].bits == 4
    assert jtp.shard_params({"w2": jqt}, jmesh)["w2"].bits == 4
    # the same bytes relabelled with a group size the shards would cut
    jbad = JQT(q=jqt.q, scales=jnp.zeros((1, 11008 // gs, 8)), group_size=gs, bits=4)
    tbad = tq.QuantizedTensor(q=tqt.q, scales=torch.zeros(1, 11008 // gs, 8), group_size=gs,
                              bits=4)
    with pytest.raises(ValueError) as want:
        jtp.shard_params({"w2": jbad}, jmesh)
    with pytest.raises(ValueError) as got:
        ttp.shard_params({"w2": tbad}, torch_cfg(tiny_config()), _mesh(1, 8, 0))
    assert str(got.value) == str(want.value)


def test_fused_params_are_refused_under_tp():
    cfg = tiny_config()
    fused = tl.fuse_params(jax_params_to_torch(cfg, jl.load_params(
        cfg, random_params(cfg, seed=2), dtype=jnp.float32)), torch_cfg(cfg))
    with pytest.raises(ValueError, match="unfused"):
        ttp.shard_params(fused, torch_cfg(cfg), _mesh(1, 2, 0))


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_then_fuse_is_rama_tpus_fused_shard(quant, tp):
    """Each rank fuses its own shard (shard_config's hidden dim picks the
    w13 interleave tile): rank r's wqkv / w13 equal column shard r of
    rama_tpu's fuse_params(params, cfg, tp), the interleave width with
    them."""
    jcfg = tiny_config(dim=128, hidden_dim=512, n_heads=4, n_kv_heads=4, seq_len=32)
    jp = _jax_params(jcfg, random_params(jcfg, seed=9), quant)
    jfused = jl.fuse_params(jp, jcfg, tp_size=tp)
    full, cfg = jax_params_to_torch(jcfg, jp), torch_cfg(jcfg)
    for rank in range(tp):
        local = tl.fuse_params(ttp.shard_params(full, cfg, _mesh(1, tp, rank)),
                               ttp.shard_config(cfg, tp))
        for name in ("wqkv", "w13"):
            want = jfused[name]
            if isinstance(want, JQT):
                n = want.q.shape[-1] // tp
                cols = slice(rank * n, (rank + 1) * n)
                assert local[name].il == want.il
                np.testing.assert_array_equal(local[name].q.numpy(), np.asarray(want.q)[..., cols])
                np.testing.assert_array_equal(local[name].scales.numpy(),
                                              np.asarray(want.scales)[..., cols])
            else:
                n = want.shape[-1] // tp
                np.testing.assert_array_equal(
                    local[name].numpy(), np.asarray(want)[..., rank * n:(rank + 1) * n])


def test_shard_config_keeps_head_dim():
    cfg = torch_cfg(tiny_config(dim=128, hidden_dim=512, n_heads=8, n_kv_heads=2))
    local = ttp.shard_config(cfg, 2)
    assert (local.n_heads, local.n_kv_heads, local.hidden_dim) == (4, 1, 256)
    assert local.head_dim == cfg.head_dim and local.vocab_size == cfg.vocab_size
    assert ttp.shard_config(cfg, 1) is cfg


@pytest.mark.parametrize("kv_quant,paged", [(None, False), ("int8", False), (None, True),
                                           ("int8", True)])
def test_engine_cache_is_rama_tpus_shard_of_the_global_cache(monkeypatch, tiny, kv_quant,
                                                             paged):
    """Each rank's engine makes its own cache (Engine._create_cache): at dp 2
    x tp 2 rank r's dense cache, or its sub-pool of pages, has the shape of
    rama_tpu's shard_cache / shard_paged_cache shard r of the global one
    (slots or pages over data, kv heads over model, an int8 cache's row
    scales with their rows), and a paged engine keeps one allocator a
    replica over its own pages."""
    from rama_tpu.runtime.paged import PagedKVCache as JPKV
    from rama_tpu.runtime.paged import QuantPagedKVCache as JQPKV
    from rama_tpu_torch.config import EngineConfig
    from rama_tpu_torch.runtime import engine as teng
    from rama_tpu_torch.tokenizer import Tokenizer

    jcfg, np_params = tiny
    cfg = torch_cfg(jcfg)
    params = tl.load_params(cfg, np_params, dtype=torch.float32, device="cpu")
    tok = Tokenizer(["<unk>", "<s>", "</s>"] + ["a"] * (cfg.vocab_size - 3),
                    [0.0] * cfg.vocab_size, max_token_length=4)
    ecfg = EngineConfig(max_batch_size=4, max_seq_len=32, tp_size=2, dp_size=2,
                        kv_quant=kv_quant, paged_kv=paged, kv_page_size=8, kv_num_pages=8)
    jmesh = jmake_mesh(tp_size=2, dp_size=2, devices=jax.devices()[:4])
    if paged:
        pool = (JQPKV.create(jcfg, 2 * (4 + 1), 8) if kv_quant else
                JPKV.create(jcfg, 2 * (4 + 1), 8, dtype=jnp.float32))
        want = jtp.shard_paged_cache(pool, jmesh)
    else:
        full = (jl.QuantKVCache.create(jcfg, batch=4, max_len=32) if kv_quant else
                jl.KVCache.create(jcfg, batch=4, max_len=32, dtype=jnp.float32))
        want = jtp.shard_cache(full, jmesh)
    monkeypatch.setattr(teng, "world_size", lambda: 4)
    for rank in range(4):
        mesh = _mesh(2, 2, rank)
        eng = teng.Engine(cfg, params, tok, ecfg, mesh=mesh)
        device = jmesh.devices[mesh.data_index, mesh.model_index]
        fields = ("k", "v", "ks", "vs") if kv_quant else ("k", "v")
        for f in fields:
            got, shard = getattr(eng.cache, f), _jax_shard(getattr(want, f), device)
            assert tuple(got.shape) == shard.shape, f
            assert str(got.dtype).split(".")[-1] == str(shard.dtype), f
        assert (eng.lo, eng.hi) == (2 * mesh.data_index, 2 * mesh.data_index + 2)
        if paged:
            assert len(eng.allocators) == 2 and eng.trash_page == 4


class _FakeDist:
    """A world of `world` ranks seen from `rank`: the calls make_mesh makes."""

    def __init__(self, world, rank):
        self.world, self.rank, self.groups = world, rank, []

    def is_initialized(self):
        return True

    def get_world_size(self, group=None):
        return self.world

    def get_rank(self):
        return self.rank

    def new_group(self, ranks, backend=None, timeout=None):
        self.groups.append((tuple(ranks), backend))
        return ("group", tuple(ranks))


@pytest.mark.parametrize("tp,dp,shape", [(4, None, (2, 4)), (None, 8, (8, 1)), (2, 4, (4, 2)),
                                         (8, 1, (1, 8))])
def test_make_mesh_shapes_groups_and_coordinates(monkeypatch, tp, dp, shape):
    """tests/test_tp.py:95 on the port, in a world of 8: the (dp, tp) grid,
    every rank's coordinates and its model / data groups (every group made
    by every rank, in one order), gloo for ranks listed on the CPU."""
    for rank in range(8):
        fake = _FakeDist(8, rank)
        monkeypatch.setattr(tmesh, "dist", fake)
        m = tmesh.make_mesh(tp, dp, devices=["cpu"] * 8)
        assert m.ranks.shape == shape and (m.dp, m.tp) == shape
        assert m.shape == {tmesh.DATA_AXIS: shape[0], tmesh.MODEL_AXIS: shape[1]}
        assert m.ranks[m.data_index, m.model_index] == rank
        assert m.backend == "gloo" and m.device == torch.device("cpu")
        assert [g for g, _ in fake.groups] == ([tuple(r) for r in m.ranks.tolist()]
                                               + [tuple(c) for c in m.ranks.T.tolist()])
        model = tuple(m.ranks[m.data_index].tolist())
        data = tuple(m.ranks[:, m.model_index].tolist())
        assert m.model_group == (("group", model) if m.tp > 1 else None)
        assert m.data_group == (("group", data) if m.dp > 1 else None)


def test_make_mesh_refusals(monkeypatch):
    monkeypatch.setattr(tmesh, "dist", _FakeDist(8, 0))
    with pytest.raises(ValueError, match="dp 3 x tp 3 != 8"):
        tmesh.make_mesh(3, 3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="4 devices for a world of 8"):
        tmesh.make_mesh(8, 1, devices=["cpu"] * 4)
    monkeypatch.setattr(tmesh.torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="8 ranks need 8 visible GPUs, one a rank; 0 are"):
        tmesh.make_mesh(8, 1)


def test_one_rank_mesh_has_no_groups():
    m = tmesh.make_mesh(devices=["cpu"])
    assert (m.dp, m.tp, m.model_group, m.data_group, m.backend) == (1, 1, None, None, None)


@pytest.mark.parametrize("devices,backend", [
    (["cuda:0", "cuda:1"], "nccl"), (["cuda:0", "cuda:0"], "gloo"), (["cpu", "cpu"], "gloo"),
    (["cuda:0", "cuda:1", "cuda:1", "cuda:2"], "gloo")])
def test_backend_is_nccl_only_with_a_gpu_a_rank(devices, backend):
    assert tmesh.backend_for([torch.device(d) for d in devices]) == backend


@pytest.mark.parametrize("kw,match", [
    (dict(max_batch_size=3, dp_size=2), "dp_size 2 does not divide max_batch_size 3"),
    (dict(tp_size=3), "tp_size 3 does not divide n_heads=4"),
    (dict(tp_size=2, dp_size=2), "call rama_tpu_torch.parallel.distributed.init_distributed")])
def test_engine_refuses_as_rama_tpu(tiny, kw, match):
    """tests/test_tp.py:245 on the port: dp must divide the slots and tp the
    model's dims (checked before any process group is needed); outside a
    group of tp * dp ranks the engine names init_distributed."""
    from rama_tpu_torch.config import EngineConfig
    from rama_tpu_torch.runtime.engine import Engine
    from rama_tpu_torch.tokenizer import Tokenizer

    jcfg, np_params = tiny
    cfg = torch_cfg(jcfg)
    params = tl.load_params(cfg, np_params, dtype=torch.float32, device="cpu")
    tok = Tokenizer(["<unk>", "<s>", "</s>"] + ["a"] * (cfg.vocab_size - 3),
                    [0.0] * cfg.vocab_size, max_token_length=4)
    with pytest.raises(ValueError, match=match):
        Engine(cfg, params, tok, EngineConfig(**kw))
