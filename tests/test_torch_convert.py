"""rama_tpu_torch.convert.params_from_numpy (the weight carrier) and the
port's checkpoint copy: the JAX package's parameters become the port's
with every leaf intact, and the port's writers/readers agree byte for byte
with rama_tpu's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_tree_to_numpy, torch_cfg
from rama_tpu import checkpoint as jck
from rama_tpu.models import llama as jl
from rama_tpu.testing.ref_model import random_params, tiny_config
from rama_tpu_torch import checkpoint as tck
from rama_tpu_torch.convert import params_from_numpy
from rama_tpu_torch.ops.quant import QuantizedEmbedding, QuantizedTensor

torch.set_num_threads(1)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_tree_round_trip(bits):
    jcfg = tiny_config(seq_len=32, shared_classifier=False)
    jp = jl.fuse_params(jl.quantize_params(jcfg, random_params(jcfg, seed=2), bits=bits,
                                           group_size=16, dtype=jnp.float32), jcfg)
    tree = jax_tree_to_numpy(jp)
    tp = params_from_numpy(torch_cfg(jcfg), tree, "cpu")
    assert set(tp) == set(jp)
    assert isinstance(tp["tok_embedding"], QuantizedEmbedding)
    for name in ("wqkv", "w13", "wo", "w2", "wcls"):
        assert isinstance(tp[name], QuantizedTensor)
        assert tp[name].il == jp[name].il and tp[name].group_size == jp[name].group_size
        assert tp[name].bits == jp[name].bits == (8 if name == "wcls" else bits)
        assert tp[name].shape == tuple(jp[name].shape)
        np.testing.assert_array_equal(tp[name].q.numpy(), np.asarray(jp[name].q))
        np.testing.assert_array_equal(tp[name].scales.numpy(), np.asarray(jp[name].scales))
    assert tp["rope_cos"].dtype == torch.float32
    np.testing.assert_array_equal(tp["attn_norm"].numpy(), np.asarray(jp["attn_norm"]))


def test_dense_tree_cast_and_bf16_leaves():
    jcfg = tiny_config(seq_len=16)
    jp = jl.load_params(jcfg, random_params(jcfg, seed=3), dtype=jnp.bfloat16)
    tp = params_from_numpy(torch_cfg(jcfg), jax_tree_to_numpy(jp), "cpu",
                           dtype=torch.bfloat16)
    assert tp["wq"].dtype == torch.bfloat16 and tp["rope_sin"].dtype == torch.float32
    np.testing.assert_array_equal(tp["wq"].float().numpy(),
                                  np.asarray(jp["wq"]).astype(np.float32))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="--device cpu"):
        params_from_numpy(torch_cfg(tiny_config()), {"final_norm": np.ones(4, np.float32)})


def test_rejects_non_int8_quantized_leaf():
    tree = {"wo": {"q": np.zeros((4, 4), np.int32), "scales": np.ones((1, 4), np.float32),
                   "group_size": 4, "bits": 8, "il": 0}}
    with pytest.raises(TypeError, match="int8"):
        params_from_numpy(torch_cfg(tiny_config()), tree, "cpu")


@pytest.mark.parametrize("leaf,match", [
    # int4 K = 2 * 12 rows is not a multiple of the 2 * 8 packing block
    ({"q": np.zeros((12, 4), np.int8), "scales": np.ones((3, 4), np.float32),
      "group_size": 8, "bits": 4, "il": 0}, "multiple of 16"),
    ({"q": np.zeros((16, 4), np.int8), "scales": np.ones((2, 4), np.float32),
      "group_size": 8, "bits": 4, "il": 0}, "scales"),
    ({"q": np.zeros((16, 4), np.int8), "scales": np.ones((2, 4), np.float32),
      "group_size": 8, "bits": 2, "il": 0}, "bits"),
])
def test_rejects_malformed_quantized_leaf(leaf, match):
    with pytest.raises(ValueError, match=match):
        params_from_numpy(torch_cfg(tiny_config()), {"wo": leaf}, "cpu")


def test_rejects_w13_tile_not_dividing_hidden():
    jcfg = tiny_config()  # hidden 176
    leaf = {"q": np.zeros((32, 352), np.int8), "scales": np.ones((4, 352), np.float32),
            "group_size": 16, "bits": 4, "il": 128}
    with pytest.raises(ValueError, match="hidden_dim"):
        params_from_numpy(torch_cfg(jcfg), {"w13": leaf}, "cpu")


@pytest.mark.parametrize("shared", [True, False])
def test_checkpoint_writers_and_readers_match_rama_tpu(tmp_path, shared):
    jcfg = tiny_config(seq_len=16, shared_classifier=shared)
    np_params = random_params(jcfg, seed=4)
    cfg = torch_cfg(jcfg)
    for ver, jw, tw in (("v0", jck.save_v0, tck.save_v0), ("v2", jck.save_v2, tck.save_v2)):
        a, b = tmp_path / f"j_{ver}.bin", tmp_path / f"t_{ver}.bin"
        jw(str(a), jcfg, np_params)
        tw(str(b), cfg, np_params)
        assert a.read_bytes() == b.read_bytes(), ver
        assert tck.peek_version(str(b)) == jck.peek_version(str(a))
        assert tck.load_config(str(b)) == cfg
        jc, jparams = jck.load_checkpoint(str(a))
        tc, tparams = tck.load_checkpoint(str(b))
        for k in jparams:
            np.testing.assert_array_equal(tparams[k], jparams[k])
    jq, tq = jck.load_checkpoint_quantized(str(a)), tck.load_checkpoint_quantized(str(b))
    assert tq.group_size == jq.group_size
    for k in jq.quant:
        np.testing.assert_array_equal(tq.quant[k][0], jq.quant[k][0])
        np.testing.assert_array_equal(tq.quant[k][1], jq.quant[k][1])
    cos_j, sin_j = jck.compute_freqs(jcfg, seq_len=40)
    cos_t, sin_t = tck.compute_freqs(cfg, seq_len=40)
    np.testing.assert_array_equal(cos_t, cos_j)
    np.testing.assert_array_equal(sin_t, sin_j)


def test_tokenizer_copy_matches_rama_tpu(tokenizer_bin):
    from rama_tpu.tokenizer import Tokenizer as JTok
    from rama_tpu_torch.tokenizer import Tokenizer as TTok

    jt = JTok.from_file(tokenizer_bin, 32000, use_native=False)
    tt = TTok.from_file(tokenizer_bin, 32000)
    for s in ("Once upon a time, there was a little dog.", "héllo wörld", "  a\nb  "):
        ids = tt.encode(s)
        assert ids == jt.encode(s)
        assert tt.decode_ids(ids) == jt.decode_ids(ids)
