"""Card-only tests: each hand-written kernel against its plain PyTorch version
on the GPU at small and ragged shapes (plus a 4096 x 4096 weight), and a
tiny int8 model's logits through the kernels against the plain path.
Marked `cuda`; skipped (with the reason) where torch sees no GPU. On the
card (whose Python has no JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: bf16 compared in fp32, max |err| <= 2e-2 * max |ref|; fp32 atol
1e-4 (other summation order)."""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())


def _qt(dev, L, k, n, gs, seed):
    from rama_tpu_torch.ops.quant import quantize_int8

    g = torch.Generator().manual_seed(seed)
    return quantize_int8(torch.randn(L, k, n, generator=g) * 0.05, gs).to(dev)


@pytest.mark.parametrize("m", [1, 3, 8, 33, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n,gs", [(256, 384, 64), (288, 1000, 32), (4096, 4096, 64)])
def test_quant_matmul(dev, m, dtype, k, n, gs):
    from rama_tpu_torch.ops.kernels import quant_matmul as qm

    w = _qt(dev, 2, k, n, gs, seed=k + n)
    x = torch.randn(m, k, device=dev).to(dtype)
    before = qm.launches
    _close(qm.quant_matmul(x, w, 1), qm.quant_matmul_plain(x, w, 1), dtype)
    assert qm.launches == before + 1


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("il", [0, 128])
def test_ffn(dev, m, il):
    from rama_tpu_torch.ops.kernels import ffn
    from rama_tpu_torch.ops.quant import QuantizedTensor

    w13 = _qt(dev, 2, 256, 512, 64, seed=1)
    w13 = QuantizedTensor(q=w13.q, scales=w13.scales, group_size=64, il=il)
    w2 = _qt(dev, 2, 256, 192, 64, seed=2)
    x = torch.randn(m, 256, device=dev, dtype=torch.bfloat16)
    _close(ffn.ffn(x, w13, w2, 1), ffn.ffn_plain(x, w13, w2, 1), torch.bfloat16)


@pytest.mark.parametrize("nh,nkv,hd", [(4, 4, 128), (4, 2, 48), (8, 1, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention(dev, nh, nkv, hd, dtype):
    from rama_tpu_torch.ops.kernels import decode_attention as da

    S = 256
    k = torch.randn(2, 4, nkv, S, hd, device=dev).to(dtype)
    v = torch.randn(2, 4, nkv, S, hd, device=dev).to(dtype)
    q = torch.randn(4, nh, hd, device=dev).to(dtype)
    pos = torch.tensor([0, 63, 64, S - 1], dtype=torch.int32, device=dev)
    for layer in (0, 1):
        _close(da.decode_attention(q, k, v, pos, layer),
               da.decode_attention_plain(q, k, v, pos, layer), dtype)


@pytest.mark.parametrize("nh,nkv,t,plen", [(4, 4, 16, [16, 3]), (4, 2, 40, [40, 17]),
                                           (32, 32, 64, [64, 1])])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefill_attention(dev, nh, nkv, t, plen, dtype):
    from rama_tpu_torch.ops.kernels import prefill_attention as pa

    hd = 128 if nh == 32 else 64
    q = torch.randn(2, t, nh, hd, device=dev).to(dtype)
    k = torch.randn(2, nkv, t + 8, hd, device=dev).to(dtype)
    v = torch.randn(2, nkv, t + 8, hd, device=dev).to(dtype)
    pl = torch.tensor(plen, dtype=torch.int32, device=dev)
    _close(pa.prefill_attention(q, k, v, pl), pa.prefill_attention_plain(q, k, v, pl), dtype)


def test_tiny_model_logits_kernels_equal_plain(dev):
    """int8 tiny model in fp32 on the card: prefill and decode logits through
    the kernels equal the plain path's (atol 1e-3: fp32 sums in another
    order, through three layers), and the greedy continuations agree."""
    import numpy as np

    from rama_tpu_torch.config import ModelConfig
    from rama_tpu_torch.models.llama import (KVCache, decode_step, fuse_params, prefill,
                                             quantize_params)

    cfg = ModelConfig(dim=64, hidden_dim=176, n_layers=3, n_heads=4, n_kv_heads=2,
                      vocab_size=128, seq_len=48)
    rng = np.random.default_rng(7)
    L, D, H, V = 3, 64, 176, 128
    p = {n: (rng.standard_normal(s) * 0.05).astype(np.float32) for n, s in {
        "tok_embedding": (V, D), "wq": (L, D, D), "wk": (L, D, 32), "wv": (L, D, 32),
        "wo": (L, D, D), "w1": (L, D, H), "w2": (L, H, D), "w3": (L, D, H)}.items()}
    p.update(attn_norm=np.ones((L, D), np.float32), ffn_norm=np.ones((L, D), np.float32),
             final_norm=np.ones(D, np.float32))
    params = fuse_params(quantize_params(cfg, p, group_size=16, dtype=torch.float32,
                                         device=dev), cfg)
    toks = torch.tensor([[1, 3, 42, 7, 11]], device=dev)
    caches = [KVCache.create(cfg, 1, 24, dtype=torch.float32, device=dev) for _ in range(2)]
    lk, _ = prefill(params, cfg, toks, caches[0], last_only=True)
    lp, _ = prefill(params, cfg, toks, caches[1], last_only=True, plain=True)
    torch.testing.assert_close(lk, lp, atol=1e-3, rtol=0)
    tok_k = tok_p = torch.argmax(lp[:, -1], dim=-1)
    for pos in range(5, 16):
        p_t = torch.tensor([pos], device=dev)
        lk, _ = decode_step(params, cfg, tok_k, p_t, caches[0])
        lp, _ = decode_step(params, cfg, tok_p, p_t, caches[1], plain=True)
        torch.testing.assert_close(lk, lp, atol=1e-3, rtol=0)
        tok_k, tok_p = torch.argmax(lk, dim=-1), torch.argmax(lp, dim=-1)
        assert tok_k.item() == tok_p.item()


def test_engine_on_card_matches_cpu_engine(dev):
    """The slim engine on the card (every kernel, decode ticks of 4, a prompt
    truncated to fill the cache, a stream that runs to max_len, a sampled
    stream) emits the same streams as the engine on the CPU."""
    import numpy as np

    from rama_tpu_torch.config import EngineConfig, ModelConfig
    from rama_tpu_torch.models.llama import quantize_params
    from rama_tpu_torch.runtime.engine import Engine, Request
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
    tok = Tokenizer(vocab, [0.0] * V)
    outs = []
    for device in ("cpu", dev):
        eng = Engine(cfg, quantize_params(cfg, p, group_size=16, dtype=torch.float32,
                                          device=device),
                     tok, EngineConfig(max_batch_size=4, decode_tick=4))
        reqs = [Request(prompt="ab" * 40, steps=8, temperature=0.0),
                Request(prompt="abc", steps=100, temperature=0.0, stop_at_eos=False),
                Request(prompt="zq", steps=20, temperature=0.9)]
        eng.start()
        try:
            for r in reqs:
                eng.submit(r)
            got = []
            for r in reqs:
                toks = []
                while (t := r.queue.get(timeout=120)) is not None:
                    toks.append(t)
                got.append(toks)
        finally:
            eng.stop()
        assert all(r.error is None for r in reqs)
        assert len(got[1]) == 64 - 4   # ran to the end of the cache
        outs.append(got)
    assert outs[0] == outs[1]
