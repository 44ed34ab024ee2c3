"""Kernel 5: causal flash attention for prefill, masked by prompt length.

The counterpart of `rama_tpu/ops/pallas/prefill_attention.py`'s
`prefill_attention`: query t of slot b (position t) sees cache row s iff
s <= t and s < plen[b]; the unnormalized probabilities are rounded to the
cache dtype before P.V, the normalizer is taken from the unrounded ones
(`csrc/prefill_attention.cu`).

One deliberate difference: a row with no visible key (plen == 0) outputs
zeros here. The Pallas kernel's -1e30 fill makes such a row the mean of
the first S-tile's values instead; the engine never prefills plen == 0
(every prompt starts with BOS), so no caller sees either value.

Dispatch: a CUDA tensor launches a kernel body (or raises), a CPU tensor
runs `prefill_attention_plain`. The body is fixed by dtype and head dim
before the launch (`body_for`): bf16 at the head dims of MMA_HEAD_DIMS
takes the tensor-core body ("mma"), fp32 and any other head dim the SIMT
body ("simt"). A refused launch raises; it never gives way to the other
body.

Any whole GQA group: a CTA holds 64 query rows, `tile_rows` of the group's
heads and positions (the C entry's `pa_rows`). Where the group divides 64
(every Llama-2 and TinyLlama shape) they are all live and either body
runs its "div64" form; any other group runs the "gqa" form, whose
rows past hc * bq are idle (groups above 64 in slices of 64 heads).
`launches_by_form` counts the launches by that form (`form_for`).
"""

from __future__ import annotations

import math

import torch

from rama_tpu_torch.ops.kernels import build
from rama_tpu_torch.ops.kernels.build import I, P, require

launches = 0  # kernel launches since the last reset (chip_smoke reads it)
launches_by_body = {"mma": 0, "simt": 0}   # the same launches by kernel body
FORMS = ("div64", "gqa")   # both bodies' forms 0 / 1 (csrc pattn_form)
launches_by_form = dict.fromkeys(FORMS, 0)   # the same launches by the form run

MMA_HEAD_DIMS = (48, 64, 128)   # the tensor-core body's instantiations
ROWS = 64                       # query rows a CTA (csrc kPaRows, kFaRows)

_SIGNATURES = {
    "rama_prefill_attention": [P, P, P, P, P, I, I, I, I, I, I, I, P],
    "rama_prefill_attention_mma": [P, P, P, P, P, I, I, I, I, I, I, P],
}


def body_for(dtype: torch.dtype, hd: int) -> str:
    """The kernel body a CUDA call launches: "mma" (tensor cores) for bf16
    at a head dim of MMA_HEAD_DIMS, "simt" (fp32 on the CUDA cores) else."""
    return "mma" if dtype == torch.bfloat16 and hd in MMA_HEAD_DIMS else "simt"


def form_for(nh: int, nkv: int) -> str:
    """The form a launch of nh query heads over nkv kv heads runs: "div64"
    where the GQA group divides 64, "gqa" for any other whole group."""
    return FORMS[ROWS % (nh // nkv) != 0]


def tile_rows(rep: int) -> tuple[int, int, int]:
    """(hc, ns, bq) of a CTA for a GQA group of rep (csrc `pa_rows`): hc
    heads of the group (a slice of it above ROWS), ns slices, bq positions
    of each head; rows hc * bq .. ROWS - 1 of a CTA are idle, and so are
    those past the group's last head in its last slice. Row r is head
    (slice * hc + r // bq) of the group at position t0 + r % bq."""
    hc = min(rep, ROWS)
    return hc, -(-rep // hc), ROWS // hc


def prefill_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, plen: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version. q (B, T, nh, hd); caches (B, nkv, S, hd) with
    rows 0..T-1 written; plen (B,). Returns (B, T, nh, hd) in q's dtype."""
    b, t, nh, hd = q.shape
    nkv, s = k_cache.shape[1], k_cache.shape[2]
    rep = nh // nkv
    qg = q.reshape(b, t, nkv, rep, hd).float()
    scores = torch.einsum("btkrh,bksh->btkrs", qg, k_cache.float()) / math.sqrt(hd)
    tpos = torch.arange(t, device=q.device)
    spos = torch.arange(s, device=q.device)
    visible = ((spos[None, None, :] <= tpos[None, :, None])
               & (spos[None, None, :] < plen.long()[:, None, None]))   # (B, T, S)
    scores = scores.masked_fill(~visible[:, :, None, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m)                                          # masked -> 0
    l = e.sum(dim=-1, keepdim=True)
    pv = torch.einsum("btkrs,bksh->btkrh", e.to(v_cache.dtype).float(),
                      v_cache.float())
    out = pv / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(b, t, nh, hd).to(q.dtype)


def prefill_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      plen: torch.Tensor) -> torch.Tensor:
    """Causal prefill attention over freshly written cache stripes.

    q (B, T, nh, hd): the prompt's queries at positions 0..T-1;
    k_cache/v_cache (B, nkv, S, hd), S >= T, rows 0..T-1 written;
    plen (B,) int32. Returns (B, T, nh, hd) in q's dtype."""
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k_cache, v_cache, plen)
    global launches
    require(q.device.type == "cuda", f"unsupported device {q.device}")
    require(q.dim() == 4 and k_cache.dim() == 4 and k_cache.shape == v_cache.shape,
            "q (B, T, nh, hd) and caches (B, nkv, S, hd) expected")
    b, t, nh, hd = q.shape
    bc, nkv, s, hdc = k_cache.shape
    require(bc == b and hdc == hd and s >= t, f"q {tuple(q.shape)} does not fit "
            f"cache {tuple(k_cache.shape)}")
    require(nkv >= 1 and nh % nkv == 0, f"nh/nkv={nh}/{nkv} is not a whole GQA group")
    require(hd % 2 == 0 and hd <= 256, f"head_dim {hd} must be even and <= 256")
    require(q.dtype == k_cache.dtype == v_cache.dtype,
            f"q {q.dtype} and cache {k_cache.dtype} dtypes differ")
    require(all(x.is_contiguous() for x in (q, k_cache, v_cache)),
            "q and caches must be contiguous")
    require(plen.dtype == torch.int32 and plen.shape == (b,) and plen.device == q.device
            and plen.is_contiguous(), "plen must be a contiguous (B,) int32 CUDA tensor")
    dtype = build.dtype_code(q)
    body = body_for(q.dtype, hd)
    lib = build.library("prefill_attention", _SIGNATURES)
    out = torch.empty_like(q)
    args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), plen.data_ptr(),
            out.data_ptr(), b, t, nh, nkv, s, hd)
    if body == "mma":
        require(all(x.data_ptr() % 16 == 0 for x in (q, k_cache, v_cache)),
                "q and caches must be 16-byte aligned")
        err = lib.rama_prefill_attention_mma(*args, build.stream_ptr(q))
    else:
        err = lib.rama_prefill_attention(*args, dtype, build.stream_ptr(q))
    build.check(lib, err, "prefill_attention")
    launches += 1
    launches_by_body[body] += 1
    launches_by_form[form_for(nh, nkv)] += 1
    return out
