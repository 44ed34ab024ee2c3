"""chip_smoke.py's checks, on the CPU: the per-group comparison fails a
kernel that drops one edge row of one slot, the planted edges make such a
drop large, and a subset of phases never reads as a full run."""

import importlib.util
import pathlib
import sys

import pytest
import torch

from rama_tpu_torch.ops.kernels.decode_attention import decode_attention_plain
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
