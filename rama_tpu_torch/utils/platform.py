"""Device selection for the port's entry points.

Entry points run on `cuda` unless the caller asks for the CPU. A request
for `cuda` on a machine without a visible GPU raises: the port never
carries on silently on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch sees no CUDA GPU; pass "
            "--device cpu (device='cpu') to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev
