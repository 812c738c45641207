"""Public JL projection with the reference's signature."""
from __future__ import annotations

import torch

from .jl_rademacher import jl_rademacher
from .ref import jl_row_seeds, sqrt_m


def jl_project(values: torch.Tensor, m: int, seed) -> torch.Tensor:
    """``S(a) = Pi a / sqrt(m)``, Pi regenerated from ``seed`` (never
    stored), on ``values``' device."""
    v = values.to(torch.float32).contiguous()
    rows = torch.arange(int(m), dtype=torch.int64, device=v.device)
    return jl_rademacher(v, jl_row_seeds(seed, rows)) / sqrt_m(m)
