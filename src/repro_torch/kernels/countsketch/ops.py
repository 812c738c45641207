"""Public CountSketch entry with the reference's signature: any float
vector and integer or tensor seeds in, the kernel's table out."""
from __future__ import annotations

import torch

from .countsketch import countsketch_scatter


def countsketch(values: torch.Tensor, m: int, seed_bucket,
                seed_sign) -> torch.Tensor:
    """(n,) -> (m,) float32 CountSketch of ``values`` (on its device)."""
    return countsketch_scatter(values.to(torch.float32).contiguous(), int(m),
                               int(seed_bucket), int(seed_sign))
