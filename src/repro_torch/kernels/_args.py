"""Argument conventions shared by the kernel wrappers."""
from __future__ import annotations

import torch

VARIANT_CODES = {"l2": 0, "l1": 1, "uniform": 2}
MAX_ROWS = 65535   # the kernels put rows on grid.y


def variant_code(variant: str) -> int:
    if variant not in VARIANT_CODES:
        raise ValueError(f"unknown variant {variant!r}")
    return VARIANT_CODES[variant]


def check_block(x: torch.Tensor, what: str) -> None:
    """A contiguous (D, n) float32 CUDA tensor with D <= MAX_ROWS."""
    if not x.is_cuda:
        raise ValueError(f"{what} must be a CUDA or CPU tensor, got {x.device}")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{what} must be a contiguous (D, n) float32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"{what} has {x.shape[0]} rows; at most {MAX_ROWS} "
                         "per launch")
