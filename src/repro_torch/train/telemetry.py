"""Gradient analytics from sketches (``repro.train.telemetry``, DESIGN.md
§3.1 of the reference): estimate inner products and cosines between
per-domain or per-worker gradients at O(m) communication with the paper's
estimator, and the gradient noise scale (critical batch size) from
sketched per-shard gradients.  Every estimate ships with the Theorem 1/3
Chebyshev half-width.

The sketches are the reference's choice: ``priority_sketch`` with its
default ``backend="reference"`` (``backend=`` passes another).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import obs
from repro_torch.core.estimator import estimate_inner_product
from repro_torch.core.priority import priority_sketch
from repro_torch.core.sketches import Sketch
from repro_torch.models.tree import param_leaves


class GradSketch(NamedTuple):
    sketch: Sketch
    norm2: torch.Tensor   # ||g||^2 (cheap local scalar, kept exact)


def sketch_grads(grads: Any, m: int, seed, *,
                 backend: str = "reference") -> GradSketch:
    """Priority sketch of the gradient tree flattened in the reference's
    leaf order, and its exact squared norm."""
    flat = torch.cat([x.reshape(-1).to(torch.float32)
                      for _, x in param_leaves(grads)])
    return GradSketch(priority_sketch(flat, m, seed, backend=backend),
                      torch.sum(flat * flat))


def grad_inner_product(a: GradSketch, b: GradSketch):
    """(estimate, chebyshev_halfwidth@95%) of <g_a, g_b>."""
    est = estimate_inner_product(a.sketch, b.sketch)
    m = a.sketch.capacity
    var_bound = 2.0 / max(m - 1, 1) * a.norm2 * b.norm2  # ||g_I|| <= ||g||
    half = torch.sqrt(var_bound / 0.05)
    return est, half


def grad_cosine(a: GradSketch, b: GradSketch) -> torch.Tensor:
    est, _ = grad_inner_product(a, b)
    return est / torch.sqrt(torch.clamp(a.norm2 * b.norm2, min=1e-30))


def gradient_noise_scale(per_shard: list, batch_per_shard: int):
    """Simple GNS estimate (McCandlish et al.): |g_small|^2 (per shard)
    against |g_big|^2 (the mean gradient), the big norm estimated from the
    pairwise sketch inner products, each pair i < j once and doubled (the
    estimator is symmetric).  Sets the ``repro_train_gns*`` gauges when
    observability is on."""
    W = len(per_shard)
    small2 = torch.mean(torch.stack([s.norm2 for s in per_shard]))
    total = 0.0
    half_sum = 0.0
    n_pairs = 0
    for i in range(W):
        total = total + per_shard[i].norm2
        for j in range(i + 1, W):
            est, half = grad_inner_product(per_shard[i], per_shard[j])
            total = total + 2.0 * est
            half_sum = half_sum + half
            n_pairs += 1
    big2 = total / (W * W)
    b_small = batch_per_shard
    b_big = batch_per_shard * W
    g2 = (b_big * big2 - b_small * small2) / max(b_big - b_small, 1)
    s = (small2 - big2) / (1.0 / b_small - 1.0 / b_big)
    gns = torch.clamp(s, min=0.0) / torch.clamp(g2, min=1e-30)
    if obs.enabled():
        mean_half = half_sum / n_pairs if n_pairs else 0.0
        obs.quality_monitor().observe_gns(
            float(gns), float(big2), float(small2), float(mean_half))
    return gns
