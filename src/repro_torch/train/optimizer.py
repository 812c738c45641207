"""AdamW with global-norm clipping and warmup-cosine schedule
(``repro.train.optimizer``).

Moments are float32 whatever the parameter dtype; the update is computed
in float32 and cast back to each parameter's dtype.  Weight decay is
decoupled and applied only to leaves with ``ndim >= 2``, as the
reference's: in the stacked layout a group's norm gains are
``(n_groups, d)`` and *are* decayed, ``final_norm`` is not.  Trees are the
port's nested parameter dicts; the update is functional (new tensors, the
inputs left as they are), as the reference's is.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models import dt
from repro_torch.models.tree import param_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: Any
    nu: Any


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> Callable:
    """step -> learning rate (float32 scalar tensor): linear warmup to
    ``base_lr`` over ``warmup`` steps, then a cosine down to ``min_frac``
    of it at ``total``."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        dev = step.device
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (
            1 + torch.cos(_f32(math.pi, dev) * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    leaves = [x for _, x in param_leaves(tree)]
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def adamw(lr, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda step: _f32(lr, step.device))

    def init(params):
        dev = param_leaves(params)[0][1].device
        def zeros(p):
            # a sharded parameter's moments are sharded as it is
            return torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    def update(grads, state: AdamWState, params):
        with dt.scope(params):
            return _update(grads, state, params)

    def _update(grads, state: AdamWState, params):
        step = state.step + 1
        stepf = step.to(torch.float32)
        dev = step.device
        gnorm = global_norm(grads)
        scale = (torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9),
                             max=1.0) if clip_norm else _f32(1.0, dev))
        lr_t = lr_fn(step)
        bc1 = 1.0 - torch.pow(_f32(b1, dev), stepf)
        bc2 = 1.0 - torch.pow(_f32(b2, dev), stepf)

        def upd(g, m, v, p):
            g = g.to(torch.float32) * scale
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * g * g
            delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
            if p.ndim >= 2 and weight_decay:
                delta = delta + weight_decay * p.to(torch.float32)
            return ((p.detach().to(torch.float32) - lr_t * delta).to(p.dtype),
                    m_new, v_new)

        out = tree_map(upd, grads, state.mu, state.nu, params)
        pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
        return pick(0), AdamWState(step, pick(1), pick(2)), {
            "grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init=init, update=update)
