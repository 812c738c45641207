"""Training step + loop (``repro.train.loop``): microbatch gradient
accumulation in float32, the optimizer update, periodic checkpointing and
the step-time watchdog.

``make_train_step`` builds the (params, opt_state, batch) -> (params,
opt_state, metrics) function the loop drives.  Its metrics carry the
MoE load-balancing loss (``aux_loss``, 0 for the other families) beside
the loss; with microbatches, their mean (the reference's accumulated
step reports ``ce_loss`` only).  PyTorch runs eagerly, so
the step has no ``jit``; its gradients come from autograd over the
parameter leaves.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dt
from repro_torch.models import loss_fn as model_loss_fn
from repro_torch.models.tree import param_leaves, tree_from_leaves, tree_map

from .optimizer import Optimizer


def value_and_grad(loss_fn: Callable, params, batch):
    """((loss, metrics), grads): ``loss_fn(params, batch)`` and its
    gradient with respect to every leaf of ``params`` (a nested dict),
    in the leaves' dtypes.  The inputs are not modified: the leaves are
    detached views that require grad."""
    pl = param_leaves(params)
    leaves = [x.detach().requires_grad_(True) for _, x in pl]
    tracked = tree_from_leaves([(path, x)
                                for (path, _), x in zip(pl, leaves)])
    with dt.scope(params, batch):
        loss, metrics = loss_fn(tracked, batch)
        grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_from_leaves(
        [(path, g) for (path, _), g in zip(pl, grads)])


def _microbatch(v, microbatches: int, i: int):
    """Rows ``[i B / mb, (i + 1) B / mb)`` of a (B, ...) batch leaf.  A
    DTensor batch is gathered along the batch, sliced, and laid out as it
    was (its rows of a microbatch live on other ranks)."""
    whole = dt.unshard(v, 0)
    mb = whole.reshape((microbatches, v.shape[0] // microbatches)
                       + tuple(v.shape[1:]))[i]
    if dt.is_dt(v):
        from repro_torch.distributed.sharding import constrain_batch_sharded
        mb = constrain_batch_sharded(mb)
    return mb


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *,
                    microbatches: int = 1,
                    loss_fn: Optional[Callable] = None) -> Callable:
    loss_fn = loss_fn or (lambda p, b: model_loss_fn(cfg, p, b))

    def compute_grads(params, batch):
        if microbatches == 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
            return loss, metrics, grads
        mbs = [{k: _microbatch(v, microbatches, i) for k, v in batch.items()}
               for i in range(microbatches)]
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        loss = torch.zeros((), dtype=torch.float32,
                           device=next(iter(batch.values())).device)
        aux = torch.zeros_like(loss)
        for mb in mbs:
            (mb_loss, mb_metrics), g = value_and_grad(loss_fn, params, mb)
            grads = tree_map(
                lambda a, x: a + x.to(torch.float32) / microbatches, grads, g)
            loss = loss + mb_loss / microbatches
            if "aux_loss" in mb_metrics:
                aux = aux + mb_metrics["aux_loss"] / microbatches
        return loss, {"ce_loss": loss, "aux_loss": aux}, grads

    def train_step(params, opt_state, batch):
        with dt.scope(params, batch):
            loss, metrics, grads = compute_grads(params, batch)
            params, opt_state, opt_metrics = optimizer.update(
                grads, opt_state, params)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def train_loop(cfg: ModelConfig, params, opt_state, data_iter, train_step, *,
               n_steps: int, start_step: int = 0,
               checkpointer=None, checkpoint_every: int = 0,
               watchdog=None, log_every: int = 10,
               log_fn: Callable = print) -> tuple:
    """Drives training with periodic async checkpoints and step-time
    watchdog hooks.  Returns (params, opt_state, history)."""
    history = []
    for step in range(start_step, n_steps):
        t0 = time.monotonic()
        batch = next(data_iter)
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if watchdog is not None or step % max(log_every, 1) == 0:
            if metrics["loss"].is_cuda:
                torch.cuda.synchronize(metrics["loss"].device)
        dt = time.monotonic() - t0
        if watchdog is not None:
            watchdog.observe(step, dt)
        if step % max(log_every, 1) == 0:
            rec = {k: float(v) for k, v in metrics.items()}
            rec.update(step=step, step_time_s=dt)
            history.append(rec)
            log_fn(f"step {step:6d} loss {rec.get('loss', float('nan')):.4f} "
                   f"({dt*1e3:.0f} ms)")
        if checkpointer is not None and checkpoint_every and \
                step > start_step and step % checkpoint_every == 0:
            checkpointer.save(step, {"params": params, "opt_state": opt_state})
    if checkpointer is not None and checkpoint_every:
        checkpointer.save(n_steps, {"params": params, "opt_state": opt_state})
        checkpointer.wait()
    return params, opt_state, history
