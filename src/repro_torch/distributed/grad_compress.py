"""SketchDP: the paper's coordinated sampling sketches as a gradient
compressor for data-parallel training (``repro.distributed.
grad_compress``, DESIGN.md §3.1 of the reference).

Each data-parallel rank threshold- or priority-samples its local flat
gradient with a *shared per-step seed* (coordination), all-gathers only
the ``(idx, val, tau)`` sketch payload, O(m) a rank instead of the O(P)
dense all-reduce, and every rank reconstructs the unbiased mean gradient
locally:

    ghat_i = g_i / p_i  for sampled i        (unbiased: Thm 1 per rank)
    mean_g = (1/W) sum_w densify(sketch_w)

An error-feedback residual re-injects the mass a rank did not send on its
next step.  The flat gradient is the parameter leaves in the reference's
order (``models.convert.flatten_params``), so coordinate j is the same
coordinate in both packages.  The sketches go through the linear-time
build (``backend="kernel"``, the reference's ``"pallas"``): the threshold
build runs B3 and B2, the priority build B1 and B2.

The reference runs the step under ``shard_map`` over a mesh's
data-parallel axes; here each rank of a ``torch.distributed`` group (a
``DeviceMesh``'s axes ``axes``, or ``group=``) calls the step on its own
shard of the batch with its own (replicated) parameters, and the gather
is ``all_gather_into_tensor``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core.priority import priority_sketch
from repro_torch.core.sketches import INVALID_IDX
from repro_torch.core.threshold import threshold_sketch
from repro_torch.models.convert import flatten_params, unflatten_params
from repro_torch.models.tree import param_leaves

MAX_FLAT = (1 << 31) - 1    # coordinates are int32 in both packages


def sketch_gradient(flat_grad: torch.Tensor, m: int, seed, *,
                    method: str = "threshold", backend: str = "kernel"):
    """Sketch a flat gradient; returns (idx, val, tau).

    ``backend="kernel"`` (the default) routes through the linear-time
    build of ``kernels/sketch_build``; ``"reference"`` through the
    sort-based builders.  Kept sets and values are the same.  A flat
    vector of 2^31 or more coordinates raises: its ids do not fit the
    sketches' int32."""
    n = flat_grad.shape[-1]
    if n > MAX_FLAT:
        raise ValueError(f"a flat gradient of {n} coordinates does not fit "
                         f"int32 sketch ids (at most {MAX_FLAT})")
    if method == "threshold":
        sk = threshold_sketch(flat_grad, m, seed, backend=backend)
    elif method == "priority":
        sk = priority_sketch(flat_grad, m, seed, backend=backend)
    else:
        raise ValueError(f"unknown method {method!r}")
    return sk.idx, sk.val, sk.tau


def _rescaled(idx, val, tau):
    """(safe ids int64, contributions val / p, 0 where not kept) with
    ``p = min(1, tau val^2)``; ``tau`` broadcasts over the last axis."""
    p = torch.clamp(tau[..., None] * (val * val), max=1.0)
    valid = idx != INVALID_IDX
    contrib = torch.where(valid & (p > 0),
                          val / torch.where(p > 0, p, torch.ones_like(p)),
                          torch.zeros_like(p))
    return torch.where(valid, idx, 0).to(torch.int64), contrib


def densify_mean(idx, val, tau, n: int) -> torch.Tensor:
    """Reconstruct the mean of W gathered sketches.
    idx/val: (W, cap); tau: (W,)."""
    W = idx.shape[0]
    safe, contrib = _rescaled(idx, val, tau)
    out = torch.zeros((n,), dtype=torch.float32, device=val.device)
    out.index_add_(0, safe.reshape(-1), contrib.reshape(-1))
    return out / W


def error_feedback_residual(flat: torch.Tensor, idx, val, tau
                            ) -> torch.Tensor:
    """``flat`` less what a rank's own sketch carries (``densify`` of
    ``(idx, val, tau)``), in place: the error-feedback residual.  The
    sketch's ids are distinct, so each coordinate loses at most one
    contribution and the result is ``flat - sent`` exactly."""
    safe, contrib = _rescaled(idx, val, tau)
    return flat.index_add_(0, safe, -contrib)


def _all_gather(t: torch.Tensor, world: int, group) -> torch.Tensor:
    """(k,) on every rank -> (world, k), rank order."""
    out = torch.empty((world * t.shape[0],), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out.reshape(world, t.shape[0])


def step_seed(step) -> int:
    """The shared seed of a step: ``0x5EED + step`` as a uint32."""
    return (0x5EED + int(step)) & 0xFFFFFFFF


def _dp_group(mesh, axes: tuple):
    """The process group over ``mesh``'s axes ``axes`` (those it has):
    the ranks that share this rank's coordinates on every other axis."""
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in axes if a in names)
    if not axes:
        raise ValueError(f"the mesh {names} has none of the axes {axes}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def make_sketchdp_grad_fn(loss_fn: Callable, m: int, *,
                          method: str = "threshold",
                          error_feedback: bool = True, mesh=None,
                          axes: tuple = ("data",), group=None,
                          on_stage: Optional[Callable[[str, dict], None]]
                          = None
                          ) -> Callable:
    """grad_fn(params, batch, ef_state, step) -> (loss, mean_grads,
    new_ef_state) for one rank of ``group``: by default the data-parallel
    axes ``axes`` of ``mesh`` (a ``DeviceMesh``; the reference's ``mesh``
    and ``axes``) when one is given, else the default process group.

    ``batch`` is this rank's shard of the global batch; ``ef_state`` its
    own (n,) residual (:func:`init_ef_state`).  The only communication is
    the all-gather of the sketches and the mean of the loss.  The
    residual is updated in place of the flat gradient (no second n-sized
    buffer).  ``on_stage(name, tensors)``, when given, is called after
    each stage (``grad``, ``flatten``, ``sketch``, ``gather``,
    ``densify``) with what the stage made (``flatten``: the flat gradient
    plus the residual in, which the residual then overwrites; ``sketch``:
    ``idx``, ``val``, ``tau``): a hook for timing and checking."""
    from repro_torch.train.loop import value_and_grad
    if mesh is not None and group is None:
        group = _dp_group(mesh, axes)
    mark = on_stage or (lambda name, tensors: None)

    def grad_fn(params, batch, ef_state, step):
        (loss, _), grads = value_and_grad(loss_fn, params, batch)
        mark("grad", {})
        flat, meta = flatten_params(grads)
        del grads
        n = flat.shape[0]
        if error_feedback:
            flat += ef_state
        mark("flatten", {"flat": flat})
        idx, val, tau = sketch_gradient(flat, m, step_seed(step),
                                        method=method)
        mark("sketch", {"idx": idx, "val": val, "tau": tau})
        if error_feedback:
            new_ef = error_feedback_residual(flat, idx, val, tau)
        else:
            new_ef = torch.zeros_like(flat)
        del flat
        world = dist.get_world_size(group)
        g_idx, g_val, g_tau = (_all_gather(t.reshape(-1), world, group)
                               for t in (idx, val, tau))
        loss = loss.clone()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        loss = loss / world
        mark("gather", {})
        mean = unflatten_params(
            densify_mean(g_idx, g_val, g_tau.reshape(-1), n), meta)
        mark("densify", {})
        return loss, mean, new_ef

    return grad_fn


def init_ef_state(params) -> torch.Tensor:
    """A rank's error-feedback residual: zeros over the flat parameter
    vector, float32, on the parameters' device.  (The reference's
    ``init_ef_state(mesh, params, axes)`` makes the W ranks' residuals as
    one (W n,) array over the data-parallel axes; each rank here holds
    its own, which needs no mesh.)"""
    pl = param_leaves(params)
    n = sum(x.numel() for _, x in pl)
    return torch.zeros((n,), dtype=torch.float32, device=pl[0][1].device)


def compression_ratio(params, m: int, cap_overhead: float = 1.3) -> float:
    """Dense all-reduce bytes / sketch all-gather bytes (per rank)."""
    n = sum(x.numel() for _, x in param_leaves(params))
    dense = 4.0 * n
    sketch = 8.0 * m * cap_overhead  # idx (4B) + val (4B) per slot
    return dense / sketch


# ---------------------------------------------------------------------------
# Matrix mode: row-sampled compression of 2-D gradient tensors
# ---------------------------------------------------------------------------


def sketch_matrix_gradient(G: torch.Tensor, m: int, seed, *,
                           method: str = "priority"):
    """Row-sample a 2-D gradient tensor (n, d) -> (row_idx, rows, tau):
    whole rows with probability proportional to their squared norms
    (``repro_torch.matrix`` builders), the same seed contract as the flat
    path.  The payload is ``m (d + 1)`` words against ``n d`` dense."""
    from repro_torch.matrix import (priority_matrix_sketch,
                                    threshold_matrix_sketch)
    if method == "priority":
        sk = priority_matrix_sketch(G, m, seed)
    elif method == "threshold":
        sk = threshold_matrix_sketch(G, m, seed)
    else:
        raise ValueError(f"unknown method {method!r}")
    return sk.row_idx, sk.rows, sk.tau


def densify_matrix_mean(row_idx, rows, tau, n_rows: int) -> torch.Tensor:
    """Reconstruct the unbiased mean of W gathered matrix sketches.

    ``row_idx``: (W, cap); ``rows``: (W, cap, d); ``tau``: (W,).  Row i
    of shard w contributes ``rows_w[i] / p_i`` with
    ``p_i = min(1, tau_w ||rows_w[i]||^2)``."""
    W = row_idx.shape[0]
    wgt = torch.sum(rows * rows, dim=-1)               # (W, cap)
    p = torch.clamp(tau[:, None] * wgt, max=1.0)
    valid = row_idx != INVALID_IDX
    scale = torch.where(valid & (p > 0),
                        1.0 / torch.where(p > 0, p, torch.ones_like(p)),
                        torch.zeros_like(p))
    contrib = rows * scale[..., None]
    flat_idx = torch.where(valid, row_idx, 0).reshape(-1).to(torch.int64)
    out = torch.zeros((n_rows, rows.shape[-1]), dtype=torch.float32,
                      device=rows.device)
    out.index_add_(0, flat_idx, contrib.reshape(-1, rows.shape[-1]))
    return out / W


def matrix_compression_ratio(shape, m: int, *,
                             method: str = "priority") -> float:
    """Dense 2-D grad bytes / matrix-sketch payload bytes (per shard):
    priority sketches carry ``m`` row slots, threshold sketches the
    Lemma-4 capacity ``m + 4 ceil(sqrt(m))``."""
    from repro_torch.matrix import matrix_capacity
    n, d = shape
    slots = m if method == "priority" else matrix_capacity(m)
    dense = 4.0 * n * d
    sketch = 4.0 * slots * (d + 1)    # d f32 row values + 1 int32 row id
    return dense / sketch
