"""The parameter and decode-state carriers between the two packages.

Both packages keep parameters as nested dicts in the same layout
(``groups/p<i>`` leaves stacked over the groups, ``tail/t<j>``
unrolled).  The reference's flat order is ``jax.tree.leaves``: dict keys
sorted at every level, each stacked ``(n_groups, ...)`` leaf one block.
SketchDP hashes coordinate j of that flat vector, so a sketch built by
either package joins with the other's only if both flatten in this order
(:func:`flatten_params` is the reference's ``grad_compress._flatten``).
"""
from __future__ import annotations

import numpy as np
import torch

from .transformer import param_dtype, param_specs
from .tree import param_leaves, tree_from_leaves


def flatten_params(tree):
    """Concatenate the leaves, each flattened and cast to float32, in the
    reference's order -> (flat (n,) float32, meta for
    :func:`unflatten_params`)."""
    pl = param_leaves(tree)
    meta = tuple((path, tuple(x.shape), x.dtype) for path, x in pl)
    flat = torch.cat([x.reshape(-1).to(torch.float32) for _, x in pl])
    return flat, meta


def unflatten_params(flat: torch.Tensor, meta) -> dict:
    """Inverse of :func:`flatten_params`: each leaf sliced out, reshaped
    and cast back to its dtype."""
    out, off = [], 0
    for path, shape, dtype in meta:
        size = int(np.prod(shape, dtype=np.int64))
        out.append((path, flat[off:off + size].reshape(shape).to(dtype)))
        off += size
    if off != flat.shape[0]:
        raise ValueError(f"flat vector has {flat.shape[0]} entries; the "
                         f"layout holds {off}")
    return tree_from_leaves(out)


def params_from_reference(cfg, tree, *, device=None) -> dict:
    """The JAX package's parameters (nested dicts of numpy arrays, as
    ``jax.device_get`` gives them) -> the port's, in the config dtype on
    ``device`` (default ``cuda``).  Every leaf of ``param_specs(cfg)``
    must be there with its shape, and nothing else."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    dtype = param_dtype(cfg)
    want = dict(param_leaves(param_specs(cfg)))
    got = dict(param_leaves(tree))
    if set(want) != set(got):
        raise ValueError(f"parameter paths differ: missing "
                         f"{sorted(set(want) - set(got))}, extra "
                         f"{sorted(set(got) - set(want))}")
    out = []
    for path, spec in want.items():
        a = np.array(got[path], dtype=np.float32)
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"{'/'.join(path)}: shape {a.shape}, expected "
                             f"{spec.shape}")
        out.append((path, torch.as_tensor(a, device=dev).to(dtype)))
    return tree_from_leaves(out)


def params_to_reference(tree) -> dict:
    """The port's parameters (or gradients) -> nested dicts of float32
    numpy arrays, the layout the JAX package takes."""
    return tree_from_leaves([(path, x.detach().to(torch.float32).cpu().numpy())
                   for path, x in param_leaves(tree)])


def state_from_reference(cfg, tree, *, device=None) -> dict:
    """The JAX package's decode state (nested dicts of numpy arrays, as
    ``jax.device_get`` gives them) -> the port's, on ``device`` (default
    ``cuda``): ``pos`` and the caches' ``pos`` int32, ``ssm`` and ``h``
    float32, the rest in the config dtype.  The leaf paths must be those
    of :func:`~repro_torch.models.model.init_decode_state` for ``cfg``."""
    from repro_torch.device import resolve_device
    from .model import init_decode_state
    dev = resolve_device(device)
    want = dict(param_leaves(init_decode_state(cfg, 0, 1, 1, device="cpu")))
    got = dict(param_leaves(tree))
    if set(want) != set(got):
        raise ValueError(f"state paths differ: missing "
                         f"{sorted(set(want) - set(got))}, extra "
                         f"{sorted(set(got) - set(want))}")
    out = []
    for path, like in want.items():
        a = np.asarray(got[path])
        if a.ndim != like.ndim:
            raise ValueError(f"{'/'.join(path)}: {a.ndim} dims, expected "
                             f"{like.ndim}")
        a = np.array(a, dtype=np.int32 if like.dtype == torch.int32
                     else np.float32)
        out.append((path, torch.as_tensor(a, device=dev).to(like.dtype)))
    return tree_from_leaves(out)


def state_to_reference(state) -> dict:
    """The port's decode state -> nested dicts of numpy arrays in the
    reference's layout: int32 where the state is, float32 elsewhere.
    The arrays are copies: decode steps write the state in place."""
    return tree_from_leaves([
        (path, np.array(x.cpu().numpy() if x.dtype == torch.int32
                        else x.to(torch.float32).cpu().numpy()))
        for path, x in param_leaves(state)])
