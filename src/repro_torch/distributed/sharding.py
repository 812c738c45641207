"""Logical-axis -> mesh-axis sharding rules (DP / TP / EP / FSDP + pod)
(``repro.distributed.sharding``), on ``torch.distributed``'s DTensor.

Parameters carry *logical* axis names in their ``ParamSpec``
(``models/transformer``); this module maps them onto the production mesh:

- TP  : vocab / heads / kv_heads / ffn / experts / inner / ssm_heads / rnn
        -> "model"
- EP  : the "experts" axis is TP's model axis (128 experts / 16 = 8 a card)
- FSDP: for ``cfg.fsdp`` archs the "embed" (d_model) axis additionally
        shards over "data" (ZeRO-3 style; optimizer state inherits)
- DP  : batch dims shard over ("pod", "data") when divisible

Axes apply only where the dimension divides by the mesh axis's size;
other dims replicate, as in the reference.

The rules return this module's :class:`PartitionSpec`: a tuple with one
entry a tensor dim, each a mesh-axis name, ``None`` or a tuple of names,
entry for entry the reference's ``jax.sharding.PartitionSpec``.  They
read only the mesh's axis sizes, so ``mesh`` is a ``DeviceMesh`` (its
``mesh_dim_names`` and ``shape``) or a plain ``{name: size}`` mapping.

The placement layer is the counterpart of ``NamedSharding`` and
``device_put``: :func:`placements_for` turns a spec into one
``Shard(d)`` / ``Replicate()`` a mesh dim (a tensor dim split over two
mesh axes, as ``("data", "model")``, is split data-major, JAX's order),
:class:`NamedSharding` pairs a mesh with a spec, and :func:`place` lays a
tree of tensors out as DTensors by a tree of shardings.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.dt import is_dt, pin_batch
from repro_torch.models.transformer import ParamSpec, param_specs
from repro_torch.models.tree import tree_map

TP_AXES = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "experts": "model",
    "inner": "model",
    "ssm_heads": "model",
    "rnn": "model",
}


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: one entry a tensor dim (a mesh-axis
    name, ``None``, or a tuple of names; a one-name tuple is stored as
    the name, as JAX's is); a plain tuple otherwise."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or of such a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _mesh_axis_size(shape: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= shape[a]
        return out
    return shape[axis]


def pspec_for(spec: ParamSpec, mesh, *, fsdp: bool,
              strategy: str = "tp") -> PartitionSpec:
    shape = mesh_axes(mesh)
    entries = []
    for dim, axis_name in zip(spec.shape, spec.axes):
        mesh_axis = None
        if strategy == "fsdp":
            # pure data parallelism: shard the d_model dim of every weight
            # over all non-pod axes (ZeRO-3); no tensor parallelism.
            if axis_name == "embed":
                cand = tuple(a for a in ("data", "model") if a in shape)
                mesh_axis = cand if cand else None
        else:
            if axis_name in TP_AXES and "model" in shape:
                mesh_axis = TP_AXES[axis_name]
            elif axis_name == "embed" and fsdp and "data" in shape:
                mesh_axis = "data"
        if mesh_axis is not None and dim % _mesh_axis_size(shape,
                                                           mesh_axis) != 0:
            mesh_axis = None  # replicate non-divisible dims
        entries.append(mesh_axis)
    return P(*entries)


def param_pspecs(cfg: ModelConfig, mesh) -> Any:
    return tree_map(lambda s: pspec_for(s, mesh, fsdp=cfg.fsdp,
                                        strategy=cfg.strategy),
                    param_specs(cfg))


def dp_axes(mesh) -> tuple:
    shape = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def batch_pspec(mesh, global_batch: int, extra_dims: int = 1,
                axes: tuple | None = None) -> PartitionSpec:
    """PartitionSpec for a (batch, ...) input.  ``axes`` overrides the DP
    axes (the fsdp strategy also shards batch over the model axis)."""
    shape = mesh_axes(mesh)
    axes = dp_axes(shape) if axes is None else tuple(
        a for a in axes if a in shape)
    if axes and global_batch % _mesh_axis_size(shape, axes) == 0:
        return P(axes, *([None] * extra_dims))
    # try pods only / data only before giving up
    for cand in (("data",), ("pod",)):
        cand = tuple(a for a in cand if a in shape)
        if cand and global_batch % _mesh_axis_size(shape, cand) == 0:
            return P(cand, *([None] * extra_dims))
    return P(*([None] * (extra_dims + 1)))


# ----------------------------------------------------------------------------
# Decode-state specs (mirror models/model.py cache layouts)
# ----------------------------------------------------------------------------


def _cache_pspec(cfg: ModelConfig, kind: str, mesh, batch: int,
                 stacked: bool) -> Any:
    """PartitionSpec tree matching one block's cache."""
    shape = mesh_axes(mesh)
    lead = (None,) if stacked else ()  # group/layer dim replicated
    bp = batch_pspec(shape, batch, 0)
    b = bp[0] if len(bp) > 0 else None
    model = "model" if "model" in shape else None

    def ok(dim, axis):
        return axis if axis and dim % _mesh_axis_size(shape, axis) == 0 \
            else None

    if kind in ("attn", "attn_local"):
        if cfg.serve_2d:
            # replicate batch; shard cache seq over every mesh axis
            axes = tuple(a for a in ("data", "model") if a in shape)
            return {"k": P(*lead, None, axes, None, None),
                    "v": P(*lead, None, axes, None, None),
                    "pos": P(*lead, None, axes)}
        kv = ok(cfg.n_kv_heads, model)
        # GQA archs with fewer kv heads than the model axis: shard the KV
        # cache along the *sequence* dim instead (sequence-sharded KV
        # decode).  The cache length is data-dependent: the spec shards
        # on seq unconditionally; placement replicates a seq dim the axis
        # does not divide (see :func:`placements_for`).
        seq = model if kv is None else None
        return {"k": P(*lead, b, seq, kv, None),
                "v": P(*lead, b, seq, kv, None),
                "pos": P(*lead, b, seq)}
    if kind == "ssd":
        return {"conv_x": P(*lead, b, None, ok(cfg.d_inner, model)),
                "conv_b": P(*lead, b, None, None),
                "conv_c": P(*lead, b, None, None),
                "ssm": P(*lead, b, ok(cfg.ssm_heads, model), None, None)}
    if kind == "rglru":
        return {"conv": P(*lead, b, None, ok(cfg.rnn_width, model)),
                "h": P(*lead, b, ok(cfg.rnn_width, model))}
    raise ValueError(kind)


def decode_state_pspecs(cfg: ModelConfig, mesh, batch: int) -> Any:
    shape = mesh_axes(mesh)
    model = "model" if "model" in shape else None
    bp = batch_pspec(shape, batch, 0)
    b = bp[0] if len(bp) > 0 else None

    def ok(dim, axis):
        return axis if axis and dim % _mesh_axis_size(shape, axis) == 0 \
            else None

    state: dict = {
        "pos": P(),
        "groups": {f"p{i}": _cache_pspec(cfg, kind, shape, batch, True)
                   for i, kind in enumerate(cfg.layer_pattern)},
    }
    if cfg.n_tail_layers:
        state["tail"] = {
            f"t{j}": _cache_pspec(cfg, cfg.layer_pattern[j], shape, batch,
                                  False)
            for j in range(cfg.n_tail_layers)}
    if cfg.is_encdec:
        kv = ok(cfg.n_kv_heads, model)
        seq = model if kv is None else None
        cross_g = {f"p{i}": {"k": P(None, b, seq, kv, None),
                             "v": P(None, b, seq, kv, None)}
                   for i in range(len(cfg.layer_pattern))}
        state["cross"] = {"groups": cross_g}
        if cfg.n_tail_layers:
            state["cross"]["tail"] = {
                f"t{j}": {"k": P(b, seq, kv, None), "v": P(b, seq, kv, None)}
                for j in range(cfg.n_tail_layers)}
    return state


# ----------------------------------------------------------------------------
# Placements: the NamedSharding / device_put layer
# ----------------------------------------------------------------------------


def placements_for(pspec, mesh, shape: tuple | None = None) -> tuple:
    """One ``Shard(d)`` / ``Replicate()`` a dim of the ``DeviceMesh``
    ``mesh``.  A tensor dim named by several mesh axes is split by them
    in the mesh's order, the first the major one (the axes of an entry
    must follow the mesh's order, as every rule here writes them).  With
    ``shape``, a dim that the named axes do not divide replicates (the
    data-dependent cache length of ``_cache_pspec``)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, tuple(mesh.shape)))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(pspec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"axes {axes} of {pspec} do not follow the "
                             f"mesh's order {names}")
        if shape is not None and shape[d] % _mesh_axis_size(sizes, axes):
            continue
        for i in pos:
            out[i] = Shard(d)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A mesh and a spec (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: PartitionSpec

    def placements(self, shape: tuple | None = None) -> tuple:
        return placements_for(self.spec, self.mesh, shape)


def param_shardings(cfg: ModelConfig, mesh) -> Any:
    return tree_map(lambda sp: NamedSharding(mesh, sp),
                    param_pspecs(cfg, mesh))


def batch_shardings(mesh, batch_specs: Any, axes: tuple | None = None) -> Any:
    """``batch_specs``: a tree whose leaves have ``.shape`` (tensors,
    ``meta`` tensors, ``ShapeDtypeStruct``s)."""
    return tree_map(lambda s: NamedSharding(
        mesh, batch_pspec(mesh, s.shape[0], len(s.shape) - 1, axes)),
        batch_specs)


def decode_state_shardings(cfg: ModelConfig, mesh, batch: int) -> Any:
    """The decode state's shardings, in the decode state's structure (the
    reference takes that structure as a fourth argument)."""
    return tree_map(lambda sp: NamedSharding(mesh, sp),
                    decode_state_pspecs(cfg, mesh, batch))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def place_leaf(x: torch.Tensor, sharding) -> torch.Tensor:
    """One tensor laid out by ``sharding`` (a :class:`NamedSharding`).  A
    plain tensor is the same full tensor on every rank: each keeps its
    own shard of it, with no communication.  A DTensor is
    redistributed."""
    pl = sharding.placements(tuple(x.shape))
    if is_dt(x):
        return x.redistribute(sharding.mesh, pl)
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, sharding.mesh, pl, src_data_rank=None)


def place(tree: Any, shardings: Any) -> Any:
    """``tree`` (nested dicts / NamedTuples of tensors) laid out by the
    same-structured ``shardings``; a :class:`NamedSharding` in place of a
    subtree applies to each of its leaves (``replicated(mesh)`` for
    AdamW's step)."""
    if isinstance(shardings, NamedSharding):
        if isinstance(tree, dict) or _is_namedtuple(tree):
            return place(tree, _broadcast(tree, shardings))
        return place_leaf(tree, shardings)
    if isinstance(tree, dict):
        return {k: place(tree[k], shardings[k]) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(place(v, s) for v, s in zip(tree, shardings)))
    raise TypeError(f"no sharding for {type(tree)}")


def _broadcast(tree, sharding):
    if isinstance(tree, dict):
        return {k: _broadcast(v, sharding) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_broadcast(v, sharding) for v in tree))
    return sharding


def opt_state_shardings(p_shard: Any, mesh) -> Any:
    """AdamW state's shardings: the step replicated, each moment as its
    parameter (the reference's ``_opt_state_shardings``)."""
    from repro_torch.train.optimizer import AdamWState
    return AdamWState(step=replicated(mesh), mu=p_shard, nu=p_shard)


def gather(tree: Any) -> Any:
    """Every DTensor of ``tree`` as its full plain tensor (the other
    leaves as they are)."""
    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(gather(v) for v in tree))
    return tree.full_tensor() if is_dt(tree) else tree


def constrain_batch_sharded(x, n_lead: int = 1):
    """``x`` redistributed to the batch-sharded layout (dim 0 over the DP
    axes, the rest replicated) when it is a DTensor, that is when a mesh
    is active; a plain tensor, or a batch the DP axes do not divide,
    passes through.  Pins the activation layout at module boundaries
    (the reference's ``with_sharding_constraint``, §Perf hillclimb B3:
    deferring the psum past the MoE gather inflates it by top_k)."""
    if not is_dt(x):
        return x
    sizes = mesh_axes(x.device_mesh)
    axes = dp_axes(sizes)
    if not axes or x.shape[0] % _mesh_axis_size(sizes, axes):
        return x
    return pin_batch(x)
