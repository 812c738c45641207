"""What the model code needs to run on DTensors (parameters, batch and
decode state laid out by ``distributed.sharding``).

Sharding propagation covers most ops; where it has no rule, or where a
view would split a sharded dim unevenly, the model code calls one of
these first.  Each is the identity on a plain tensor, so the
single-device path runs exactly the ops it ran before; on a DTensor each
redistributes, which is real communication (the collective counters of
the dry run record it).
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dt(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor for a plain
    tensor's sake)."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    return isinstance(x, _dtensor_type())


def settle(x):
    """A DTensor's pending reductions (``Partial`` placements) done:
    each becomes ``Replicate``; the shards stay."""
    if not is_dt(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def unshard(x, *dims: int):
    """A DTensor with tensor dims ``dims`` whole on every rank (the mesh
    dims that split them replicate; pending reductions are done).  No
    ``dims``: the whole tensor replicated."""
    if not is_dt(x):
        return x
    from torch.distributed.tensor import Replicate
    nd = x.ndim
    want = {d % nd for d in dims} if dims else set(range(nd))
    pl = tuple(Replicate() if p.is_partial()
               or (p.is_shard() and p.dim % nd in want) else p
               for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def fsdp_whole(w, dim: int, x):
    """``w``, gathered along its d_model dim ``dim`` (which fsdp splits
    over the data axes) when the activation ``x`` (B, S, ...) it meets is
    a DTensor of more than one position: FSDP's gather, its gradient
    reduce-scattered back.  Left to DTensor, such a product can contract
    over the split d instead, which makes the batch's rows whole on every
    rank (a whole pod's rows of a training step's MLP).  One-token decode
    keeps that choice: its rows are few, the weights many times larger.
    A plain tensor passes through."""
    if not is_dt(w) or x.shape[1] <= 1:
        return w
    return unshard(w, dim)


def linear(x, w):
    """``x @ w`` for a 2-D ``w``.  On a DTensor ``x`` of more than two
    dims the leading dims are folded into one first: DTensor runs a
    (B, S, d) @ (d, f) product as a batched one, ``w`` copied once a row
    of the batch (a one-token decode's (rows, d, f) copy of every
    projection)."""
    if not is_dt(x) or x.ndim <= 2:
        return x @ w
    return (x.reshape(-1, x.shape[-1]) @ w).reshape(x.shape[:-1] + (-1,))


def row_parallel(x, w):
    """``x @ w`` of a product that contracts x's last dim (split over
    ``model``: an MLP's down projection, an attention's or a recurrent
    block's output projection).  On a DTensor of more than one position
    each rank multiplies its own rows' share of that dim by its rows of
    ``w`` (``w`` gathered over the data axes where fsdp splits it) and
    the result is a pending sum over ``model``: left to DTensor, the
    backward of such a product can make every position of the batch
    whole on a rank.  Otherwise ``x @ w``."""
    if not is_dt(x) or x.shape[1] <= 1:
        return linear(x, w)
    return batch_local(torch.matmul, "cf", "p", x, w)


def shard_count(x, dim: int) -> int:
    """How many pieces the mesh splits tensor dim ``dim`` of ``x`` into
    (1 for a plain tensor)."""
    if not is_dt(x):
        return 1
    n = 1
    for size, p in zip(x.device_mesh.shape, x.placements):
        if p.is_shard() and p.dim % x.ndim == dim % x.ndim:
            n *= size
    return n


def pin_batch(x):
    """The residual stream at a block's entry, on a DTensor laid out
    batch-sharded (dim 0 over the data-parallel axes, the rest
    replicated; pending reductions done): sharding propagation picks
    layouts op by op, and without a pin a block can hand the next one
    activations split along the sequence, which later products have no
    rule for.  A plain tensor passes through."""
    if not is_dt(x):
        return x
    pl = _layout(x.device_mesh, "b", x.shape)
    return x if tuple(x.placements) == pl else x.redistribute(
        x.device_mesh, pl)


class _SumLast(torch.autograd.Function):
    """A DTensor summed over its last dim on each rank's own columns (a
    pending sum across the mesh where the mesh splits that dim); the
    gradient is expanded to the local columns only (DTensor's own rule
    expands it to the full dim before splitting it again)."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import DTensor, Partial
        last = x.ndim - 1
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        ctx.local_shape = x.to_local().shape
        out_pl = tuple(Partial() if p.is_shard() and p.dim % x.ndim == last
                       else p for p in x.placements)
        return DTensor.from_local(x.to_local().sum(-1), ctx.mesh, out_pl,
                                  run_check=False, shape=x.shape[:-1],
                                  stride=_contiguous_strides(x.shape[:-1]))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate
        last = len(ctx.local_shape) - 1
        want = tuple(Replicate() if p.is_shard() and p.dim == last else p
                     for p in ctx.placements)
        if tuple(g.placements) != want:
            g = g.redistribute(ctx.mesh, want)
        local = g.to_local()[..., None].expand(ctx.local_shape)
        return DTensor.from_local(local, ctx.mesh, ctx.placements,
                                  run_check=False)


def _contiguous_strides(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def sum_last(x):
    """``x.sum(-1)``; see :class:`_SumLast` for a DTensor."""
    if not is_dt(x):
        return x.sum(-1)
    return _SumLast.apply(x)


def logsumexp(x, dim: int):
    """``torch.logsumexp(x, dim)``; on a DTensor split along its last dim
    (the vocabulary of the loss's logits), the max and the sum of
    exponentials reduce across the mesh (two small all-reduces) instead
    of gathering ``x`` whole."""
    if shard_count(x, dim) == 1:
        return torch.logsumexp(unshard(x, dim), dim=dim)
    assert dim % x.ndim == x.ndim - 1
    m = settle(x.detach().amax(dim=dim, keepdim=True))
    return torch.log(settle(sum_last(torch.exp(x - m)))) + m.squeeze(dim)


def split_softmax_values(s, cv):
    """``softmax(s) @ v`` of one-token decode attention whose scores ``s``
    (B, K, G, 1, C) the mesh splits along the cache (a sequence-sharded
    KV cache): each rank exponentiates its own positions against the
    global max and the sums and products reduce across the mesh
    (flash-decoding's combine; all-reduces of B H and B H dh floats),
    instead of gathering the scores.  ``cv``: (B, C, K, dh)."""
    m = settle(s.detach().amax(dim=-1, keepdim=True))
    e = torch.exp(s - m)
    den = settle(sum_last(e))[..., None]
    num = settle(torch.matmul(
        e, cv.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]))
    return num / den


def aligned(ref, t, ref_dim: int, t_dim: int = 0):
    """``t`` (a plain tensor along ``ref``'s dim ``ref_dim``: a column
    mask, the column ids) split as ``ref`` splits that dim when ``ref``
    is a DTensor (each rank keeps its own piece, no communication), so
    that ops and their gradients stay at the local size; else ``t``."""
    if not is_dt(ref):
        return t
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    rd = ref_dim % ref.ndim
    pl = tuple(Shard(t_dim) if p.is_shard() and p.dim % ref.ndim == rd
               else Replicate() for p in ref.placements)
    return distribute_tensor(t, ref.device_mesh, pl, src_data_rank=None)


def take_last(x, idx):
    """``torch.gather(x, -1, idx[..., None])[..., 0]`` (the gold logit of
    each position).  On a DTensor split along its last dim (the
    vocabulary) each rank gathers from its own columns, 0 where the
    column is another rank's, and the one nonzero a row is summed across
    the mesh: exact, and nothing of the (B, S, V) shape is made or saved
    beyond the logits' own gradient."""
    if shard_count(x, -1) == 1:
        return torch.gather(unshard(x, -1), -1, idx[..., None])[..., 0]
    cols = aligned(x, torch.arange(x.shape[-1], device=x.device), -1)
    return settle(batch_local(_pick, "cbm", "p", x, idx, cols))


def _pick(x, idx, cols):
    """Each row's entry at column ``idx`` among this rank's consecutive
    columns ``cols`` (0 where ``idx`` is not among them)."""
    n = x.shape[-1]
    li = idx - cols[0]
    ok = (li >= 0) & (li < n)
    got = torch.gather(x, -1, torch.clamp(li, 0, n - 1)[..., None])[..., 0]
    return torch.where(ok, got, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def like(ref, t):
    """``t`` (a plain tensor made by a factory) as a replicated DTensor
    on ``ref``'s mesh when ``ref`` is a DTensor; ``t`` otherwise."""
    if not is_dt(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


class _GradUnshard(torch.autograd.Function):
    """Identity; the gradient's dim ``dim`` is gathered when the mesh
    splits it into pieces that do not divide ``groups``."""

    @staticmethod
    def forward(ctx, x, dim, groups):
        ctx.dim, ctx.groups = dim, groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.groups % shard_count(g, ctx.dim):
            g = unshard(g, ctx.dim)
        return g, None, None


class _KeepLayout(torch.autograd.Function):
    """Identity; the gradient is laid out as the input was (replicated
    where the input was a pending sum)."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        ctx.mesh = x.device_mesh
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dt(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def keep_layout(*xs):
    """``xs`` as they are; on DTensors each gradient is redistributed to
    its tensor's own layout on the way back (the backward of an
    elementwise op may pick another, say one split along the sequence,
    that the weight gradient's product has no rule for).  Plain tensors
    pass through."""
    out = tuple(_KeepLayout.apply(x) if is_dt(x) else x for x in xs)
    return out[0] if len(out) == 1 else out


def grad_unshard(x, dim: int, groups: int):
    """``x``, whose gradient reaches a view that splits dim ``dim`` into
    ``groups`` (a merge of the GQA groups, read backwards): on a DTensor
    that gradient is gathered along ``dim`` first when the mesh would
    split the groups unevenly.  A plain tensor passes through."""
    if not is_dt(x):
        return x
    return _GradUnshard.apply(x, dim, groups)


_MODEL_DIM = {"c": -1, "m": -1, "f": 0, "h": 1, "k": 2}


def _model_dim(kind: str, ndim: int):
    d = _MODEL_DIM.get(kind)
    return None if d is None else d % ndim


def _layout(mesh, kind: str, shape, dp_ok: bool = True,
            model_ok: bool = False) -> tuple:
    """Placements of one kind (see :func:`batch_local`): dim 0 over the
    mesh's data-parallel axes (``pod`` / ``data``) for the kinds ``b``,
    ``c``, ``h``, ``k``, ``p`` when ``dp_ok``, the kind's model dim over
    ``model`` when ``model_ok`` (``p``: a pending sum over ``model``), the
    rest replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    names = tuple(mesh.mesh_dim_names or ())
    dp = [i for i, a in enumerate(names) if a in ("pod", "data")]
    size = 1
    for i in dp:
        size *= mesh.shape[i]
    ndim = len(shape)
    batched = kind in "bchkp" and ndim > 0 and dp_ok and shape[0] % size == 0
    mdim = _model_dim(kind, ndim) if ndim else None
    out = []
    for i, name in enumerate(names):
        if i in dp and batched:
            out.append(Shard(0))
        elif name == "model" and model_ok and kind == "p":
            out.append(Partial())
        elif name == "model" and model_ok and mdim is not None:
            out.append(Shard(mdim))
        else:
            out.append(Replicate())
    return tuple(out)


def batch_local(fn: Callable, layout: str, out_layout: str, *args):
    """``fn(*args)`` on each rank's shards, for code with no sharding rule
    that works independently along the batch and, where it says so, along
    one model-split dim (a scan over the sequence, the SSD chunk
    recurrence, a causal conv, the attention tiles).

    ``layout`` gives each argument's kind, ``out_layout`` each returned
    tensor's: ``b`` the batch (dim 0) split over the data-parallel axes
    and the rest whole; ``c`` that and the last dim over ``model``; ``h``
    dim 1 over ``model``; ``k`` dim 2 over ``model``; ``m`` only the last
    dim over ``model``; ``f`` only dim 0 over ``model``; ``r`` whole;
    ``p`` (a result) the batch split and
    a pending sum over ``model``; ``-`` not a tensor.  The batch is
    split only if every batched argument's divides, the model dims only
    if every one divides, so the local shards agree.  DTensor arguments
    are redistributed so, ``fn`` runs on their local tensors, and the
    results come back as DTensors.  An argument whole along a mesh dim
    the call splits the work over gets its gradient back as a pending
    sum over that dim (each rank's share of it).  With no DTensor among
    ``args``: ``fn(*args)``."""
    first = next((a for a in args if is_dt(a)), None)
    if first is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor
    mesh = first.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    sizes = dict(zip(names, tuple(mesh.shape)))
    dp_size = 1
    for a in ("pod", "data"):
        dp_size *= sizes.get(a, 1)
    tens = [(k, a) for k, a in zip(layout, args)
            if isinstance(a, torch.Tensor)]
    batched = [a for k, a in tens if k in "bchk"]
    dp_ok = bool(batched) and all(a.shape[0] % dp_size == 0
                                  for a in batched)
    msize = sizes.get("model")
    split_m = [(k, a) for k, a in tens if k in "chkmf"]
    model_ok = msize is not None and bool(split_m) and all(
        a.shape[_model_dim(k, a.ndim)] % msize == 0 for k, a in split_m)
    # the mesh dims this call splits the work over: an argument whole on
    # one of them is used by each rank for its own share, so its
    # gradient is the sum of the ranks' (a pending sum there)
    from torch.distributed.tensor import Partial, Replicate
    split = {i for i, n in enumerate(names)
             if (dp_ok and n in ("pod", "data"))
             or (model_ok and n == "model")}
    local = []
    for kind, a in zip(layout, args):
        if isinstance(a, torch.Tensor):
            if not is_dt(a):
                a = like(first, a)
            pl = _layout(mesh, kind, a.shape, dp_ok, model_ok)
            grad_pl = tuple(Partial() if i in split and isinstance(
                p, Replicate) else p for i, p in enumerate(pl))
            a = a.redistribute(mesh, pl).to_local(grad_placements=grad_pl)
        local.append(a)
    outs = fn(*local)
    single = isinstance(outs, torch.Tensor)
    outs = (outs,) if single else outs
    back = []
    for kind, o in zip(out_layout, outs):
        if isinstance(o, torch.Tensor):
            # the global shape's dim 0 divides, as the inputs' did
            shape = (dp_size,) + tuple(o.shape[1:]) if o.ndim else ()
            o = DTensor.from_local(o, mesh, _layout(mesh, kind, shape, dp_ok,
                                                    model_ok),
                                   run_check=False)
        back.append(o)
    return back[0] if single else type(outs)(back)


def merged(w, dim: int):
    """A weight's dims ``dim`` and ``dim + 1`` merged into one (``wq``
    (d, H, dh) -> (d, H dh), ``wo`` (H, dh, d) -> (H dh, d)).  On a
    DTensor the gradient's merged dim is gathered, where the mesh splits
    it unevenly into the weight's ``w.shape[dim]`` heads, before the
    view back splits it."""
    shape = tuple(w.shape)
    out = w.reshape(shape[:dim] + (shape[dim] * shape[dim + 1],)
                    + shape[dim + 2:])
    return grad_unshard(out, dim, shape[dim])


def split_guard(x, groups: int, dim: int = -1):
    """``x`` ready for a view that splits dim ``dim`` into ``groups``
    leading pieces (the GQA heads, K of them): on a DTensor whose mesh
    splits that dim into a count that does not divide ``groups``, the
    dim is gathered first.  A plain tensor passes through."""
    if is_dt(x) and groups % shard_count(x, dim):
        return unshard(x, dim)
    return x


def shard_offset(t, d: int) -> int:
    """Where this rank's shard of DTensor ``t`` starts along dim ``d``
    (the mesh dims that split it, first the major one; ``torch.chunk``'s
    pieces), from the mesh coordinate alone."""
    start, size = 0, t.shape[d]
    for c, n, p in zip(t.device_mesh.get_coordinate(), t.device_mesh.shape,
                       t.placements):
        if p.is_shard() and p.dim % t.ndim == d:
            chunk = -(-size // n)
            start += c * chunk
            size = max(0, min(chunk, size - c * chunk))
    return start


def ring_write_(t, dim: int, index, src):
    """``t.index_copy_(dim, index, src)`` where ``index`` holds
    consecutive positions modulo ``t.shape[dim]`` (a ring cache's slots).
    On a DTensor cache, which the mesh may split along ``dim`` (a
    sequence-sharded KV cache), each rank writes its own positions in
    place: a position takes its source row where the ring puts one there
    and keeps its value otherwise; ``src`` is laid out as the cache on
    every other dim and whole along ``dim``.  No cache is gathered."""
    if not is_dt(t):
        return t.index_copy_(dim, index, src)
    from torch.distributed.tensor import Replicate
    mesh, nd = t.device_mesh, t.ndim
    d = dim % nd
    want = tuple(Replicate() if p.is_shard() and p.dim % nd == d else p
                 for p in t.placements)
    src_l = (src if is_dt(src) else like(t, src)).redistribute(
        mesh, want).to_local()
    idx = index.full_tensor() if is_dt(index) else index
    local = t.to_local()
    C, n = t.shape[d], src.shape[d]
    pos = shard_offset(t, d) + torch.arange(local.shape[d],
                                            device=local.device)
    j = (pos - idx[0]) % C                          # source row of position
    hit = j < n
    rows = src_l.index_select(d, torch.clamp(j, max=n - 1))
    shape = [1] * nd
    shape[d] = local.shape[d]
    local.copy_(torch.where(hit.reshape(shape), rows, local))
    return t


def mesh_of(tree):
    """The mesh of the first DTensor among ``tree``'s leaves (nested
    dicts, lists, tuples), or None."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            m = mesh_of(v)
            if m is not None:
                return m
        return None
    return tree.device_mesh if is_dt(tree) else None


_SCOPE_DEPTH = [0]


def scope(*trees):
    """The context a step over ``trees`` runs in: with a DTensor among
    them, plain tensors made inside (masks, position tables, running
    sums' zeros) count as replicated where they meet one
    (``implicit_replication``, entered by the outermost scope only: its
    exit clears the flag rather than restoring it); else nothing."""
    if _SCOPE_DEPTH[0] or mesh_of(list(trees)) is None:
        return contextlib.nullcontext()
    return _outer_scope()


@contextlib.contextmanager
def _outer_scope():
    from torch.distributed.tensor.experimental import implicit_replication
    _SCOPE_DEPTH[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _SCOPE_DEPTH[0] -= 1


def no_grad_scope(*trees):
    """``torch.inference_mode()`` for plain trees; ``torch.no_grad()``
    where a DTensor is among them (DTensor views of tensors made outside
    inference mode cannot be taken inside it)."""
    if mesh_of(list(trees)) is None:
        return torch.inference_mode()
    return torch.no_grad()
