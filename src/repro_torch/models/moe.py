"""Mixture-of-Experts FFN with token-choice top-k routing
(``repro.models.moe``).

The assignments are sorted by expert id, packed into a fixed (E, C, d)
capacity buffer, run through batched expert products and combined back
with the router gates; an expert's assignments beyond its capacity are
dropped.  C = ceil8(int(T * top_k / E * cf) + 1).

The routing is the reference's: float32 router logits, top-k by a
stable descending sort (the lower expert id first on ties, as
``lax.top_k``), a stable sort of the assignments by expert id (as
``jnp.argsort``).  The buffer is built by gathers, never by a scatter
with duplicate indices, and so is every gradient:

- dispatch: slot (e, c) holds assignment ``first[e] + c`` of the sorted
  order while c < count[e].  **When any assignment is dropped, slot
  (0, 0) is zero.**  The reference sends every dropped assignment to
  slot (0, 0) with a zero token (``buf.at[be, bp].set(tok)``); on XLA's
  CPU the last of the duplicate writes wins, so the token first routed to
  expert 0 loses its expert output whenever anything is dropped.  The
  port reproduces that result explicitly (it is the live reference's);
- combine: each token's K contributions gathered and summed in ascending
  expert order in the activation dtype, the order in which the
  reference's ``.at[t_s].add`` accumulates on the CPU.  ``index_add_``
  is not used: on the card its float atomics change bits from run to
  run.

On DTensors (:func:`_moe_sharded`) every rank routes only its own
tokens, with the whole slab's capacity and drops, and the experts' slots
travel to the experts' ranks by all-to-all; no rank holds the slab.
"""
from __future__ import annotations

import math

import torch

from . import dt


def capacity(n_tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(n_tokens * top_k / n_experts * cf) + 1
    return -(-c // 8) * 8


class _Gather(torch.autograd.Function):
    """``out[i] = src[index[i]]`` where ``valid[i]``, else 0, with the
    gradient gathered back through the inverse map: ``g_src[j] =
    sum_r g_out[inv[j, r]]`` over ``inv_valid[j, r]``, in r order (no
    atomics, so its bits do not depend on the run)."""

    @staticmethod
    def forward(ctx, src, index, valid, inv, inv_valid):
        ctx.save_for_backward(inv, inv_valid)
        out = src[index]
        return torch.where(valid[:, None], out,
                           torch.zeros((), dtype=out.dtype, device=out.device))

    @staticmethod
    def backward(ctx, g_out):
        inv, inv_valid = ctx.saved_tensors
        g = None
        for r in range(inv.shape[1]):
            part = torch.where(inv_valid[:, r, None], g_out[inv[:, r]],
                               torch.zeros((), dtype=g_out.dtype,
                                           device=g_out.device))
            g = part if g is None else g + part
        return g, None, None, None, None


def _count(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)`` for ids below ``n``, with a
    shape that does not depend on the data (the dry run's fake tensors
    carry no values)."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def _route(xt, router, top_k: int):
    """The reference's router over a (T, d) token slab: logits (T, E)
    float32, expert ids (T, K) in top-k order and gates (T, K)
    float32."""
    logits = xt.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[:, :top_k], expert_ids[:, :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return logits, expert_ids, gate_vals


def _slot_maps(expert_ids, counts, cap: int, width: int, earlier, total):
    """The maps between a slab's assignments and a buffer of ``width``
    slots an expert.  An assignment is kept while its position among all
    assignments to its expert in flat token order is below ``cap``:
    ``earlier[e]`` of them lie in the slabs before this one, ``total[e]``
    in all slabs (``counts[e]`` in this one).  When anything anywhere is
    dropped, the first assignment to expert 0 in flat order gets a zero
    slot (the reference's duplicate writes).  -> (slot -> assignment,
    slot valid, assignment -> its slot or -1)."""
    T, top_k = expert_ids.shape
    dev = expert_ids.device
    flat_e = expert_ids.reshape(-1)                         # (T*K,)
    order = torch.sort(flat_e, stable=True).indices         # (T*K,)
    e_s = flat_e[order]
    first = torch.cumsum(counts, 0) - counts                 # (E,)
    pos = torch.arange(T * top_k, device=dev) - first[e_s]  # in its expert
    keep_s = pos + earlier[e_s] < cap
    # slot (e, c) <- sorted assignment first[e] + c, while it is kept
    c = torch.arange(width, device=dev)
    n_keep = torch.clamp(torch.minimum(counts, cap - earlier), min=0)
    slot_valid = c[None, :] < n_keep[:, None]
    # the reference's duplicate writes: a drop zeroes slot (0, 0)
    slot_valid[0, 0] &= ~((total > cap).any() & (earlier[0] == 0))
    slot_src = torch.clamp(first[:, None] + c[None, :], max=T * top_k - 1)
    slot_assign = order[slot_src].reshape(-1)               # (E*W,) flat a
    slot_valid = slot_valid.reshape(-1)
    # assignment a = t*K + k -> its slot, -1 if dropped
    slot_of = torch.full((T * top_k,), -1, dtype=torch.int64, device=dev)
    slot_of[order] = torch.where(keep_s, e_s * width + pos,
                                 torch.full_like(pos, -1))
    return slot_assign, slot_valid, slot_of


def _routing(xt, router, n_experts: int, top_k: int, cap: int):
    """The reference's routing of a whole (T, d) token slab: logits,
    expert ids, gates (:func:`_route`) and the slot maps of the (E, cap)
    buffer (:func:`_slot_maps`)."""
    logits, expert_ids, gate_vals = _route(xt, router, top_k)
    counts = _count(expert_ids.reshape(-1), n_experts)
    maps = _slot_maps(expert_ids, counts, cap, cap, torch.zeros_like(counts),
                      counts)
    return (logits, expert_ids, gate_vals) + maps


def _slots(slot_of, slot_assign, slot_valid, lo: int, hi: int):
    """The buffer slots ``[lo, hi)`` (a range of experts' rows): whether
    each assignment's slot is among them, its slot counted from ``lo``
    (clamped into the range), and the range's slot -> assignment map and
    validity."""
    here = (slot_of >= lo) & (slot_of < hi)                 # (T*K,)
    lslot = torch.clamp(slot_of - lo, min=0, max=hi - lo - 1)
    return here, lslot, slot_assign[lo:hi], slot_valid[lo:hi]


def _dispatch(x, slot_assign, slot_valid, slot_of, top_k: int, C: int,
              lo: int, hi: int):
    """The capacity buffer's slots ``[lo, hi)`` gathered from the tokens
    ``x`` (T, d) -> ((hi - lo) / C, C, d): slot <- its assignment's token;
    a token's gradient sums its K slots."""
    T, d = x.shape
    here, lslot, sa, sv = _slots(slot_of, slot_assign, slot_valid, lo, hi)
    buf = _Gather.apply(x, torch.div(sa, top_k, rounding_mode="floor"), sv,
                        lslot.reshape(T, top_k),
                        (here & sv[lslot]).reshape(T, top_k))
    return buf.reshape(-1, C, d)


def _experts(buf, w_gate, w_up, w_down, act_fn):
    """The experts' gated MLPs over their rows of the buffer."""
    h_gate = act_fn(torch.bmm(buf, w_gate))
    h_up = torch.bmm(buf, w_up)
    return torch.bmm(h_gate * h_up, w_down)


def _combine(out_buf, gate_vals, expert_ids, slot_assign, slot_valid,
             slot_of, lo: int, hi: int):
    """Each token's K outputs from the slots ``[lo, hi)`` (``out_buf``
    (n, C, d)) times their gates, summed in ascending expert order ->
    (T, d) (the slots outside the range contribute 0: with a partial
    range this is one term of the sum)."""
    T, top_k = expert_ids.shape
    d = out_buf.shape[-1]
    here, lslot, sa, sv = _slots(slot_of, slot_assign, slot_valid, lo, hi)
    # assignment <- its slot's output (a slot's gradient is its one
    # assignment's)
    out_tok = _Gather.apply(out_buf.reshape(-1, d), lslot, here,
                            sa[:, None], sv[:, None])
    contrib = out_tok * gate_vals.reshape(-1, 1).to(out_buf.dtype)
    contrib = contrib.reshape(T, top_k, d)
    # each token's contributions in ascending expert order
    by_expert = torch.sort(expert_ids, dim=-1).indices       # (T, K)
    out = None
    for k in range(top_k):
        part = torch.gather(contrib, 1,
                            by_expert[:, k, None, None].expand(T, 1, d))[:, 0]
        out = part if out is None else out + part
    return out


def _moe_tokens(p, xt: torch.Tensor, *, n_experts: int, top_k: int, act_fn,
                capacity_factor: float):
    """Core dispatch over a flat (T, d) token slab -> (out (T, d),
    (logits, expert_ids)); on DTensors :func:`_moe_sharded`."""
    T, d = xt.shape
    C = capacity(T, top_k, n_experts, capacity_factor)
    if dt.is_dt(xt):
        return _moe_sharded(p, xt, n_experts=n_experts, top_k=top_k,
                            act_fn=act_fn, C=C)
    logits, expert_ids, gate_vals, slot_assign, slot_valid, slot_of = \
        _routing(xt, p["router"], n_experts, top_k, C)
    hi = n_experts * C                                       # every slot
    buf = _dispatch(xt, slot_assign, slot_valid, slot_of, top_k, C, 0, hi)
    out_buf = _experts(buf, p["w_gate"], p["w_up"], p["w_down"], act_fn)
    out = _combine(out_buf, gate_vals, expert_ids, slot_assign, slot_valid,
                   slot_of, 0, hi)
    return out, (logits, expert_ids)


def _earlier_and_total(counts, mesh, dims):
    """(E,) assignment counts of this rank's slab -> the counts of the
    slabs before it in flat token order, and of all slabs: one
    all-gather of the counts a mesh dim in ``dims`` (the dims that split
    the tokens; a slab's place in token order is its coordinate along
    them, the first the major one)."""
    import torch.distributed._functional_collectives as funcol
    every = counts[None]
    for i in reversed(dims):
        every = funcol.all_gather_tensor(every, 0, (mesh, i))
    coord = mesh.get_coordinate()
    block = 0
    for i in dims:
        block = block * mesh.shape[i] + coord[i]
    before = torch.arange(every.shape[0], device=counts.device) < block
    return (every * before[:, None]).sum(0), every.sum(0)


def _to_experts(buf, mesh, dim: int):
    """All-to-all over mesh dim ``dim``, whose n ranks hold E / n experts
    each: (E, W, d) slots of this rank's tokens by expert -> (E / n,
    n W, d) slots of this rank's experts by source rank."""
    import torch.distributed._functional_collectives as funcol
    E, W, d = buf.shape
    n = mesh.shape[dim]
    got = funcol.all_to_all_single_autograd(buf.reshape(E * W, d), None,
                                            None, (mesh, dim))
    return got.reshape(n, E // n, W, d).transpose(0, 1).reshape(
        E // n, n * W, d)


def _from_experts(out, mesh, dim: int):
    """The inverse of :func:`_to_experts`: (E / n, n W, d) -> (E, W, d)."""
    import torch.distributed._functional_collectives as funcol
    El, nW, d = out.shape
    n = mesh.shape[dim]
    send = out.reshape(El, n, nW // n, d).transpose(0, 1).reshape(-1, d)
    got = funcol.all_to_all_single_autograd(send, None, None, (mesh, dim))
    return got.reshape(n * El, nW // n, d)


def _moe_sharded(p, xt, *, n_experts: int, top_k: int, act_fn, C: int):
    """The MoE on DTensors: every rank routes only its own tokens.

    The slab is split over every mesh dim where the tokens are split,
    and over the dims where they are whole too when the rank's tokens
    divide among them (each rank a contiguous piece).  The capacity C is
    the whole slab's and the drops are global: one all-gather of the
    (E,) counts a split dim gives each rank the assignments to each
    expert in the slabs before its own (:func:`_earlier_and_total`).  A
    rank's kept assignments fill its (E, W, d) buffer, W = min(C, its
    tokens) (no slab can keep more for one expert).  Where the mesh
    splits the experts along a dim that splits the tokens, one
    all-to-all sends each expert's slots to its rank and one brings the
    outputs back; where it splits them along a dim the tokens are whole
    on, each rank runs its own experts and the outputs are gathered over
    that dim; else each rank runs every expert on its own slots.  The
    output is laid out as ``xt``.  -> (out (T, d), (logits, expert_ids),
    split as the tokens)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = xt.device_mesh
    xt = dt.unshard(xt, 1)
    layout = tuple(xt.placements)
    whole = [i for i, pl in enumerate(layout) if not pl.is_shard()]
    divides = xt.to_local().shape[0] % math.prod(
        mesh.shape[i] for i in whole) == 0
    tok = tuple(Shard(0) if pl.is_shard() or divides else Replicate()
                for pl in layout)
    split = [i for i, pl in enumerate(tok) if pl.is_shard()]
    xs = xt.redistribute(mesh, tok)
    x_l = xs.to_local()
    # the experts' dim (the last, where several split them)
    ep = [i for i, pl in enumerate(p["w_gate"].placements)
          if pl.is_shard() and pl.dim == 0][-1:]
    w_pl = tuple(Shard(0) if i in ep else Replicate()
                 for i in range(mesh.ndim))
    # a weight serves this rank's tokens only: a pending sum over the
    # dims that split them (its expert dim aside)
    w_grad = tuple(Shard(0) if i in ep else Partial() if i in split
                   else Replicate() for i in range(mesh.ndim))
    r_grad = tuple(Partial() if i in split else Replicate()
                   for i in range(mesh.ndim))
    router = p["router"].redistribute(mesh, (Replicate(),) * mesh.ndim
                                      ).to_local(grad_placements=r_grad)
    ws = [p[k].redistribute(mesh, w_pl).to_local(grad_placements=w_grad)
          for k in ("w_gate", "w_up", "w_down")]

    logits, expert_ids, gate_vals = _route(x_l, router, top_k)
    counts = _count(expert_ids.reshape(-1), n_experts)
    earlier, total = _earlier_and_total(counts, mesh, split)
    W = min(C, x_l.shape[0])
    sa, sv, so = _slot_maps(expert_ids, counts, C, W, earlier, total)
    full = n_experts * W
    if ep and ep[0] in split:                 # all-to-all to the experts
        buf = _to_experts(_dispatch(x_l, sa, sv, so, top_k, W, 0, full),
                          mesh, ep[0])
        out_buf = _from_experts(_experts(buf, *ws, act_fn), mesh, ep[0])
    elif ep:              # tokens whole along the expert dim: own experts
        lo = mesh.get_coordinate()[ep[0]] * ws[0].shape[0] * W
        hi = lo + ws[0].shape[0] * W
        # (the dispatch's gradient: this rank's experts' share)
        x_d = xs.to_local(grad_placements=tuple(
            Partial() if i in ep else pl for i, pl in enumerate(tok)))
        mine = _experts(_dispatch(x_d, sa, sv, so, top_k, W, lo, hi), *ws,
                        act_fn)
        sub = mesh[mesh.mesh_dim_names[ep[0]]]
        out_buf = DTensor.from_local(mine, sub, (Shard(0),),
                                     run_check=False).redistribute(
            sub, (Replicate(),)).to_local()
    else:                                     # every expert on this rank
        out_buf = _experts(_dispatch(x_l, sa, sv, so, top_k, W, 0, full),
                           *ws, act_fn)
    out = _combine(out_buf, gate_vals, expert_ids, sa, sv, so, 0, full)

    def up(t):
        return DTensor.from_local(t, mesh, tok, run_check=False)

    return up(out).redistribute(mesh, layout), (up(logits), up(expert_ids))


def moe_ffn(p, x: torch.Tensor, *, n_experts: int, top_k: int, act_fn,
            capacity_factor: float = 1.25, per_row: bool = False):
    """x: (B, S, d) -> ((B, S, d), (logits (B*S, E), expert_ids
    (B*S, K))).  p: ``router`` (d, E), ``w_gate`` / ``w_up`` (E, d, f),
    ``w_down`` (E, f, d).

    ``per_row=True`` dispatches each batch row on its own (capacity a
    row, drops decided a row, the reference's vmap)."""
    B, S, d = x.shape
    if per_row:
        outs, logits, eids = [], [], []
        for row in dt.unshard(x, 0):
            o, (lg, e) = _moe_tokens(p, row, n_experts=n_experts,
                                     top_k=top_k, act_fn=act_fn,
                                     capacity_factor=capacity_factor)
            outs.append(o)
            logits.append(lg)
            eids.append(e)
        return torch.stack(outs), (torch.cat(logits), torch.cat(eids))
    out, aux = _moe_tokens(p, x.reshape(B * S, d), n_experts=n_experts,
                           top_k=top_k, act_fn=act_fn,
                           capacity_factor=capacity_factor)
    return out.reshape(B, S, d), aux


def shared_expert_ffn(p, x: torch.Tensor, *, act_fn):
    """Always-on shared experts (qwen2-moe): a gated MLP with the shared
    experts fused into one wider FFN."""
    gate = act_fn(dt.linear(x, dt.fsdp_whole(p["w_gate"], 0, x)))
    up = dt.linear(x, dt.fsdp_whole(p["w_up"], 0, x))
    return dt.row_parallel(gate * up, p["w_down"])


def load_balancing_loss(logits: torch.Tensor, expert_ids: torch.Tensor,
                        n_experts: int, top_k: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * p_e.  On DTensors
    (split as :func:`_moe_sharded` splits the tokens) each rank sums its
    own rows' probabilities and counts, and the (2, E) sums are reduced
    across the mesh."""
    if not dt.is_dt(logits):
        return _balance(logits, expert_ids, n_experts, top_k)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = logits.device_mesh
    local = torch.stack([
        torch.softmax(logits.to_local(), dim=-1).sum(0),
        _count(expert_ids.to_local().reshape(-1), n_experts).to(
            torch.float32)])
    sums = DTensor.from_local(
        local, mesh, tuple(Partial() if pl.is_shard() else Replicate()
                           for pl in logits.placements),
        run_check=False).redistribute(mesh, (Replicate(),) * mesh.ndim)
    T = logits.shape[0]
    return n_experts * torch.sum(sums[1] / (T * top_k) * (sums[0] / T))


def _balance(logits, expert_ids, n_experts: int, top_k: int):
    probs = torch.softmax(logits, dim=-1)                    # (T, E)
    p_mean = probs.mean(dim=0)
    f = (_count(expert_ids.reshape(-1), n_experts).to(torch.float32)
         / (expert_ids.shape[0] * top_k))
    return n_experts * torch.sum(f * p_mean)
