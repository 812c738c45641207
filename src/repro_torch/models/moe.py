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
"""
from __future__ import annotations

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
        return torch.where(valid[:, None], out, torch.zeros_like(out))

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


def _routing(xt, router, n_experts: int, top_k: int, cap: int):
    """The reference's routing of a (T, d) token slab: logits (T, E)
    float32, expert ids (T, K) in top-k order, gates (T, K) float32, and
    the maps between assignments and buffer slots."""
    T = xt.shape[0]
    dev = xt.device
    logits = xt.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[:, :top_k], expert_ids[:, :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    flat_e = expert_ids.reshape(-1)                         # (T*K,)
    order = torch.sort(flat_e, stable=True).indices         # (T*K,)
    e_s = flat_e[order]
    counts = _count(flat_e, n_experts)
    first = torch.cumsum(counts, 0) - counts                 # (E,)
    pos = torch.arange(T * top_k, device=dev) - first[e_s]  # in its expert
    keep_s = pos < cap
    # slot (e, c) <- sorted assignment first[e] + c, while c < count[e]
    c = torch.arange(cap, device=dev)
    slot_valid = c[None, :] < torch.clamp(counts, max=cap)[:, None]
    # the reference's duplicate writes: a drop zeroes slot (0, 0)
    slot_valid[0, 0] &= ~(counts > cap).any()
    slot_src = torch.clamp(first[:, None] + c[None, :], max=T * top_k - 1)
    slot_assign = order[slot_src].reshape(-1)               # (E*C,) flat a
    slot_valid = slot_valid.reshape(-1)
    # assignment a = t*K + k -> its slot, -1 if dropped
    slot_of = torch.full((T * top_k,), -1, dtype=torch.int64, device=dev)
    slot_of[order] = torch.where(keep_s, e_s * cap + pos,
                                 torch.full_like(pos, -1))
    return logits, expert_ids, gate_vals, slot_assign, slot_valid, slot_of


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
    (logits, expert_ids)).  On DTensors the routing runs replicated
    (every rank routes every token: the capacity and the drops are the
    whole slab's); where the mesh splits the experts, each rank runs its
    own over every token (:func:`_moe_expert_parallel`), else the
    dispatch and the combine run replicated and the expert products on
    the weights' shards."""
    T, d = xt.shape
    C = capacity(T, top_k, n_experts, capacity_factor)
    routing = dt.replicated_call(_routing, xt, p["router"], n_experts,
                                 top_k, C)
    if dt.shard_count(p["w_gate"], 0) > 1:
        return _moe_expert_parallel(p, xt, routing, top_k=top_k,
                                    act_fn=act_fn, C=C)
    logits, expert_ids, gate_vals, slot_assign, slot_valid, slot_of = routing
    hi = n_experts * C                                       # every slot
    buf = dt.replicated_call(_dispatch, xt, slot_assign, slot_valid, slot_of,
                             top_k, C, 0, hi)
    out_buf = _experts(buf, p["w_gate"], p["w_up"], p["w_down"], act_fn)
    out = dt.replicated_call(_combine, out_buf, gate_vals, expert_ids,
                             slot_assign, slot_valid, slot_of, 0, hi)
    return out, (logits, expert_ids)


def _moe_expert_parallel(p, xt, routing, *, top_k: int, act_fn, C: int):
    """The MoE on DTensors whose experts the mesh splits: each rank runs
    its own experts (their weights gathered over any other axis) over the
    whole routing, and the token outputs are a pending sum over the expert
    axes; the tokens and the gates get their gradients back as such sums.
    -> (out (T, d), (logits, expert_ids))."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    logits, expert_ids, gate_vals, slot_assign, slot_valid, slot_of = routing
    mesh = p["w_gate"].device_mesh
    split = [i for i, pl in enumerate(p["w_gate"].placements)
             if pl.is_shard() and pl.dim == 0]
    rep = (Replicate(),) * mesh.ndim
    part = tuple(Partial() if i in split else Replicate()
                 for i in range(mesh.ndim))
    ep = tuple(Shard(0) if i in split else Replicate()
               for i in range(mesh.ndim))
    x_l = xt.redistribute(mesh, rep).to_local(grad_placements=part)
    g_l = gate_vals.redistribute(mesh, rep).to_local(grad_placements=part)
    e_l, sa, sv, so = [t.redistribute(mesh, rep).to_local()
                       for t in (expert_ids, slot_assign, slot_valid,
                                 slot_of)]
    ws = [p[k].redistribute(mesh, ep) for k in ("w_gate", "w_up", "w_down")]
    lo = dt.shard_offset(ws[0], 0) * C
    hi = lo + ws[0].to_local().shape[0] * C
    buf = _dispatch(x_l, sa, sv, so, top_k, C, lo, hi)
    out_buf = _experts(buf, *(w.to_local() for w in ws), act_fn)
    out = _combine(out_buf, g_l, e_l, sa, sv, so, lo, hi)
    return (DTensor.from_local(out, mesh, part, run_check=False),
            (logits, expert_ids))


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
    gate = act_fn(x @ p["w_gate"])
    up = x @ p["w_up"]
    return (gate * up) @ p["w_down"]


def load_balancing_loss(logits: torch.Tensor, expert_ids: torch.Tensor,
                        n_experts: int, top_k: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * p_e."""
    return dt.replicated_call(_balance, logits, expert_ids, n_experts, top_k)


def _balance(logits, expert_ids, n_experts: int, top_k: int):
    probs = torch.softmax(logits, dim=-1)                    # (T, E)
    p_mean = probs.mean(dim=0)
    f = (_count(expert_ids.reshape(-1), n_experts).to(torch.float32)
         / (expert_ids.shape[0] * top_k))
    return n_experts * torch.sum(f * p_mean)
