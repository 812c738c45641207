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
    counts = torch.bincount(flat_e, minlength=n_experts)
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


def _moe_tokens(p, xt: torch.Tensor, *, n_experts: int, top_k: int, act_fn,
                capacity_factor: float):
    """Core dispatch over a flat (T, d) token slab -> (out (T, d),
    (logits, expert_ids))."""
    T, d = xt.shape
    C = capacity(T, top_k, n_experts, capacity_factor)
    logits, expert_ids, gate_vals, slot_assign, slot_valid, slot_of = \
        _routing(xt, p["router"], n_experts, top_k, C)
    kept = slot_of >= 0                                      # (T*K,)
    slot_safe = torch.clamp(slot_of, min=0)
    # dispatch: slot <- its assignment's token; a token's gradient sums
    # its K slots
    buf = _Gather.apply(xt, torch.div(slot_assign, top_k,
                                      rounding_mode="floor"),
                        slot_valid, slot_safe.reshape(T, top_k),
                        kept.reshape(T, top_k) & slot_valid[slot_safe]
                        .reshape(T, top_k))
    buf = buf.reshape(n_experts, C, d)

    h_gate = act_fn(torch.bmm(buf, p["w_gate"]))
    h_up = torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h_gate * h_up, p["w_down"]).reshape(-1, d)

    # combine: assignment <- its slot's output (a slot's gradient is its
    # one assignment's)
    out_tok = _Gather.apply(out_buf, slot_safe, kept,
                            slot_assign[:, None], slot_valid[:, None])
    contrib = out_tok * gate_vals.reshape(-1, 1).to(xt.dtype)
    contrib = contrib.reshape(T, top_k, d)
    # each token's contributions in ascending expert order
    by_expert = torch.sort(expert_ids, dim=-1).indices       # (T, K)
    out = None
    for k in range(top_k):
        part = torch.gather(contrib, 1,
                            by_expert[:, k, None, None].expand(T, 1, d))[:, 0]
        out = part if out is None else out + part
    return out, (logits, expert_ids)


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
        for row in x:
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
    probs = torch.softmax(logits, dim=-1)                    # (T, E)
    p_mean = probs.mean(dim=0)
    f = (torch.bincount(expert_ids.reshape(-1), minlength=n_experts)
         .to(torch.float32) / (expert_ids.shape[0] * top_k))
    return n_experts * torch.sum(f * p_mean)
