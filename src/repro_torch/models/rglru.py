"""RG-LRU recurrent block (``repro.models.rglru``; RecurrentGemma /
Griffin, arXiv:2402.19427).

    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)            (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training runs the linear recurrence as a log-depth scan over the
sequence: ``jax.lax.associative_scan`` has no PyTorch counterpart, so
:func:`linear_scan` is its recursion written out (the reference's
combine ``(a1 a2, a2 b1 + b2)`` in the same tree), and the float32 result
differs from the reference's in rounding only (XLA may fuse
``a2 b1 + b2``); decode is the O(1) step.  The block around it is
Griffin's: linear in -> causal conv(4) -> RG-LRU, gated by a GeLU branch,
then a linear out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import dt
from .ssm import causal_conv1d

_C = 8.0


def _gates(p, u):
    r_in, i_in = dt.keep_layout(u @ p["w_r"], u @ p["w_i"])
    r = torch.sigmoid(r_in)
    i = torch.sigmoid(i_in)
    log_a = (-_C * F.softplus(p["lam"].to(torch.float32))
             * r.to(torch.float32))
    a = torch.exp(log_a)
    one_less = 1.0 - a * a
    gated = (torch.sqrt(torch.maximum(one_less,
                                      torch.full_like(one_less, 1e-12)))
             * (i.to(torch.float32) * u.to(torch.float32)))
    return a, gated


def _combine(x, y):
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Positions 0, 2, 4, ... from ``even``, 1, 3, ... from ``odd``
    (along dim 1; ``even`` one longer when the length is odd)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2)
    out = pairs.reshape(pairs.shape[:1] + (2 * n,) + pairs.shape[3:])
    return out if even.shape[1] == n else torch.cat([out, even[:, n:]], 1)


def linear_scan(a: torch.Tensor, b: torch.Tensor):
    """All prefixes of the combine ``(a1 a2, a2 b1 + b2)`` along dim 1:
    the second is h_t = a_t h_{t-1} + b_t from h_{-1} = 0.  The
    reference's ``jax.lax.associative_scan`` recursion (combine adjacent
    pairs, scan the half, combine back into the even positions): depth
    2 ceil(log2 L), O(L) work."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = linear_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    return tuple(_interleave(torch.cat([e[:, :1], r], dim=1), o)
                 for e, r, o in zip((a, b), even, odd))


def rglru_scan(p, u: torch.Tensor, h0=None):
    """u: (B, L, W) conv output.  Returns (h_seq (B, L, W) in u's dtype,
    h_last (B, W) float32)."""
    a, b = _gates(p, u)
    if h0 is not None:
        # fold the initial state into the first element
        b = torch.cat([b[:, :1] + a[:, :1] * h0.to(torch.float32)[:, None],
                       b[:, 1:]], dim=1)
    # a rank scans its rows and channels
    _, h = dt.batch_local(linear_scan, "cc", "cc", a, b)
    return h.to(u.dtype), h[:, -1]


def rglru_step(p, u1: torch.Tensor, h):
    """u1: (B, 1, W); h: (B, W) -> (h1 (B, 1, W), h_new)."""
    a, b = _gates(p, u1)
    h_new = a[:, 0] * h.to(torch.float32) + b[:, 0]
    return h_new[:, None].to(u1.dtype), h_new


def _in_and_gate(p, x):
    u = x @ p["w_x"]
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    return dt.keep_layout(u, gate)


def recurrent_block_train(p, x: torch.Tensor, *, conv_state=None, h0=None):
    """Griffin recurrent block over a full sequence.  x: (B, L, d) ->
    (y, (conv_state, h_last))."""
    u, gate = _in_and_gate(p, x)
    u, conv_state = causal_conv1d(u, p["conv_w"], conv_state)
    h, h_last = rglru_scan(p, u, h0)
    y = (h * gate) @ p["w_out"]
    return y, (conv_state, h_last)


def recurrent_block_decode(p, x1: torch.Tensor, conv_state, h):
    u, gate = _in_and_gate(p, x1)
    u, conv_state = causal_conv1d(u, p["conv_w"], conv_state)
    h1, h_new = rglru_step(p, u, h)
    y = (h1 * gate) @ p["w_out"]
    return y, (conv_state, h_new)
