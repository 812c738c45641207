"""Mamba-2 SSD (state-space duality) block (``repro.models.ssm``): the
chunked parallel form for training, the one-token recurrent form.

Recurrence (per head h, state size N, head dim P):
    H_t = exp(dt_t * A_h) * H_{t-1} + dt_t * B_t (x) x_t      (N x P state)
    y_t = C_t . H_t + D_h * x_t

Chunked form (arXiv:2405.21060): the sequence in chunks of Q tokens;
within a chunk the quadratic, attention-like form; across chunks a loop
carries the (H, N, P) state (the reference's ``lax.scan``).  The
projections stay separate (``w_z`` / ``w_x`` / ``w_b`` / ``w_c`` /
``w_dt``), as the reference keeps them.

**One departure, in the gradient only.**  The reference computes the
intra-chunk decay as ``where(tri, exp(diff), 0)``: above the diagonal
``diff`` is a positive sum of up to Q decay steps, which overflows to
``inf`` at Q = 256, and the gradient of the ``where`` is then
``0 * inf = NaN``.  Here the mask comes first (``exp(where(tri, diff,
-inf))``): the forward is the same, the gradients finite.  The SSD output
does not depend on Q, so at the published chunk the reference at a short
chunk is this form's oracle.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import dt as dt_mod


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv.  x: (B, L, D); w: (K, D).  ``state``
    ((B, K-1, D), the trailing inputs of the previous segment) prefixes
    the input when given.  Returns (y, new_state).  On DTensors each rank
    convolves its rows and channels."""
    return dt_mod.batch_local(_conv, "cmc", "cc", x, w, state)


def _conv(x, w, state):
    K = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    L = x.shape[1]
    y = xp[:, 0:L] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + L] * w[i]
    new_state = xp[:, -(K - 1):] if K > 1 else state
    return y, new_state


def _project(p, x):
    z = dt_mod.linear(x, p["w_z"])        # gate   (B, L, di)
    xs = dt_mod.linear(x, p["w_x"])       # values (B, L, di)
    Bm = dt_mod.linear(x, p["w_b"])       # (B, L, N)
    Cm = dt_mod.linear(x, p["w_c"])
    dt = dt_mod.linear(x, p["w_dt"])      # (B, L, H)
    return dt_mod.keep_layout(z, xs, Bm, Cm, dt)


def _gated_norm(p, y, z, dtype):
    y = y * F.silu(z)
    yf = y.to(torch.float32)
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + 1e-6)
            * (1.0 + p["norm"].to(torch.float32))).to(dtype)


def _conv_silu(p, xs, Bm, Cm, state):
    xs, conv_x = causal_conv1d(xs, p["conv_x"], state.get("conv_x"))
    Bm, conv_b = causal_conv1d(Bm, p["conv_b"], state.get("conv_b"))
    Cm, conv_c = causal_conv1d(Cm, p["conv_c"], state.get("conv_c"))
    return (F.silu(xs), F.silu(Bm), F.silu(Cm),
            {"conv_x": conv_x, "conv_b": conv_b, "conv_c": conv_c})


def _ssd_chunks(xs, Bm, Cm, dt, A, d_skip, h, *, chunk: int, n_state: int,
                headdim: int, dtype):
    """The chunked SSD over (B, L, ...) inputs from state ``h`` (None:
    zeros) -> (y (B, L, d_inner) in ``dtype``, final state).  The heads
    are those of ``dt`` (a rank's own on DTensors)."""
    B, L, d_inner = xs.shape
    H = dt.shape[-1]
    Q = min(chunk, L)
    assert L % Q == 0
    nc = L // Q
    # heads ahead of positions: (B, nc, H, Q, ...)
    xh = xs.reshape(B, nc, Q, H, headdim).to(torch.float32).transpose(2, 3)
    Bc = Bm.reshape(B, nc, Q, n_state).to(torch.float32)
    Cc = Cm.reshape(B, nc, Q, n_state).to(torch.float32)
    dtc = dt.reshape(B, nc, Q, H).transpose(2, 3)               # (B,nc,H,Q)
    cum = torch.cumsum(dtc * A[:, None], dim=-1)                # inclusive
    total = cum[..., -1]                                        # (B,nc,H)

    # --- intra-chunk (quadratic), the decay masked before exp ---
    CB = Cc @ Bc.transpose(-1, -2)                              # (B,nc,Q,Q)
    diff = cum[..., :, None] - cum[..., None, :]                # (B,nc,H,Q,Q)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xs.device).tril()
    decay = torch.exp(torch.where(tri, diff, float("-inf")))
    scores = CB[:, :, None] * decay * dtc[..., None, :]
    y_intra = scores @ xh                                       # (B,nc,H,Q,P)

    # --- chunk states ---
    w = torch.exp(total[..., None] - cum) * dtc                 # (B,nc,H,Q)
    S_chunk = (Bc.transpose(-1, -2)[:, :, None]
               @ (w[..., None] * xh))                           # (B,nc,H,N,P)

    # --- inter-chunk carry ---
    if h is None:
        h = torch.zeros((B, H, n_state, headdim), dtype=torch.float32,
                        device=xs.device)
    decay_c = torch.exp(total)
    y_inter = []
    for c in range(nc):
        y_inter.append((Cc[:, c, None] @ h)
                       * torch.exp(cum[:, c])[..., None])       # (B,H,Q,P)
        h = h * decay_c[:, c, :, None, None] + S_chunk[:, c]
    y_inter = torch.stack(y_inter, dim=1)

    y = (y_intra + y_inter
         + d_skip.to(torch.float32)[:, None, None] * xh)
    y = y.transpose(2, 3).reshape(B, L, d_inner).to(dtype)
    return y, h


def ssd_train(p, x: torch.Tensor, *, d_inner: int, n_state: int,
              headdim: int, chunk: int, state=None):
    """x: (B, L, d) -> (y (B, L, d), new_state dict).

    ``state`` = {"conv_x", "conv_b", "conv_c", "ssm"} for segment-wise
    prefill; the final states are returned for the decode handoff."""
    state = state or {}
    z, xs, Bm, Cm, dt = _project(p, x)
    xs, Bm, Cm, new_state = _conv_silu(p, xs, Bm, Cm, state)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["a_log"].to(torch.float32))                # (H,) < 0

    # the chunk recurrence is independent along the batch and the heads:
    # a rank runs it on its rows and heads
    y, h = dt_mod.batch_local(
        functools.partial(_ssd_chunks, chunk=chunk, n_state=n_state,
                          headdim=headdim, dtype=x.dtype),
        "cbbcmmh", "ch", xs, Bm, Cm, dt, A, p["d_skip"], state.get("ssm"))
    y = _gated_norm(p, y, z, x.dtype)
    out = dt_mod.row_parallel(y, p["w_out"])
    new_state["ssm"] = h
    return out, new_state


def _ssd_step(xs, Bm, Cm, dt, A, d_skip, ssm, *, headdim: int, dtype):
    """One token's SSD update: xs (B, 1, d_inner), dt (B, H) -> (y
    (B, 1, d_inner) in ``dtype``, new state (B, H, N, P))."""
    B, _, d_inner = xs.shape
    H = dt.shape[-1]
    xh = xs.reshape(B, H, headdim).to(torch.float32)
    Bv = Bm[:, 0].to(torch.float32)
    Cv = Cm[:, 0].to(torch.float32)
    decay = torch.exp(dt * A)                                   # (B, H)
    upd = dt[:, :, None, None] * Bv[:, None, :, None] * xh[:, :, None, :]
    ssm = ssm * decay[:, :, None, None] + upd
    y = ((Cv[:, None, None, :] @ ssm)[:, :, 0]
         + d_skip.to(torch.float32)[None, :, None] * xh)
    y = y.reshape(B, 1, d_inner).to(dtype)
    return y, ssm


def ssd_decode(p, x1: torch.Tensor, state, *, d_inner: int, n_state: int,
               headdim: int):
    """One-token recurrent step.  x1: (B, 1, d)."""
    z, xs, Bm, Cm, dt = _project(p, x1)
    xs, Bm, Cm, new_state = _conv_silu(p, xs, Bm, Cm, state)
    dt = F.softplus(dt.to(torch.float32)
                    + p["dt_bias"].to(torch.float32))[:, 0]     # (B, H)
    A = -torch.exp(p["a_log"].to(torch.float32))
    y, ssm = dt_mod.batch_local(
        functools.partial(_ssd_step, headdim=headdim, dtype=x1.dtype),
        "cbbcmmh", "ch", xs, Bm, Cm, dt, A, p["d_skip"], state["ssm"])
    y = _gated_norm(p, y, z, x1.dtype)
    out = dt_mod.linear(y, p["w_out"])
    new_state["ssm"] = ssm
    return out, new_state
