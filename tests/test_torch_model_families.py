"""Port parity: the family blocks of the LM stack (``repro_torch.models.
moe`` / ``ssm`` / ``rglru``, cross attention, the encoder, the image
prefix) against ``repro.models`` on numpy-seeded inputs, and SketchDP on
the reduced MoE config.

Tolerances (float32 throughout, each against the reference's value):

- outputs and gradients within ``TOL = 2e-5`` of the compared array's
  largest magnitude (the products and sums run in other orders);
- the MoE routing exactly: the expert ids and the kept assignments, also
  where capacity drops assignments and the reference's duplicate writes
  zero slot (0, 0) of the dispatch buffer;
- the RG-LRU scan is the reference's associative-scan tree, so it
  differs from it in the gates' rounding only (the same ``TOL``);
- the port's SSD at chunk 256 against the reference at chunk 16 (the
  reference's own gradients at chunk 256 are NaN, its masked ``exp``
  overflowing): loss within 1e-5, gradients finite and within 1e-4 of
  their scale.
"""
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import rglru as jrg
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro_torch.configs import get_config
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trg
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.models import (flatten_params, init_params, loss_fn,
                                params_from_reference)
from repro_torch.models.tree import param_leaves
from _torch_common import release_jax_executables  # noqa: F401
from whisper_grad_norms import compare as compare_whisper_grad_norms

TOL = 2e-5


def _np_tree(rng, shapes: dict, scale: float = 0.3) -> dict:
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            if isinstance(s, tuple) else _np_tree(rng, s, scale)
            for k, s in shapes.items()}


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), requires_grad=True)


def _grads_of(tree):
    if isinstance(tree, dict):
        return {k: _grads_of(v) for k, v in tree.items()}
    return (tree.grad.numpy() if tree.grad is not None
            else np.zeros(tuple(tree.shape), np.float32))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) / scale
    assert err < tol, err


def _close_trees(got, want, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close_trees(got[k], want[k], tol)
    else:
        _close(got, want, tol)


def _vjp_both(jfn, tfn, args_np, ct_np):
    """(the reference's output and input cotangents, the port's): ``jfn``
    / ``tfn`` take the same positional args (arrays or dicts of arrays)
    and return one array."""
    out, vjp = jax.vjp(jax.jit(jfn), *args_np)
    want = (np.asarray(out), vjp(jnp.asarray(ct_np)))
    targs = [_t(a) for a in args_np]
    got = tfn(*targs)
    got.backward(torch.as_tensor(ct_np))
    return want, (got.detach().numpy(), [_grads_of(a) for a in targs])


# ---------------------------------------------------------------- MoE

E, K, D_MODEL, F_EXP = 4, 2, 16, 24


def _moe_params(rng, skew: float = 0.0):
    p = _np_tree(rng, {"router": (D_MODEL, E), "w_gate": (E, D_MODEL, F_EXP),
                       "w_up": (E, D_MODEL, F_EXP),
                       "w_down": (E, F_EXP, D_MODEL)})
    # a skewed router sends most tokens to experts 0 and 1
    p["router"][:, :2] += np.float32(skew)
    return p


def _ref_keep(expert_ids: np.ndarray, T: int, cf: float) -> np.ndarray:
    """The reference's kept assignments (``moe.py:64-70``), by token and
    top-k slot, from its expert ids."""
    flat = expert_ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    e_s = flat[order]
    pos = np.arange(flat.size) - np.searchsorted(e_s, e_s, side="left")
    keep = np.zeros(flat.size, bool)
    keep[order] = pos < jmoe.capacity(T, K, E, cf)
    return keep.reshape(expert_ids.shape)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("skew", [0.0, 3.0])
def test_moe_ffn_matches_reference(per_row, skew):
    """Output, logits, expert ids and the input / weight gradients; with
    the skewed router capacity drops assignments (the kept set equals the
    reference's), and the reference's slot (0, 0) is zero: its output at
    the token first routed to expert 0 lacks that expert's contribution,
    and the port's does too."""
    rng = np.random.default_rng(7 + int(skew))
    Bx, Sx = 2, 32
    p = _moe_params(rng, skew)
    # with the skew, inputs of positive mean route every token to experts
    # 0 and 1, past their capacity
    x = (rng.standard_normal((Bx, Sx, D_MODEL))
         + (1.0 if skew else 0.0)).astype(np.float32)
    ct = rng.standard_normal((Bx, Sx, D_MODEL)).astype(np.float32)
    kw = dict(n_experts=E, top_k=K, capacity_factor=1.25, per_row=per_row)
    (jy, (jlog, jids)) = jax.jit(lambda p_, x_: jmoe.moe_ffn(
        p_, x_, act_fn=jax.nn.silu, **kw))(p, x)
    (want, wgrads), (got, ggrads) = _vjp_both(
        lambda p_, x_: jmoe.moe_ffn(p_, x_, act_fn=jax.nn.silu, **kw)[0],
        lambda p_, x_: tmoe.moe_ffn(p_, x_, act_fn=torch.nn.functional.silu,
                                    **kw)[0], [p, x], ct)
    _, (tlog, tids) = tmoe.moe_ffn({k: torch.as_tensor(v)
                                    for k, v in p.items()},
                                   torch.as_tensor(x),
                                   act_fn=torch.nn.functional.silu, **kw)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(tlog.numpy(), np.asarray(jlog))
    _close(got, want)
    _close_trees(ggrads[0], jax.device_get(wgrads[0]))
    _close(ggrads[1], wgrads[1])
    # the kept set, and the slot (0, 0) state where something was dropped
    T = Sx if per_row else Bx * Sx
    rows = np.asarray(jids).reshape(-1, T, K)
    for r, ids in enumerate(rows):
        keep = _ref_keep(ids, T, 1.25)
        xt = torch.as_tensor(x.reshape(-1, T, D_MODEL)[r])
        C = tmoe.capacity(T, K, E, 1.25)
        *_, slot_of = tmoe._routing(xt, torch.as_tensor(p["router"]), E, K, C)
        np.testing.assert_array_equal(slot_of.numpy().reshape(T, K) >= 0,
                                      keep)
        if skew:
            assert not keep.all()
            # the token first routed to expert 0: the reference's output
            # lacks expert 0's term; so does the port's
            t0 = int(np.argsort(ids.reshape(-1), kind="stable")[0]) // K
            ref_row = np.asarray(jy).reshape(-1, T, D_MODEL)[r]
            oracle = _moe_oracle(p, x.reshape(-1, T, D_MODEL)[r], ids, keep)
            assert np.abs(ref_row[t0] - oracle[t0]).max() > 1e-3
            ok = np.ones(T, bool)
            ok[t0] = False
            _close(ref_row[ok], oracle[ok])


def _moe_oracle(p, xt, ids, keep):
    """Each kept assignment's expert on its own token, gate-weighted, in
    float64: the dispatch without the reference's slot (0, 0) write."""
    logits = xt.astype(np.float64) @ p["router"].astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    g = np.take_along_axis(probs, ids, -1)
    g /= g.sum(-1, keepdims=True)
    out = np.zeros(xt.shape)
    for t in range(xt.shape[0]):
        for k in range(K):
            if keep[t, k]:
                e = ids[t, k]
                h = xt[t] @ p["w_gate"][e]
                h = h / (1 + np.exp(-h)) * (xt[t] @ p["w_up"][e])
                out[t] += g[t, k] * (h @ p["w_down"][e])
    return out


def test_moe_top_k_takes_the_lower_expert_on_ties():
    """Equal router probabilities: the lower expert ids, as
    ``lax.top_k``."""
    p = {"router": np.zeros((D_MODEL, E), np.float32)}
    p["router"][:, 3] = 1.0
    x = np.zeros((5, D_MODEL), np.float32)
    x[1:] = 1.0
    *_, ref_ids = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x) @ p["router"]), K)
    _, ids, *_ = tmoe._routing(torch.as_tensor(x),
                               torch.as_tensor(p["router"]), E, K, 8)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    assert ids[0].tolist() == [0, 1] and ids[1].tolist() == [3, 0]


def test_load_balancing_and_shared_experts_match_reference():
    rng = np.random.default_rng(11)
    T = 40
    logits = rng.standard_normal((T, E)).astype(np.float32) * 2
    ids = np.argsort(-logits, axis=-1, kind="stable")[:, :K].astype(np.int32)
    got = tmoe.load_balancing_loss(torch.as_tensor(logits),
                                   torch.as_tensor(ids).to(torch.int64), E, K)
    want = jmoe.load_balancing_loss(jnp.asarray(logits), jnp.asarray(ids),
                                    E, K)
    _close(got.numpy(), np.asarray(want))
    p = _np_tree(rng, {"w_gate": (D_MODEL, 48), "w_up": (D_MODEL, 48),
                       "w_down": (48, D_MODEL)})
    x = rng.standard_normal((2, 8, D_MODEL)).astype(np.float32)
    ct = rng.standard_normal((2, 8, D_MODEL)).astype(np.float32)
    (want, wg), (got, gg) = _vjp_both(
        lambda p_, x_: jmoe.shared_expert_ffn(p_, x_, act_fn=jax.nn.silu),
        lambda p_, x_: tmoe.shared_expert_ffn(
            p_, x_, act_fn=torch.nn.functional.silu), [p, x], ct)
    _close(got, want)
    _close_trees(gg[0], jax.device_get(wg[0]))
    _close(gg[1], wg[1])


# ---------------------------------------------------------------- SSD

SSD_KW = dict(d_inner=32, n_state=8, headdim=8)


def _ssd_params(rng, d=16):
    di, N, H = 32, 8, 4
    p = _np_tree(rng, {"w_z": (d, di), "w_x": (d, di), "w_b": (d, N),
                       "w_c": (d, N), "w_dt": (d, H), "conv_x": (4, di),
                       "conv_b": (4, N), "conv_c": (4, N), "dt_bias": (H,),
                       "a_log": (H,), "d_skip": (H,), "norm": (di,),
                       "w_out": (di, d)})
    return p


def _ssd_state(rng, Bx=2):
    return _np_tree(rng, {"conv_x": (Bx, 3, 32), "conv_b": (Bx, 3, 8),
                          "conv_c": (Bx, 3, 8), "ssm": (Bx, 4, 8, 8)}, 0.5)


def test_causal_conv1d_with_state_matches_reference():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for state in (None, st):
        jy, js = jssm.causal_conv1d(x, w, state)
        ty, ts = tssm.causal_conv1d(torch.as_tensor(x), torch.as_tensor(w),
                                    None if state is None
                                    else torch.as_tensor(state))
        _close(ty.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("chunk", [8, 16, 48])
def test_ssd_train_with_state_matches_reference(chunk):
    """Output, final states (conv and ssm) and the gradients, from a
    nonzero state in, at the same chunk in both packages."""
    rng = np.random.default_rng(13)
    p = _ssd_params(rng)
    state = _ssd_state(rng)
    x = rng.standard_normal((2, 48, 16)).astype(np.float32)
    ct = rng.standard_normal((2, 48, 16)).astype(np.float32)
    kw = dict(SSD_KW, chunk=chunk)
    jy, jst = jax.jit(lambda p_, x_, s_: jssm.ssd_train(
        p_, x_, state=s_, **kw))(p, x, state)
    ty, tst = tssm.ssd_train({k: torch.as_tensor(v) for k, v in p.items()},
                             torch.as_tensor(x), state={
                                 k: torch.as_tensor(v)
                                 for k, v in state.items()}, **kw)
    _close(ty.numpy(), np.asarray(jy))
    for k in jst:
        _close(tst[k].numpy(), np.asarray(jst[k]))
    (want, wg), (got, gg) = _vjp_both(
        lambda p_, x_: jssm.ssd_train(p_, x_, state=state, **kw)[0],
        lambda p_, x_: tssm.ssd_train(p_, x_, state={
            k: torch.as_tensor(v) for k, v in state.items()}, **kw)[0],
        [p, x], ct)
    _close(got, want)
    _close_trees(gg[0], jax.device_get(wg[0]))
    _close(gg[1], wg[1])


def test_ssd_decode_matches_reference_and_the_chunked_form():
    """``ssd_decode`` against the reference's step, and a token at a time
    from a state against ``ssd_train`` from the same state (the
    reference's ``test_ssd_matches_naive_recurrence``)."""
    rng = np.random.default_rng(14)
    p = _ssd_params(rng)
    state = _ssd_state(rng)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    ts = {k: torch.as_tensor(v) for k, v in state.items()}
    jy, jst = jssm.ssd_decode(p, x[:, :1], state, **SSD_KW)
    ty, tst = tssm.ssd_decode(tp, torch.as_tensor(x[:, :1]), ts, **SSD_KW)
    _close(ty.numpy(), np.asarray(jy))
    for k in jst:
        _close(tst[k].numpy(), np.asarray(jst[k]))
    full, fst = tssm.ssd_train(tp, torch.as_tensor(x), state=ts, chunk=4,
                               **SSD_KW)
    steps, st = [], ts
    for i in range(12):
        y, st = tssm.ssd_decode(tp, torch.as_tensor(x[:, i:i + 1]), st,
                                **SSD_KW)
        steps.append(y)
    _close(torch.cat(steps, 1).numpy(), full.numpy(), 1e-4)
    _close(st["ssm"].numpy(), fst["ssm"].numpy(), 1e-4)


def test_ssd_at_the_published_chunk_against_reference_at_chunk_16():
    """mamba2-370m's chunk of 256 over 256 tokens: the reference's
    gradients are NaN there (``exp`` of the unmasked decay overflows); the
    port masks before ``exp``: its loss equals the reference's at chunk
    16 within 1e-5 and its gradients are finite and within 1e-4 of
    the reference's at chunk 16."""
    rng = np.random.default_rng(15)
    p = _ssd_params(rng)
    x = rng.standard_normal((1, 256, 16)).astype(np.float32)
    tgt = rng.standard_normal((1, 256, 16)).astype(np.float32)

    def jloss(p_, chunk):
        y, _ = jssm.ssd_train(p_, x, chunk=chunk, **SSD_KW)
        return jnp.mean((y - tgt) ** 2)

    jl16, jg16 = jax.jit(jax.value_and_grad(jloss), static_argnums=1)(p, 16)
    jg256 = jax.jit(jax.grad(jloss), static_argnums=1)(p, 256)
    assert any(np.isnan(np.asarray(g)).any()
               for g in jax.tree.leaves(jg256))
    tp = _t(p)
    y, _ = tssm.ssd_train(tp, torch.as_tensor(x), chunk=256, **SSD_KW)
    loss = torch.mean((y - torch.as_tensor(tgt)) ** 2)
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(jl16)) <= 1e-5 * max(1.0, float(jl16))
    got = _grads_of(tp)
    assert all(np.isfinite(g).all() for g in got.values())
    _close_trees(got, jax.device_get(jg16), 1e-4)


# ---------------------------------------------------------------- RG-LRU

W = 24


def _rnn_params(rng, d=16):
    p = _np_tree(rng, {"w_x": (d, W), "w_gate": (d, W), "w_out": (W, d),
                       "conv_w": (4, W), "w_r": (W, W), "w_i": (W, W),
                       "lam": (W,)})
    return p


@pytest.mark.parametrize("L", [1, 7, 64])
def test_rglru_scan_with_h0_matches_reference(L):
    """The scan (odd and even lengths) from an initial state: the
    sequence, the last state and the gradients."""
    rng = np.random.default_rng(16 + L)
    p = {k: v for k, v in _rnn_params(rng).items()
         if k in ("w_r", "w_i", "lam")}
    u = rng.standard_normal((2, L, W)).astype(np.float32)
    h0 = rng.standard_normal((2, W)).astype(np.float32)
    ct = rng.standard_normal((2, L, W)).astype(np.float32)
    jh, jlast = jax.jit(jrg.rglru_scan)(p, u, h0)
    th, tlast = trg.rglru_scan({k: torch.as_tensor(v) for k, v in p.items()},
                               torch.as_tensor(u), torch.as_tensor(h0))
    _close(th.numpy(), np.asarray(jh))
    _close(tlast.numpy(), np.asarray(jlast))
    (want, wg), (got, gg) = _vjp_both(
        lambda p_, u_, h_: jrg.rglru_scan(p_, u_, h_)[0],
        lambda p_, u_, h_: trg.rglru_scan(p_, u_, h_)[0], [p, u, h0], ct)
    _close(got, want)
    _close_trees(gg[0], jax.device_get(wg[0]))
    _close(gg[1], wg[1])
    _close(gg[2], wg[2])


def test_recurrent_block_train_and_decode_match_reference():
    """The Griffin block over a sequence from a conv state and h0, its
    one-token decode, and ``rglru_step`` a token at a time against the
    scan."""
    rng = np.random.default_rng(17)
    p = _rnn_params(rng)
    x = rng.standard_normal((2, 10, 16)).astype(np.float32)
    cs = rng.standard_normal((2, 3, W)).astype(np.float32)
    h0 = rng.standard_normal((2, W)).astype(np.float32)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    jy, (jcs, jh) = jax.jit(lambda p_, x_, c_, h_: jrg.recurrent_block_train(
        p_, x_, conv_state=c_, h0=h_))(p, x, cs, h0)
    ty, (tcs, th) = trg.recurrent_block_train(
        tp, torch.as_tensor(x), conv_state=torch.as_tensor(cs),
        h0=torch.as_tensor(h0))
    _close(ty.numpy(), np.asarray(jy))
    _close(tcs.numpy(), np.asarray(jcs))
    _close(th.numpy(), np.asarray(jh))
    jy1, (jcs1, jh1) = jax.jit(jrg.recurrent_block_decode)(p, x[:, :1], cs,
                                                           h0)
    ty1, (tcs1, th1) = trg.recurrent_block_decode(
        tp, torch.as_tensor(x[:, :1]), torch.as_tensor(cs),
        torch.as_tensor(h0))
    _close(ty1.numpy(), np.asarray(jy1))
    _close(tcs1.numpy(), np.asarray(jcs1))
    _close(th1.numpy(), np.asarray(jh1))
    steps, c, h = [], torch.as_tensor(cs), torch.as_tensor(h0)
    for i in range(10):
        y, (c, h) = trg.recurrent_block_decode(tp, torch.as_tensor(
            x[:, i:i + 1]), c, h)
        steps.append(y)
    _close(torch.cat(steps, 1).numpy(), ty.numpy(), 1e-5)
    _close(h.numpy(), th.numpy(), 1e-5)


# ------------------------------------------- cross attention, encoder, VLM


def test_sinusoidal_positions_bit_equal():
    for length, d in ((16, 64), (1024, 768)):
        np.testing.assert_array_equal(
            tl.sinusoidal_positions(length, d).numpy(),
            np.asarray(jl.sinusoidal_positions(length, d)))


def test_attention_train_with_kv_override_matches_reference():
    """Cross attention (no RoPE on the given keys, bidirectional, kv
    blocks over 24 encoder positions) on both packages, with RoPE on the
    queries and without; the output and the gradients of the weights,
    the queries' input and the given keys and values."""
    rng = np.random.default_rng(18)
    d, H, Kh, dh = 16, 4, 2, 8
    p = _np_tree(rng, {"wq": (d, H, dh), "wk": (d, Kh, dh),
                       "wv": (d, Kh, dh), "wo": (H, dh, d)})
    x = rng.standard_normal((2, 32, d)).astype(np.float32)
    kx = rng.standard_normal((2, 24, Kh, dh)).astype(np.float32)
    vx = rng.standard_normal((2, 24, Kh, dh)).astype(np.float32)
    ct = rng.standard_normal((2, 32, d)).astype(np.float32)
    for theta in (0.0, 10000.0):
        kw = dict(causal=False, window=0, rope_theta=theta, cap=0.0,
                  q_block=16, kv_block=16)
        (want, wg), (got, gg) = _vjp_both(
            lambda p_, x_, k_, v_: jl.attention_train(
                p_, x_, positions=jnp.arange(32), kv_override=(k_, v_, None),
                **kw),
            lambda p_, x_, k_, v_: tl.attention_train(
                p_, x_, positions=torch.arange(32),
                kv_override=(k_, v_, None), **kw), [p, x, kx, vx], ct)
        _close(got, want)
        wgp = jax.device_get(wg[0])
        for name in ("wq", "wo"):
            _close(gg[0][name], wgp[name])
        for i in (1, 2, 3):
            _close(gg[i], wg[i])


@pytest.fixture(scope="module")
def whisper_phi():
    """whisper-small's and phi-3-vision's reduced configs in both
    packages, the reference's params at PRNGKey(1) carried over."""
    out = {}
    for arch in ("whisper-small", "phi-3-vision-4.2b"):
        jcfg = j_get_config(arch).reduced()
        jp = jax.device_get(jtr.init_params(jcfg, jax.random.PRNGKey(1)))
        tcfg = get_config(arch).reduced()
        out[arch] = (jcfg, jp, tcfg,
                     params_from_reference(tcfg, jp, device="cpu"))
    return out


def test_encode_matches_reference(whisper_phi):
    """The encoder (sinusoidal positions, bidirectional attention, MLP,
    final norm) and its gradient to the frames."""
    jcfg, jp, tcfg, tp = whisper_phi["whisper-small"]
    rng = np.random.default_rng(19)
    frames = (rng.standard_normal((2, 16, jcfg.d_model)) * 0.02
              ).astype(np.float32)
    ct = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    out, vjp = jax.vjp(jax.jit(lambda f: jtr.encode(jcfg, jp, f)), frames)
    tf = torch.tensor(frames, requires_grad=True)
    got = ttr.encode(tcfg, tp, tf)
    got.backward(torch.as_tensor(ct))
    _close(got.detach().numpy(), np.asarray(out))
    _close(tf.grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]))


def test_embed_tokens_with_images_matches_reference(whisper_phi):
    """The first ``vision_tokens`` positions are the projected image
    embeddings, the rest the scaled token embeddings."""
    jcfg, jp, tcfg, tp = whisper_phi["phi-3-vision-4.2b"]
    rng = np.random.default_rng(20)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    img = (rng.standard_normal((2, jcfg.vision_tokens, jcfg.d_model))
           * 0.02).astype(np.float32)
    want = jtr.embed_tokens(jcfg, jp, tokens, img)
    got = ttr.embed_tokens(tcfg, tp, torch.as_tensor(tokens),
                           torch.as_tensor(img))
    _close(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got[:, jcfg.vision_tokens:].numpy(),
        ttr.embed_tokens(tcfg, tp, torch.as_tensor(tokens))[
            :, jcfg.vision_tokens:].numpy())


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_whisper_full_width_grad_norm_matches_reference(depth):
    """whisper-small at its published widths, ``depth`` + ``depth``
    layers, float32, the reference's weights carried over, 2 x 128 tokens
    and 2 x 32 frames (``whisper_grad_norms.compare``): the loss within
    1e-5 max(1, |loss|) and the global gradient norm within 2e-3 of the
    reference's.  The init rule's saturated attention scores make the
    norm grow with depth (about 25, 75, 370 at depth 1, 2, 4) and make
    single leaves ill-conditioned in float32, so the norm is compared,
    not each leaf."""
    r = compare_whisper_grad_norms(depth, 128)
    assert abs(r["port_loss"] - r["ref_loss"]) <= 1e-5 * max(
        1.0, abs(r["ref_loss"])), r
    assert abs(r["port_grad_norm"] - r["ref_grad_norm"]) <= (
        2e-3 * r["ref_grad_norm"]), r


# ---------------------------------------------------------------- SketchDP


def test_sketchdp_on_moe_exact_when_m_covers_params(tmp_path):
    """The reduced MoE config in a one-rank gloo group: SketchDP with
    m >= n gives the dense mean gradient within the reference's rtol 3e-3,
    atol 2e-4 (``tests/test_distributed.py``), the loss within 1e-4 and a
    residual below 1e-10."""
    from repro_torch.distributed import init_ef_state, make_sketchdp_grad_fn
    from repro_torch.train import value_and_grad
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (4, 32)),
                                    dtype=torch.int32),
             "labels": torch.tensor(rng.integers(0, cfg.vocab_size, (4, 32)),
                                    dtype=torch.int32),
             "mask": torch.ones((4, 32))}
    lfn = lambda p, b: loss_fn(cfg, p, b)  # noqa: E731
    n = flatten_params(params)[0].numel()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        loss, grads, ef = make_sketchdp_grad_fn(
            lfn, m=n + 64, method="threshold")(params, batch,
                                                init_ef_state(params), 0)
    finally:
        dist.destroy_process_group()
    (d_loss, metrics), d_grads = value_and_grad(lfn, params, batch)
    assert float(metrics["aux_loss"]) > 0
    np.testing.assert_allclose(flatten_params(grads)[0].numpy(),
                               flatten_params(d_grads)[0].numpy(),
                               rtol=3e-3, atol=2e-4)
    assert abs(float(loss) - float(d_loss)) < 1e-4
    assert float(ef.abs().max()) < 1e-10
    assert [p for p, _ in param_leaves(grads)] == \
        [p for p, _ in param_leaves(params)]
