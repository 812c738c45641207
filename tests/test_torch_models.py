"""Port parity: the LM stack (``repro_torch.configs`` /
``repro_torch.models``) against ``repro.configs`` / ``repro.models``, on
every one of the ten configs (dense, MoE, SSD, RG-LRU hybrid,
encoder-decoder, VLM stub).

The reference's parameters (``init_params`` at ``PRNGKey(0)``, the
reduced configs in float32) are carried to the port with
``params_from_reference``; both packages take the same numpy batch
(with ``frames`` and ``image_embeds`` stubs, N(0, 0.02^2), where the
config has an encoder or image tokens).

Tolerances.  The loss agrees within ``1e-5 max(1, |loss|)``.  Gradients
are compared at two sets of weights:

- the reference's init with each attention's ``wq`` and ``wk`` scaled
  by 1/4, where the scores are O(1): every leaf within
  ``1e-4 max|ref leaf|``;
- the reference's init as it is: within ``5e-4 max|ref leaf|``.  Its
  rule draws ``wq`` / ``wk`` with std ``1/sqrt(n_heads)`` (the stacked
  shape's second-to-last dim), so the scores have std ~16 and the
  float32 forward is ill-conditioned: on gemma2-2b-reduced both packages
  are 3.6e-5 from the float64 forward of the same weights and 5.5e-5
  from each other, and the gradients differ by up to 2.1e-4 of a leaf's
  scale (1e-6 with the scores scaled down), whatever the order of the
  float32 sums.  recurrentgemma-2b-reduced comes closest (4.0e-4): its
  attn_local layer takes the RG-LRU layers' output.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs.paper_sketch import CONFIG as J_PAPER
from repro.distributed.grad_compress import _flatten as j_flatten
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.models import param_specs as j_param_specs
from repro.models import layers as jl
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.paper_sketch import CONFIG as PAPER
from repro_torch.models import (flatten_params, init_params, loss_fn,
                                param_leaves, param_specs,
                                params_from_reference, params_to_reference,
                                unflatten_params)
from repro_torch.models import layers as tl
from repro_torch.train import value_and_grad
from _torch_common import (one_torch_thread,  # noqa: F401
                           release_jax_executables)

ALL = list(J_ARCH_IDS)
B, S = 2, 64
QK_SCALE = 0.25


def _batch(cfg):
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "mask": (rng.random((B, S)) < 0.9).astype(np.float32)}
    if cfg.vision_tokens:
        out["image_embeds"] = (rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = (rng.standard_normal(
            (B, S // cfg.enc_ratio, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _scale_qk(params):
    """Each attention group's ``wq`` and ``wk`` times QK_SCALE (SSD and
    RG-LRU groups have none)."""
    out = jax.tree.map(lambda a: a, params)
    for g in out["groups"].values():
        if "wq" in g:
            g["wq"] = g["wq"] * QK_SCALE
            g["wk"] = g["wk"] * QK_SCALE
    return out


@pytest.fixture(scope="module")
def ref_runs():
    """arch -> the reference's params (as it inits them, and with the
    scores scaled down), the batch, and its loss and gradients on each;
    one jit a config, made the first time a test asks for the arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = j_get_config(arch).reduced()
            batch = _batch(cfg)
            vg = jax.jit(jax.value_and_grad(
                lambda p, b: j_loss_fn(cfg, p, b), has_aux=True))
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            p0 = j_init_params(cfg, jax.random.PRNGKey(0))
            runs = {}
            for name, p in (("init", p0), ("scaled", _scale_qk(p0))):
                (loss, _), grads = vg(p, jb)
                runs[name] = (jax.device_get(p), float(loss),
                              [np.asarray(g) for g in jax.tree.leaves(grads)])
            cache[arch] = (batch, runs)
        return cache[arch]
    return get


def _port_loss_and_grads(arch, params_np, batch):
    cfg = get_config(arch).reduced()
    params = params_from_reference(cfg, params_np, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    (loss, _), grads = value_and_grad(lambda p, b: loss_fn(cfg, p, b),
                                      params, tb)
    return float(loss), [g.numpy() for _, g in param_leaves(grads)]


def _leaf_errors(got, want):
    return [float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30))
            for g, w in zip(got, want)]


@pytest.mark.parametrize("arch", ALL)
def test_loss_and_grads_match_reference(arch, ref_runs):
    """Scores scaled down: the loss within 1e-5 max(1, |loss|), every
    gradient leaf within 1e-4 of its scale."""
    batch, runs = ref_runs(arch)
    params, ref_loss, ref_grads = runs["scaled"]
    loss, grads = _port_loss_and_grads(arch, params, batch)
    assert abs(loss - ref_loss) <= 1e-5 * max(1.0, abs(ref_loss))
    assert len(grads) == len(ref_grads)
    errs = _leaf_errors(grads, ref_grads)
    assert max(errs) < 1e-4, errs


@pytest.mark.parametrize("arch", ALL)
def test_loss_and_grads_at_reference_init(arch, ref_runs):
    """The reference's init as it is: the loss within 1e-5 max(1, |loss|),
    every gradient leaf within 5e-4 of its scale (the module docstring
    says why not 1e-4)."""
    batch, runs = ref_runs(arch)
    params, ref_loss, ref_grads = runs["init"]
    loss, grads = _port_loss_and_grads(arch, params, batch)
    assert abs(loss - ref_loss) <= 1e-5 * max(1.0, abs(ref_loss))
    errs = _leaf_errors(grads, ref_grads)
    assert max(errs) < 5e-4, errs


@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 0.0), (0, 50.0),
                                        (24, 50.0)])
def test_chunked_attention_matches_reference(window, cap):
    """Output and input gradients within 1e-5 of their scale, with and
    without the local window and the score softcap; ragged blocks (q
    blocks of 16 over 48 positions, kv blocks fitted to 24)."""
    rng = np.random.default_rng(3)
    Bq, Sq, K, G, dh = 2, 48, 2, 2, 16
    q = (rng.standard_normal((Bq, Sq, K, G, dh)) * 2).astype(np.float32)
    k = (rng.standard_normal((Bq, Sq, K, dh)) * 2).astype(np.float32)
    v = rng.standard_normal((Bq, Sq, K, dh)).astype(np.float32)
    ct = rng.standard_normal((Bq, Sq, K, G, dh)).astype(np.float32)
    kw = dict(causal=True, window=window, q_pos0=0, k_pos0=0, q_block=16,
              kv_block=32, cap=cap)
    out, vjp = jax.vjp(lambda *a: jl.chunked_attention(*a, **kw), q, k, v)
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(ct))]
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = tl.chunked_attention(tq, tk, tv, **kw)
    got.backward(torch.tensor(ct))
    got = [got.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(),
           tv.grad.numpy()]
    assert max(_leaf_errors(got, want)) < 1e-5


def test_layers_match_reference():
    """rms_norm (its 1 + gamma gain), softcap, the three activations
    (gelu with the tanh approximation) and RoPE, within 1e-6."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32) * 3
    g = rng.standard_normal(16).astype(np.float32) * 0.1
    t = torch.as_tensor
    pairs = [(tl.rms_norm(t(x), t(g), 1e-6), jl.rms_norm(x, g, 1e-6)),
             (tl.softcap(t(x), 5.0), jl.softcap(x, 5.0)),
             (tl.rope(t(x), torch.arange(8), 10000.0),
              jl.rope(x, jnp.arange(8), 10000.0))]
    pairs += [(tl.activation(t(x), a), jl.activation(x, a))
              for a in ("silu", "gelu", "relu2")]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", ALL)
def test_flatten_params_bit_equal_to_reference(arch, ref_runs):
    """``flatten_params`` of the carried parameters is the reference's
    ``grad_compress._flatten`` bit for bit (the SketchDP coordinate
    order), and ``unflatten_params`` inverts it."""
    _, runs = ref_runs(arch)
    params_np = runs["init"][0]
    cfg = get_config(arch).reduced()
    params = params_from_reference(cfg, params_np, device="cpu")
    flat, meta = flatten_params(params)
    j_flat, _ = j_flatten(jax.tree.map(jnp.asarray, params_np))
    np.testing.assert_array_equal(flat.numpy().view(np.uint32),
                                  np.asarray(j_flat).view(np.uint32))
    back = unflatten_params(flat, meta)
    for (pa, a), (pb, b) in zip(param_leaves(back), param_leaves(params)):
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(a, b)
    rt = params_to_reference(params)
    for a, b in zip(jax.tree.leaves(rt), jax.tree.leaves(params_np)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ALL)
def test_param_specs_and_init_follow_reference(arch):
    """The same leaf paths, shapes and init kinds as the reference's
    specs, at full width and reduced; ``init_params`` draws the reference's
    per-leaf scales (zeros for the gains, ones for the SSD skip, 0.02 for
    the embedding, 0.2 for the convolutions, 1/sqrt(stacked shape[-2])
    for the rest) in the config dtype, the same on every call with one
    seed.  A leaf's sample std is held to 10% of the scale, or 4 of its
    standard errors (1/sqrt(2 numel)) where that is wider (the SSD's
    (4, 16) convolutions)."""
    for cfg_t, cfg_j in ((get_config(arch), j_get_config(arch)),
                         (get_config(arch).reduced(),
                          j_get_config(arch).reduced())):
        ours = dict(param_leaves(param_specs(cfg_t)))
        ref = {tuple(str(k.key) for k in path): s for path, s in
               jax.tree_util.tree_flatten_with_path(
                   j_param_specs(cfg_j),
                   is_leaf=lambda x: hasattr(x, "axes"))[0]}
        assert set(ours) == set(ref)
        for path, s in ours.items():
            r = ref[path]
            assert (s.shape, s.axes, s.init, s.scale) == \
                (r.shape, r.axes, r.init, r.scale), path
    cfg = get_config(arch).reduced()
    a = init_params(cfg, 5, device="cpu")
    b = init_params(cfg, 5, device="cpu")
    for (path, x), (_, y) in zip(param_leaves(a), param_leaves(b)):
        assert torch.equal(x, y) and x.dtype == torch.float32
        spec = dict(param_leaves(param_specs(cfg)))[path]
        if spec.init in ("zeros", "ones"):
            assert torch.equal(x, torch.full_like(
                x, 0.0 if spec.init == "zeros" else 1.0)), path
            continue
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        want = spec.scale if spec.scale is not None else fan_in ** -0.5
        tol = max(0.1, 4 / (2 * x.numel()) ** 0.5)
        assert abs(float(x.std()) / want - 1) < tol, path


def test_configs_are_the_reference_configs():
    """Every registered config, its reduced form, its parameter counts,
    ``SHAPES`` and the paper's sketch workload equal the reference's."""
    assert ARCH_IDS == J_ARCH_IDS and SHAPES == J_SHAPES
    assert dataclasses.asdict(PAPER) == dataclasses.asdict(J_PAPER)
    for arch in ARCH_IDS:
        for ours, ref in ((get_config(arch), j_get_config(arch)),
                          (get_config(arch).reduced(),
                           j_get_config(arch).reduced())):
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
            assert ours.param_count() == ref.param_count()
            assert ours.active_param_count() == ref.active_param_count()
            assert ours.padded_vocab == ref.padded_vocab
    with pytest.raises(KeyError):
        get_config("no-such-arch")
