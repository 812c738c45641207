"""Port parity: the training substrate (``repro_torch.train``,
``repro_torch.data.pipeline``, ``repro_torch.launch.train``) against
``repro.train`` / ``repro.data``, and the reference's own training-loop
tests (``tests/test_train_loop.py``) on the port.

Weights are the reference's ``init_params`` of ``gemma2-2b``'s reduced
config (float32), carried with ``params_from_reference``.  The optimizer
is compared on the same gradients (the reference's, carried), so the
comparison is of AdamW and not of the two packages' float32 gradients
(``tests/test_torch_models.py`` compares those).
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro import obs as j_obs
from repro.configs import get_config as j_get_config
from repro.data import BinTokenSource as JBin
from repro.data import SyntheticLM as JSynthetic
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.train import Checkpointer as JCheckpointer
from repro.train import adamw as j_adamw
from repro.train import global_norm as j_global_norm
from repro.train import telemetry as jt
from repro.train import warmup_cosine as j_warmup_cosine
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.data import BinTokenSource, Prefetcher, SyntheticLM
from repro_torch.models import (init_params, param_leaves,
                                params_from_reference)
from repro_torch.train import (AdamWState, Checkpointer, StepWatchdog, adamw,
                               global_norm, gradient_noise_scale,
                               grad_cosine, grad_inner_product,
                               make_train_step, run_with_recovery,
                               sketch_grads, train_loop, warmup_cosine)
from _torch_common import (one_torch_thread,  # noqa: F401
                           release_jax_executables)

REPO = Path(__file__).resolve().parents[1]
ARCH = "gemma2-2b"


@pytest.fixture(scope="module")
def carried():
    """(reference cfg, port cfg, reference params (numpy), port params)."""
    jcfg = j_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    p = jax.device_get(j_init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, p, params_from_reference(cfg, p, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config(ARCH).reduced()
    return cfg, init_params(cfg, 0, device="cpu")


def _leaves_np(tree):
    return [x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in (leaf for _, leaf in param_leaves(tree))]


def _torch_tree(tree_np):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree_np)


# ------------------------------------------------------------- optimizer


@pytest.fixture(scope="module")
def adamw_runs(carried):
    """Three AdamW steps on both sides from the carried parameters, each
    step's gradients the reference's at its own current parameters
    (batches of ``SyntheticLM``); weight decay and clipping on."""
    jcfg, cfg, p_np, p_t = carried
    j_opt = j_adamw(j_warmup_cosine(3e-3, warmup=2, total=10))
    opt = adamw(warmup_cosine(3e-3, warmup=2, total=10))
    data = JSynthetic(jcfg.vocab_size, 32, 4, seed=6)
    grad = jax.jit(jax.grad(lambda p, b: j_loss_fn(jcfg, p, b)[0]))
    jp, js = jax.tree.map(jnp.asarray, p_np), None
    js = j_opt.init(jp)
    tp, ts = p_t, opt.init(p_t)
    metrics = []
    for step in range(3):
        g = grad(jp, data.batch_at(step))
        jp, js, jm = j_opt.update(g, js, jp)
        tp, ts, tm = opt.update(_torch_tree(jax.device_get(g)), ts, tp)
        metrics.append((jm, tm))
    return jp, js, tp, ts, metrics


def test_adamw_three_steps_match_reference(adamw_runs):
    """Parameters within 1e-4 of each leaf's scale (1e-6 seen), moments
    within 1e-4 of theirs, the step count and the grad-norm / lr metrics
    equal."""
    jp, js, tp, ts, metrics = adamw_runs
    for want, got in zip(jax.tree.leaves(jp), _leaves_np(tp)):
        want = np.asarray(want)
        assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))
    for tree_j, tree_t in ((js.mu, ts.mu), (js.nu, ts.nu)):
        for want, got in zip(jax.tree.leaves(tree_j), _leaves_np(tree_t)):
            want = np.asarray(want)
            assert np.max(np.abs(got - want)) <= \
                1e-4 * max(np.max(np.abs(want)), 1e-30)
    assert int(ts.step) == int(js.step) == 3 and ts.step.dtype == torch.int32
    for jm, tm in metrics:
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)


def test_weight_decay_mask_is_the_reference_ndim_rule(carried):
    """Zero gradients and lr 1: a leaf moves only by its decay.  The
    decayed set equals the reference's ``ndim >= 2`` set: the stacked
    ``(n_groups, d)`` norm gains decay, ``final_norm`` does not."""
    _, cfg, p_np, _ = carried
    p_np = jax.tree.map(lambda a: a + np.float32(0.1), p_np)
    p_t = params_from_reference(cfg, p_np, device="cpu")
    j_opt = j_adamw(1.0, weight_decay=0.5, clip_norm=0.0)
    opt = adamw(1.0, weight_decay=0.5, clip_norm=0.0)
    jp = jax.tree.map(jnp.asarray, p_np)
    zeros_j = jax.tree.map(jnp.zeros_like, jp)
    new_j, _, _ = j_opt.update(zeros_j, j_opt.init(jp), jp)
    zeros_t = jax.tree.map(torch.zeros_like, p_t)
    new_t, _, _ = opt.update(zeros_t, opt.init(p_t), p_t)
    decayed = {}
    for (path, a), b, old in zip(param_leaves(new_t), jax.tree.leaves(new_j),
                                 jax.tree.leaves(p_np)):
        moved_t = not np.array_equal(a.numpy(), old)
        moved_j = not np.array_equal(np.asarray(b), old)
        assert moved_t == moved_j, path
        decayed[path] = moved_t
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert decayed[("groups", "p0", "ln1")] and decayed[("embed",)]
    assert not decayed[("final_norm",)]
    assert decayed == {path: np.ndim(x) >= 2
                       for path, x in param_leaves(p_np)}


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-370m",
                                  "recurrentgemma-2b", "whisper-small",
                                  "phi-3-vision-4.2b"])
def test_weight_decay_mask_over_every_family(arch):
    """The same zero-gradient step over each new family's leaves (the
    experts, the router, the SSD and RG-LRU leaves, cross attention, the
    encoder, ``img_proj``): the port's updated leaves equal the
    reference's and the decayed set is ``ndim >= 2``."""
    jcfg = j_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    p_np = jax.tree.map(lambda a: np.asarray(a) + np.float32(0.1),
                        jax.device_get(j_init_params(
                            jcfg, jax.random.PRNGKey(0))))
    p_t = params_from_reference(cfg, p_np, device="cpu")
    j_opt = j_adamw(1.0, weight_decay=0.5, clip_norm=0.0)
    opt = adamw(1.0, weight_decay=0.5, clip_norm=0.0)
    jp = jax.tree.map(jnp.asarray, p_np)
    new_j, _, _ = j_opt.update(jax.tree.map(jnp.zeros_like, jp),
                               j_opt.init(jp), jp)
    new_t, _, _ = opt.update(jax.tree.map(torch.zeros_like, p_t),
                             opt.init(p_t), p_t)
    for (path, a), b, old in zip(param_leaves(new_t), jax.tree.leaves(new_j),
                                 jax.tree.leaves(p_np)):
        assert (not np.array_equal(a.numpy(), old)) == (np.ndim(old) >= 2)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7, err_msg=str(path))


def test_warmup_cosine_and_global_norm_match_reference():
    lr, j_lr = warmup_cosine(1.0, 10, 110), j_warmup_cosine(1.0, 10, 110)
    for s in list(range(20)) + [60, 110, 150]:
        np.testing.assert_allclose(float(lr(s)), float(j_lr(jnp.asarray(s))),
                                   rtol=0, atol=1e-6)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1.0) < 1e-6
    assert abs(float(lr(110)) - 0.1) < 1e-5
    lr2, j_lr2 = warmup_cosine(3e-3, 5, 20), j_warmup_cosine(3e-3, 5, 20)
    for s in range(21):
        np.testing.assert_allclose(float(lr2(torch.tensor(s))),
                                   float(j_lr2(jnp.asarray(s))), atol=1e-6)
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    np.testing.assert_allclose(float(global_norm(_torch_tree(tree))),
                               float(j_global_norm(tree)), rtol=1e-6)


# ----------------------------------------------------------------- loop


def test_loss_decreases(tiny):
    """Overfit one fixed batch: 40 steps take the loss from ln(V) (> 5.5)
    below 4.8 (4.3 seen; the reference's 150 steps reach < 2.0)."""
    cfg, params = tiny
    data = SyntheticLM(cfg.vocab_size, 32, 8, seed=1, device="cpu")
    fixed = data.batch_at(0)
    opt = adamw(3e-3, weight_decay=0.0)
    step_fn = make_train_step(cfg, opt)
    _, _, hist = train_loop(cfg, params, opt.init(params),
                            iter(lambda: fixed, None), step_fn, n_steps=40,
                            log_every=13, log_fn=lambda *_: None)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    assert first > 5.5 and last < 4.8, (first, last)
    assert [h["step"] for h in hist] == [0, 13, 26, 39]


def test_microbatch_equivalence(tiny):
    """grad-accumulated step == single-batch step (same data)."""
    cfg, params = tiny
    batch = SyntheticLM(cfg.vocab_size, 32, 8, seed=2,
                        device="cpu").batch_at(0)
    opt = adamw(1e-3, weight_decay=0.0)
    p1, _, m1 = make_train_step(cfg, opt, microbatches=1)(
        params, opt.init(params), batch)
    p4, _, m4 = make_train_step(cfg, opt, microbatches=4)(
        params, opt.init(params), batch)
    d = max(float((a.float() - b.float()).abs().max())
            for a, b in zip(_leaves_t(p1), _leaves_t(p4)))
    assert d < 5e-3, d
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4


def _leaves_t(tree):
    return [x for _, x in param_leaves(tree)]


def test_checkpoint_restart_determinism(tiny, tmp_path):
    """Train 10 steps straight == train 5, checkpoint, restore, train 5."""
    cfg, params = tiny
    opt = adamw(5e-3, weight_decay=0.0)
    step_fn = make_train_step(cfg, opt)

    def run(n, start, p, s):
        it = SyntheticLM(cfg.vocab_size, 16, 4, seed=3,
                         device="cpu").iter_from(start)
        for _ in range(start, n):
            p, s, _ = step_fn(p, s, next(it))
        return p, s

    pA, _ = run(10, 0, params, opt.init(params))
    pB, sB = run(5, 0, params, opt.init(params))
    ck = Checkpointer(str(tmp_path / "ck"), async_save=False)
    ck.save(5, {"params": pB, "opt": sB})
    step, restored = ck.restore({"params": pB, "opt": sB})
    assert step == 5 and isinstance(restored["opt"], AdamWState)
    pB2, _ = run(10, 5, restored["params"], restored["opt"])
    for a, b in zip(_leaves_t(pA), _leaves_t(pB2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_watchdog_flags_stragglers():
    w = StepWatchdog(ratio=3.0, warmup_steps=2)
    for i in range(10):
        assert not w.observe(i, 0.1)
    assert w.observe(10, 0.5)           # 5x EWMA -> straggler
    assert len(w.straggler_events) == 1
    assert not w.observe(11, 0.12)      # recovered


def test_run_with_recovery(tiny, tmp_path):
    """Simulated crash at step 7 -> auto-resume from checkpoint -> finish."""
    cfg, params = tiny
    opt = adamw(5e-3, weight_decay=0.0)
    step_fn = make_train_step(cfg, opt)
    ck = Checkpointer(str(tmp_path / "ck2"), async_save=False)
    crashed = {"done": False}

    def run_fn(start_step):
        p, s = params, opt.init(params)
        if start_step > 0:
            _, restored = ck.restore({"params": p, "opt": s})
            p, s = restored["params"], restored["opt"]
        it = SyntheticLM(cfg.vocab_size, 16, 4, seed=4,
                         device="cpu").iter_from(start_step)
        for step in range(start_step, 12):
            p, s, _ = step_fn(p, s, next(it))
            if step == 5:
                ck.save(step + 1, {"params": p, "opt": s})
            if step == 7 and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError("simulated node failure")
        return step

    restarts = []
    final = run_with_recovery(run_fn, checkpointer=ck, max_restarts=2,
                              on_restart=lambda n, e: restarts.append(str(e)),
                              sleep=lambda s: None)
    assert final == 11
    assert len(restarts) == 1 and "simulated" in restarts[0]


def test_run_with_recovery_resets_budget_on_progress(tmp_path):
    """Crashes that still advance the checkpoint reset the restart budget:
    5 productive crashes survive max_restarts=2."""
    ck = Checkpointer(str(tmp_path / "ck3"), async_save=False)
    calls = {"n": 0}
    sleeps = []

    def run_fn(start_step):
        calls["n"] += 1
        step = (ck.latest_step() or 0) + 1
        if step <= 5:
            ck.save(step, {"x": np.zeros(1)})
            raise RuntimeError(f"preempted after step {step}")
        return step

    out = run_with_recovery(run_fn, checkpointer=ck, max_restarts=2,
                            sleep=sleeps.append)
    assert out == 6
    assert calls["n"] == 6
    assert sleeps == [1.0] * 5
    assert ck.all_steps() == [3, 4, 5]      # keep = 3


def test_run_with_recovery_backoff_and_exhaustion(tmp_path):
    """A stuck step backs off exponentially (capped) and re-raises once the
    unproductive-restart budget is exhausted."""
    ck = Checkpointer(str(tmp_path / "ck4"), async_save=False)
    sleeps = []

    def run_fn(start_step):
        raise RuntimeError("stuck step")

    with pytest.raises(RuntimeError, match="stuck step"):
        run_with_recovery(run_fn, checkpointer=ck, max_restarts=3,
                          backoff_base=0.5, backoff_max=1.5,
                          sleep=sleeps.append)
    assert sleeps == [0.5, 1.0, 1.5]


def test_train_loop_checkpoints_async_and_watches(tiny, tmp_path):
    """``train_loop`` with an async ``Checkpointer`` (keep 2) and a
    watchdog: the periodic and the final checkpoints land atomically (no
    ``.tmp`` left), the oldest are removed, every step is observed, and
    the final checkpoint restores the returned state bit for bit."""
    cfg, params = tiny
    opt = adamw(1e-3)
    ck = Checkpointer(str(tmp_path / "ck5"), keep=2)
    wd = StepWatchdog()
    data = SyntheticLM(cfg.vocab_size, 16, 4, seed=5, device="cpu")
    p, s, hist = train_loop(cfg, params, opt.init(params),
                            Prefetcher(data.iter_from(0)),
                            make_train_step(cfg, opt), n_steps=7,
                            checkpointer=ck, checkpoint_every=2, watchdog=wd,
                            log_every=3, log_fn=lambda *_: None)
    assert ck.all_steps() == [6, 7]
    assert not [n for n in os.listdir(ck.dir) if n.endswith(".tmp")]
    assert wd.observed == 7 and len(hist) == 3
    step, back = ck.restore({"params": p, "opt_state": s})
    assert step == 7
    for a, b in zip(_leaves_t(back["params"]), _leaves_t(p)):
        assert torch.equal(a, b)
    assert torch.equal(back["opt_state"].step, s.step)
    for tree_a, tree_b in ((back["opt_state"].mu, s.mu),
                           (back["opt_state"].nu, s.nu)):
        for a, b in zip(_leaves_t(tree_a), _leaves_t(tree_b)):
            assert torch.equal(a, b)


# ----------------------------------------------------- checkpoints across


def test_float32_checkpoint_crosses_to_reference(carried, tmp_path):
    """A checkpoint of the port's params and AdamW state restores in
    ``repro.train.Checkpointer`` bit for bit, with the same manifest keys,
    shapes and dtypes the reference writes for the same tree."""
    jcfg, cfg, p_np, p_t = carried
    opt = adamw(1e-3)
    s_t = opt.init(p_t)
    s_t = AdamWState(torch.tensor(3, dtype=torch.int32),
                     jax.tree.map(lambda x: x + 0.5, s_t.mu),
                     jax.tree.map(lambda x: x + 0.25, s_t.nu))
    Checkpointer(str(tmp_path / "port"), async_save=False).save(
        3, {"params": p_t, "opt_state": s_t})
    jp = jax.tree.map(jnp.asarray, p_np)
    j_opt = j_adamw(1e-3)
    js = j_opt.init(jp)
    step, back = JCheckpointer(str(tmp_path / "port")).restore(
        {"params": jp, "opt_state": js})
    assert step == 3
    want = _leaves_np({"params": p_t}) + [s_t.step.numpy()] + \
        _leaves_np(s_t.mu) + _leaves_np(s_t.nu)
    got = jax.tree.leaves({"params": back["params"]}) + \
        [back["opt_state"].step] + jax.tree.leaves(back["opt_state"].mu) + \
        jax.tree.leaves(back["opt_state"].nu)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    JCheckpointer(str(tmp_path / "ref"), async_save=False).save(
        3, {"params": jp, "opt_state": js})
    import json
    mine = json.load(open(tmp_path / "port/step_00000003/manifest.json"))
    theirs = json.load(open(tmp_path / "ref/step_00000003/manifest.json"))
    assert mine == theirs


def test_float32_checkpoint_crosses_from_reference(carried, tmp_path):
    """A checkpoint the reference writes (params and AdamW state after a
    step) restores in the port bit for bit, as an ``AdamWState``."""
    jcfg, cfg, p_np, p_t = carried
    jp = jax.tree.map(jnp.asarray, p_np)
    j_opt = j_adamw(1e-3)
    g = jax.tree.map(lambda x: jnp.full_like(x, 0.01), jp)
    jp2, js2, _ = j_opt.update(g, j_opt.init(jp), jp)
    JCheckpointer(str(tmp_path / "ref"), async_save=False).save(
        8, {"params": jp2, "opt_state": js2})
    opt = adamw(1e-3)
    step, back = Checkpointer(str(tmp_path / "ref")).restore(
        {"params": p_t, "opt_state": opt.init(p_t)})
    assert step == 8 and isinstance(back["opt_state"], AdamWState)
    assert int(back["opt_state"].step) == 1
    assert back["opt_state"].step.dtype == torch.int32
    for tree_t, tree_j in ((back["params"], jp2),
                           (back["opt_state"].mu, js2.mu),
                           (back["opt_state"].nu, js2.nu)):
        for a, b in zip(_leaves_np(tree_t), jax.tree.leaves(tree_j)):
            assert a.tobytes() == np.asarray(b).tobytes()


def test_bfloat16_checkpoint_reads_the_reference_payload(tmp_path):
    """bfloat16 leaves: the reference writes the raw 16-bit payload
    (``<V2``); the port restores it to the same bfloat16 values, and
    writes the same bytes for the same values."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 3)).astype(np.float32)
    tree_j = {"w": jnp.asarray(x, jnp.bfloat16), "g": jnp.asarray(x[0])}
    JCheckpointer(str(tmp_path / "ref"), async_save=False).save(1, tree_j)
    like = {"w": torch.zeros((5, 3), dtype=torch.bfloat16),
            "g": torch.zeros(3)}
    step, back = Checkpointer(str(tmp_path / "ref")).restore(like)
    assert back["w"].dtype == torch.bfloat16
    want = torch.tensor(x).to(torch.bfloat16)
    assert torch.equal(back["w"], want)
    assert torch.equal(back["g"], torch.tensor(x[0]))
    Checkpointer(str(tmp_path / "port"), async_save=False).save(
        1, {"w": want, "g": torch.tensor(x[0])})
    for name in ("w.s0.npy", "g.s0.npy", "manifest.json"):
        assert (tmp_path / "port/step_00000001" / name).read_bytes() == \
            (tmp_path / "ref/step_00000001" / name).read_bytes()


# ----------------------------------------------------------------- data


def test_synthetic_lm_matches_reference():
    """Token-equal to the reference for 3 steps and 2 ranks."""
    for rank in range(2):
        ours = SyntheticLM(512, 32, 8, n_ranks=2, rank=rank, seed=9,
                           device="cpu")
        ref = JSynthetic(512, 32, 8, n_ranks=2, rank=rank, seed=9)
        it = ours.iter_from(0)
        for step in range(3):
            got, want = next(it), ref.batch_at(step)
            for k in ("tokens", "labels", "mask"):
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
            assert got["tokens"].dtype == torch.int32
            assert got["mask"].dtype == torch.float32
    with pytest.raises(ValueError, match="divide"):
        SyntheticLM(512, 32, 7, n_ranks=2, device="cpu")


def test_bin_token_source_matches_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(3).integers(0, 700, 5000).astype(
        np.uint16).tofile(path)
    for rank in range(2):
        ours = BinTokenSource(str(path), 600, 16, 4, n_ranks=2, rank=rank,
                              device="cpu")
        ref = JBin(str(path), 600, 16, 4, n_ranks=2, rank=rank)
        for step in (0, 1, 77):
            got, want = ours.batch_at(step), ref.batch_at(step)
            for k in ("tokens", "labels", "mask"):
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))


def test_prefetcher_keeps_order_and_stops():
    assert list(Prefetcher(iter(range(7)), depth=2)) == list(range(7))


# ------------------------------------------------------------- telemetry


@pytest.fixture(scope="module")
def grad_sketches(carried):
    """The reference's gradients of 4 microbatches, sketched by both
    packages (priority, the reference backend, m = 256, one seed)."""
    jcfg, cfg, p_np, _ = carried
    data = JSynthetic(jcfg.vocab_size, 32, 16, seed=11)
    batch = data.batch_at(0)
    grad = jax.jit(jax.grad(lambda p, b: j_loss_fn(jcfg, p, b)[0]))
    jp = jax.tree.map(jnp.asarray, p_np)
    ours, ref = [], []
    for i in range(4):
        mb = {k: v[4 * i:4 * i + 4] for k, v in batch.items()}
        g = grad(jp, mb)
        ref.append(jt.sketch_grads(g, 256, 21))
        ours.append(sketch_grads(_torch_tree(jax.device_get(g)), 256, 21))
    return ours, ref


def test_grad_sketches_match_reference(grad_sketches):
    """Same kept coordinates and values, tau bit-equal (an order
    statistic), norms within 1e-6."""
    ours, ref = grad_sketches
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.sketch.idx.numpy(),
                                      np.asarray(b.sketch.idx))
        np.testing.assert_array_equal(a.sketch.val.numpy(),
                                      np.asarray(b.sketch.val))
        assert float(a.sketch.tau) == float(b.sketch.tau)
        np.testing.assert_allclose(float(a.norm2), float(b.norm2), rtol=1e-6)


def test_telemetry_estimates_match_reference(grad_sketches):
    """``grad_inner_product`` (estimate and half-width), ``grad_cosine``
    and ``gradient_noise_scale`` within 1e-5."""
    ours, ref = grad_sketches
    for i in range(4):
        for j in range(i + 1, 4):
            est, half = grad_inner_product(ours[i], ours[j])
            j_est, j_half = jt.grad_inner_product(ref[i], ref[j])
            np.testing.assert_allclose(float(est), float(j_est), rtol=1e-5,
                                       atol=1e-5 * float(j_half))
            np.testing.assert_allclose(float(half), float(j_half), rtol=1e-5)
            np.testing.assert_allclose(float(grad_cosine(ours[i], ours[j])),
                                       float(jt.grad_cosine(ref[i], ref[j])),
                                       rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(gradient_noise_scale(ours, 4)),
                               float(jt.gradient_noise_scale(ref, 4)),
                               rtol=1e-5)


def test_gradient_noise_scale_symmetry_and_gauges():
    """``tests/test_obs.py``'s GNS test on the port: the i < j estimate
    equals the full double loop's (the estimator is symmetric) and the
    four ``repro_train_gns*`` gauges are set, equal to the reference's
    after the same call."""
    from repro_torch.core.estimator import estimate_inner_product
    rng = np.random.default_rng(10)
    vecs = [rng.normal(size=256).astype(np.float32) for _ in range(3)]
    shards = [sketch_grads([torch.tensor(v)], 64, 7) for v in vecs]
    e_ij = float(estimate_inner_product(shards[0].sketch, shards[1].sketch))
    e_ji = float(estimate_inner_product(shards[1].sketch, shards[0].sketch))
    assert e_ij == pytest.approx(e_ji, rel=1e-6)
    names = ("repro_train_gns", "repro_train_gns_big_norm2",
             "repro_train_gns_small_norm2", "repro_train_gns_ci_halfwidth")
    obs.reset()
    j_obs.reset()
    obs.enable()
    j_obs.enable()
    try:
        gns = float(gradient_noise_scale(shards, 32))
        j_gns = float(jt.gradient_noise_scale(
            [jt.sketch_grads([jnp.asarray(v)], 64, 7) for v in vecs], 32))
        r, jr = obs.registry(), j_obs.registry()
        assert gns >= 0.0 and r.value("repro_train_gns") == \
            pytest.approx(gns, rel=1e-6)
        assert r.value("repro_train_gns_ci_halfwidth") > 0.0
        assert r.value("repro_train_gns_big_norm2") > 0.0
        for name in names:
            assert r.value(name) == pytest.approx(jr.value(name), rel=1e-5)
        assert j_gns == pytest.approx(gns, rel=1e-5)
    finally:
        obs.disable()
        j_obs.disable()
        obs.reset()
        j_obs.reset()


# -------------------------------------------------------------- launcher


def test_launcher_runs_and_resumes(tmp_path):
    """``python -m repro_torch.launch.train --reduced --steps 3 --device
    cpu`` in a subprocess, with a checkpoint directory; a second run with
    more steps resumes from the last checkpoint."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    env.pop("WORLD_SIZE", None)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
           "--steps", "3", "--device", "cpu", "--batch", "4", "--seq", "32",
           "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "arch=gemma2-2b-reduced" in out.stdout
    assert "step      0 loss" in out.stdout
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000002",
                                                   "step_00000003"]
    cmd[cmd.index("--steps") + 1] = "4"
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "resumed from step 3" in out.stdout


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-370m",
                                  "recurrentgemma-2b", "whisper-small",
                                  "phi-3-vision-4.2b"])
def test_launcher_trains_every_family(arch, capsys):
    """The launcher's ``main`` on each new family's reduced config on the
    CPU (the frame and image stubs for whisper and phi-3-vision): two
    logged steps with finite losses, and no thread of its own left
    running after it returns (the batch prefetcher's ends with the last
    step)."""
    from repro_torch.launch.train import main
    before = set(threading.enumerate())
    main(["--arch", arch, "--reduced", "--steps", "2", "--device", "cpu",
          "--batch", "2", "--seq", "32"])
    for t in set(threading.enumerate()) - before:
        t.join(timeout=30)
    assert not [t for t in set(threading.enumerate()) - before
                if t.is_alive()]
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced" in out
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("step ")]
    assert len(losses) == 1 and all(np.isfinite(losses)), out
