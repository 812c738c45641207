"""Port parity: SketchDP (``repro_torch.distributed.grad_compress``)
against ``repro.distributed.grad_compress``.

The pieces run on the same numpy inputs in both packages: the flat
sketches (the port's kernel route, on the CPU the kernels' plain
versions, against the reference's ``backend="pallas"`` route and both
packages' sort-based ``"reference"`` builders) under the North star's
contract (ids and values bit for bit, priority tau bit for bit, the
adaptive threshold tau within rtol 1e-6 of the same route and 1e-5
across routes); ``densify_mean`` and the error-feedback residual on
hand-built W = 2 sketches within 1e-6; the matrix mode.  The whole step
runs in two gloo ranks (``tests/_torch_sketchdp_worker.py``): with m >= n
it equals the dense mean gradient within the reference's rtol 3e-3,
atol 2e-4 (``tests/test_distributed.py``) and leaves a residual below
1e-10.
"""
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.sketches import INVALID_IDX
from repro.distributed import compression_ratio as j_compression_ratio
from repro.distributed import densify_matrix_mean as j_densify_matrix_mean
from repro.distributed import matrix_compression_ratio as j_matrix_ratio
from repro.distributed import sketch_gradient as j_sketch_gradient
from repro.distributed import sketch_matrix_gradient as j_sketch_matrix
from repro.distributed.grad_compress import densify_mean as j_densify_mean
from repro_torch.distributed import (compression_ratio, densify_matrix_mean,
                                     densify_mean, init_ef_state,
                                     matrix_compression_ratio,
                                     sketch_gradient, sketch_matrix_gradient)
from repro_torch.distributed.grad_compress import (error_feedback_residual,
                                                   step_seed)
from _torch_common import assert_bits
from _torch_common import release_jax_executables  # noqa: F401

TESTS = Path(__file__).resolve().parent


def _flat(n: int, seed: int) -> np.ndarray:
    """A gradient-like vector: Student-t magnitudes, half of them zero."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_t(3, n) * 1e-3).astype(np.float32)
    g[rng.random(n) < 0.5] = 0
    return g


@pytest.mark.parametrize("method", ["threshold", "priority"])
@pytest.mark.parametrize("n,m", [(1 << 14, 256), (50_000, 2_500)])
def test_sketch_gradient_matches_reference(method, n, m):
    g = _flat(n, n + m)
    seed = step_seed(3)
    got = sketch_gradient(torch.as_tensor(g), m, seed, method=method)
    pallas = j_sketch_gradient(jnp.asarray(g), m, seed, method=method)
    ref = j_sketch_gradient(jnp.asarray(g), m, seed, method=method,
                            backend="reference")
    got_ref = sketch_gradient(torch.as_tensor(g), m, seed, method=method,
                              backend="reference")
    for ours, theirs, rtol in ((got, pallas, 1e-6), (got_ref, ref, 1e-6),
                               (got, ref, 1e-5)):
        assert_bits(ours[0], np.asarray(theirs[0]))
        assert_bits(ours[1], np.asarray(theirs[1]))
        if method == "priority":
            assert_bits(ours[2], np.asarray(theirs[2]))
        else:
            np.testing.assert_allclose(float(ours[2]), float(theirs[2]),
                                       rtol=rtol)
    with pytest.raises(ValueError, match="unknown method"):
        sketch_gradient(torch.as_tensor(g), m, seed, method="uniform")


def test_sketch_gradient_refuses_more_than_int32_ids():
    """n >= 2^31 raises rather than wrapping the int32 ids (a stride-0
    view: no memory behind it)."""
    huge = torch.zeros(1).expand(1 << 31)
    with pytest.raises(ValueError, match="int32"):
        sketch_gradient(huge, 1024, 1)


def test_step_seed_is_the_reference_uint32():
    for step in (0, 1, 2**31, 2**32 - 0x5EED, 2**32 + 5):
        want = int(jnp.uint32(0x5EED) + jnp.asarray(step % 2**32,
                                                     jnp.uint32))
        assert step_seed(step) == want


def _hand_built(rng, n=64, cap=12):
    """Two ranks' sketches: distinct sorted ids, INVALID padding, one
    value small enough that p < 1 and one large enough that p = 1."""
    idx = np.full((2, cap), INVALID_IDX, np.int32)
    val = np.zeros((2, cap), np.float32)
    for w, size in enumerate((cap, cap - 3)):
        idx[w, :size] = np.sort(rng.choice(n, size, replace=False))
        val[w, :size] = rng.standard_normal(size).astype(np.float32)
    val[0, 0] = 30.0
    tau = np.array([0.5, 2.0], np.float32)
    return idx, val, tau


def test_densify_mean_matches_reference_at_w2():
    rng = np.random.default_rng(5)
    idx, val, tau = _hand_built(rng)
    idx[1, :4] = idx[0, :4]              # shared coordinates across ranks
    idx[1] = np.sort(idx[1])
    got = densify_mean(torch.as_tensor(idx), torch.as_tensor(val),
                       torch.as_tensor(tau), 64)
    want = j_densify_mean(jnp.asarray(idx), jnp.asarray(val),
                          jnp.asarray(tau), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_error_feedback_residual_matches_reference_step():
    """The reference's residual (``grad_compress.py``'s local step: ``sent``
    scattered from the rank's own sketch, ``flat - sent``) on each of two
    ranks' hand-built sketches, within 1e-6; the residual is updated in
    place."""
    rng = np.random.default_rng(6)
    idx, val, tau = _hand_built(rng)
    for w in range(2):
        flat = rng.standard_normal(64).astype(np.float32)
        flat[idx[w][idx[w] != INVALID_IDX]] = val[w][idx[w] != INVALID_IDX]
        t = torch.as_tensor(flat.copy())
        out = error_feedback_residual(t, torch.as_tensor(idx[w]),
                                      torch.as_tensor(val[w]),
                                      torch.as_tensor(tau[w]))
        assert out is t
        ji, jv, jtau = (jnp.asarray(idx[w]), jnp.asarray(val[w]),
                        jnp.asarray(tau[w]))
        p = jnp.minimum(1.0, jtau * (jv * jv))
        valid = ji != INVALID_IDX
        sent = jnp.zeros((64,), jnp.float32).at[jnp.where(valid, ji, 0)].add(
            jnp.where(valid & (p > 0), jv / jnp.where(p > 0, p, 1.0), 0.0))
        np.testing.assert_allclose(out.numpy(), np.asarray(flat - sent),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", ["priority", "threshold"])
def test_matrix_mode_matches_reference(method):
    """Row sketches of two ranks' (n, d) gradients (ids and rows bit for
    bit, tau bit for bit or within rtol 1e-6), ``densify_matrix_mean`` of
    them within 1e-6 of the reference's on the same sketches, and the
    payload ratio equal."""
    rng = np.random.default_rng(8)
    n, d, m = 300, 8, 40
    Gs = [(rng.standard_normal((n, d)) *
           rng.lognormal(0, 1, (n, 1))).astype(np.float32) for _ in range(2)]
    ours = [sketch_matrix_gradient(torch.as_tensor(G), m, 13, method=method)
            for G in Gs]
    theirs = [j_sketch_matrix(jnp.asarray(G), m, 13, method=method)
              for G in Gs]
    for a, b in zip(ours, theirs):
        assert_bits(a[0], np.asarray(b[0]))
        assert_bits(a[1], np.asarray(b[1]))
        if method == "priority":
            assert_bits(a[2], np.asarray(b[2]))
        else:
            np.testing.assert_allclose(float(a[2]), float(b[2]), rtol=1e-6)
    got = densify_matrix_mean(torch.stack([o[0] for o in ours]),
                              torch.stack([o[1] for o in ours]),
                              torch.stack([o[2] for o in ours]), n)
    # the reference's mean of the same (the port's) sketches: a threshold
    # tau that differs in its last bits moves p = min(1, tau w) near 1
    want = j_densify_matrix_mean(
        *(jnp.stack([jnp.asarray(o[i].numpy()) for o in ours])
          for i in range(3)), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert matrix_compression_ratio((n, d), m, method=method) == \
        j_matrix_ratio((n, d), m, method=method)
    with pytest.raises(ValueError, match="unknown method"):
        sketch_matrix_gradient(torch.as_tensor(Gs[0]), m, 13, method="x")


def test_compression_ratio_and_ef_state():
    params = {"a": torch.zeros((30, 4)), "b": {"c": torch.zeros(17)}}
    j_params = {"a": jnp.zeros((30, 4)), "b": {"c": jnp.zeros(17)}}
    for m in (8, 50):
        assert compression_ratio(params, m) == j_compression_ratio(j_params, m)
    ef = init_ef_state(params)
    assert ef.shape == (137,) and ef.dtype == torch.float32 and not ef.any()


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """``_torch_sketchdp_worker.py`` in 2 gloo ranks; a hang fails within
    240 s and leaves no rank behind."""
    tmp = tmp_path_factory.mktemp("sketchdp")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(TESTS.parent / "src")] + ([env["PYTHONPATH"]]
                                       if env.get("PYTHONPATH") else []))
    proc = subprocess.Popen(
        [sys.executable, str(TESTS / "_torch_sketchdp_worker.py"), "2",
         str(tmp / "rendezvous"), str(tmp)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail("2 gloo ranks did not finish within 240 s")
    assert proc.returncode == 0, log
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def test_sketchdp_two_ranks_exact_when_m_covers_params(gloo_ranks):
    """m >= n: the compressed mean gradient is the dense gradient of the
    whole batch within rtol 3e-3, atol 2e-4, the loss within 1e-4, the
    residual below 1e-10 (``tests/test_distributed.py``'s test), and both
    ranks hold the same bits."""
    for out in gloo_ranks:
        np.testing.assert_allclose(out["exact_mean"], out["dense"],
                                   rtol=3e-3, atol=2e-4)
        assert abs(float(out["exact_loss"]) - float(out["dense_loss"])) < 1e-4
        assert float(out["exact_ef"]) < 1e-10
    assert_bits(gloo_ranks[0]["exact_mean"], gloo_ranks[1]["exact_mean"])


@pytest.mark.parametrize("method", ["threshold", "priority"])
def test_sketchdp_two_ranks_error_feedback(gloo_ranks, method):
    """m = n / 20 with error feedback: each rank's residual is its flat
    gradient plus the residual in, less what its own sketch carries
    (within 1e-6 of the scale); every rank's mean gradient is
    ``densify_mean`` of both ranks' sketches, bit-equal across ranks."""
    mean = None
    for out in gloo_ranks:
        flat_in = out[f"ef_{method}_in"]
        idx, val = out[f"ef_{method}_idx"], out[f"ef_{method}_val"]
        tau = out[f"ef_{method}_tau"]
        sent = np.zeros_like(flat_in)
        keep = idx != INVALID_IDX
        p = np.minimum(np.float32(1.0), tau * (val * val))
        sent[idx[keep]] = (val / np.where(p > 0, p, 1))[keep]
        np.testing.assert_allclose(out[f"ef_{method}_out"], flat_in - sent,
                                   rtol=0,
                                   atol=1e-6 * np.max(np.abs(flat_in)))
        assert np.count_nonzero(out[f"ef_{method}_out"]) < flat_in.size
        if mean is None:
            both = [(o[f"ef_{method}_idx"], o[f"ef_{method}_val"],
                     o[f"ef_{method}_tau"]) for o in gloo_ranks]
            mean = densify_mean(torch.as_tensor(np.stack([b[0] for b in both])),
                                torch.as_tensor(np.stack([b[1] for b in both])),
                                torch.as_tensor(np.stack([b[2] for b in both])),
                                flat_in.size).numpy()
        assert_bits(out[f"ef_{method}_mean"], mean)
