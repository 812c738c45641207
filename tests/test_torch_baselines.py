"""Port parity: the CountSketch and JL kernels' plain versions and the
paper's baselines (``core/baselines.py``) against ``repro``.

Both packages get the same numpy-made inputs; the port runs on the CPU
(the kernels' plain versions).  Tolerances as the reference's own kernel
tests state them: CountSketch rtol = atol = 1e-5, JL 1e-4 (float32 sums
in another order); the JL sign stream and MinHash are bit-equal.  WMH
takes logs, which may differ by an ulp between PyTorch and XLA: its
samples are equal except on near ties (the reference's two smallest
``log_aq`` within 4 ulp), which are counted and reported.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_common import assert_bits, to_np
from _torch_common import release_jax_executables  # noqa: F401

import repro.core as rc
from repro.core.hashing import fold_seed as j_fold_seed
from repro.core.hashing import mix32 as j_mix32
from repro.core.hashing import hash_unit as j_hash_unit
from repro.kernels import countsketch_kernel, countsketch_ref, jl_project, jl_ref
from repro.kernels.jl_rademacher import jl_signs_ref
import repro_torch.core as tc
import repro_torch.kernels as tk
from repro_torch.kernels.countsketch import countsketch_ref as t_cs_ref
from repro_torch.kernels.jl_rademacher import (jl_ref as t_jl_ref,
                                               jl_signs_ref as t_signs_ref)

CS_TOL = dict(rtol=1e-5, atol=1e-5)
JL_TOL = dict(rtol=1e-4, atol=1e-4)
SEEDS = [0, 7, 0xB0C4, 2**32 - 5]


def _vec(rng, n, sparsity=0.7):
    v = rng.standard_normal(n).astype(np.float32)
    v[rng.random(n) < sparsity] = 0
    return v


def _edge_vec(rng, n):
    """Normal values with the flush-to-zero traps: subnormal inputs,
    normals whose squares are subnormal, zeros and signed zeros."""
    v = _vec(rng, n, sparsity=0.3)
    traps = np.array([1e-40, -1e-40, 1e-20, -1e-20, 1.1e-19, 3e-39, -0.0,
                      0.0], np.float32)
    pick = rng.random(n) < 0.2
    v[pick] = rng.choice(traps, int(pick.sum()))
    return v


# ----------------------------------------------------------------------------
# B8 countsketch (plain version) and B9 JL (plain version)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(1000, 64), (1024, 128), (5000, 400),
                                 (8192, 512), (3000, 1000)])
def test_countsketch_plain_matches_reference(n, m):
    rng = np.random.default_rng(n + m)
    v = _vec(rng, n)
    got = tk.countsketch(torch.as_tensor(v), m, 5, 6)
    for ref in (countsketch_kernel(jnp.asarray(v), m, 5, 6),
                countsketch_ref(jnp.asarray(v), 5, 6, m)):
        np.testing.assert_allclose(to_np(got), np.asarray(ref), **CS_TOL)
    np.testing.assert_allclose(
        to_np(t_cs_ref(torch.as_tensor(v), 5, 6, m)),
        np.asarray(countsketch_ref(jnp.asarray(v), 5, 6, m)), **CS_TOL)


@pytest.mark.parametrize("n,m", [(500, 64), (1024, 256), (4096, 100),
                                 (2000, 300)])
def test_jl_plain_matches_reference(n, m):
    rng = np.random.default_rng(n)
    v = _vec(rng, n)
    got = tk.jl_project(torch.as_tensor(v), m, 11)
    for ref in (jl_project(jnp.asarray(v), m, 11),
                jl_ref(jnp.asarray(v), m, 11)):
        np.testing.assert_allclose(to_np(got), np.asarray(ref), **JL_TOL)
    np.testing.assert_allclose(to_np(t_jl_ref(torch.as_tensor(v), m, 11)),
                               np.asarray(jl_ref(jnp.asarray(v), m, 11)),
                               **JL_TOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_jl_signs_bit_equal(seed):
    rows = np.array([0, 1, 2, 255, 256, 1000, 2**31 + 7], np.int64)
    assert_bits(t_signs_ref(seed, torch.as_tensor(rows), 3001),
                jl_signs_ref(seed, jnp.asarray(rows.astype(np.uint32)), 3001))


def test_jl_sign_bit_shortcut_matches_mix32():
    """The JL kernel takes its sign from ``sketch::mix32_sign_bit``: mix32's
    first steps, then one multiply by M2 * (2^31 + 2^16), whose bit 31 is
    the low bit of mix32.  With the header's own constants, on random and
    edge words, that bit equals the reference's ``mix32(x) & 1``."""
    header = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
              "csrc" / "sketch_common.cuh").read_text()
    m1, m2 = (int(re.search(rf"{name} = (0x[0-9A-Fa-f]+)u;", header)[1], 16)
              for name in ("M1", "M2"))
    assert "return x * (M2 * 0x80010000u);" in header
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.integers(0, 2**32, 200000, dtype=np.uint64),
                        np.array([0, 1, 2**15, 2**16, 2**31, 2**32 - 1],
                                 np.uint64)])
    mask = np.uint64(0xFFFFFFFF)
    y = x ^ (x >> np.uint64(16))
    y = (y * np.uint64(m1)) & mask
    y ^= y >> np.uint64(15)
    y = (y * np.uint64((m2 * 0x80010000) & 0xFFFFFFFF)) & mask
    want = np.asarray(j_mix32(jnp.asarray(x.astype(np.uint32)))) & 1
    np.testing.assert_array_equal((y >> np.uint64(31)).astype(np.uint32),
                                  want)


def test_kernel_wrappers_on_cpu_use_plain_versions():
    rng = np.random.default_rng(3)
    v = torch.as_tensor(_vec(rng, 3000))
    before = (tk.countsketch_scatter.launches, tk.jl_rademacher.launches)
    assert_bits(tk.countsketch(v, 300, 1, 2), t_cs_ref(v, 1, 2, 300))
    assert_bits(tk.jl_project(v, 40, 9), t_jl_ref(v, 40, 9))
    # a CPU tensor runs the plain version and launches nothing
    assert (tk.countsketch_scatter.launches,
            tk.jl_rademacher.launches) == before


# ----------------------------------------------------------------------------
# core.baselines
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_jl_and_countsketch_baselines_match_reference(seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    a, b = _vec(rng, 6000), _vec(rng, 6000)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for m in (64, 300):   # row blocks of 64: a whole block and a ragged one
        sa, sb = tc.jl_sketch(ta, m, seed), tc.jl_sketch(tb, m, seed)
        ra, rb = rc.jl_sketch(ja, m, seed), rc.jl_sketch(jb, m, seed)
        np.testing.assert_allclose(to_np(sa), np.asarray(ra), **JL_TOL)
        np.testing.assert_allclose(float(tc.jl_estimate(sa, sb)),
                                   float(rc.jl_estimate(ra, rb)),
                                   rtol=1e-4, atol=1e-3)
    for m in (64, 400):   # both bucket branches: mask and modulo
        ca, cb = tc.countsketch(ta, m, seed), tc.countsketch(tb, m, seed)
        ra, rb = rc.countsketch(ja, m, seed), rc.countsketch(jb, m, seed)
        np.testing.assert_allclose(to_np(ca), np.asarray(ra), **CS_TOL)
        np.testing.assert_allclose(float(tc.countsketch_estimate(ca, cb)),
                                   float(rc.countsketch_estimate(ra, rb)),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k", [32, 75])
def test_minhash_bit_equal(seed, k):
    rng = np.random.default_rng(seed & 0xFFFF)
    a = _edge_vec(rng, 4000)
    b = a.copy()
    b[rng.random(4000) < 0.5] = 0
    got_a = tc.minhash_sketch(torch.as_tensor(a), k, seed)
    ref_a = rc.minhash_sketch(jnp.asarray(a), k, seed)
    for g, r in zip(got_a, ref_a):
        assert_bits(g, r)
    got_b = tc.minhash_sketch(torch.as_tensor(b), k, seed)
    ref_b = rc.minhash_sketch(jnp.asarray(b), k, seed)
    # the estimate's two float32 sums run in another order: tolerance
    np.testing.assert_allclose(float(tc.minhash_estimate(got_a, got_b)),
                               float(rc.minhash_estimate(ref_a, ref_b)),
                               rtol=1e-5)


def _ref_log_aq(a: np.ndarray, seed, j: int) -> np.ndarray:
    """The reference's WMH ``log_aq`` of repetition ``j``, eagerly."""
    a = jnp.asarray(a)
    idx = jnp.arange(a.shape[0], dtype=jnp.int32)
    w = a * a
    logw = jnp.where(w > 0, jnp.log(jnp.where(w > 0, w, 1.0)), -jnp.inf)
    js = jnp.uint32(j)
    u = [j_hash_unit(j_fold_seed(seed, 4 + t) + js, idx) for t in range(5)]
    r = -jnp.log(u[0]) - jnp.log(u[1])
    c = -jnp.log(u[2]) - jnp.log(u[3])
    t = jnp.floor(logw / r + u[4])
    log_aq = jnp.log(c) - (r * (t - u[4]) + r)
    return np.asarray(jnp.where(w > 0, log_aq, jnp.inf))


def _near_tie(log_aq: np.ndarray) -> bool:
    lo = np.sort(log_aq)[:2]
    return bool(np.isfinite(lo).all()
                and abs(lo[1] - lo[0]) <= 4 * np.spacing(np.abs(lo).max()))


@pytest.mark.parametrize("seed", SEEDS)
def test_wmh_matches_reference_except_near_ties(seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    a = _edge_vec(rng, 3000)
    b = a.copy()
    b[rng.random(3000) < 0.4] *= 0.5
    k = 40
    near = 0
    sketches = []
    for v in (a, b):
        got = tc.wmh_sketch(torch.as_tensor(v), k, seed)
        ref = rc.wmh_sketch(jnp.asarray(v), k, seed)
        g_idx, r_idx = to_np(got.idx), np.asarray(ref.idx)
        for j in np.flatnonzero(g_idx != r_idx):
            assert _near_tie(_ref_log_aq(v, seed, int(j))), \
                f"repetition {j}: samples {g_idx[j]} vs {r_idx[j]}, no tie"
            near += 1
        same = g_idx == r_idx
        assert_bits(to_np(got.val)[same], np.asarray(ref.val)[same])
        np.testing.assert_allclose(float(got.wsum), float(ref.wsum),
                                   rtol=1e-5)
        sketches.append((got, ref))
    print(f"WMH near-tie mismatches: {near} of {2 * k}")
    (ga, ra), (gb, rb) = sketches
    if near == 0:
        np.testing.assert_allclose(float(tc.wmh_estimate(ga, gb)),
                                   float(rc.wmh_estimate(ra, rb)),
                                   rtol=1e-5)


def test_baselines_flush_subnormals_like_reference():
    """A subnormal input is outside MinHash's support and a normal input
    with a subnormal square has zero WMH weight, as under XLA."""
    a = np.zeros(256, np.float32)
    a[[3, 50]] = 1e-40          # subnormal inputs
    a[[7, 90]] = 1e-20          # squares are subnormal
    a[[11, 200]] = [0.5, -2.0]
    for seed in (1, 99):
        got = tc.minhash_sketch(torch.as_tensor(a), 16, seed)
        ref = rc.minhash_sketch(jnp.asarray(a), 16, seed)
        for g, r in zip(got, ref):
            assert_bits(g, r)
        got_w = tc.wmh_sketch(torch.as_tensor(a), 16, seed)
        ref_w = rc.wmh_sketch(jnp.asarray(a), 16, seed)
        assert_bits(got_w.idx, ref_w.idx)
        assert_bits(got_w.val, ref_w.val)
        assert set(to_np(got_w.idx).tolist()) <= {11, 200}
        np.testing.assert_allclose(float(got_w.wsum), float(ref_w.wsum),
                                   rtol=1e-6)


def test_baselines_on_a_zero_row():
    z = np.zeros(777, np.float32)
    t, j = torch.as_tensor(z), jnp.asarray(z)
    assert_bits(tc.jl_sketch(t, 50, 3), rc.jl_sketch(j, 50, 3))
    assert_bits(tc.countsketch(t, 50, 3), rc.countsketch(j, 50, 3))
    for g, r in zip(tc.minhash_sketch(t, 8, 3), rc.minhash_sketch(j, 8, 3)):
        assert_bits(g, r)
    got_w, ref_w = tc.wmh_sketch(t, 8, 3), rc.wmh_sketch(j, 8, 3)
    assert_bits(got_w.idx, ref_w.idx)
    assert_bits(got_w.val, ref_w.val)
    assert float(got_w.wsum) == float(ref_w.wsum) == 0.0


# ----------------------------------------------------------------------------
# the reference's estimator-consistency tests, on the port
# ----------------------------------------------------------------------------

def test_countsketch_estimate_consistency():
    rng = np.random.default_rng(1)
    a = torch.as_tensor(_vec(rng, 4000))
    b = torch.as_tensor(_vec(rng, 4000))
    true = float(torch.dot(a, b))
    ests = [float(torch.dot(tk.countsketch(a, 512, s, s + 1),
                            tk.countsketch(b, 512, s, s + 1)))
            for s in range(40)]
    se = np.std(ests) / np.sqrt(len(ests))
    assert abs(np.mean(ests) - true) < 4 * se + 1e-3


def test_jl_preserves_inner_products():
    rng = np.random.default_rng(2)
    a = torch.as_tensor(_vec(rng, 3000, sparsity=0.0))
    b = torch.as_tensor(_vec(rng, 3000, sparsity=0.0))
    true = float(torch.dot(a, b))
    ests = [float(torch.dot(tk.jl_project(a, 512, s), tk.jl_project(b, 512, s)))
            for s in range(25)]
    se = np.std(ests) / np.sqrt(len(ests))
    assert abs(np.mean(ests) - true) < 4 * se + 1e-2


def test_minhash_estimate_matches_reference():
    """MinHash's samples of one pair are the reference's bit for bit, and
    its estimate (two float32 sums) within rtol 1e-5."""
    rng = np.random.default_rng(5)
    a, b = _vec(rng, 5000, 0.5), _vec(rng, 5000, 0.5)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    got = [tc.minhash_sketch(ta, 128, 4), tc.minhash_sketch(tb, 128, 4)]
    ref = [rc.minhash_sketch(ja, 128, 4), rc.minhash_sketch(jb, 128, 4)]
    for g, r in zip(got, ref):
        for x, y in zip(g, r):
            assert_bits(x, y)
    np.testing.assert_allclose(float(tc.minhash_estimate(*got)),
                               float(rc.minhash_estimate(*ref)), rtol=1e-5)
