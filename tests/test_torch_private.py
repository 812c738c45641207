"""Port parity: the private and bias-aware subsystem (``repro_torch.
private``), the DP variance bounds, and the serving index's ``bias_aware``
and ``private`` query modes, against ``repro``.

Both packages get the same numpy-made inputs; the port runs on the CPU.
Contracts: the accountant's ledgers are equal; a release under the same
seeded ``dp_rng`` is bit-equal (both are host numpy with the same draws);
the float64 estimators agree within 1e-12 relative; the DP bounds are
float32 sums in another order (rtol 1e-5) except the norm-only band, an
elementwise formula (rtol 1e-6); CountSketch tables within 1e-5 (the
kernel's tolerance).  The serve-mode cases of the reference's own tests
are mirrored on the port.
"""
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_common import assert_bits, to_np

import repro.core as rc
import repro.private as rp
from repro.data.synthetic import zipf_frequency_tables
from repro.serve.sketch_service import SketchIndex as JSketchIndex
import repro_torch.core as tc
import repro_torch.private as tp
from repro_torch.private import DPParams, PrivacyBudgetExceeded
from repro_torch.serve import SketchIndex, index_from_arrays

CPU = "cpu"


def _small_pair(rng, n=400, nnz=120):
    a = np.zeros(n, np.float32)
    b = np.zeros(n, np.float32)
    a[rng.choice(n, nnz, replace=False)] = rng.uniform(-1, 1, nnz)
    b[rng.choice(n, nnz, replace=False)] = rng.uniform(-1, 1, nnz)
    return a, b


def _ledger(acct):
    return [(r.label, r.epsilon, r.delta, r.mem_epsilon) for r in acct.ledger]


# ---------------------------------------------------------------------------
# accountant
# ---------------------------------------------------------------------------

def _drive(mod):
    """One script of spends, refusals and merges; returns what it saw."""
    seen = []
    acct = mod.PrivacyAccountant(epsilon_budget=2.0, delta_budget=1e-5)
    acct.spend(0.5, 1e-6, label="a")
    acct.spend(0.75, label="b", mem_epsilon=3.0)
    for eps, dlt in ((1.0, 0.0), (0.1, 1e-4), (0.75, 0.0), (1e-3, 0.0)):
        try:
            acct.spend(eps, dlt, label=f"try{eps}")
            seen.append("ok")
        except mod.PrivacyBudgetExceeded:
            seen.append("refused")
    peer = mod.PrivacyAccountant()
    peer.spend(0.3, label="peer")
    try:
        acct.merge_from(peer)
        seen.append("merged")
    except mod.PrivacyBudgetExceeded:
        seen.append("merge refused")
    unmetered = mod.PrivacyAccountant()
    for _ in range(5):
        unmetered.spend(100.0)
    return (seen, _ledger(acct), acct.spent_epsilon, acct.spent_delta,
            acct.remaining_epsilon, acct.remaining_delta,
            acct.informal_mem_epsilon, unmetered.spent_epsilon)


def test_accountant_ledger_arithmetic_matches_reference():
    assert _drive(tp) == _drive(rp)
    for mod in (tp, rp):
        with pytest.raises(ValueError):
            mod.PrivacyAccountant().spend(-0.1)
        with pytest.raises(ValueError):
            mod.PrivacyAccountant(epsilon_budget=-1.0)


def test_composition_arithmetic_matches_reference():
    T, R = tp.PrivacyAccountant, rp.PrivacyAccountant
    for eps in ([0.5, 0.25, 0.25], [], [3.0]):
        assert T.sequential_epsilon(eps) == R.sequential_epsilon(eps)
        assert T.parallel_epsilon(eps) == R.parallel_epsilon(eps)
    for e, k, slack in ((0.1, 100, 1e-6), (1.0, 3, 0.5), (0.0, 0, 0.1)):
        assert T.advanced_epsilon(e, k, slack) == \
            R.advanced_epsilon(e, k, slack)
    for bad in ((0.1, -1, 1e-6), (0.1, 3, 1.5)):
        with pytest.raises(ValueError):
            T.advanced_epsilon(*bad)


# ---------------------------------------------------------------------------
# DP release and its estimators
# ---------------------------------------------------------------------------

def _corpus(rng, D=5, n=600, m=48):
    A = np.stack([_small_pair(rng, n, 150)[0] for _ in range(D)])
    sks = [rc.priority_sketch(jnp.asarray(a), m, 3) for a in A]
    idx = np.stack([np.asarray(s.idx) for s in sks])
    val = np.stack([np.asarray(s.val) for s in sks])
    tau = np.array([float(s.tau) for s in sks], np.float32)
    return A, idx, val, tau


@pytest.mark.parametrize("params", [
    DPParams(), DPParams(epsilon=4.0, clamp=1.0, p_floor=0.05),
    DPParams(epsilon=0.5, mem_epsilon=2.0, clamp=0.3, p_floor=0.2)])
@pytest.mark.parametrize("variant", ["l2", "l1", "uniform"])
def test_release_corpus_bit_equal_under_same_rng(params, variant):
    rng = np.random.default_rng(0)
    A, idx, val, tau = _corpus(rng)
    ta, ra = tp.PrivacyAccountant(), rp.PrivacyAccountant()
    got = tp.private_release_corpus(
        idx, val, tau, A.shape[1], params, rng=np.random.default_rng(5),
        variant=variant, accountant=ta)
    ref = rp.private_release_corpus(
        idx, val, tau, A.shape[1], rp.DPParams(*params),
        rng=np.random.default_rng(5), variant=variant, accountant=ra)
    assert_bits(got.idx, ref.idx)
    assert_bits(got.z, ref.z)
    assert got.universe == ref.universe
    assert _ledger(ta) == _ledger(ra)
    # d > 1 payload layout: the same draws, shape (D, cap, d)
    pay = np.stack([val, 0.5 * val, -val], axis=-1)
    g = tp.private_release_corpus(idx, pay, tau, A.shape[1], params,
                                  rng=np.random.default_rng(6),
                                  variant=variant)
    r = rp.private_release_corpus(idx, pay, tau, A.shape[1],
                                  rp.DPParams(*params),
                                  rng=np.random.default_rng(6),
                                  variant=variant)
    assert_bits(g.idx, r.idx)
    assert_bits(g.z, r.z)


def test_release_of_port_sketch_bit_equal_and_estimators():
    """The port's own sketch (bit-equal to the reference's) released under
    the same rng gives the reference's release; the dense and product
    estimators are float64 numpy within 1e-12 relative."""
    rng = np.random.default_rng(1)
    a, b = _small_pair(rng, n=500, nnz=160)
    params = DPParams(epsilon=2.0, clamp=1.0, p_floor=0.05)
    sk_t = tc.priority_sketch(torch.as_tensor(a), 64, 7)
    sk_r = rc.priority_sketch(jnp.asarray(a), 64, 7)
    got = tp.private_release(sk_t, a.shape[0], params,
                             rng=np.random.default_rng(9))
    ref = rp.private_release(sk_r, a.shape[0], rp.DPParams(*params),
                             rng=np.random.default_rng(9))
    assert_bits(got.idx, ref.idx)
    assert_bits(got.z, ref.z)
    np.testing.assert_allclose(tp.estimate_private_dense(got, b),
                               rp.estimate_private_dense(ref, b), rtol=1e-12)
    sb_t = tc.priority_sketch(torch.as_tensor(b), 64, 99)
    sb_r = rc.priority_sketch(jnp.asarray(b), 64, 99)
    gb = tp.private_release(sb_t, b.shape[0], params,
                            rng=np.random.default_rng(10))
    rb = rp.private_release(sb_r, b.shape[0], rp.DPParams(*params),
                            rng=np.random.default_rng(10))
    np.testing.assert_allclose(tp.estimate_private_product(got, gb),
                               rp.estimate_private_product(ref, rb),
                               rtol=1e-12)
    # batched dense estimates, (D, cap) -> (D,)
    A, idx, val, tau = _corpus(rng, n=500, m=64)
    g = tp.private_release_corpus(idx, val, tau, A.shape[1], params,
                                  rng=np.random.default_rng(2))
    r = rp.private_release_corpus(idx, val, tau, A.shape[1],
                                  rp.DPParams(*params),
                                  rng=np.random.default_rng(2))
    q = rng.normal(size=A.shape[1]).astype(np.float32)
    np.testing.assert_allclose(tp.estimate_private_dense(g, q),
                               rp.estimate_private_dense(r, q), rtol=1e-12)
    with pytest.raises(ValueError, match="single-row"):
        tp.estimate_private_product(g, gb)


def test_release_strict_budget_and_validation():
    rng = np.random.default_rng(2)
    A, idx, val, tau = _corpus(rng, D=4)
    acct = tp.PrivacyAccountant(epsilon_budget=1.0)
    tp.private_release_corpus(idx, val, tau, A.shape[1], DPParams(epsilon=1.0),
                              rng=rng, accountant=acct)
    assert acct.spent_epsilon == pytest.approx(1.0)
    with pytest.raises(PrivacyBudgetExceeded):
        tp.private_release_corpus(idx, val, tau, A.shape[1],
                                  DPParams(epsilon=0.5), rng=rng,
                                  accountant=acct)
    assert acct.spent_epsilon == pytest.approx(1.0)
    for bad in (DPParams(epsilon=0), DPParams(mem_epsilon=0),
                DPParams(clamp=-1), DPParams(p_floor=0),
                DPParams(delta=-1)):
        with pytest.raises(ValueError):
            bad.validate()
    p = DPParams(epsilon=2.0)
    assert p.noise_scale(64, d=3) == rp.DPParams(epsilon=2.0).noise_scale(
        64, d=3)
    assert p.survival == rp.DPParams(epsilon=2.0).survival


# ---------------------------------------------------------------------------
# DP variance bounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["priority", "threshold"])
@pytest.mark.parametrize("variant", ["l2", "uniform"])
def test_dp_bounds_match_reference(method, variant):
    rng = np.random.default_rng(4)
    a, b = _small_pair(rng)
    a[:5] *= 3.0            # a few values past the clamp
    m = 32
    p = DPParams(epsilon=1.0, clamp=1.0, p_floor=0.05)
    kw = dict(q=p.survival, noise_scale=p.noise_scale(m), clamp=p.clamp,
              p_floor=p.p_floor, method=method, variant=variant)
    for mode in ("dense", "pair"):
        for extra in (dict(), dict(universe=a.shape[0], capacity=m),
                      dict(tau=0.37)):
            if mode == "pair" and "tau" in extra:
                continue
            got = float(tc.dp_variance_bound(a, b, m, mode=mode, **kw,
                                             **extra))
            ref = float(rc.dp_variance_bound(jnp.asarray(a), jnp.asarray(b),
                                             m, mode=mode, **kw, **extra))
            assert got == pytest.approx(ref, rel=1e-5)
        gk = dict(clamp=p.clamp, p_floor=p.p_floor, method=method,
                  variant=variant, mode=mode)
        got = float(tc.dp_debias_gap(a, b, m, **gk))
        ref = float(rc.dp_debias_gap(jnp.asarray(a), jnp.asarray(b), m,
                                     **gk))
        assert got == pytest.approx(ref, rel=1e-5, abs=1e-6)
    with pytest.raises(ValueError, match="unknown mode"):
        tc.dp_variance_bound(a, b, m, mode="bogus", **kw)
    for eps in (0.5, 1.0, 4.0):
        q = DPParams(epsilon=eps, clamp=1.0, p_floor=0.05)
        hw = dict(q=q.survival, noise_scale=q.noise_scale(64), clamp=q.clamp,
                  p_floor=q.p_floor, capacity=64, universe=1000,
                  method=method)
        assert float(tc.dp_chebyshev_halfwidth(50.0, 73.5, 64, **hw)) == \
            pytest.approx(float(rc.dp_chebyshev_halfwidth(50.0, 73.5, 64,
                                                           **hw)), rel=1e-6)


# ---------------------------------------------------------------------------
# bias-aware head/tail estimation
# ---------------------------------------------------------------------------

def test_head_split_equal():
    rng = np.random.default_rng(5)
    a = _small_pair(rng, n=300, nnz=80)[0]
    a[[3, 9, 27]] = [5.0, -5.0, 5.0]      # ties break by coordinate
    for h in (0, 1, 4, 16, 300, 400):
        for g, r in zip(tp.head_split(a, h), rp.head_split(a, h)):
            assert_bits(g, r)


@pytest.mark.parametrize("kind", ["priority", "threshold"])
@pytest.mark.parametrize("variant", ["l2", "uniform"])
@pytest.mark.parametrize("h", [0, 7])
def test_bias_aware_sketch_and_estimate_match_reference(kind, variant, h):
    rng = np.random.default_rng(6)
    fa, fb = zipf_frequency_tables(rng, 3_000, 10_000, 10_000, overlap=0.3,
                                   z=1.5)
    for seed in (0, 5):
        ga = tp.bias_aware_sketch(fa, 96, seed, h=h, kind=kind,
                                  variant=variant, device=CPU)
        gb = tp.bias_aware_sketch(fb, 96, seed, h=h, kind=kind,
                                  variant=variant, device=CPU)
        ra = rp.bias_aware_sketch(fa, 96, seed, h=h, kind=kind,
                                  variant=variant)
        rb = rp.bias_aware_sketch(fb, 96, seed, h=h, kind=kind,
                                  variant=variant)
        for g, r in ((ga, ra), (gb, rb)):
            assert_bits(g.head_idx, r.head_idx)
            assert_bits(g.head_val, r.head_val)
            assert_bits(g.tail.idx, r.tail.idx)
            assert_bits(g.tail.val, r.tail.val)
            np.testing.assert_allclose(float(g.tail.tau), float(r.tail.tau),
                                       rtol=1e-5)
            assert g.head_size == r.head_size
        assert tp.estimate_bias_aware(ga, gb) == pytest.approx(
            rp.estimate_bias_aware(ra, rb), rel=1e-5)
    assert tp.head_tail_variance_bound(fa, fb, 96, h, variant=variant,
                                       method=kind) == pytest.approx(
        rp.head_tail_variance_bound(fa, fb, 96, h, variant=variant,
                                    method=kind), rel=1e-12)


def test_bias_aware_exact_when_sketch_keeps_everything():
    rng = np.random.default_rng(6)
    a, b = _small_pair(rng, n=150, nnz=40)
    true = float(a.astype(np.float64) @ b.astype(np.float64))
    for h in (0, 1, 7, 40):
        sa = tp.bias_aware_sketch(a, 64, 3, h=h, device=CPU)
        sb = tp.bias_aware_sketch(b, 64, 3, h=h, device=CPU)
        assert tp.estimate_bias_aware(sa, sb) == pytest.approx(true,
                                                               rel=1e-4)
    with pytest.raises(ValueError):
        tp.bias_aware_sketch(a, 8, 1, h=8, device=CPU)
    with pytest.raises(ValueError):
        tp.bias_aware_sketch(a, 8, 1, h=2, kind="bogus", device=CPU)
    sa = tp.bias_aware_sketch(a, 8, 1, h=2, variant="l2", device=CPU)
    sb = tp.bias_aware_sketch(a, 8, 1, h=2, variant="uniform", device=CPU)
    with pytest.raises(ValueError):
        tp.estimate_bias_aware(sa, sb)


@pytest.mark.parametrize("m,reps", [(256, 3), (400, 3), (144, 1)])
def test_bias_aware_cs_matches_reference(m, reps):
    """Tables within the CountSketch tolerance (both branches: (m - h) //
    reps = 80 and 128 are the modulo and mask branches), point queries and
    the median estimate within float64 rounding of the same tables."""
    rng = np.random.default_rng(10)
    fa, fb = zipf_frequency_tables(rng, 2_000, 10_000, 10_000, overlap=0.3,
                                   z=1.5)
    for seed in (0, 3, 2**32 - 7000):
        ga = tp.bias_aware_cs_sketch(fa, m, seed, h=16, reps=reps,
                                     device=CPU)
        gb = tp.bias_aware_cs_sketch(fb, m, seed, h=16, reps=reps,
                                     device=CPU)
        ra = rp.bias_aware_cs_sketch(fa, m, seed, h=16, reps=reps)
        rb = rp.bias_aware_cs_sketch(fb, m, seed, h=16, reps=reps)
        for g, r in ((ga, ra), (gb, rb)):
            assert_bits(g.head_idx, r.head_idx)
            assert_bits(g.head_val, r.head_val)
            np.testing.assert_allclose(g.tables, r.tables, rtol=1e-5,
                                       atol=1e-5)
            assert (g.seed, g.universe) == (r.seed, r.universe)
        assert tp.estimate_bias_aware_cs(ga, gb) == pytest.approx(
            rp.estimate_bias_aware_cs(ra, rb), rel=1e-6)


def test_bias_aware_cs_fallback_reasonable():
    rng = np.random.default_rng(10)
    fa, fb = zipf_frequency_tables(rng, 2_000, 10_000, 10_000, overlap=0.3,
                                   z=1.5)
    true = float(fa.astype(np.float64) @ fb.astype(np.float64))
    ests = [tp.estimate_bias_aware_cs(
        tp.bias_aware_cs_sketch(fa, 256, s, h=16, reps=3, device=CPU),
        tp.bias_aware_cs_sketch(fb, 256, s, h=16, reps=3, device=CPU))
        for s in range(8)]
    assert abs(np.median(ests) - true) / true < 0.5
    with pytest.raises(ValueError):
        tp.bias_aware_cs_sketch(fa, 20, 0, h=16, reps=5, device=CPU)


# ---------------------------------------------------------------------------
# serve modes (the reference's serve-mode tests, mirrored)
# ---------------------------------------------------------------------------

def _mk_index(**kw):
    kw.setdefault("m", 64)
    kw.setdefault("n_buckets", 128)
    kw.setdefault("seed", 11)
    return SketchIndex(device=CPU, **kw)


def _mk_ref_index(**kw):
    kw.setdefault("m", 64)
    kw.setdefault("n_buckets", 128)
    kw.setdefault("seed", 11)
    if kw.get("dp") is not None:
        kw["dp"] = rp.DPParams(*kw["dp"])
    return JSketchIndex(**kw)


def test_serve_mode_dispatch_and_validation():
    rng = np.random.default_rng(11)
    idx = _mk_index(head_h=8)
    v = rng.normal(size=500).astype(np.float32)
    idx.add("x", v)
    q = rng.normal(size=500).astype(np.float32)
    plain = dict(idx.query(q))["x"]
    ba = dict(idx.query(q, mode="bias_aware"))["x"]
    assert np.isfinite(plain) and np.isfinite(ba)
    with pytest.raises(ValueError, match="unknown mode"):
        idx.query(q, mode="bogus")
    with pytest.raises(ValueError, match="dp=DPParams"):
        idx.query(q, mode="private")


def test_serve_bias_aware_head_h0_matches_plain():
    rng = np.random.default_rng(12)
    idx = _mk_index(head_h=0)
    v = rng.normal(size=500).astype(np.float32)
    idx.add("x", v)
    q = rng.normal(size=500).astype(np.float32)
    assert dict(idx.query(q, mode="bias_aware"))["x"] == \
        dict(idx.query(q))["x"]


def test_serve_bias_aware_unbiased_correction_when_kept():
    rng = np.random.default_rng(13)
    idx = _mk_index(m=64, head_h=8)
    v = np.zeros(500, np.float32)
    v[rng.choice(500, 30, replace=False)] = rng.normal(size=30)
    idx.add("x", v)
    q = np.zeros(500, np.float32)
    q[rng.choice(500, 30, replace=False)] = rng.normal(size=30)
    true = float(v.astype(np.float64) @ q.astype(np.float64))
    assert dict(idx.query(q))["x"] == pytest.approx(true, rel=1e-4)
    assert dict(idx.query(q, mode="bias_aware"))["x"] == \
        pytest.approx(true, rel=1e-4)


def test_serve_modes_match_reference_index():
    """Plain and bias-aware answers within the estimators' tolerance of
    the reference index's; private answers (same seeded ``dp_rng``) and
    the ledgers equal."""
    rng = np.random.default_rng(17)
    fa, fb = zipf_frequency_tables(rng, 2_000, 20_000, 20_000, overlap=0.3,
                                   z=2.0)
    rows = [fa, fb, (fa / fa.max()).astype(np.float32),
            rng.uniform(0, 1, 2_000).astype(np.float32)]
    params = DPParams(epsilon=4.0, clamp=1.0, p_floor=0.05)
    t = _mk_index(m=96, n_buckets=256, head_h=16, dp=params,
                  dp_rng=np.random.default_rng(3))
    r = _mk_ref_index(m=96, n_buckets=256, head_h=16, dp=params,
                      dp_rng=np.random.default_rng(3))
    for k, row in enumerate(rows[:2]):
        t.add(f"r{k}", row)
        r.add(f"r{k}", row)
    t.add_many(["r2", "r3"], np.stack(rows[2:]))
    r.add_many(["r2", "r3"], np.stack(rows[2:]))
    assert_bits(t._idx, r._idx)
    assert_bits(t._val, r._val)
    assert_bits(t._head_idx, r._head_idx)
    assert_bits(t._head_kept, r._head_kept)
    for q in (fb, rows[3]):
        for mode in ("plain", "bias_aware"):
            got = np.array([e for _, e in t.query(q, mode=mode)])
            ref = np.array([e for _, e in r.query(q, mode=mode)])
            np.testing.assert_allclose(got, ref, rtol=2e-5,
                                       atol=2e-5 * np.abs(ref).max())
        got = np.array([e for _, e in t.query(q, mode="private")])
        ref = np.array([e for _, e in r.query(q, mode="private")])
        np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert_bits(t._private_release.idx, r._private_release.idx)
    assert_bits(t._private_release.z, r._private_release.z)
    assert _ledger(t.accountant) == _ledger(r.accountant)


def test_serve_private_accounting_lifecycle():
    rng = np.random.default_rng(14)
    idx = _mk_index(head_h=0, dp=DPParams(epsilon=1.0), privacy_budget=2.5)
    v = rng.uniform(0, 1, 500).astype(np.float32)
    idx.add("x", v)
    idx.add("y", rng.uniform(0, 1, 500).astype(np.float32))
    q = rng.normal(size=500).astype(np.float32)
    est = dict(idx.query(q, mode="private"))
    assert set(est) == {"x", "y"}
    assert idx.accountant.spent_epsilon == pytest.approx(1.0)
    idx.query(q, mode="private")   # cached release: free
    idx.query(rng.normal(size=500).astype(np.float32), mode="private")
    assert idx.accountant.spent_epsilon == pytest.approx(1.0)
    idx.add("z", rng.uniform(0, 1, 500).astype(np.float32))
    idx.query(q, mode="private")   # the corpus changed: a new release
    assert idx.accountant.spent_epsilon == pytest.approx(2.0)
    idx.add("w", rng.uniform(0, 1, 500).astype(np.float32))
    with pytest.raises(PrivacyBudgetExceeded):
        idx.query(q, mode="private")
    assert idx._private_release is None   # refused before any release
    assert idx.accountant.spent_epsilon == pytest.approx(2.0)
    assert len(idx.query(q)) == 4


def test_serve_budget_refuses_first_release():
    idx = _mk_index(head_h=0, dp=DPParams(epsilon=1.0), privacy_budget=0.5)
    idx.add("x", np.ones(100, np.float32))
    with pytest.raises(PrivacyBudgetExceeded):
        idx.query(np.ones(100, np.float32), mode="private")
    assert idx._private_release is None and idx.accountant.ledger == ()


def test_serve_release_invalidated_by_every_mutation():
    rng = np.random.default_rng(18)
    params = DPParams(epsilon=1.0)
    idx = _mk_index(head_h=2, dp=params)
    peer = _mk_index(head_h=2, dp=params)
    for k in range(3):
        v = rng.uniform(0, 1, 300).astype(np.float32)
        idx.add(f"x{k}", v)
        peer.add(f"x{k}", v)
    q = rng.normal(size=300).astype(np.float32)
    spent = 0.0
    for mutate in (lambda: idx.add("y", np.ones(300, np.float32)),
                   lambda: idx.add_many(["z"], np.ones((1, 300), np.float32)),
                   lambda: idx._rollback_last(2)):
        idx.query(q, mode="private")
        spent += 1.0
        assert idx._private_release is not None
        mutate()
        assert idx._private_release is None
    idx.query(q, mode="private")
    spent += 1.0
    idx.merge_from(peer)
    assert idx._private_release is None
    assert idx.accountant.spent_epsilon == pytest.approx(spent)


def test_serve_release_randomness_not_derived_from_public_seed():
    rng = np.random.default_rng(22)
    v = rng.uniform(0, 1, 300).astype(np.float32)
    q = rng.normal(size=300).astype(np.float32)

    def release_of(dp_rng=None):
        idx = _mk_index(head_h=0, dp=DPParams(epsilon=1.0), dp_rng=dp_rng)
        idx.add("x", v)
        idx.query(q, mode="private")
        return idx._private_release

    ra, rb = release_of(), release_of()
    assert not np.array_equal(ra.z, rb.z)
    rc_, rd = release_of(np.random.default_rng(99)), \
        release_of(np.random.default_rng(99))
    assert_bits(rc_.z, rd.z)
    assert_bits(rc_.idx, rd.idx)


def test_serve_merge_from_composes_accountants_and_heads():
    rng = np.random.default_rng(15)
    n = 400
    full = rng.normal(size=n).astype(np.float32)
    full[:4] *= 50
    lo, hi = full.copy(), full.copy()
    lo[n // 2:] = 0
    hi[: n // 2] = 0
    params = DPParams(epsilon=1.0)
    ia = _mk_index(head_h=4, dp=params)
    ib = _mk_index(head_h=4, dp=params)
    ia.add("x", lo)
    ib.add("x", hi)
    q = rng.normal(size=n).astype(np.float32)
    ib.query(q, mode="private")
    assert ib.accountant.spent_epsilon == pytest.approx(1.0)
    ia.merge_from(ib)
    assert ia.accountant.spent_epsilon == pytest.approx(1.0)
    got = set(ia._head_idx[0][ia._head_idx[0] >= 0].tolist())
    want = set(np.argsort(-(full.astype(np.float64) ** 2))[:4].tolist())
    assert got == want
    assert np.isfinite(dict(ia.query(q, mode="bias_aware"))["x"])


def test_serve_merge_from_strict_accountant_mutates_nothing():
    rng = np.random.default_rng(19)
    params = DPParams(epsilon=1.0)
    ia = _mk_index(head_h=2, dp=params, privacy_budget=1.5)
    ib = _mk_index(head_h=2, dp=params)
    v = rng.uniform(0, 1, 300).astype(np.float32)
    ia.add("x", v)
    ib.add("x", v[::-1].copy())
    q = rng.normal(size=300).astype(np.float32)
    ia.query(q, mode="private")
    ib.query(q, mode="private")
    before = {k: getattr(ia, k).copy() for k in ("_idx", "_val", "_tau",
                                                  "_head_idx")}
    with pytest.raises(PrivacyBudgetExceeded):
        ia.merge_from(ib)   # 1.0 + 1.0 > 1.5
    for k, arr in before.items():
        assert_bits(getattr(ia, k), arr)
    assert ia.accountant.spent_epsilon == pytest.approx(1.0)
    assert ia._private_release is not None


def test_serve_rollback_clears_head_state():
    rng = np.random.default_rng(16)
    idx = _mk_index(head_h=4)
    idx.add("x", rng.normal(size=300).astype(np.float32))
    idx.add("y", rng.normal(size=300).astype(np.float32))
    idx._rollback_last(1)
    assert len(idx) == 1
    assert np.all(idx._head_idx[1] == -1)
    assert not idx._head_kept[1].any()


def test_index_from_arrays_carries_private_state():
    """A reference index with a spent ledger carried into the port: the
    ledger, budget and DP parameters come across, and the next release
    (same seeded rng) and its answers are the reference's."""
    rng = np.random.default_rng(20)
    params = DPParams(epsilon=1.0, clamp=1.0, p_floor=0.05)
    r = _mk_ref_index(head_h=4, dp=params, privacy_budget=2.5,
                      dp_rng=np.random.default_rng(4))
    rows = rng.uniform(0, 1, (3, 400)).astype(np.float32)
    r.add_many(["a", "b", "c"], rows)
    q = rng.normal(size=400).astype(np.float32)
    r.query(q, mode="private")
    r.add("d", rng.uniform(0, 1, 400).astype(np.float32))
    t = index_from_arrays(
        idx=r._idx, val=r._val, tau=r._tau, dropped=r._dropped, g=r._g,
        kn=r._kn, head_idx=r._head_idx, head_val=r._head_val,
        head_kept=r._head_kept, names=r._names, dim=r._dim, m=r.m,
        n_buckets=r.n_buckets, slots=r.slots, seed=r.seed, dp=params,
        privacy_budget=2.5, ledger=_ledger(r.accountant),
        dp_rng=np.random.default_rng(8), device=CPU)
    r._dp_rng = np.random.default_rng(8)
    assert _ledger(t.accountant) == _ledger(r.accountant)
    assert t.accountant.epsilon_budget == r.accountant.epsilon_budget
    got = np.array([e for _, e in t.query(q, mode="private")])
    ref = np.array([e for _, e in r.query(q, mode="private")])
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert _ledger(t.accountant) == _ledger(r.accountant)
    with pytest.raises(PrivacyBudgetExceeded):
        index_from_arrays(
            idx=r._idx, val=r._val, tau=r._tau, dropped=r._dropped, g=r._g,
            kn=r._kn, head_idx=r._head_idx, head_val=r._head_val,
            head_kept=r._head_kept, names=r._names, dim=r._dim, m=r.m,
            n_buckets=r.n_buckets, slots=r.slots, seed=r.seed, dp=params,
            privacy_budget=1.5, ledger=_ledger(r.accountant), device=CPU)


# ---------------------------------------------------------------------------
# the quickstart's CountSketch line
# ---------------------------------------------------------------------------

def test_quickstart_countsketch_line_matches_example():
    """The port's quickstart prints the example's CountSketch baseline:
    the same tables (CountSketch tolerance) and estimate."""
    from repro_torch import quickstart
    a, b = quickstart.make_vectors()
    m, seed = quickstart.M, quickstart.SEED
    ref = float(rc.countsketch_estimate(
        rc.countsketch(jnp.asarray(a), int(m * 1.5), seed),
        rc.countsketch(jnp.asarray(b), int(m * 1.5), seed)))
    out = quickstart.main(device=CPU)
    assert math.isclose(out["countsketch"], ref, rel_tol=1e-5)
    np.testing.assert_allclose(
        to_np(tc.countsketch(torch.as_tensor(a), int(m * 1.5), seed)),
        np.asarray(rc.countsketch(jnp.asarray(a), int(m * 1.5), seed)),
        rtol=1e-5, atol=1e-5)


def test_serve_modes_set_their_gauges():
    """With observability on, the bias-aware query sets the head-fraction
    gauge and the private query the spent-epsilon gauge (as the
    reference's ``repro.obs`` gauges)."""
    from repro_torch import obs
    rng = np.random.default_rng(23)
    idx = _mk_index(head_h=4, dp=DPParams(epsilon=1.5))
    idx.add("x", rng.normal(size=300).astype(np.float32))
    q = rng.normal(size=300).astype(np.float32)
    obs.reset()
    obs.enable()
    try:
        idx.query(q, mode="bias_aware")
        idx.query(q, mode="private")
        snap = obs.snapshot()
    finally:
        obs.disable()
        obs.reset()
    assert 0.0 <= snap[("repro_biasaware_head_fraction", "")] <= 1.0
    assert snap[("repro_dp_epsilon_spent", "")] == 1.5
    assert obs.gauge("repro_dp_epsilon_spent") is obs.NOOP_GAUGE
