"""Port parity for the slice as a whole: ``repro_torch.serve.SketchIndex``
against ``repro.serve.SketchIndex`` on the same ingest sequence, the state
conversion, the error paths of ``tests/test_serve.py`` mirrored, and the
Algorithm 2 estimator."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_common import (assert_bits, assert_close,
                           sparse_block, to_np)

from repro.core import estimate_inner_product as j_estimate
from repro.core import intersection_size as j_intersection
from repro.core import priority_sketch as j_priority
from repro.serve import SketchIndex as JIndex
from repro_torch import obs
from repro_torch.core import estimate_inner_product, intersection_size
from repro_torch.core import priority_sketch
from repro_torch.serve import SketchIndex, index_from_arrays

CFG = dict(m=64, n_buckets=128, slots=4, initial_capacity=8)
STATE = ("_idx", "_val", "_tau", "_dropped", "_g", "_kn", "_head_idx",
         "_head_val", "_head_kept")


def _ingest(index, vecs):
    """add_many of 30 rows (growth past 8), one dense add, one sparse add,
    a rollback of the sparse add and a second sparse add: D = 40."""
    index.add_many([f"v{d}" for d in range(30)], vecs[:30])
    for d in range(30, 38):
        index.add(f"v{d}", vecs[d])
    nz = np.flatnonzero(vecs[38])
    index.add("v38", indices=nz, values=vecs[38][nz])
    index._rollback_last(1)
    index.add("v38", indices=nz, values=vecs[38][nz])
    nz = np.flatnonzero(vecs[39])
    index.add("v39", indices=nz, values=vecs[39][nz])


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(40)
    vecs = sparse_block(rng, 40, 3000, 300)
    j = JIndex(**CFG)
    t = SketchIndex(**CFG, device="cpu")
    _ingest(j, vecs)
    _ingest(t, vecs)
    return j, t, vecs, rng


def test_index_host_blocks_bit_equal(pair):
    j, t, _, _ = pair
    assert len(t) == len(j) == 40
    assert t.capacity == j.capacity == 64
    assert t._names == j._names
    for name in STATE:
        assert_bits(getattr(t, name), getattr(j, name))
    assert t.total_dropped == j.total_dropped
    assert t.summary_epoch == j.summary_epoch
    assert_bits(np.stack(t.row_summaries()), np.stack(j.row_summaries()))


def test_index_query_and_all_pairs_match(pair):
    j, t, vecs, rng = pair
    for k in (3, 17, 39):
        q = vecs[k] + 0.05 * rng.standard_normal(3000).astype(np.float32) \
            * (vecs[k] != 0)
        top_t, top_j = t.query(q, top_k=5), j.query(q, top_k=5)
        assert [n for n, _ in top_t] == [n for n, _ in top_j]
        assert top_t[0][0] == f"v{k}"
        est_t = np.array([e for _, e in t.query(q)])
        est_j = np.array([e for _, e in j.query(q)])
        assert_close(est_t, est_j)
    ap_t, ap_j = t.all_pairs(), j.all_pairs()
    assert ap_t.shape == (40, 40)
    assert_close(ap_t, ap_j)
    assert_close(t.all_pairs(use_kernel=False), ap_j)


def test_index_from_arrays_answers_identically(pair):
    j, t, vecs, _ = pair
    c = index_from_arrays(
        **{name.lstrip("_"): np.asarray(getattr(j, name)) for name in STATE},
        names=list(j._names), dim=j._dim, m=j.m, n_buckets=j.n_buckets,
        slots=j.slots, seed=j.seed, device="cpu")
    for name in STATE:
        assert_bits(getattr(c, name), getattr(t, name))
    assert c.capacity == t.capacity and c._dim == t._dim
    q = vecs[11]
    assert c.query(q) == t.query(q)
    assert_bits(c.all_pairs(), t.all_pairs())
    # the converted index keeps ingesting like a port-built one
    c.add("extra", vecs[0] * 2)
    t2 = SketchIndex(**CFG, device="cpu")
    t2.add("extra", vecs[0] * 2)
    assert_bits(c._idx[40], t2._idx[0])
    with pytest.raises(ValueError, match="unique"):
        index_from_arrays(**{name.lstrip("_"): np.asarray(getattr(j, name))
                             for name in STATE},
                          names=["a"] * 40, dim=j._dim, m=j.m,
                          n_buckets=j.n_buckets, slots=j.slots, seed=j.seed,
                          device="cpu")


def test_index_add_many_matches_sequential_add():
    rng = np.random.default_rng(6)
    vecs = sparse_block(rng, 10, 4000, 250)
    seq = SketchIndex(m=64, n_buckets=128, slots=4, initial_capacity=4,
                      device="cpu")
    for d, v in enumerate(vecs):
        seq.add(f"v{d}", v)
    bat = SketchIndex(m=64, n_buckets=128, slots=4, initial_capacity=4,
                      device="cpu")
    bat.add_many([f"v{d}" for d in range(10)], vecs)
    assert bat.capacity == seq.capacity == 16
    for name in STATE:
        assert_bits(getattr(bat, name)[:10], getattr(seq, name)[:10])


def test_index_corpus_shape_stable_between_growth():
    rng = np.random.default_rng(4)
    vecs = sparse_block(rng, 7, 4000, 200)
    idx = SketchIndex(m=64, n_buckets=128, slots=4, initial_capacity=8,
                      device="cpu")
    shapes = set()
    for d, v in enumerate(vecs):
        idx.add(f"v{d}", v)
        shapes.add(tuple(idx._corpus().idx.shape))
    assert shapes == {(8, 128, 4)}
    est = dict(idx.query(vecs[2]))
    assert max(est, key=est.get) == "v2"


# ------------------------------------------------ error paths (test_serve.py)


def test_index_add_rejects_ambiguous_input():
    idx = SketchIndex(m=16, n_buckets=64, slots=2, device="cpu")
    v = np.ones(32, np.float32)
    with pytest.raises(ValueError):
        idx.add("both", v, indices=np.arange(3), values=v[:3])
    with pytest.raises(ValueError):
        idx.add("neither")
    with pytest.raises(ValueError):
        idx.add("half", indices=np.arange(3))


def test_index_rejects_duplicate_names():
    rng = np.random.default_rng(8)
    idx = SketchIndex(m=16, n_buckets=64, slots=2, device="cpu")
    idx.add("a", rng.normal(size=64).astype(np.float32))
    with pytest.raises(ValueError, match="duplicate name 'a'"):
        idx.add("a", rng.normal(size=64).astype(np.float32))
    with pytest.raises(ValueError, match="duplicate"):
        idx.add_many(["b", "a"], rng.normal(size=(2, 64)).astype(np.float32))
    with pytest.raises(ValueError, match="within the batch"):
        idx.add_many(["c", "c"], rng.normal(size=(2, 64)).astype(np.float32))
    assert len(idx) == 1


def test_index_query_error_paths():
    rng = np.random.default_rng(9)
    idx = SketchIndex(m=16, n_buckets=64, slots=2, device="cpu")
    with pytest.raises(ValueError, match="empty index"):
        idx.query(np.ones(64, np.float32))
    idx.add("a", rng.normal(size=64).astype(np.float32))
    with pytest.raises(ValueError, match="coordinates"):
        idx.query(np.ones(32, np.float32))
    with pytest.raises(ValueError, match="1-D"):
        idx.query(np.ones((2, 64), np.float32))
    with pytest.raises(ValueError, match="unknown mode"):
        idx.query(np.ones(64, np.float32), mode="fast")
    # the bias-aware mode answers; the private mode needs dp=DPParams
    assert np.isfinite(idx.query(np.ones(64, np.float32),
                                 mode="bias_aware")[0][1])
    with pytest.raises(ValueError, match="dp=DPParams"):
        idx.query(np.ones(64, np.float32), mode="private")
    with pytest.raises(ValueError, match="coordinates"):
        idx.add_many(["z"], np.ones((1, 32), np.float32))
    with pytest.raises(ValueError, match="len"):
        idx.add_many(["y", "z"], np.ones((1, 64), np.float32))


def test_index_rejects_nonfinite_input():
    rng = np.random.default_rng(10)
    idx = SketchIndex(m=16, n_buckets=64, slots=2, device="cpu")
    v = rng.normal(size=64).astype(np.float32)
    v[5] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        idx.add("bad", v)
    assert len(idx) == 0
    clean = v.copy()
    clean[5] = 0.0
    lax = SketchIndex(m=16, n_buckets=64, slots=2, nonfinite="sanitize",
                      device="cpu")
    lax.add("ok", v)
    ref = SketchIndex(m=16, n_buckets=64, slots=2, device="cpu")
    ref.add("ok", clean)
    assert_bits(lax._idx[:1], ref._idx[:1])
    idx.add("good", clean)
    q = clean.copy()
    q[3] = np.inf
    with pytest.raises(ValueError, match="non-finite"):
        idx.query(q)
    with pytest.raises(ValueError):
        SketchIndex(nonfinite="ignore", device="cpu")
    with pytest.raises(ValueError, match="head_h"):
        SketchIndex(head_h=-1, device="cpu")


def test_index_sparse_validation():
    idx = SketchIndex(m=16, n_buckets=64, slots=2, device="cpu")
    idx.add("a", np.ones(64, np.float32))
    with pytest.raises(ValueError, match="ascending"):
        idx.add("b", indices=np.array([3, 2]), values=np.ones(2))
    with pytest.raises(ValueError, match="non-negative"):
        idx.add("b", indices=np.array([-1, 2]), values=np.ones(2))
    with pytest.raises(ValueError, match="out of range"):
        idx.add("b", indices=np.array([1, 64]), values=np.ones(2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SketchIndex()


def test_obs_counts_ops_and_rejects():
    obs.reset()
    obs.enable()
    try:
        idx = SketchIndex(m=16, n_buckets=64, slots=2, device="cpu")
        idx.add("a", np.ones(64, np.float32))
        idx.query(np.ones(64, np.float32))
        with pytest.raises(ValueError):
            idx.add("a", np.ones(64, np.float32))
        snap = obs.snapshot()
        spans = [name for name, *_ in obs.spans()]
    finally:
        obs.disable()
        obs.reset()
    assert snap[("repro_op_total", "serve.index.add")] == 1
    assert snap[("repro_op_total", "serve.index.query")] == 1
    assert snap[("repro_kernel_launches_total",
                 "intersect_estimate.query")] == 1
    assert snap[("repro_validation_rejects_total", "duplicate_name")] == 1
    assert spans == ["serve.index.add", "serve.index.query"]
    assert obs.snapshot() == {}          # disabled and reset: nothing kept


# ------------------------------------------------------------- the estimator


@pytest.mark.parametrize("variant", ["l2", "l1", "uniform"])
def test_estimate_inner_product_matches_reference(variant):
    rng = np.random.default_rng(2)
    a, b = sparse_block(rng, 2, 5000, 1500)
    b[: 2500] = a[: 2500] * 0.5
    sa_j, sb_j = (j_priority(jnp.asarray(x), 200, 42, variant=variant)
                  for x in (a, b))
    sa_t, sb_t = (priority_sketch(torch.as_tensor(x), 200, 42,
                                  variant=variant) for x in (a, b))
    assert_close(estimate_inner_product(sa_t, sb_t, variant=variant),
                 j_estimate(sa_j, sb_j, variant=variant))
    assert int(intersection_size(sa_t, sb_t)) == \
        int(j_intersection(sa_j, sb_j))
