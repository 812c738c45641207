"""The port's matrix-product sketching against the live reference (JAX on
the CPU): the row weight, the builders, the estimators, the merge and the
partitioned build, the Frobenius helpers and ``MatrixSketchStore``.

Same numpy-made inputs through ``repro`` and ``repro_torch``
(``device="cpu"``).  Builds are held bit for bit (ids, rows, priority
tau); the adaptive threshold tau and every estimate within the float32
summation tolerance of ``_torch_common``."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from _torch_common import assert_bits, assert_close, edge_values, to_np
from _torch_common import release_jax_executables  # noqa: F401

from repro.core.merge import PartitionStats as JStats
from repro.distributed import partitioned_matrix_sketch as j_partitioned
from repro.engine import payload_weight as j_payload_weight
import repro.matrix as jm
from repro.serve import MatrixSketchStore as JStore

from repro_torch.core.merge import PartitionStats
from repro_torch.distributed import partitioned_matrix_sketch
from repro_torch.engine import estimate_product, payload_weight
from repro_torch.engine.containers import PayloadSketch
import repro_torch.matrix as tm
from repro_torch.serve import MatrixSketchStore, store_from_arrays

INVALID = np.iinfo(np.int32).max
# matrix-store estimates sum up to m matched rank-one terms in another order
TAU_RTOL = 1e-5


def make_matrix_pair(rng, n=2048, d=8, overlap=0.3):
    """Row-partial-overlap pair with lognormal row scales: A on a prefix,
    B on a suffix of the rows (``benchmarks/matrix_product.py::_pair``)."""
    A = rng.standard_normal((n, d)).astype(np.float32)
    B = rng.standard_normal((n, d)).astype(np.float32)
    A *= rng.lognormal(0.0, 1.0, (n, 1)).astype(np.float32)
    B *= rng.lognormal(0.0, 1.0, (n, 1)).astype(np.float32)
    lead = (1.0 - overlap) / 2.0
    A[int((lead + overlap) * n):] = 0
    B[: int(lead * n)] = 0
    return A, B


def t_sketch(j) -> tm.MatrixSketch:
    return tm.MatrixSketch(*(torch.as_tensor(np.array(x)) for x in j))


def j_sketch(t) -> jm.MatrixSketch:
    return jm.MatrixSketch(*(jnp.asarray(to_np(x)) for x in t))


@pytest.fixture(scope="module")
def pair():
    return make_matrix_pair(np.random.default_rng(0))


# ------------------------------------------------------------------ weights


@pytest.mark.parametrize("variant", ["l2", "l1"])
@pytest.mark.parametrize("d", [2, 8, 16, 17, 32, 33, 64, 128])
def test_payload_weight_bit_equal(d, variant):
    """The summation order of the reference's jitted weight (the order its
    build and merge jits use): sequential with fused multiply-adds at
    d <= 32 except 5..8, windows of 32 beyond.  Random rows with
    lognormal scales and rows with the flush-to-zero traps."""
    rng = np.random.default_rng(d)
    P = (rng.standard_normal((1024, d))
         * rng.lognormal(0.0, 1.0, (1024, 1))).astype(np.float32)
    ref_fn = jax.jit(lambda x: j_payload_weight(x, variant))
    for X in (P, edge_values(rng, 256, d)):
        got = payload_weight(torch.as_tensor(X), variant)
        assert_bits(got, ref_fn(jnp.asarray(X)))
        if variant == "l2":
            assert_bits(tm.row_weight(torch.as_tensor(X), "l2"), got)


def test_row_weight_uniform_and_bad_variant():
    X = np.zeros((5, 3), np.float32)
    X[1, 2] = 2.0
    X[3, 0] = 1e-40                   # subnormal: flushed, weight 0
    assert_bits(tm.row_weight(torch.as_tensor(X), "uniform"),
                np.array([0, 1, 0, 0, 0], np.float32))
    with pytest.raises(ValueError, match="variant"):
        tm.row_weight(torch.as_tensor(X), "l1")


# ----------------------------------------------------------------- builders


def _global_unsorted(rng, n):
    """Global row ids of a partition of a taller matrix, in shuffled
    order."""
    return (10_000 + rng.permutation(n)).astype(np.int32)


@pytest.mark.parametrize("backend", ["fused", "reference"])
@pytest.mark.parametrize("d", [8, 16, 64])
def test_priority_builder_bit_equal(d, backend):
    rng = np.random.default_rng(d + 1)
    A, _ = make_matrix_pair(rng, n=1024, d=d)
    for rows in (None, _global_unsorted(rng, 1024)):
        got = tm.priority_matrix_sketch(torch.as_tensor(A), 96, 7,
                                        row_indices=rows, backend=backend)
        ref = jm.priority_matrix_sketch(
            jnp.asarray(A), 96, 7, backend=backend,
            row_indices=None if rows is None else jnp.asarray(rows))
        for g, r in zip(got, ref):
            assert_bits(g, r)


@pytest.mark.parametrize("backend", ["fused", "reference"])
@pytest.mark.parametrize("d", [8, 16, 64])
def test_threshold_builder_kept_rows_bit_equal(d, backend):
    rng = np.random.default_rng(d + 2)
    A, _ = make_matrix_pair(rng, n=1024, d=d)
    for rows in (None, _global_unsorted(rng, 1024)):
        got = tm.threshold_matrix_sketch(torch.as_tensor(A), 96, 7,
                                         row_indices=rows, backend=backend)
        ref = jm.threshold_matrix_sketch(
            jnp.asarray(A), 96, 7, backend=backend,
            row_indices=None if rows is None else jnp.asarray(rows))
        assert_bits(got.row_idx, ref.row_idx)
        assert_bits(got.rows, ref.rows)
        np.testing.assert_allclose(to_np(got.tau), np.asarray(ref.tau),
                                   rtol=TAU_RTOL)


def test_priority_tau_bits_at_d64():
    """An (8192, 64) matrix, seed 11, m = 256: the case where the port's
    earlier row weight gave a priority tau with other bits."""
    rng = np.random.default_rng(11)
    A = (rng.standard_normal((8192, 64))
         * rng.lognormal(0.0, 1.0, (8192, 1))).astype(np.float32)
    got = tm.priority_matrix_sketch(torch.as_tensor(A), 256, 11)
    ref = jm.priority_matrix_sketch(jnp.asarray(A), 256, 11)
    for g, r in zip(got, ref):
        assert_bits(g, r)


def test_builders_reject_bad_inputs_and_run_on_cpu():
    A = torch.zeros((16, 4))
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        tm.priority_matrix_sketch(torch.zeros(16), 4, 0)
    with pytest.raises(ValueError, match="backend"):
        tm.priority_matrix_sketch(A, 4, 0, backend="pallas")
    with pytest.raises(ValueError, match="variant"):
        tm.threshold_matrix_sketch(A, 4, 0, variant="l1")
    # numpy input goes to the default device: the card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.priority_matrix_sketch(np.zeros((16, 4), np.float32), 4, 0)
    sk = tm.priority_matrix_sketch(np.eye(16, 4, dtype=np.float32), 8, 0,
                                   device="cpu")
    assert sk.row_idx.device.type == "cpu" and int(sk.size()) == 4


# --------------------------------------------------------------- estimators


@pytest.mark.parametrize("method", ["priority", "threshold"])
def test_estimators_match_reference(pair, method):
    A, B = pair
    tb = getattr(tm, f"{method}_matrix_sketch")
    jb = getattr(jm, f"{method}_matrix_sketch")
    ta, tb_ = (tb(torch.as_tensor(X), 128, 3) for X in (A, B))
    ja, jb_ = (jb(jnp.asarray(X), 128, 3) for X in (A, B))
    assert_close(tm.estimate_matrix_product(ta, tb_),
                 jm.estimate_matrix_product(ja, jb_))
    assert int(tm.matrix_intersection_size(ta, tb_)) == \
        int(jm.matrix_intersection_size(ja, jb_))
    # batched pairs on the CPU: the sorted join, row by row
    SA = tm.stack_matrix_sketches([ta, tb_, ta])
    SB = tm.stack_matrix_sketches([tb_, ta, ta])
    got = tm.estimate_matrix_products(SA, SB)
    ref = jm.estimate_matrix_products(
        jm.stack_matrix_sketches([ja, jb_, ja]),
        jm.stack_matrix_sketches([jb_, ja, ja]))
    assert got.shape == (3, 8, 8)
    assert_close(got, ref)


def test_estimate_exact_when_everything_kept(pair):
    A, B = pair
    A, B = A[:100], B[:100]
    sa = tm.priority_matrix_sketch(torch.as_tensor(A), 128, 1)
    sb = tm.priority_matrix_sketch(torch.as_tensor(B), 128, 1)
    assert float(sa.tau) == np.inf
    np.testing.assert_allclose(to_np(tm.estimate_matrix_product(sa, sb)),
                               A.T @ B, rtol=1e-4, atol=1e-3)


def test_estimate_product_reductions():
    """d = 1 "sum" against the reference, the d > 1 "sum" rejection and an
    unknown reduction."""
    rng = np.random.default_rng(4)
    a, b = make_matrix_pair(rng, n=512, d=1)
    ta = tm.priority_matrix_sketch(torch.as_tensor(a), 64, 2)
    tb = tm.priority_matrix_sketch(torch.as_tensor(b), 64, 2)
    from repro.engine import estimate_product as j_estimate_product
    from repro.engine.containers import from_matrix
    ref = j_estimate_product(from_matrix(j_sketch(ta)),
                             from_matrix(j_sketch(tb)))
    pa, pb = (PayloadSketch(s.row_idx, s.rows, s.tau) for s in (ta, tb))
    assert_close(estimate_product(pa, pb), ref)
    assert estimate_product(pa, pb, reduction="matmul").shape == (1, 1)
    wide = PayloadSketch(pa.idx, pa.payload.expand(-1, 3), pa.tau)
    with pytest.raises(ValueError, match="matmul"):
        estimate_product(wide, wide, reduction="sum")
    with pytest.raises(ValueError, match="reduction"):
        estimate_product(pa, pb, reduction="dot")


# -------------------------------------------------- merge and partitioned


def _row_parts(A, P, method, m, seed):
    bounds = np.linspace(0, A.shape[0], P + 1).astype(int)
    parts_t, parts_j, stats_t, stats_j = [], [], [], []
    for s, e in zip(bounds[:-1], bounds[1:]):
        ids = np.arange(s, e, dtype=np.int32)
        tb = getattr(tm, f"{method}_matrix_sketch")
        jb = getattr(jm, f"{method}_matrix_sketch")
        parts_t.append(tb(torch.as_tensor(A[s:e]), m, seed, row_indices=ids))
        parts_j.append(jb(jnp.asarray(A[s:e]), m, seed,
                          row_indices=jnp.asarray(ids)))
        stats_t.append(tm.matrix_partition_stats(torch.as_tensor(A[s:e])))
        stats_j.append(jm.matrix_partition_stats(jnp.asarray(A[s:e])))
    st = PartitionStats(torch.stack([x.total_weight for x in stats_t]),
                        torch.stack([x.nnz for x in stats_t]))
    sj = JStats(jnp.stack([x.total_weight for x in stats_j]),
                jnp.stack([x.nnz for x in stats_j]))
    return parts_t, parts_j, st, sj


@pytest.mark.parametrize("P", [2, 3, 4])
def test_priority_merge_bit_exact(pair, P):
    A, _ = pair
    parts_t, parts_j, _, _ = _row_parts(A, P, "priority", 64, 9)
    got = tm.merge_matrix_sketches(parts_t, 9, m=64)
    one_shot = tm.priority_matrix_sketch(torch.as_tensor(A), 64, 9)
    ref = jm.merge_matrix_sketches(parts_j, 9, m=64)
    for g, o, r in zip(got, one_shot, ref):
        assert_bits(g, o)
        assert_bits(g, r)


@pytest.mark.parametrize("P", [2, 3, 4])
def test_threshold_merge_kept_set_exact(pair, P):
    A, _ = pair
    parts_t, parts_j, st, sj = _row_parts(A, P, "threshold", 64, 9)
    got = tm.merge_matrix_sketches(parts_t, 9, m=64, method="threshold",
                                   stats=st)
    one_shot = tm.threshold_matrix_sketch(torch.as_tensor(A), 64, 9)
    ref = jm.merge_matrix_sketches(parts_j, 9, m=64, method="threshold",
                                   stats=sj)
    for other in (one_shot, ref):
        assert_bits(got.row_idx, other.row_idx)
        assert_bits(got.rows, other.rows)
        np.testing.assert_allclose(to_np(got.tau), to_np(other.tau),
                                   rtol=TAU_RTOL)
    # the matrix stats against the reference's
    assert_close(st.total_weight, sj.total_weight)
    assert_bits(st.nnz, sj.nnz)


def test_merge_errors(pair):
    A, _ = pair
    parts_t, _, _, _ = _row_parts(A, 2, "threshold", 32, 9)
    with pytest.raises(ValueError, match="PartitionStats"):
        tm.merge_matrix_sketches(parts_t, 9, m=32, method="threshold")
    with pytest.raises(ValueError, match="method"):
        tm.merge_matrix_sketches(parts_t, 9, m=32, method="union")
    # the same rows twice, promised disjoint: the output check raises
    sk = tm.priority_matrix_sketch(torch.as_tensor(A), 32, 9)
    with pytest.raises(ValueError, match="duplicate id"):
        tm.merge_matrix_sketches([sk, sk], 9, m=32, dedupe=False)
    # and with the duplicate scan the union is the sketch itself
    for g, r in zip(tm.merge_matrix_sketches([sk, sk], 9, m=32), sk):
        assert_bits(g, r)


@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("method", ["priority", "threshold"])
def test_partitioned_matrix_sketch(pair, P, method):
    A, _ = pair
    got = partitioned_matrix_sketch(torch.as_tensor(A), 64, 5,
                                    num_partitions=P, method=method)
    one_shot = getattr(tm, f"{method}_matrix_sketch")(torch.as_tensor(A),
                                                      64, 5)
    ref = j_partitioned(jnp.asarray(A), 64, 5, num_partitions=P,
                        method=method)
    for other in (one_shot, ref):
        assert_bits(got.row_idx, other.row_idx)
        assert_bits(got.rows, other.rows)
        if method == "priority":
            assert_bits(got.tau, other.tau)
        else:
            np.testing.assert_allclose(to_np(got.tau), to_np(other.tau),
                                       rtol=TAU_RTOL)


# ------------------------------------------------------------- variance


def test_variance_helpers_match_reference(pair):
    A, B = pair
    At, Bt = torch.as_tensor(A), torch.as_tensor(B)
    Aj, Bj = jnp.asarray(A), jnp.asarray(B)
    for g, r in zip(tm.variance.intersection_frobenius(At, Bt),
                    jm.variance.intersection_frobenius(Aj, Bj)):
        np.testing.assert_allclose(to_np(g), np.asarray(r), rtol=1e-5)
    for method in ("threshold", "priority"):
        np.testing.assert_allclose(
            to_np(tm.frobenius_variance_bound(At, Bt, 64, method=method)),
            np.asarray(jm.frobenius_variance_bound(Aj, Bj, 64,
                                                   method=method)),
            rtol=1e-5)
        np.testing.assert_allclose(
            to_np(tm.frobenius_error_guarantee(At, Bt, 64, 0.2,
                                               method=method)),
            np.asarray(jm.frobenius_error_guarantee(Aj, Bj, 64, 0.2,
                                                    method=method)),
            rtol=1e-5)
    np.testing.assert_allclose(to_np(tm.jl_frobenius_error(At, Bt, 200)),
                               np.asarray(jm.jl_frobenius_error(Aj, Bj, 200)),
                               rtol=1e-5)
    assert tm.matrix_sketch_bytes(256, 16) == jm.matrix_sketch_bytes(256, 16)


def test_estimate_error_within_guarantee(pair):
    """Priority sketches at m = 256: the Frobenius error of the estimate
    within the delta = 0.1 guarantee, computed in float64."""
    A, B = pair
    sa = tm.priority_matrix_sketch(torch.as_tensor(A), 256, 5)
    sb = tm.priority_matrix_sketch(torch.as_tensor(B), 256, 5)
    err = np.linalg.norm(to_np(tm.estimate_matrix_product(sa, sb))
                         - A.astype(np.float64).T @ B)
    bound = float(tm.frobenius_error_guarantee(
        torch.as_tensor(A, dtype=torch.float64),
        torch.as_tensor(B, dtype=torch.float64), 256, 0.1,
        method="priority"))
    assert err <= bound


# ------------------------------------------------------------------ store


def _stores(m=32, dim=4, initial_capacity=2, **kw):
    return (MatrixSketchStore(m, dim=dim, initial_capacity=initial_capacity,
                              device="cpu", **kw),
            JStore(m, dim=dim, initial_capacity=initial_capacity))


def test_store_matches_reference_with_growth():
    rng = np.random.default_rng(12)
    t, j = _stores()
    mats = [make_matrix_pair(rng, n=400, d=4)[k % 2] for k in range(7)]
    for k, X in enumerate(mats):
        t.add(f"M{k}", X)
        j.add(f"M{k}", X)
    assert len(t) == 7 and t.capacity == j.capacity == 8
    for name in ("_idx", "_rows", "_tau"):
        assert_bits(getattr(t, name), getattr(j, name))
    assert_close(t.product("M0", "M1"), j.product("M0", "M1"))
    pairs = [("M0", "M1"), ("M2", "M3"), ("M4", "M4"), ("M6", "M5")]
    got = t.products(pairs)
    assert got.shape == (4, 4, 4)
    assert_close(got, j.products(pairs))
    q = make_matrix_pair(rng, n=400, d=4)[1]
    got_q, ref_q = t.query(q), j.query(q)
    assert [n for n, _ in got_q] == [n for n, _ in ref_q] == \
        [f"M{k}" for k in range(7)]
    assert_close(np.stack([e for _, e in got_q]),
                 np.stack([e for _, e in ref_q]))


def test_store_rollback_and_round_trip():
    rng = np.random.default_rng(13)
    t, j = _stores(initial_capacity=4)
    mats = [make_matrix_pair(rng, n=300, d=4)[0] for _ in range(5)]
    for k, X in enumerate(mats):
        t.add(f"M{k}", X)
        j.add(f"M{k}", X)
    t._rollback_last(2)
    j._rollback_last(2)
    assert len(t) == 3 and "M4" not in t._name_set
    for name in ("_idx", "_rows", "_tau"):
        assert_bits(getattr(t, name), getattr(j, name))
    t.add("M3", mats[3])                  # the name is free again
    # the reference store's state carried into a port store
    j.add("M3", mats[3])
    back = store_from_arrays(idx=j._idx, rows=j._rows, tau=j._tau,
                             names=j._names, m=j.m, dim=j.dim, seed=j.seed,
                             device="cpu")
    for name in ("_idx", "_rows", "_tau"):
        assert_bits(getattr(back, name)[:4], getattr(t, name)[:4])
    q = mats[4]
    assert_close(np.stack([e for _, e in back.query(q)]),
                 np.stack([e for _, e in j.query(q)]))
    with pytest.raises(ValueError, match="unique"):
        store_from_arrays(idx=j._idx, rows=j._rows, tau=j._tau,
                          names=["a", "a", "b", "c"], m=j.m, dim=j.dim,
                          seed=j.seed, device="cpu")


def test_store_error_paths():
    t = MatrixSketchStore(16, dim=4, device="cpu")
    with pytest.raises(ValueError, match="empty store"):
        t.query(np.ones((8, 4), np.float32))
    with pytest.raises(ValueError, match=r"\(n, 4\)"):
        t.add("A", np.ones((8, 3), np.float32))
    bad = np.ones((8, 4), np.float32)
    bad[2, 1] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        t.add("A", bad)
    t.add("A", np.ones((8, 4), np.float32))
    with pytest.raises(ValueError, match="duplicate name 'A'"):
        t.add("A", np.ones((8, 4), np.float32))
    with pytest.raises(KeyError, match="unknown matrix"):
        t.product("A", "B")
    with pytest.raises(ValueError, match="dim"):
        MatrixSketchStore(16, dim=0, device="cpu")
    s = MatrixSketchStore(16, dim=4, nonfinite="sanitize", device="cpu")
    s.add("A", bad)
    assert len(s) == 1


def test_vector_adapters_are_the_references():
    """``engine.from_vector`` / ``to_vector``, the d = 1 adapters: a
    vector sketch as a payload sketch and back, field for field the
    reference's on the same sketch; a payload of d > 1 is refused."""
    from repro.core import threshold_sketch as j_threshold_sketch
    from repro.engine import from_vector as j_from_vector
    from repro.engine import to_vector as j_to_vector
    from repro_torch.core import threshold_sketch
    from repro_torch.engine import from_vector, to_vector
    a = np.random.default_rng(21).standard_normal(3000).astype(np.float32)
    sk = threshold_sketch(torch.as_tensor(a), 128, 9)
    ref = j_from_vector(j_threshold_sketch(jnp.asarray(a), 128, 9))
    ps = from_vector(sk)
    assert ps.payload.shape == sk.val.shape + (1,)
    for f in ("idx", "payload", "tau"):
        assert_bits(getattr(ps, f), getattr(ref, f))
    back, j_back = to_vector(ps), j_to_vector(ref)
    for f in ("idx", "val", "tau"):
        assert_bits(getattr(back, f), getattr(sk, f))
        assert_bits(getattr(back, f), getattr(j_back, f))
    wide = PayloadSketch(ps.idx, ps.payload.expand(-1, 2), ps.tau)
    with pytest.raises(ValueError, match="not a vector sketch"):
        to_vector(wide)
