"""Port parity: the table store (``repro_torch.data``) and its state
conversion (``serve.table_store_from_arrays``).

The same columns go into ``repro.data.SketchedTableStore`` (JAX on the
CPU) and the port's store (``device="cpu"``).  Contract: column vectors
bit for bit; ``top_correlated`` with the reference's names in the
reference's order and scores within 1e-5; ``join_size`` and
``inner_product`` within the estimator tolerance."""
import numpy as np
import pytest
import torch

from _torch_common import RTOL, assert_bits
from _torch_common import release_jax_executables  # noqa: F401

from repro.data import SketchedTableStore as JStore
from repro.data import column_to_vector as j_column_to_vector
from repro_torch.core import estimate_join_correlation
from repro_torch.data import SketchedTableStore, column_to_vector
from repro_torch.serve import table_store_from_arrays


def _discovery_columns():
    """``examples/join_correlation_discovery.py``'s six columns (rng 1)."""
    rng = np.random.default_rng(1)
    q_keys = rng.choice(200_000, 5000, replace=False)
    q_vals = rng.normal(100, 25, len(q_keys))
    cols = [("taxi_trips", q_keys, q_vals)]
    targets = {"temperature": 0.75, "precipitation": -0.55, "pressure": 0.05,
               "wind": -0.2, "humidity": 0.4}
    for name, rho in targets.items():
        shared = rng.choice(q_keys, 3000, replace=False)
        own = rng.choice(200_000, 2000, replace=False)
        keys = np.concatenate([shared, own])
        order = np.argsort(q_keys)
        base = q_vals[order][np.searchsorted(q_keys[order], shared)]
        z = rng.standard_normal(len(keys))
        vals = np.concatenate([rho * (base - 100) / 25, np.zeros(2000)]) + \
            np.sqrt(max(1 - rho ** 2, 0)) * z
        cols.append((name, keys, vals))
    return dict(universe=1 << 18, m=512), "taxi_trips", cols


def _workflow_columns():
    """``tests/test_data_pipeline.py::test_table_store_workflow``'s."""
    rng = np.random.default_rng(0)
    base_keys = rng.choice(100000, 3000, replace=False)
    base_vals = rng.normal(10, 3, len(base_keys))
    cols = [("query", base_keys, base_vals)]
    for i, rho in enumerate([-0.7, 0.1, 0.9]):
        shared = base_keys[:2000]
        z = rng.standard_normal(len(shared))
        vals = rho * (base_vals[:2000] - 10) / 3 + np.sqrt(1 - rho ** 2) * z
        cols.append((f"col{i}", shared, vals))
    return dict(universe=1 << 16, m=256), "query", cols


DATASETS = {"discovery_example": _discovery_columns,
            "workflow": _workflow_columns}


@pytest.fixture(scope="module", params=sorted(DATASETS))
def stores(request):
    kw, query, cols = DATASETS[request.param]()
    ours, theirs = SketchedTableStore(**kw, device="cpu"), JStore(**kw)
    for name, keys, vals in cols:
        ours.add_column(name, keys, vals)
        theirs.add_column(name, keys, vals)
    return ours, theirs, query


@pytest.mark.parametrize("aggregate", ["sum", "count"])
def test_column_to_vector_bit_equal(aggregate):
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 50_000, 4000)          # repeated keys included
    vals = rng.normal(0, 3, 4000)
    assert_bits(column_to_vector(keys, vals, 1 << 14, aggregate=aggregate),
                j_column_to_vector(keys, vals, 1 << 14, aggregate=aggregate))
    with pytest.raises(ValueError):
        column_to_vector(keys, vals, 1 << 14, aggregate="mean")


def test_top_correlated_matches_reference(stores):
    ours, theirs, query = stores
    assert ours.columns() == theirs.columns()
    got, want = ours.top_correlated(query, k=5), theirs.top_correlated(query,
                                                                      k=5)
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=1e-5)
    # each batched score is the per-pair estimate
    for name, score in got:
        assert abs(score - ours.join_correlation(query, name)) <= 1e-5


def test_join_size_and_inner_product(stores):
    ours, theirs, query = stores
    for other in ours.columns():
        for fn in ("join_size", "inner_product", "join_correlation"):
            want = getattr(theirs, fn)(query, other)
            np.testing.assert_allclose(getattr(ours, fn)(query, other), want,
                                       rtol=RTOL,
                                       atol=2e-5 * max(1.0, abs(want)))


def test_table_store_from_arrays(stores):
    """The reference store's sketches, carried over as numpy arrays,
    answer as the reference store does."""
    _, theirs, query = stores
    names = theirs.columns()

    def stack(d, fields):
        return tuple(np.stack([np.asarray(getattr(d[c], f)) for c in names])
                     for f in fields)

    carried = table_store_from_arrays(
        names=names, ip=stack(theirs._ip, ("idx", "val", "tau")),
        corr=stack(theirs._corr, ("idx", "val", "tau_ones", "tau_val",
                                  "tau_sq", "scale")),
        freq=stack(theirs._freq, ("idx", "val", "tau")),
        universe=theirs.universe, m=theirs.m, seed=theirs.seed, device="cpu")
    got, want = carried.top_correlated(query), theirs.top_correlated(query)
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=1e-5)
    other = names[-1]
    np.testing.assert_allclose(carried.join_size(query, other),
                               theirs.join_size(query, other), rtol=RTOL)
    assert float(estimate_join_correlation(carried._corr[query],
                                           carried._corr[query])) > 0.99
    with pytest.raises(ValueError):
        table_store_from_arrays(
            names=[names[0]] * len(names), ip=stack(theirs._ip, ("idx", "val",
                                                                 "tau")),
            corr=(), freq=(), universe=1, m=1, seed=1, device="cpu")


def test_store_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SketchedTableStore(universe=1 << 10, m=8)
