"""Port parity: the paper's synthetic data generators
(``repro_torch.data.synthetic``, numpy copies) against
``repro.data.synthetic``: the same arrays, bit for bit, from
``np.random.default_rng`` generators of the same seed, and the same
state of the generator after the draw."""
import numpy as np
import pytest

from repro.data import synthetic as js
from repro_torch.data import synthetic as ts
from repro_torch.data import tfidf_documents


def _both(fn_name, seed, **kw):
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    got = getattr(ts, fn_name)(ra, **kw)
    want = getattr(js, fn_name)(rb, **kw)
    # the generators were drawn from alike
    assert ra.integers(1 << 62) == rb.integers(1 << 62)
    return got, want


@pytest.mark.parametrize("seed,kw", [
    (0, dict(n_docs=20, vocab=2000)),
    (1, dict(n_docs=20, vocab=2000, doc_len_range=(5, 40), zipf_z=2.0)),
    (2, dict(n_docs=3, vocab=50)),
])
def test_tfidf_documents_bit_equal(seed, kw):
    got, want = _both("tfidf_documents", seed, **kw)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (kw["n_docs"], kw["vocab"])
    np.testing.assert_array_equal(got, want)
    # unit rows
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def test_tfidf_documents_exported():
    assert tfidf_documents is ts.tfidf_documents


@pytest.mark.parametrize("fn_name,kw", [
    ("vector_pair", dict(n=5000, nnz=800)),
    ("vector_pair", dict(n=5000, nnz=800, binary=True)),
    ("correlated_pair", dict(n=5000, nnz=800, rho=0.3)),
    ("zipf_frequency_tables", dict(n_keys=3000, rows_a=10000,
                                   rows_b=8000)),
])
def test_generators_bit_equal(fn_name, kw):
    got, want = _both(fn_name, 7, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
