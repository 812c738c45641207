"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches must
see the real single CPU device; only launch/dryrun.py forces 512 devices."""
import zlib

import numpy as np
import pytest

from _datagen import make_pair  # noqa: F401  (re-export for fixtures below)


@pytest.fixture
def rng(request):
    """Per-test deterministic RNG, seeded from the test's node id: data is
    stable across runs and test orderings without hand-picked seed
    constants, and two tests never share a stream by accident."""
    return np.random.default_rng(zlib.crc32(request.node.nodeid.encode()))


@pytest.fixture(scope="session")
def vector_pair():
    rng = np.random.default_rng(42)
    return make_pair(rng)


@pytest.fixture(scope="session")
def small_pair():
    rng = np.random.default_rng(7)
    return make_pair(rng, n=2000, nnz=400, overlap=0.3)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped with a reason when "
        "torch.cuda.is_available() is false")
