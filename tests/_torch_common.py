"""Shared pieces of the port's tests (``tests/test_torch_*.py``).

The port's tests run the same numpy-made inputs through ``repro`` (JAX on
the CPU) and ``repro_torch`` (``device="cpu"``, the kernels' plain
versions) and compare.  Tests that need the card take the ``cuda_device``
fixture and carry the ``cuda`` marker: the fixture decides whether a card
is present when the test runs, never when the module is imported.
"""
import numpy as np
import pytest
import torch

# estimates are float32 sums over <= B*S^2 matched terms taken in another
# order than the reference's
RTOL = 2e-5


def atol_for(ref) -> float:
    return 2e-5 * max(1.0, float(np.max(np.abs(ref))) if np.size(ref) else 1.0)


def assert_close(got, ref):
    ref = to_np(ref)
    np.testing.assert_allclose(to_np(got), ref, rtol=RTOL,
                               atol=atol_for(ref))


def assert_bits(got, ref):
    """Bit-for-bit equality of two arrays (NaN/inf/-0 included)."""
    got = np.ascontiguousarray(to_np(got))
    ref = np.ascontiguousarray(to_np(ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert got.dtype.itemsize == ref.dtype.itemsize, (got.dtype, ref.dtype)
    view = {1: np.uint8, 4: np.uint32, 8: np.uint64}[got.dtype.itemsize]
    bad = np.flatnonzero(got.view(view) != ref.view(view))
    assert bad.size == 0, (f"{bad.size} of {got.size} differ; first at "
                           f"{bad[:5]}: {got.ravel()[bad[:5]]} vs "
                           f"{ref.ravel()[bad[:5]]}")


def to_np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.fixture
def cuda_device():
    """``torch.device("cuda")``, or a skip with the reason when there is
    no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def sparse_block(rng, D: int, n: int, nnz: int) -> np.ndarray:
    """(D, n) float32 rows with ``nnz`` nonzeros each, U(-1, 1)."""
    out = np.zeros((D, n), np.float32)
    for d in range(D):
        ii = rng.choice(n, nnz, replace=False)
        out[d, ii] = rng.uniform(-1, 1, nnz)
    return out


def edge_values(rng, D: int, n: int) -> np.ndarray:
    """(D, n) float32 with the flush-to-zero traps mixed in: subnormal
    squares (1e-20), subnormal inputs, huge values whose ranks are
    subnormal (1e19), overflowing squares (1e20), zeros and signed
    zeros."""
    A = rng.uniform(-1, 1, (D, n)).astype(np.float32)
    A[rng.random((D, n)) < 0.3] = 0.0
    traps = np.array([1e-20, -1e-20, 1e-40, 1.1e-19, 1e19, -1e19, 1e20,
                      3e18, -0.0, 1e-19], np.float32)
    pick = rng.random((D, n)) < 0.05
    A[pick] = rng.choice(traps, int(pick.sum()))
    return A


def selection_cases(rng) -> list:
    """(name, keys (D, n) float32, k) cases for the exact k-th smallest
    key: k = 1, k = n and a per-row k; all-+inf rows; ties across the k-th
    key; rows whose keys share one top byte (more candidates than a block
    holds on chip); zeros from flushed subnormals; n not a multiple of any
    chunk."""
    n = 3000 + 77
    mixed = np.abs(edge_values(rng, 5, n)) * np.float32(1e3)
    mixed[rng.random(mixed.shape) < 0.4] = np.inf
    mixed[mixed < np.finfo(np.float32).tiny] = 0.0
    per_row = rng.integers(1, n + 1, 5)
    inf_rows = np.full((3, 4098), np.inf, np.float32)
    inf_rows[1, :100] = rng.random(100)             # k past the finite keys
    ties = rng.choice(np.array([0.25, 0.5, 0.5000001, 3.0, np.inf],
                               np.float32), (4, 5000))
    top = (1.0 + rng.random((3, 20011))).astype(np.float32)   # all 0x3F..
    top[2, ::7] = 1.5                               # and a heavy tie
    zeros = rng.random((3, 9001)).astype(np.float32)
    zeros[:, rng.random(9001) < 0.6] = 0.0
    return [
        ("mixed_k1", mixed, 1), ("mixed_kn", mixed, n),
        ("mixed_k257", mixed, 257), ("mixed_per_row", mixed, per_row),
        ("all_inf_k1", inf_rows, 1), ("all_inf_k200", inf_rows, 200),
        ("all_inf_kn", inf_rows, 4098),
        ("ties_mid", ties, 2500), ("ties_per_row", ties,
                                   rng.integers(1, 5001, 4)),
        ("top_byte", top, 10006), ("top_byte_k1", top, 1),
        ("zeros_in", zeros, 3000), ("zeros_edge", zeros,
                                    np.array([5400, 5401, 9001])),
    ]
