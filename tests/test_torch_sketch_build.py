"""Port parity: the linear-time priority build.

The plain versions of the two build kernels are bit-equal to the Pallas
kernels (interpret mode), and the port's build — front end, k-th smallest
rank, pack — is bit-equal to ``repro.kernels.build_priority_corpus`` on
the parity grid, dense and sparse.  The CUDA kernels themselves are held
against the plain versions on the card (``cuda`` marker)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from parity._grid import VECTOR_CASES, MATRIX_CASES, make_payloads
from _torch_common import (assert_bits, edge_values, selection_cases,
                           sparse_block, to_np)

from repro.engine import build_payload_corpus as j_build_payload
from repro.kernels import build_priority_corpus as j_build
from repro.kernels import kth_smallest_ranks as j_kth
from repro.kernels.sketch_build import pack_kept as j_pack_kept
from repro.kernels.sketch_build import hash_rank_hist_pallas, rank_hist_pallas
from repro_torch.core import priority_sketch
from repro_torch.engine import build_payload_corpus
from repro_torch.kernels.hash_rank.hash_rank import takes_spread_route
from repro_torch.kernels.sketch_build import (build_priority_corpus,
                                              build_priority_corpus_ref,
                                              hash_rank_hist,
                                              hash_rank_hist_ref,
                                              kth_smallest_ranks,
                                              kth_smallest_ranks_ref,
                                              pack_kept, radix_select,
                                              rank_hist_ref)

PRIORITY_CASES = [c for c in VECTOR_CASES if c.method == "priority"]
BLOCK = 1024   # the Pallas kernels' (8, 128) tile


def _pallas_front(A: np.ndarray, seed: int, variant: str):
    """Reference B1 on the padded (D, rows, 128) layout, unpadded again
    with the same histogram correction as ``repro``'s ``_front_end``."""
    D, n = A.shape
    n_pad = -(-n // BLOCK) * BLOCK
    v = np.pad(A, ((0, 0), (0, n_pad - n))).reshape(D, n_pad // 128, 128)
    h, rank, hist = hash_rank_hist_pallas(jnp.asarray(v), jnp.asarray(seed),
                                          variant=variant, interpret=True)
    hist = np.asarray(hist).copy()
    hist[:, 0x7F] -= n_pad - n
    return (np.asarray(h).reshape(-1)[:n],
            np.asarray(rank).reshape(D, -1)[:, :n], hist)


ONE_VECTOR_N = 30000   # Fig. 10's key space: the join path's single vectors


@pytest.mark.parametrize("variant", ["l2", "l1", "uniform"])
@pytest.mark.parametrize("n", [2048, 3000 + 77, ONE_VECTOR_N])
def test_hash_rank_hist_plain_matches_pallas(variant, n):
    """A (3, n) block, and at the join path's n one vector (D = 1, the
    shape that takes the kernel's spread route on the card), with zeros
    and the flush-to-zero traps among the values."""
    rng = np.random.default_rng(n)
    A = edge_values(rng, 1 if n == ONE_VECTOR_N else 3, n)
    h_j, r_j, hist_j = _pallas_front(A, 0xB0C4, variant)
    h_t, r_t, hist_t = hash_rank_hist(torch.as_tensor(A), 0xB0C4,
                                      variant=variant)
    assert_bits(h_t, h_j)
    assert_bits(r_t, r_j)
    assert_bits(hist_t, hist_j)


@pytest.mark.parametrize("D,n,hist,spread", [
    (1, 1, True, True), (1, 30000, True, True), (1, 100000, True, True),
    (7, 65613, True, True), (3, 30001, False, True), (16, 30000, True, True),
    (263, 4096, True, True), (264, 4096, True, False),
    (264, 4096, False, False), (64, 30000, False, False),
    (512, 65536, True, False), (1, 1 << 17, True, True),
    (1, (1 << 17) + 1, True, False), (1, (1 << 17) + 1, False, True),
    (1, 2_000_000, False, False), (1, 0, True, False)])
def test_spread_route_boundary(D, n, hist, spread):
    """The one boundary between the hash/rank kernel's routes, on a card
    of 132 SMs: the spread route while the batched grid (a block per 4096
    coordinates of a row) would hold fewer than two blocks an SM, which
    takes every single vector the paths sketch (n <= 1e5); with the
    histogram (one cluster a row) only up to 2^17 coordinates a row."""
    assert takes_spread_route(D, n, 132, hist=hist) is spread


@pytest.mark.parametrize("shift", [24, 16, 8, 0])
def test_rank_hist_plain_matches_pallas(shift):
    """Every level, at the prefix the exact descent reaches (so the
    counts are nontrivial), on +inf-padded keys fed to both."""
    rng = np.random.default_rng(shift)
    A = edge_values(rng, 4, 2 * BLOCK)
    _, rank, _ = hash_rank_hist_ref(torch.as_tensor(A), 3)
    kth = to_np(kth_smallest_ranks(rank, 40))
    bits = kth.view(np.uint32).astype(np.int64)
    prefix = (bits >> (shift + 8)) if shift < 24 else np.zeros_like(bits)
    got = rank_hist_ref(rank, torch.as_tensor(prefix.astype(np.int32)),
                        shift=shift)
    ref = rank_hist_pallas(jnp.asarray(to_np(rank).reshape(4, -1, 128)),
                           jnp.asarray(prefix.astype(np.uint32)),
                           shift=shift, interpret=True)
    assert_bits(got, ref)
    assert int(to_np(got).sum()) > 0


@pytest.mark.parametrize("k", [1, 17, 257, 3000])
def test_kth_smallest_matches_kthvalue(k):
    rng = np.random.default_rng(k)
    A = edge_values(rng, 5, 3000)
    _, rank, hist0 = hash_rank_hist(torch.as_tensor(A), 11)
    want = torch.kthvalue(rank, k, dim=1).values
    assert_bits(kth_smallest_ranks(rank, k, hist0=hist0), want)
    assert_bits(kth_smallest_ranks(rank, k), want)


_SELECTION = selection_cases(np.random.default_rng(77))


@pytest.mark.parametrize("name,keys,k", _SELECTION,
                         ids=[c[0] for c in _SELECTION])
def test_kth_smallest_edge_cases(name, keys, k):
    """The selection's plain descent, through ``kth_smallest_ranks`` and
    the ``radix_select`` wrapper's CPU route, bit-equal to
    ``torch.kthvalue`` and to ``repro``'s k-th smallest on the cases the
    card test holds the kernel to (the reference's XLA descent; a per-row
    k as a tensor)."""
    keys_t = torch.as_tensor(keys)
    k_t = k if isinstance(k, int) else torch.as_tensor(k)
    want = torch.stack([torch.kthvalue(row, k if isinstance(k, int)
                                       else int(k[d])).values
                        for d, row in enumerate(keys_t)])
    got = kth_smallest_ranks(keys_t, k_t)
    assert_bits(got, want)
    assert_bits(radix_select(keys_t, k_t), want)
    assert_bits(kth_smallest_ranks(keys_t, k_t, use_kernel=False), want)
    assert_bits(got, j_kth(jnp.asarray(keys), jnp.asarray(k)))


def test_kth_smallest_ref_takes_hist0():
    """With the level-0 histogram given, the descent skips its first count
    and lands on the same bits."""
    rng = np.random.default_rng(8)
    A = edge_values(rng, 4, 5000)
    _, rank, hist0 = hash_rank_hist(torch.as_tensor(A), 9)
    for k in (1, 300, 5000):
        assert_bits(kth_smallest_ranks_ref(rank, k, hist0=hist0),
                    kth_smallest_ranks_ref(rank, k))
    with pytest.raises(ValueError, match="1 <= k <= n"):
        kth_smallest_ranks(rank, 5001)


@pytest.mark.parametrize("k", [0, -1, 5001])
def test_radix_select_rejects_k_outside_the_row(k):
    """The public select raises for an int k that names no key, as
    ``kth_smallest_ranks`` does (on the card it would return NaN)."""
    keys = torch.rand((2, 5000), generator=torch.Generator().manual_seed(3))
    with pytest.raises(ValueError, match="1 <= k <= n"):
        radix_select(keys, k)
    with pytest.raises(ValueError, match="1 <= k <= n"):
        kth_smallest_ranks(keys, k, use_kernel=False)


def test_pack_kept_matches_reference():
    rng = np.random.default_rng(5)
    keep = rng.random((4, 300)) < 0.1
    keep[2] = True                          # overflow: truncates in order
    keep[3] = False                         # nothing kept
    vals = rng.normal(size=(4, 300)).astype(np.float32)
    ind = np.sort(rng.choice(10_000, 300, replace=False)).astype(np.int32)
    for indices in (None, ind):
        got = pack_kept(torch.as_tensor(keep), torch.as_tensor(vals), 16,
                        None if indices is None else torch.as_tensor(indices))
        ref = j_pack_kept(jnp.asarray(keep), jnp.asarray(vals), 16,
                          None if indices is None else jnp.asarray(indices))
        assert_bits(got[0], ref[0])
        assert_bits(got[1], ref[1])


def _assert_sketch_bits(got, ref):
    for g, r in zip(got, ref):
        assert_bits(g, r)


@pytest.mark.parametrize("case", PRIORITY_CASES, ids=lambda c: c.name)
def test_build_priority_dense_bit_equal(case):
    A = make_payloads(case, D=3)[..., 0]
    got = build_priority_corpus(torch.as_tensor(A), case.m, case.seed,
                                variant=case.variant, device="cpu")
    ref = j_build(jnp.asarray(A), case.m, case.seed, variant=case.variant)
    _assert_sketch_bits(got, ref)
    _assert_sketch_bits(got, build_priority_corpus_ref(
        torch.as_tensor(A), case.m, case.seed, variant=case.variant))


@pytest.mark.parametrize("case", PRIORITY_CASES, ids=lambda c: c.name)
@pytest.mark.parametrize("shared", [True, False])
def test_build_priority_sparse_bit_equal(case, shared):
    """Explicit coordinates, shared (n,) or per-row (D, n), given out of
    order (the build sorts them)."""
    rng = np.random.default_rng(case.seed)
    A = make_payloads(case, D=3)[..., 0]
    universe = 40 * case.n
    if shared:
        ind = rng.choice(universe, case.n, replace=False).astype(np.int32)
    else:
        ind = np.stack([rng.choice(universe, case.n, replace=False)
                        for _ in range(3)]).astype(np.int32)
    got = build_priority_corpus(torch.as_tensor(A), case.m, case.seed,
                                variant=case.variant,
                                indices=torch.as_tensor(ind), device="cpu")
    ref = j_build(jnp.asarray(A), case.m, case.seed, variant=case.variant,
                  indices=jnp.asarray(ind))
    _assert_sketch_bits(got, ref)


def test_build_priority_edge_values_bit_equal():
    """Subnormal and huge values (the flush-to-zero traps) and a row of
    huge values, whose ranks all flush to 0 (tau = 0, nothing kept)."""
    rng = np.random.default_rng(9)
    A = edge_values(rng, 4, 3000 + 77)
    A[3] = 1e19
    got = build_priority_corpus(torch.as_tensor(A), 64, 11, device="cpu")
    ref = j_build(jnp.asarray(A), 64, 11)
    _assert_sketch_bits(got, ref)


def test_kernel_backend_priority_sketch_matches_reference():
    rng = np.random.default_rng(12)
    a = torch.as_tensor(sparse_block(rng, 1, 5000, 700)[0])
    _assert_sketch_bits(priority_sketch(a, 128, 42, backend="kernel"),
                        priority_sketch(a, 128, 42))
    with pytest.raises(ValueError, match="unknown backend"):
        priority_sketch(a, 128, 42, backend="pallas")


@pytest.mark.parametrize("case", [c for c in MATRIX_CASES
                                  if c.method == "priority"],
                         ids=lambda c: c.name)
def test_build_payload_corpus_matrix_kept_set(case):
    """d > 1 payloads: same kept rows and payloads.  The weight is a
    float sum over d lanes, taken in another order than XLA's, so tau
    (an order statistic of ranks from those weights) agrees within
    float32 rounding, per the parity contract for float-reduced taus."""
    P = make_payloads(case, D=2)
    got = build_payload_corpus(torch.as_tensor(P), case.m, case.seed,
                               variant=case.variant, device="cpu")
    ref = j_build_payload(jnp.asarray(P), case.m, case.seed,
                          method="priority", variant=case.variant)
    assert_bits(got.idx, ref.idx)
    assert_bits(got.payload, ref.payload)
    np.testing.assert_allclose(to_np(got.tau), np.asarray(ref.tau),
                               rtol=4e-7)


def test_build_threshold_not_ported_and_card_default():
    """The threshold method now builds (its parity is in
    ``test_torch_threshold.py``); an unknown method still raises, and the
    default device is the card."""
    out = build_payload_corpus(np.ones((1, 3), np.float32), 4, 0,
                               method="threshold", device="cpu")
    assert out.idx.shape == (1, 12)
    assert int(out.size()[0]) == 3           # nnz <= m: every entry kept
    with pytest.raises(ValueError, match="unknown method"):
        build_payload_corpus(np.ones((1, 8), np.float32), 4, 0,
                             method="sorted", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_priority_corpus(np.ones((1, 8), np.float32), 4, 0)
