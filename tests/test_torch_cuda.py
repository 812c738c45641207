"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and takes the ``cuda_device``
fixture, so it skips with the reason where there is no card.  The file
imports neither ``jax`` nor ``repro``, so it runs on a machine that has
only PyTorch: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Build kernels are held bit for bit; estimators within float32 summation
tolerance (``_torch_common.RTOL``)."""
import numpy as np
import pytest
import torch

from _torch_common import (assert_bits, assert_close, cuda_device,  # noqa: F401
                           edge_values, selection_cases, sparse_block)

import repro_torch.kernels as tk
from repro_torch.kernels.intersect_estimate import (allpairs_compact_ref,
                                                    allpairs_estimate_ref,
                                                    allpairs_join_tiles_ref,
                                                    intersect_estimate_ref)
from repro_torch.kernels.intersect_estimate.ops import scan_row_list
from repro_torch.kernels.hash_rank import (hash_rank_batched_ref,
                                           hash_rank_ref)
from repro_torch.kernels.hash_rank.hash_rank import spread_route
from repro_torch.kernels.sketch_build import (build_priority_corpus_ref,
                                              hash_rank_hist_ref,
                                              kth_smallest_ranks_ref)
from repro_torch.kernels.matrix_sketch import matrix_products_ref
from repro_torch.kernels.sketch_merge import merge_bucketized_ref
from repro_torch.kernels.countsketch import countsketch_ref
from repro_torch.kernels.jl_rademacher import jl_row_seeds, jl_rows_ref
from repro_torch.engine import payload_weight
from repro_torch.core import fold_seed
import repro_torch.core as tc
import repro_torch.matrix as tm
from repro_torch.private import DPParams
from repro_torch.serve import MatrixSketchStore, SketchIndex

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("variant", ["l2", "l1", "uniform"])
def test_hash_rank_hist_kernel_matches_plain(cuda_device, variant):
    rng = np.random.default_rng(1)
    A = torch.as_tensor(edge_values(rng, 7, 65536 + 77), device=cuda_device)
    before = tk.hash_rank_hist.launches
    got = tk.hash_rank_hist(A, 11, variant=variant)
    ref = hash_rank_hist_ref(A, 11, variant=variant)
    assert tk.hash_rank_hist.launches == before + 1
    for g, r in zip(got, ref):
        assert_bits(g, r)


def test_rank_hist_kernel_and_selection(cuda_device):
    """The selection on hash/rank output, with and without the level-0
    histogram: one radix_select launch a call, bit-equal to
    torch.kthvalue and to the plain four-level descent."""
    rng = np.random.default_rng(2)
    A = torch.as_tensor(edge_values(rng, 9, 20000 + 5), device=cuda_device)
    _, rank, hist0 = tk.hash_rank_hist(A, 5)
    for k in (1, 65, 20005):
        want = torch.kthvalue(rank, k, dim=1).values
        for h in (hist0, None):
            before = tk.radix_select.launches
            got = tk.kth_smallest_ranks(rank, k, hist0=h)
            assert tk.radix_select.launches == before + 1
            assert_bits(got, want)
        assert_bits(kth_smallest_ranks_ref(rank, k, hist0=hist0), want)


_SELECTION = selection_cases(np.random.default_rng(77))


def _kth_rows(keys, k):
    return torch.stack([torch.kthvalue(row, k if isinstance(k, int)
                                       else int(k[d])).values
                        for d, row in enumerate(keys)])


@pytest.mark.parametrize("name,keys,k", _SELECTION,
                         ids=[c[0] for c in _SELECTION])
def test_radix_select_edge_cases(cuda_device, name, keys, k):
    """k = 1, k = n, per-row k; all-+inf rows; ties across the k-th key;
    rows sharing one top byte (more candidates than fit on chip, so levels
    re-read the row); flushed zeros; ragged n.  One launch, bit-equal to
    torch.kthvalue and to the plain descent."""
    keys_t = torch.as_tensor(keys, device=cuda_device)
    k_t = k if isinstance(k, int) else torch.as_tensor(k, device=cuda_device)
    before = tk.radix_select.launches
    got = tk.radix_select(keys_t, k_t)
    assert tk.radix_select.launches == before + 1
    assert_bits(got, _kth_rows(keys_t, k))
    assert_bits(got, kth_smallest_ranks_ref(keys_t, k_t))


@pytest.mark.parametrize("D,n,k", [(1, 100_000, 267), (1, 100_000, 99_999),
                                   (1, 30_000, 1), (4096, 4098, 257)])
def test_radix_select_path_shapes(cuda_device, D, n, k):
    """The shapes the paths give it: a single vector's ranks and the merge
    candidates, each with +inf padding; no host synchronisation."""
    rng = np.random.default_rng(n + k)
    keys = rng.random((D, n)).astype(np.float32) / np.float32(0.01)
    keys[rng.random((D, n)) < 0.5] = np.inf
    keys_t = torch.as_tensor(keys, device=cuda_device)
    k_dev = torch.full((D,), k, dtype=torch.int64, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tk.kth_smallest_ranks(keys_t, k)
        got_t = tk.radix_select(keys_t, k_dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = torch.kthvalue(keys_t, k, dim=1).values
    assert_bits(got, want)
    assert_bits(got_t, want)


def _split_row_case(name, rng):
    if name == "one_top_byte":       # every key 0x3F..: levels re-read
        return (1.0 + rng.random((1, 65536))).astype(np.float32), 30000
    if name == "all_inf":
        return np.full((1, 65536), np.inf, np.float32), 100
    if name == "ragged_slices":      # the last block's slice is short
        keys = rng.random((1, 65537)).astype(np.float32)
        keys[rng.random(keys.shape) < 0.3] = np.inf
        return keys, 257
    keys = rng.random((16, 40003)).astype(np.float32) * np.float32(7.0)
    return keys, rng.integers(1, 40004, 16)      # "per_row_k"


@pytest.mark.parametrize("name", ["one_top_byte", "all_inf", "ragged_slices",
                                  "per_row_k"])
def test_radix_select_rows_split_across_blocks(cuda_device, name):
    """Few long rows are split across a cluster of blocks whose counts
    are summed on chip: one launch, bit-equal to torch.kthvalue and to
    the plain descent, also where a bin overflows shared memory."""
    keys, k = _split_row_case(name, np.random.default_rng(len(name)))
    keys_t = torch.as_tensor(keys, device=cuda_device)
    k_t = k if isinstance(k, int) else torch.as_tensor(k, device=cuda_device)
    before = tk.radix_select.launches
    got = tk.radix_select(keys_t, k_t)
    assert tk.radix_select.launches == before + 1
    assert_bits(got, _kth_rows(keys_t, k))
    assert_bits(got, kth_smallest_ranks_ref(keys_t, k_t))


def test_build_on_card_matches_reference_sketches(cuda_device):
    rng = np.random.default_rng(3)
    A = torch.as_tensor(edge_values(rng, 6, 9000 + 3), device=cuda_device)
    got = tk.build_priority_corpus(A, 64, 5, device=cuda_device)
    ref = build_priority_corpus_ref(A, 64, 5)
    for g, r in zip(got, ref):
        assert_bits(g, r)


def _card_corpus(device, D, m=64, n_buckets=128, slots=4, seed=0):
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(sparse_block(rng, D, 4000, 500), device=device)
    sk = tk.build_priority_corpus(A, m, 11, device=device)
    return tk.bucketize_corpus(sk, n_buckets=n_buckets, slots=slots)


@pytest.mark.parametrize("slots", [4, 3, 1, 8, 16])
def test_intersect_estimate_kernel_matches_plain(cuda_device, slots):
    """Any S: four slots take the 16-byte loads, the others slot by slot
    (one slot drops most of the sketch, sixteen leave buckets empty)."""
    c = _card_corpus(cuda_device, 37, slots=slots)
    q = tk.BucketizedSketch(*(x[4] for x in c))
    before = tk.intersect_estimate.launches
    got = tk.intersect_estimate(q.idx, q.val, q.tau, c.idx, c.val, c.tau)
    assert tk.intersect_estimate.launches == before + 1
    assert_close(got, intersect_estimate_ref(q.idx, q.val, q.tau, c.idx,
                                             c.val, c.tau))
    assert_bits(tk.intersect_estimate(q.idx, q.val, q.tau, c.idx, c.val,
                                      c.tau), got)


def _device_corpus(device, D, n, nnz, m, n_buckets, slots=4, seed=0):
    """A bucketized corpus built on the card from rows of about ``nnz``
    U(-1, 1) nonzeros of ``n`` (made on the card: no host copy of the
    dense block)."""
    g = torch.Generator(device=device).manual_seed(seed)
    v = torch.rand((D, n), generator=g, device=device) * 2 - 1
    keep = torch.rand((D, n), generator=g, device=device) < nnz / n
    A = torch.where(keep, v, torch.zeros((), device=device))
    sk = tk.build_priority_corpus(A, m, 11, device=device)
    return tk.bucketize_corpus(sk, n_buckets=n_buckets, slots=slots)


@pytest.mark.parametrize("C,n_buckets,m", [(4096, 512, 256), (2, 1024, 400),
                                           (37, 128, 64), (4099, 128, 64)])
def test_intersect_estimate_path_shapes(cuda_device, C, n_buckets, m):
    """The served widths (4096 rows of 512 x 4), the join-size panel's
    index (2 rows of 1024 x 4 at m = 400: a block a row) and ragged C on
    either side of the card's SM count; the query is a row of the corpus
    (all its ids match) and the call makes no host synchronisation; a
    second launch gives the same bits."""
    c = _device_corpus(cuda_device, C, 16384, 500, m, n_buckets, seed=C)
    q = tk.BucketizedSketch(*(x[1] for x in c))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tk.intersect_estimate(q.idx, q.val, q.tau, c.idx, c.val, c.tau)
        again = tk.intersect_estimate(q.idx, q.val, q.tau, c.idx, c.val,
                                      c.tau)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert_close(got, intersect_estimate_ref(q.idx, q.val, q.tau, c.idx,
                                             c.val, c.tau))
    assert_bits(again, got)


def test_intersect_estimate_rows_do_not_depend_on_the_corpus(cuda_device):
    """A row's bits depend on the row and the query alone: the first k
    rows of a 4099-row corpus (a warp a row) give the same bits as a
    corpus of those k rows (a block a row up to the SM count), and so
    does a copy whose arrays are not 16-byte aligned (slot-by-slot
    loads)."""
    c = _card_corpus(cuda_device, 4099, slots=4, seed=3)
    q = tk.BucketizedSketch(*(x[7] for x in c))
    full = tk.intersect_estimate(q.idx, q.val, q.tau, c.idx, c.val, c.tau)
    for k in (1, 2, 3, 37, 132, 133, 1000):
        assert_bits(tk.intersect_estimate(q.idx, q.val, q.tau, c.idx[:k],
                                          c.val[:k], c.tau[:k]), full[:k])

    def unaligned(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    for k in (3, 4099):
        ci, cv = unaligned(c.idx[:k]), unaligned(c.val[:k])
        assert ci.data_ptr() % 16
        assert_bits(tk.intersect_estimate(unaligned(q.idx), unaligned(q.val),
                                          q.tau, ci, cv, c.tau[:k]), full[:k])


@pytest.mark.parametrize("C", [3, 4099])
def test_intersect_estimate_edge_rows(cuda_device, C):
    """An all-INVALID query gives 0 for every row; a corpus row with
    tau = +inf (everything kept, p = 1) is estimated as the plain
    version does."""
    c = _card_corpus(cuda_device, C, slots=4, seed=4)
    q = tk.BucketizedSketch(*(x[0] for x in c))
    tau = c.tau.clone()
    tau[1] = float("inf")
    got = tk.intersect_estimate(q.idx, q.val, q.tau, c.idx, c.val, tau)
    assert_close(got, intersect_estimate_ref(q.idx, q.val, q.tau, c.idx,
                                             c.val, tau))
    empty_idx = torch.full_like(q.idx, 0x7FFFFFFF)
    empty_val = torch.zeros_like(q.val)
    got = tk.intersect_estimate(empty_idx, empty_val, q.tau, c.idx, c.val,
                                tau)
    assert bool((got == 0).all())
    assert_bits(got, intersect_estimate_ref(empty_idx, empty_val, q.tau,
                                            c.idx, c.val, tau))


@pytest.mark.parametrize("moments", [False, True])
@pytest.mark.parametrize("slots", [4, 3])
def test_allpairs_estimate_kernel_matches_plain(cuda_device, moments, slots):
    """Ragged tiles on both sides (37 x 141 against 128 or 64 row tiles)."""
    a = _card_corpus(cuda_device, 37, slots=slots, seed=1)
    b = _card_corpus(cuda_device, 141, slots=slots, seed=2)
    pa, pb = tk.slot_inclusion_probs(a), tk.slot_inclusion_probs(b)
    got = tk.allpairs_estimate(a.idx, a.val, pa, b.idx, b.val, pb,
                               moments=moments)
    ref = allpairs_estimate_ref(a.idx, a.val, pa, b.idx, b.val, pb,
                                moments=moments)
    assert_close(got, ref)


def _compact_equal(got, ref):
    """The kernel's compacted layout against the plain one, up to each
    count (entries past a count are unspecified on the card)."""
    assert_bits(got[1], ref[1])
    cap = ref[0].shape[2]
    used = (torch.arange(cap, device=ref[1].device)[None, None, :]
            < ref[1][..., None])
    assert_bits(got[0][used], ref[0][used])


@pytest.mark.parametrize("moments", [False, True])
@pytest.mark.parametrize("slots", [1, 2, 4, 8, 16])
def test_allpairs_compacted_join_matches_plain(cuda_device, moments, slots):
    """S = 1..16, full buckets (32 slots a row for m = 64 sketches, so
    buckets fill and drop), empty rows (all padding),
    D = 150 x 203 (not multiples of the tile); the compaction bit-equal to
    its plain version, the estimates within tolerance of the plain
    all-pairs, the same bits on a second launch, and A against itself
    compacted once."""
    nb = 32 // slots
    a = _card_corpus(cuda_device, 150, n_buckets=nb, slots=slots, seed=5)
    b = _card_corpus(cuda_device, 203, n_buckets=nb, slots=slots, seed=6)
    a.idx[[0, 77, 149]] = 0x7FFFFFFF                 # empty rows
    a.val[[0, 77, 149]] = 0.0
    pa, pb = tk.slot_inclusion_probs(a), tk.slot_inclusion_probs(b)
    assert int((a.idx != 0x7FFFFFFF).sum(dim=2).max()) == slots
    _compact_equal(tk.allpairs_compact(a.idx, a.val, pa),
                   allpairs_compact_ref(a.idx, a.val, pa))
    got = tk.allpairs_estimate(a.idx, a.val, pa, b.idx, b.val, pb,
                               moments=moments)
    ref = allpairs_estimate_ref(a.idx, a.val, pa, b.idx, b.val, pb,
                                moments=moments)
    assert_close(got, ref)
    assert_bits(tk.allpairs_estimate(a.idx, a.val, pa, b.idx, b.val, pb,
                                     moments=moments), got)
    assert bool((got[[0, 77, 149]] == 0).all())
    before = tk.allpairs_compact.launches
    self_est = tk.allpairs_estimate(a.idx, a.val, pa, a.idx, a.val, pa,
                                    moments=moments)
    assert tk.allpairs_compact.launches == before + 1
    assert_close(self_est, allpairs_estimate_ref(a.idx, a.val, pa, a.idx,
                                                 a.val, pa, moments=moments))


def test_allpairs_cells_depend_on_their_rows_only(cuda_device):
    """A cell's bits depend on its two rows alone: emptying other rows,
    or a row's slots in other buckets, leaves the cells of untouched row
    pairs bit-equal (what a merged index's all_pairs relies on)."""
    a = _card_corpus(cuda_device, 200, slots=4, seed=9)
    pa = tk.slot_inclusion_probs(a)
    full = tk.allpairs_estimate(a.idx, a.val, pa, a.idx, a.val, pa)
    cut = tk.BucketizedSketch(a.idx.clone(), a.val.clone(), a.tau, a.dropped)
    gone = torch.arange(0, 200, 7, device=cuda_device)
    cut.idx[gone] = 0x7FFFFFFF
    cut.val[gone] = 0.0
    pc = tk.slot_inclusion_probs(cut)
    part = tk.allpairs_estimate(cut.idx, cut.val, pc, cut.idx, cut.val, pc)
    keep = torch.ones(200, dtype=torch.bool, device=cuda_device)
    keep[gone] = False
    assert_bits(part[keep][:, keep], full[keep][:, keep])
    assert bool((part[gone] == 0).all())


def test_index_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(41)
    vecs = sparse_block(rng, 40, 3000, 300)
    cfg = dict(m=64, n_buckets=128, slots=4, initial_capacity=8)
    t = SketchIndex(**cfg, device=cuda_device)
    c = SketchIndex(**cfg, device="cpu")
    for index in (t, c):
        index.add_many([f"v{d}" for d in range(30)], vecs[:30])
        for d in range(30, 39):
            index.add(f"v{d}", vecs[d])
        nz = np.flatnonzero(vecs[39])
        index.add("v39", indices=nz, values=vecs[39][nz])
    for name in ("_idx", "_val", "_tau", "_dropped", "_head_kept"):
        assert_bits(getattr(t, name), getattr(c, name))
    assert [n for n, _ in t.query(vecs[5], top_k=5)] == \
        [n for n, _ in c.query(vecs[5], top_k=5)]
    assert_close(t.all_pairs(), c.all_pairs())


@pytest.mark.parametrize("variant", ["l2", "l1", "uniform"])
def test_hash_rank_kernels_match_plain(cuda_device, variant):
    rng = np.random.default_rng(4)
    A = torch.as_tensor(edge_values(rng, 7, 65536 + 77), device=cuda_device)
    before = (tk.hash_rank_batched.launches, tk.hash_rank.launches)
    for g, r in zip(tk.hash_rank_batched(A, 11, variant=variant),
                    hash_rank_batched_ref(A, 11, variant=variant)):
        assert_bits(g, r)
    for g, r in zip(tk.hash_rank(A[3], 11, variant=variant),
                    hash_rank_ref(A[3], 11, variant=variant)):
        assert_bits(g, r)
    assert (tk.hash_rank_batched.launches, tk.hash_rank.launches) == \
        (before[0] + 1, before[1] + 1)


_ONE_VECTOR_N = [1, 255, 256, 257, 4097, 30000, 65613, 100000,
                 (1 << 17) + 1]


def _check_one_vector(row, seed, variant):
    """B1 on ``row[None]`` and B3 on ``row``, one launch each, bit-equal
    to their plain versions."""
    before = (tk.hash_rank_hist.launches, tk.hash_rank.launches)
    for g, r in zip(tk.hash_rank_hist(row[None], seed, variant=variant),
                    hash_rank_hist_ref(row[None], seed, variant=variant)):
        assert_bits(g, r)
    for g, r in zip(tk.hash_rank(row, seed, variant=variant),
                    hash_rank_ref(row, seed, variant=variant)):
        assert_bits(g, r)
    assert (tk.hash_rank_hist.launches, tk.hash_rank.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("n", _ONE_VECTOR_N)
@pytest.mark.parametrize("variant", ["l2", "l1", "uniform"])
def test_one_vector_spread_route_matches_plain(cuda_device, variant, n):
    """B1 and B3 on one vector take the spread route (B1 a cluster launch
    that writes its histogram, up to 2^17 coordinates), bit-equal to the
    plain versions with the flush-to-zero traps among the values."""
    assert spread_route(cuda_device, 1, n)
    assert spread_route(cuda_device, 1, n, hist=True) == (n <= 1 << 17)
    rng = np.random.default_rng(n)
    row = torch.as_tensor(edge_values(rng, 1, n)[0], device=cuda_device)
    _check_one_vector(row, 11, variant)


@pytest.mark.parametrize("variant", ["l2", "l1", "uniform"])
def test_one_vector_zero_and_unaligned_rows(cuda_device, variant):
    """An all-zero row (every rank +inf, the whole histogram in one bin)
    and a row that is not 16-byte aligned (row 3 of an odd-width block),
    for both kernels."""
    _check_one_vector(torch.zeros(30000, device=cuda_device), 5, variant)
    rng = np.random.default_rng(3)
    A = torch.as_tensor(edge_values(rng, 5, 30001), device=cuda_device)
    assert A[3].data_ptr() % 16
    _check_one_vector(A[3], 5, variant)


@pytest.mark.parametrize("variant", ["l2", "uniform"])
def test_spread_and_batched_routes_agree(cuda_device, variant):
    """A row launched alone (the spread route) gives the bits of the same
    row in a block whose grid takes the batched route; and blocks just on
    either side of the boundary match their plain versions."""
    rng = np.random.default_rng(8)
    A = torch.as_tensor(edge_values(rng, 64, 30000), device=cuda_device)
    assert not spread_route(cuda_device, 64, 30000)
    _, r_all, hist_all = tk.hash_rank_hist(A, 7, variant=variant)
    _, r_one, hist_one = tk.hash_rank_hist(A[5][None], 7, variant=variant)
    assert_bits(r_one[0], r_all[5])
    assert_bits(hist_one[0], hist_all[5])
    assert_bits(tk.hash_rank(A[5], 7, variant=variant)[1],
                tk.hash_rank_batched(A, 7, variant=variant)[1][5])
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for D in (2 * sms - 1, 2 * sms):
        B = torch.as_tensor(edge_values(rng, D, 4096), device=cuda_device)
        assert spread_route(cuda_device, D, 4096) == (D < 2 * sms)
        assert spread_route(cuda_device, D, 4096, hist=True) == (D < 2 * sms)
        for g, r in zip(tk.hash_rank_hist(B, 7, variant=variant),
                        hash_rank_hist_ref(B, 7, variant=variant)):
            assert_bits(g, r)
        for g, r in zip(tk.hash_rank_batched(B, 7, variant=variant),
                        hash_rank_batched_ref(B, 7, variant=variant)):
            assert_bits(g, r)


def test_one_vector_hash_rank_hist_is_one_launch(cuda_device):
    """A D = 1 call is one kernel (no fill kernel before it); a block on
    the batched route is the fill and the kernel."""
    rng = np.random.default_rng(9)
    row = torch.as_tensor(edge_values(rng, 1, 30000), device=cuda_device)
    block = torch.as_tensor(edge_values(rng, 64, 30000), device=cuda_device)
    assert _kernel_launches(lambda: tk.hash_rank_hist(row, 3)) == 1
    assert _kernel_launches(lambda: tk.hash_rank(row[0], 3)) == 1
    assert _kernel_launches(lambda: tk.hash_rank_hist(block, 3)) == 2


@pytest.mark.parametrize("n", [256, 30000, 100000])
def test_spread_route_writes_every_bin(cuda_device, n):
    """A raw launch of the spread route into a histogram full of garbage
    leaves the plain version's counts in every bin."""
    from repro_torch.kernels.sketch_build.sketch_build import _lib
    rng = np.random.default_rng(n)
    A = torch.as_tensor(edge_values(rng, 1, n), device=cuda_device)
    h = torch.empty(n, device=cuda_device)
    rank = torch.empty((1, n), device=cuda_device)
    hist = torch.full((1, 256), 0x5A5A5A5A, dtype=torch.int32,
                      device=cuda_device)
    err = _lib().repro_hash_rank_hist(
        A.data_ptr(), h.data_ptr(), rank.data_ptr(), hist.data_ptr(), 1, n,
        11, 0, 1, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    want = hash_rank_hist_ref(A, 11)
    assert_bits(hist, want[2])
    assert_bits(rank, want[1])


@pytest.mark.parametrize("cap", [None, 40])
def test_threshold_build_on_card_matches_plain(cuda_device, cap):
    """The kernel build against the same build on the kernels' plain
    versions on the card (bit for bit, tau included); cap=40 < m forces
    the overflow cut."""
    rng = np.random.default_rng(5)
    A = torch.as_tensor(edge_values(rng, 6, 9000 + 3), device=cuda_device)
    for indices in (None, torch.randperm(9003, device=cuda_device)):
        got = tk.build_threshold_corpus(A, 64, 5, cap=cap, indices=indices,
                                        device=cuda_device)
        ref = tk.build_threshold_corpus(A, 64, 5, cap=cap, indices=indices,
                                        device=cuda_device, use_kernel=False)
        for g, r in zip(got, ref):
            assert_bits(g, r)


@pytest.mark.parametrize("n_buckets", [128, 16])
def test_merge_bucketized_kernel_matches_plain(cuda_device, n_buckets):
    rng = np.random.default_rng(6)
    A = sparse_block(rng, 37, 4000, 500)
    mask = rng.random(4000) < 0.5
    halves = [torch.as_tensor(np.where(keep, A, 0.0).astype(np.float32),
                              device=cuda_device) for keep in (mask, ~mask)]
    lo, hi = (tk.bucketize_corpus(tk.build_priority_corpus(
        x, 64, 11, device=cuda_device), n_buckets=n_buckets, slots=4)
        for x in halves)
    tau = tk.merged_tau_bucketized(lo, hi, 11, m=64)
    before = tk.merge_bucketized.launches
    got = tk.merge_bucketized(lo.idx, lo.val, hi.idx, hi.val, tau, 11)
    assert tk.merge_bucketized.launches == before + 1
    ref = merge_bucketized_ref(lo.idx, lo.val, hi.idx, hi.val, tau, 11)
    for g, r in zip(got, ref):
        assert_bits(g, r)
    if n_buckets == 16:
        assert int(got[2].sum()) > 0
    # slots that miss the vector-load path (S = 3)
    lo3, hi3 = (tk.bucketize_corpus(tk.build_priority_corpus(
        x, 64, 11, device=cuda_device), n_buckets=n_buckets, slots=3)
        for x in halves)
    tau3 = tk.merged_tau_bucketized(lo3, hi3, 11, m=64)
    for g, r in zip(tk.merge_bucketized(lo3.idx, lo3.val, hi3.idx, hi3.val,
                                        tau3, 11),
                    merge_bucketized_ref(lo3.idx, lo3.val, hi3.idx, hi3.val,
                                         tau3, 11)):
        assert_bits(g, r)


def test_merge_from_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(42)
    M = sparse_block(rng, 20, 3000, 300)
    lo, hi = M.copy(), M.copy()
    lo[:, 1500:] = 0.0
    hi[:, :1500] = 0.0
    names = [f"v{d}" for d in range(20)]
    merged = []
    for dev in (cuda_device, "cpu"):
        a = SketchIndex(m=64, n_buckets=128, device=dev)
        b = SketchIndex(m=64, n_buckets=128, device=dev)
        a.add_many(names, lo)
        b.add_many(names, hi)
        a.merge_from(b)
        merged.append(a)
    for name in ("_idx", "_val", "_tau", "_dropped", "_head_kept"):
        assert_bits(getattr(merged[0], name), getattr(merged[1], name))


def test_wrappers_reject_bad_inputs(cuda_device):
    x = torch.zeros((2, 8), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        tk.hash_rank_hist(x, 0)
    keys = torch.zeros((2, 8), device=cuda_device)
    with pytest.raises(ValueError, match="hist0"):
        tk.radix_select(keys, 3, hist0=torch.zeros(
            (2, 256), dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError, match="float32"):
        tk.radix_select(x, 3)
    for k in (0, 9):
        with pytest.raises(ValueError, match="1 <= k <= n"):
            tk.radix_select(keys, k)
    with pytest.raises(ValueError, match="float32"):
        tk.hash_rank_batched(x, 0)
    with pytest.raises(ValueError, match="variant"):
        tk.hash_rank(keys[0], 0, variant="l3")
    idx = torch.zeros((2, 4, 9), dtype=torch.int32, device=cuda_device)
    val = torch.zeros((2, 4, 9), device=cuda_device)
    tau = torch.ones(2, device=cuda_device)
    with pytest.raises(ValueError, match="slots"):
        tk.merge_bucketized(idx, val, idx, val, tau, 0)
    with pytest.raises(ValueError, match="tau"):
        tk.merge_bucketized(idx[..., :4].contiguous(), val[..., :4].contiguous(),
                            idx[..., :4].contiguous(), val[..., :4].contiguous(),
                            tau[:1], 0)


def _matrix_pair(rng, n, da, db, overlap=0.5):
    """Row-partial-overlap pair with lognormal row scales, as
    ``benchmarks/matrix_product.py::_pair``."""
    A = (rng.standard_normal((n, da))
         * rng.lognormal(0.0, 1.0, (n, 1))).astype(np.float32)
    B = (rng.standard_normal((n, db))
         * rng.lognormal(0.0, 1.0, (n, 1))).astype(np.float32)
    lead = (1.0 - overlap) / 2.0
    A[int((lead + overlap) * n):] = 0
    B[: int(lead * n)] = 0
    return A, B


def _matrix_layouts(device, P, n, da, db, *, m=64, n_buckets=128, slots=4,
                    seed=0, special=False):
    """Bucketized (idx, rows, p) of both sides on the card.  ``special``:
    the last A side a padding sketch (all INVALID, tau = 1) and the first
    pair with fewer nonzero rows than m (tau = inf, everything kept)."""
    rng = np.random.default_rng(seed)
    pairs = [_matrix_pair(rng, n, da, db) for _ in range(P)]
    if special:
        pairs[0][0][40:] = 0.0
    sides = []
    for k in (0, 1):
        sks = [tm.priority_matrix_sketch(torch.as_tensor(p[k], device=device),
                                         m, 11) for p in pairs]
        S = tm.stack_matrix_sketches(sks)
        if special and k == 0:
            S.row_idx[-1] = np.iinfo(np.int32).max
            S.rows[-1] = 0.0
            S.tau[-1] = 1.0
        bc = tk.bucketize_matrix_sketches(S, n_buckets=n_buckets, slots=slots)
        sides.append((bc.idx, bc.rows, tk.matrix_slot_probs(bc), bc.dropped))
    return sides


@pytest.mark.parametrize("da,db,slots,n_buckets", [
    (16, 16, 4, 512), (8, 3, 4, 128), (6, 6, 2, 128), (5, 7, 3, 128),
    (24, 24, 4, 128), (4, 4, 4, 16), (8, 8, 4, 2048)])
def test_matrix_products_kernel_matches_plain(cuda_device, da, db, slots,
                                              n_buckets):
    """Unequal widths, S = 2, 3, 4, outputs beyond one block's 256
    threads (24 x 24), a 16-bucket layout that drops rows, 2048 buckets
    (more than four a thread), a padding pair and a keep-everything (tau =
    inf) pair."""
    a, b = _matrix_layouts(cuda_device, 7, 900, da, db, slots=slots,
                           n_buckets=n_buckets, special=True)
    if n_buckets == 16:
        assert int(a[3].sum()) > 0
    before = tk.matrix_products.launches
    got = tk.matrix_products(*a[:3], *b[:3])
    torch.cuda.synchronize()
    assert tk.matrix_products.launches == before + 1
    assert_close(got, matrix_products_ref(*a[:3], *b[:3]))
    assert bool((got[-1] == 0).all())
    # run to run: the same bits (the match list is built without atomics)
    assert_bits(tk.matrix_products(*a[:3], *b[:3]), got)


def test_matrix_products_broadcast_query(cuda_device):
    """One query side read for every pair (batch stride 0) equals the
    query copied P times, bit for bit, and the plain version."""
    a, b = _matrix_layouts(cuda_device, 9, 900, 16, 16, n_buckets=512)
    q = [x[:1].contiguous() for x in a[:3]]
    got = tk.matrix_products(*q, *b[:3])
    copies = tk.matrix_products(*(x.expand(9, *x.shape[1:]).contiguous()
                                  for x in q), *b[:3])
    assert_bits(got, copies)
    assert_close(got, matrix_products_ref(*q, *b[:3]))


@pytest.mark.parametrize("d", [2, 8, 16, 33, 64])
def test_payload_weight_card_equals_cpu(cuda_device, d):
    rng = np.random.default_rng(d)
    X = (rng.standard_normal((4096, d))
         * rng.lognormal(0.0, 2.0, (4096, 1))).astype(np.float32)
    for rows in (X, edge_values(rng, 512, d)):
        for variant in ("l2", "l1"):
            assert_bits(payload_weight(torch.as_tensor(rows,
                                                       device=cuda_device),
                                       variant),
                        payload_weight(torch.as_tensor(rows), variant))


def test_matrix_store_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(43)
    stores = [MatrixSketchStore(64, dim=8, initial_capacity=2, device=dev)
              for dev in (cuda_device, "cpu")]
    mats = [_matrix_pair(rng, 2000, 8, 8)[k % 2] for k in range(6)]
    for st in stores:
        for k, X in enumerate(mats):
            st.add(f"M{k}", X)
    for name in ("_idx", "_rows", "_tau"):
        assert_bits(getattr(stores[0], name), getattr(stores[1], name))
    q = _matrix_pair(rng, 2000, 8, 8)[1]
    before = tk.matrix_products.launches
    got = np.stack([e for _, e in stores[0].query(q)])
    assert tk.matrix_products.launches == before + 1
    assert_close(got, np.stack([e for _, e in stores[1].query(q)]))
    pairs = [("M0", "M1"), ("M2", "M3"), ("M5", "M4")]
    assert_close(stores[0].products(pairs), stores[1].products(pairs))
    assert_close(stores[0].product("M0", "M3"),
                 stores[1].product("M0", "M3"))


def test_matrix_products_rejects_bad_inputs(cuda_device):
    a, b = _matrix_layouts(cuda_device, 3, 500, 4, 4)
    with pytest.raises(ValueError, match="pair"):
        tk.matrix_products(*(x[:2] for x in a[:3]), *b[:3])
    with pytest.raises(ValueError, match="float32"):
        tk.matrix_products(a[0], a[1].double(), a[2], *b[:3])
    with pytest.raises(ValueError, match="contiguous"):
        tk.matrix_products(a[0], a[1].transpose(1, 2), a[2], *b[:3])
    # a block stages whole matched rows: rows this wide do not fit once
    ids = torch.zeros((1, 2, 4), dtype=torch.int32, device=cuda_device)
    wide = torch.zeros((1, 2, 4, 30000), device=cuda_device)
    p = torch.ones((1, 2, 4), device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        tk.matrix_products(ids, wide, p, ids, wide, p)
    # more slots a side than one launch takes
    big = torch.zeros((1, (1 << 18) + 1, 4), dtype=torch.int32,
                      device=cuda_device)
    rows = torch.zeros((1, (1 << 18) + 1, 4, 1), device=cuda_device)
    p = torch.ones((1, (1 << 18) + 1, 4), device=cuda_device)
    with pytest.raises(ValueError, match="one launch"):
        tk.matrix_products(big, rows, p, big, rows, p)


def _b7_sides(a, b, broadcast, k=None, reps=1):
    """The kernel's arguments: the A side broadcast (one query) or batched,
    the first k pairs, each pair repeated reps times."""
    def pick(x):
        x = x if k is None else x[:k]
        return x.repeat(reps, *([1] * (x.ndim - 1))).contiguous()
    aa = [x[:1].contiguous() for x in a[:3]] if broadcast else \
        [pick(x) for x in a[:3]]
    return (*aa, *(pick(x) for x in b[:3]))


@pytest.mark.parametrize("broadcast", [False, True])
def test_matrix_products_pairs_do_not_depend_on_p(cuda_device, broadcast):
    """The first k pairs of a P-pair call are bit-equal to a k-pair call,
    and 700 repeated pairs (4-warp blocks) to the 7-pair call (8-warp
    blocks): a pair's bits depend on its two sketches alone."""
    a, b = _matrix_layouts(cuda_device, 7, 900, 16, 16, n_buckets=512)
    got = tk.matrix_products(*_b7_sides(a, b, broadcast))
    for k in (1, 3, 6):
        assert_bits(tk.matrix_products(*_b7_sides(a, b, broadcast, k=k)),
                    got[:k])
    assert_bits(tk.matrix_products(*_b7_sides(a, b, broadcast, reps=100)),
                got.repeat(100, 1, 1))


@pytest.mark.parametrize("reps", [1, 100])
@pytest.mark.parametrize("broadcast", [False, True])
def test_matrix_products_is_one_launch(cuda_device, broadcast, reps):
    """A call is one kernel node in a captured graph, on both routes and
    both block sizes."""
    a, b = _matrix_layouts(cuda_device, 7, 900, 16, 16, n_buckets=512)
    args = _b7_sides(a, b, broadcast, reps=reps)
    assert _kernel_launches(lambda: tk.matrix_products(*args)) == 1


@pytest.mark.parametrize("slots,d", [(4, 16), (3, 16), (4, 480)])
def test_matrix_products_many_matches_a_pair(cuda_device, slots, d):
    """Every slot of both sides full and matched (the same ids, in another
    order in each bucket): 64 x slots matches a pair, listed 64 at a time
    (60 at d = 480, where fewer rows fit), against the plain version,
    launch to launch, and one pair alone."""
    rng = np.random.default_rng(5)
    P, B = 3, 64
    ids = rng.permutation(P * B * slots).reshape(P, B, slots)
    order = np.argsort(rng.random((P, B, slots)), axis=-1)

    def side(x):
        return (torch.as_tensor(x.astype(np.int32), device=cuda_device),
                torch.as_tensor(rng.standard_normal((P, B, slots, d))
                                .astype(np.float32), device=cuda_device),
                torch.as_tensor(rng.uniform(0.05, 1.0, (P, B, slots))
                                .astype(np.float32), device=cuda_device))
    a, b = side(ids), side(np.take_along_axis(ids, order, axis=-1))
    got = tk.matrix_products(*a, *b)
    assert_close(got, matrix_products_ref(*a, *b))
    assert_bits(tk.matrix_products(*a, *b), got)
    assert_bits(tk.matrix_products(*(x[1:2] for x in a),
                                   *(x[1:2] for x in b)), got[1:2])


def _zipf_counts(rng, n_keys, rows, z=2.0):
    """A Zipf key-frequency table (integer counts, as Fig. 10's)."""
    keys = rng.permutation(n_keys)
    f = np.zeros(n_keys, np.float32)
    np.add.at(f, keys[np.minimum(rng.zipf(z, rows) - 1, n_keys - 1)], 1.0)
    return f


def _cs_exact(t, m, seed_b, seed_s):
    """The table summed in float64, and the float32 summation error bound
    of each bucket (terms in the bucket x 2^-24 x their absolute sum)."""
    idx = torch.arange(t.shape[0], dtype=torch.int32, device=t.device)
    bucket = tc.hash_bucket(seed_b, idx, m).to(torch.int64)
    sign = tc.hash_sign(seed_s, idx).double()
    zero = torch.zeros(m, dtype=torch.float64, device=t.device)
    exact = zero.index_add(0, bucket, sign * t.double())
    mass = zero.index_add(0, bucket, t.double().abs())
    count = torch.bincount(bucket, minlength=m).double()
    return exact.cpu().numpy(), (count * 2.0**-24 * mass).cpu().numpy()


@pytest.mark.parametrize("n", [30000, 100000, 65536])
@pytest.mark.parametrize("m", [128, 400, 600, 3417, 3418, 8192])
def test_countsketch_kernel_matches_plain(cuda_device, n, m):
    """Both bucket branches (m = 128 and 8192 mask, the others take the
    modulo), ragged n, both paths (one launch up to m = 3417, two passes
    beyond); two launches give the same bits, and no call synchronises
    with the host.  Integer counts sum exactly in any order, so kernel and
    plain version are equal there; on U(-1, 1) values each is within
    float32 summation error of the float64 table (two summation orders
    over buckets of hundreds of terms may differ by more than a fixed
    1e-5)."""
    from repro_torch.kernels.countsketch.countsketch import one_pass_max_m
    assert one_pass_max_m() == 3417
    rng = np.random.default_rng(n + m)
    for v in (rng.uniform(-1, 1, n).astype(np.float32),
              _zipf_counts(rng, n, 5 * n)):
        t = torch.as_tensor(v, device=cuda_device)
        before = tk.countsketch_scatter.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = tk.countsketch_scatter(t, m, 0x9E3779B9, 12345)
            again = tk.countsketch_scatter(t, m, 0x9E3779B9, 12345)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert tk.countsketch_scatter.launches == before + 2
        assert_bits(again, got)
        ref = countsketch_ref(t, 0x9E3779B9, 12345, m)
        exact, bound = _cs_exact(t, m, 0x9E3779B9, 12345)
        for table in (got, ref):
            assert np.all(np.abs(table.cpu().numpy() - exact) <= bound)
        if np.all(v == np.round(v)):
            assert_bits(got, ref)


def _kernel_launches(fn) -> int:
    """Kernels one call of ``fn`` launches: the kernel nodes of a CUDA
    graph that captures the call, counted through the driver API."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    fn()                                  # build and first-use set-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    return kinds.count(0)                 # CU_GRAPH_NODE_TYPE_KERNEL


@pytest.mark.parametrize("m,kernels", [(128, 1), (400, 1), (600, 1),
                                       (3417, 1), (3418, 2), (8192, 2)])
def test_countsketch_launches_per_call(cuda_device, m, kernels):
    """At its callers' sizes (m <= 600) and up to the one-launch limit a
    call is one kernel launch; past it, two (the per-chunk pass and the
    sum)."""
    t = torch.as_tensor(_zipf_counts(np.random.default_rng(m), 30000,
                                     150000), device=cuda_device)
    assert _kernel_launches(lambda: tk.countsketch_scatter(t, m, 1, 2)) \
        == kernels


@pytest.mark.parametrize("n", [30000, 65536])
@pytest.mark.parametrize("m", [256, 400])
@pytest.mark.parametrize("rule", ["jl_project", "jl_sketch"])
def test_jl_rademacher_kernel_matches_plain(cuda_device, n, m, rule):
    rng = np.random.default_rng(n + m)
    t = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                        device=cuda_device)
    rows = torch.arange(m, dtype=torch.int64, device=cuda_device)
    seeds = (jl_row_seeds(11, rows) if rule == "jl_project"
             else (int(fold_seed(11, 0)) + rows) & 0xFFFFFFFF)
    before = tk.jl_rademacher.launches
    got = tk.jl_rademacher(t, seeds)
    assert tk.jl_rademacher.launches == before + 1
    assert_bits(tk.jl_rademacher(t, seeds), got)
    # sums of n terms of random sign in another order: the absolute
    # tolerance scales with the largest output, as the estimators' does
    ref = jl_rows_ref(t, seeds).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=1e-4,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))



def _jl_seeds(rule, m, device):
    rows = torch.arange(m, dtype=torch.int64, device=device)
    return (jl_row_seeds(11, rows) if rule == "jl_project"
            else (int(fold_seed(11, 0)) + rows) & 0xFFFFFFFF)


@pytest.mark.parametrize("n", [1, 255, 30001, 65536])
@pytest.mark.parametrize("m", [1, 400, 600])
@pytest.mark.parametrize("rule", ["jl_project", "jl_sketch"])
def test_jl_rademacher_one_launch_any_shape(cuda_device, n, m, rule):
    """n = 1, n off the tile, the join and parity widths, m = 1: one kernel
    node in a captured graph, the same bits from launch to launch, within
    the stated tolerance of the plain version."""
    rng = np.random.default_rng(n * 7 + m)
    t = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                        device=cuda_device)
    seeds = _jl_seeds(rule, m, cuda_device)
    # int32 seeds: the wrapper then launches no cast before the kernel
    seeds32 = seeds.to(torch.int32)
    assert _kernel_launches(lambda: tk.jl_rademacher(t, seeds32)) == 1
    assert_bits(tk.jl_rademacher(t, seeds32), tk.jl_rademacher(t, seeds))
    got = tk.jl_rademacher(t, seeds)
    assert_bits(tk.jl_rademacher(t, seeds), got)
    ref = jl_rows_ref(t, seeds).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=1e-4,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("n", [255, 30000, 65536])
@pytest.mark.parametrize("m", [400, 600])
def test_jl_rademacher_rows_do_not_depend_on_m(cuda_device, n, m):
    """The first k rows of an m-row call are bit-equal to a k-row call
    (k = 1, 7, m - 1), and a row keeps its bits at another place in the
    row tiles: a row's bits depend on its seed and the vector alone."""
    rng = np.random.default_rng(n + 3 * m)
    t = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                        device=cuda_device)
    seeds = _jl_seeds("jl_project", m, cuda_device)
    got = tk.jl_rademacher(t, seeds)
    for k in (1, 7, m - 1):
        assert_bits(tk.jl_rademacher(t, seeds[:k]), got[:k])
    assert_bits(tk.jl_rademacher(t, seeds.roll(3)), got.roll(3))


@pytest.mark.parametrize("rule", ["jl_project", "jl_sketch"])
def test_jl_rademacher_exact_on_small_integers(cuda_device, rule):
    """Small integers sum exactly in any order, so the kernel equals the
    plain version bit for bit: every sign is the reference's."""
    rng = np.random.default_rng(5)
    t = torch.as_tensor(rng.integers(-8, 9, 30001).astype(np.float32),
                        device=cuda_device)
    seeds = _jl_seeds(rule, 400, cuda_device)
    assert_bits(tk.jl_rademacher(t, seeds), jl_rows_ref(t, seeds))

def test_baselines_on_card_match_cpu(cuda_device):
    rng = np.random.default_rng(44)
    a = rng.standard_normal(20000).astype(np.float32)
    a[rng.random(20000) < 0.6] = 0
    t, c = torch.as_tensor(a, device=cuda_device), torch.as_tensor(a)
    np.testing.assert_allclose(tc.jl_sketch(t, 300, 5).cpu().numpy(),
                               tc.jl_sketch(c, 300, 5).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc.countsketch(t, 400, 5).cpu().numpy(),
                               tc.countsketch(c, 400, 5).numpy(),
                               rtol=1e-5, atol=1e-5)
    for g, r in zip(tc.minhash_sketch(t, 40, 5), tc.minhash_sketch(c, 40, 5)):
        assert_bits(g, r)


def test_served_modes_on_card_match_cpu(cuda_device):
    rng = np.random.default_rng(45)
    fa = _zipf_counts(rng, 5000, 50000)
    fb = _zipf_counts(rng, 5000, 50000)
    params = DPParams(epsilon=4.0, clamp=1.0, p_floor=0.05)
    idx = [SketchIndex(m=128, n_buckets=256, head_h=16, dp=params,
                       dp_rng=np.random.default_rng(7), device=dev)
           for dev in (cuda_device, "cpu")]
    for index in idx:
        index.add("fa", fa)
        index.add("fa_n", fa / fa.max())
        index.add_many(["fb"], fb[None])
    for name in ("_idx", "_val", "_tau", "_head_idx", "_head_kept"):
        assert_bits(getattr(idx[0], name), getattr(idx[1], name))
    for mode in ("plain", "bias_aware"):
        assert_close(np.array([e for _, e in idx[0].query(fb, mode=mode)]),
                     np.array([e for _, e in idx[1].query(fb, mode=mode)]))
    got, ref = (np.array([e for _, e in ix.query(fb, mode="private")])
                for ix in idx)
    assert_bits(got, ref)
    assert idx[0].accountant.spent_epsilon == 4.0


def test_countsketch_and_jl_reject_bad_inputs(cuda_device):
    v = torch.zeros(100, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        tk.countsketch_scatter(v.double(), 10, 0, 0)
    with pytest.raises(ValueError, match="float32"):
        tk.countsketch_scatter(v.reshape(10, 10), 10, 0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        tk.countsketch_scatter(torch.zeros((100, 2), device=cuda_device)[:, 0],
                               10, 0, 0)
    with pytest.raises(ValueError, match="m"):
        tk.countsketch_scatter(v, 0, 0, 0)
    seeds = torch.arange(8, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        tk.jl_rademacher(v.double(), seeds)
    with pytest.raises(ValueError, match="row_seeds"):
        tk.jl_rademacher(v, seeds.float())
    with pytest.raises(ValueError, match="row_seeds on"):
        tk.jl_rademacher(v, seeds.cpu())


# ------------------------------------------ join correlation (slice 9)


def _combined_block(rng, D, n, m):
    """(D, n): the edge rows of the CPU parity tests (all zero, m - 3
    nonzeros, heavy-tailed with subnormal (a/scale)^4 and subnormal
    inputs) above Gaussian rows at 40% density."""
    A = rng.standard_normal((D, n)).astype(np.float32)
    A[rng.random(A.shape) < 0.6] = 0.0
    A[0] = 0.0
    A[1] = 0.0
    A[1, rng.choice(n, m - 3, replace=False)] = 1.5
    A[2] = (rng.random(n) * 1e-4).astype(np.float32)
    A[2, rng.random(n) < 0.5] = 0.0
    A[2, 7] = 1e6
    A[2, 11:14] = (1e-40, -1e-39, 1e-20)
    return A


@pytest.mark.parametrize("method", ["priority", "threshold"])
@pytest.mark.parametrize("n,m", [(20000 + 77, 64), (1 << 18, 512), (40, 64)])
def test_combined_build_kernel_matches_plain(cuda_device, method, n, m):
    """The combined build on B2 against the same build on B2's plain
    version on the card, every field bit for bit (the two share every
    sum); the priority build also against the CPU's."""
    D = 6 if n > 64 else 2
    A = _combined_block(np.random.default_rng(n), D, n, m) if n > 64 else \
        np.random.default_rng(3).standard_normal((D, n)).astype(np.float32)
    build = (tk.build_combined_priority_corpus if method == "priority"
             else tk.build_combined_threshold_corpus)
    before = tk.radix_select.launches
    got = build(A, m, 9, device=cuda_device)
    if method == "priority" and n > m:
        assert tk.radix_select.launches == before + 2
    for g, r in zip(got, build(A, m, 9, device=cuda_device,
                               use_kernel=False)):
        assert_bits(g, r)
    if method == "priority":
        for g, r in zip(got, build(A, m, 9, device="cpu")):
            assert_bits(g, r)


def test_radix_select_on_union_positions(cuda_device):
    """B2 on the combined build's q keys at (64, 2^18): integer-valued
    floats in [0, m + 1], almost all equal to m + 1, so the k-th key's
    top-byte bin holds nearly every key; bit-equal to torch.kthvalue and
    to the plain descent, for k = m + 1 and at the edges."""
    from repro_torch.core.join_correlation import _family_ranks
    m, n = 512, 1 << 18
    rng = np.random.default_rng(8)
    A = sparse_block(rng, 64, n, 5000)
    A[5, :] = 0.0
    A[5, :100] = 1.0
    _, _, ranks = _family_ranks(torch.as_tensor(A, device=cuda_device), 7)
    q, _ = tk.sketch_build.union_positions(ranks, m)
    head = (q < m + 1).sum(dim=1)
    head[5] = 0     # 100 nonzeros: its zeros all sit at position 100
    assert int(head.max()) <= 3 * (m + 1)
    for k in (1, m + 1, n):
        got = tk.radix_select(q, k)
        assert_bits(got, torch.kthvalue(q, k, dim=1).values)
        assert_bits(got, kth_smallest_ranks_ref(q, k))


@pytest.mark.parametrize("d2", [64, 600])
def test_allpairs_moments_at_1024_buckets(cuda_device, d2):
    """B5's moments mode at B = 1024, S = 4 (the correlation matrix's
    layout): within tolerance of the plain version, the same bits launch
    to launch, a query block's rows bit-equal to the same rows of the
    square matrix."""
    from repro_torch.core.join_correlation import _bucketized_moment_inputs
    rng = np.random.default_rng(d2)
    A = sparse_block(rng, d2, 65536, 3000)
    S = tc.combined_sketch_corpus(A, 512, 7, backend="kernel",
                                  device=cuda_device)
    a = _bucketized_moment_inputs(S, 1024, 4)[:3]
    q = tuple(x[:64].contiguous() for x in a)
    got = tk.allpairs_moments(*q, *a)
    assert_close(got, allpairs_estimate_ref(*q, *a, moments=True, ct=64))
    assert_bits(tk.allpairs_moments(*q, *a), got)
    full = tk.allpairs_moments(*a, *a)
    assert_bits(full[:64], got)


# a mirrored cell's channels: (n, sum_y, sum_x, xy, sum_y2, sum_x2)
_SWAP_XY = [0, 2, 1, 3, 5, 4]


def _moments_inputs(device, D, seed):
    """A combined-sketch corpus (m = 512) bucketized as the correlation
    matrix lays it (1024 buckets x 4 slots, inclusion probabilities)."""
    from repro_torch.core.join_correlation import _bucketized_moment_inputs
    rng = np.random.default_rng(seed)
    S = tc.combined_sketch_corpus(sparse_block(rng, D, 65536, 3000), 512, 7,
                                  backend="kernel", device=device)
    return _bucketized_moment_inputs(S, 1024, 4)[:3]


def test_allpairs_moments_mirror_equals_a_copy(cuda_device):
    """The self-join (one compacted corpus on both sides: the tiles on
    and above the diagonal, mirrored) bit-equal to the join with a copy
    of the corpus on the B side (every tile joined) at a ragged D, and
    out[a, b] equal to out[b, a] with x and y swapped."""
    a = _moments_inputs(cuda_device, 300, 21)
    copy = tuple(x.clone() for x in a)
    got = tk.allpairs_moments(*a, *a)
    assert_bits(got, tk.allpairs_moments(*a, *copy))
    assert_bits(got, got.transpose(0, 1)[..., _SWAP_XY])
    assert_close(got, allpairs_estimate_ref(*a, *a, moments=True, ct=64))


def test_allpairs_moments_cells_depend_on_their_rows_only(cuda_device):
    """The moments join: emptying other rows leaves the cells of untouched
    row pairs bit-equal, in the self-join (mirrored) and against a copy."""
    a = _card_corpus(cuda_device, 200, slots=4, seed=9)
    pa = tk.slot_inclusion_probs(a)
    full = tk.allpairs_moments(a.idx, a.val, pa, a.idx, a.val, pa)
    cut = tk.BucketizedSketch(a.idx.clone(), a.val.clone(), a.tau, a.dropped)
    gone = torch.arange(0, 200, 7, device=cuda_device)
    cut.idx[gone] = 0x7FFFFFFF
    cut.val[gone] = 0.0
    pc = tk.slot_inclusion_probs(cut)
    keep = torch.ones(200, dtype=torch.bool, device=cuda_device)
    keep[gone] = False
    for b in ((cut.idx, cut.val, pc),
              (cut.idx.clone(), cut.val.clone(), pc.clone())):
        part = tk.allpairs_moments(cut.idx, cut.val, pc, *b)
        assert_bits(part[keep][:, keep], full[keep][:, keep])
        assert bool((part[gone] == 0).all())
        assert bool((part[:, gone] == 0).all())


def _heavy_moments_inputs(device, D, n_buckets, seed):
    """D rows that share most ids, as (idx, val, p) at 4 slots.  Bucket b
    draws each row's ids (distinct within the row) from a pool: b % 3 ==
    0, all four slots from 5 ids (lists of 4 x 64 entries, runs of ~51
    equal ids); b % 3 == 1, two slots from 8 ids (~128 entries); b % 3 ==
    2, at most one slot from 40 ids.  A batch of 16 buckets then holds
    more entries a side than the 1024 the join stages, so its later lists
    are read from global memory."""
    rng = np.random.default_rng(seed)
    idx = np.full((D, n_buckets, 4), 0x7FFFFFFF, dtype=np.int32)
    for b in range(n_buckets):
        kind = b % 3
        pool = rng.choice(1 << 24, (5, 8, 40)[kind], replace=False)
        for r in range(D):
            k = (4, 2, int(rng.integers(0, 2)))[kind]
            idx[r, b, :k] = rng.choice(pool, k, replace=False)
    used = idx != 0x7FFFFFFF
    val = np.where(used, rng.standard_normal(idx.shape), 0.0)
    p = np.where(used, rng.uniform(0.05, 1.0, idx.shape), 1.0)
    return tuple(torch.as_tensor(x, device=device) for x in
                 (idx, val.astype(np.float32), p.astype(np.float32)))


@pytest.mark.parametrize("mirror", [False, True])
def test_allpairs_moments_heavy_tiles(cuda_device, mirror):
    """Rows that share most ids (runs of up to 64 equal ids, lists of
    more than 64 entries a bucket, batches of more entries than the join
    stages, whose later lists it reads from global memory), D = 100 (a
    full and a ragged tile): within tolerance of the plain version and the
    same bits launch to launch, in the self-join (mirrored) and against
    the rows permuted."""
    a = _heavy_moments_inputs(cuda_device, 100, 48, 3)
    counts = tk.allpairs_compact(*a)[1]
    assert int(counts.max()) > 64
    assert int(counts.reshape(2, 3, 16).sum(dim=2).max()) > 1024
    perm = torch.as_tensor(np.random.default_rng(4).permutation(100),
                           device=cuda_device)
    b = a if mirror else tuple(x[perm].contiguous() for x in a)
    got = tk.allpairs_moments(*a, *b)
    assert_close(got, allpairs_estimate_ref(*a, *b, moments=True))
    assert_bits(tk.allpairs_moments(*a, *b), got)
    if not mirror:
        assert_bits(tk.allpairs_moments(*b, *a),
                    got.transpose(0, 1)[..., _SWAP_XY])


@pytest.mark.parametrize("slots", [1, 3, 4, 16])
def test_allpairs_moments_ragged_sides(cuda_device, slots):
    """D1 = 70 against D2 = 333 (ragged tiles on both sides, more tiles
    on one side than the other) at S = 1, 3, 4 and 16: within tolerance
    of the plain version both ways, and the two ways the same bits with
    x and y swapped."""
    a = _card_corpus(cuda_device, 70, slots=slots, seed=13)
    b = _card_corpus(cuda_device, 333, slots=slots, seed=14)
    pa, pb = tk.slot_inclusion_probs(a), tk.slot_inclusion_probs(b)
    ab = tk.allpairs_moments(a.idx, a.val, pa, b.idx, b.val, pb)
    assert_close(ab, allpairs_estimate_ref(a.idx, a.val, pa, b.idx, b.val,
                                           pb, moments=True))
    ba = tk.allpairs_moments(b.idx, b.val, pb, a.idx, a.val, pa)
    assert_bits(ba, ab.transpose(0, 1)[..., _SWAP_XY])


def test_tiles_equal_all_pairs_blocks(cuda_device):
    """Four (128, 128) tiles of random rows (and a short tile padded with
    an out-of-range id) bit-equal to the matching blocks of the full
    matrix: a cell's bits depend on its two rows only."""
    c = _card_corpus(cuda_device, 600, seed=11)
    p = tk.slot_inclusion_probs(c)
    arrs = (c.idx, c.val, p)
    full = tk.allpairs_estimate(*arrs, *arrs)
    rng = np.random.default_rng(12)
    for _ in range(4):
        ra, rb = (rng.choice(600, 128, replace=False) for _ in range(2))
        before = tk.allpairs_estimate.launches
        tile = tk.estimate_tile_rows(*arrs, *arrs, ra, rb)
        assert tk.allpairs_estimate.launches == before + 1
        assert_bits(tile, full[np.ix_(ra, rb)])
    short = tk.estimate_tile_rows(*arrs, *arrs, [3, 9, 10_000], [599, 0])
    assert_bits(short, full[np.ix_([3, 9, 599], [599, 0])])


def test_combined_merge_on_card_matches_cpu(cuda_device):
    """The combined merge of two coordinate halves: idx and val bit-equal
    to the CPU's merge of the same parts, taus within 1 ulp."""
    rng = np.random.default_rng(21)
    A = sparse_block(rng, 32, 1 << 16, 4000)
    A[3] *= np.float32(100.0)
    lo, hi = A.copy(), A.copy()
    lo[:, 1 << 15:] = 0.0
    hi[:, :1 << 15] = 0.0
    out = []
    for dev in (cuda_device, "cpu"):
        parts = [tk.build_combined_priority_corpus(x, 256, 3, device=dev)
                 for x in (lo, hi)]
        out.append(tc.merge_combined_sketches(*parts, 3, m=256))
    assert_bits(out[0].idx, out[1].idx)
    assert_bits(out[0].val, out[1].val)
    for f in ("tau_ones", "tau_val", "tau_sq", "scale"):
        g, r = getattr(out[0], f).cpu(), getattr(out[1], f)
        fin = torch.isfinite(r)
        assert torch.equal(torch.isfinite(g), fin)
        gap = (g[fin].view(torch.int32).long()
               - r[fin].view(torch.int32).long()).abs()
        assert gap.numel() == 0 or int(gap.max()) <= 1


def test_table_store_on_card_matches_cpu(cuda_device):
    """The table store on the card and on CPU copies: the same top
    columns in the same order, scores within 1e-5."""
    from repro_torch.data import SketchedTableStore
    rng = np.random.default_rng(1)
    q_keys = rng.choice(200_000, 5000, replace=False)
    q_vals = rng.normal(100, 25, 5000)
    cols = [("q", q_keys, q_vals)]
    for i, rho in enumerate((0.75, -0.55, 0.05, -0.2, 0.4, 0.6)):
        keys = np.concatenate([rng.choice(q_keys, 3000, replace=False),
                               rng.choice(200_000, 2000, replace=False)])
        vals = rng.standard_normal(5000) + rho * np.arange(5000) / 5000
        cols.append((f"c{i}", keys, vals))
    stores = [SketchedTableStore(universe=1 << 18, m=512, device=dev)
              for dev in (cuda_device, "cpu")]
    for s in stores:
        for name, keys, vals in cols:
            s.add_column(name, keys, vals)
    got, want = (s.top_correlated("q", k=5) for s in stores)
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               atol=1e-5)


def _skewed_index(device, D, seed=0, m=64, n=4096):
    """A ``SketchIndex`` on ``device`` over Zipf(1.5)-scaled Gaussian rows
    (the discovery regime: heavy-tailed norms), six planted pairs."""
    rng = np.random.default_rng(seed)
    scales = (np.arange(1, D + 1, dtype=np.float32) ** -1.5) * 8.0
    X = rng.standard_normal((D, n), dtype=np.float32) * scales[:, None]
    for i in range(6):
        X[2 * i + 1] = 0.9 * X[2 * i] + 0.3 * scales[2 * i + 1] * \
            rng.standard_normal(n).astype(np.float32)
    ix = SketchIndex(m, n_buckets=128, slots=4, device=device)
    ix.add_many([f"c{i}" for i in range(D)], X)
    return ix, X


def _sorted_pairs(est, names, k, absolute):
    """The top k of the upper triangle of ``est``: descending score, ties
    by ascending (row, column)."""
    iu, ju = np.triu_indices(est.shape[0], k=1)
    v = est[iu, ju]
    score = np.abs(v) if absolute else v
    order = np.lexsort((ju, iu, -score))[:k]
    return [(names[iu[o]], names[ju[o]], float(v[o])) for o in order]


def _counted_batches(monkeypatch):
    """Record the size of each batch the discovery scans take (a list
    append: the fan-out's threads may share it)."""
    import repro_torch.serve.discovery as disc
    sizes = []
    real = disc.scan_tile_batch

    def counting(a, b, pairs, **kw):
        sizes.append(len(pairs))
        return real(a, b, pairs, **kw)

    monkeypatch.setattr(disc, "scan_tile_batch", counting)
    return sizes


def _launch_counts():
    return (tk.allpairs_join_tiles.launches, tk.allpairs_join_tiles.tiles,
            tk.allpairs_compact.launches, tk.allpairs_estimate.launches)


@pytest.mark.parametrize("absolute", [False, True])
@pytest.mark.parametrize("tile", [8, 64, 128])
def test_discovery_scan_equals_all_pairs_sort(cuda_device, tile, absolute,
                                              monkeypatch):
    """The pruned scan on the card: bit-equal to ``all_pairs()`` plus the
    sort (a tile's cells equal all_pairs' blocks), one compaction launch
    for the engine's layout (none on a second scan), one launch of the
    tile-list join a batch computing (tile / 64)^2 join tiles (at least
    one) a listed pair, every visited tile pair in a batch, and the tiles
    accounted for."""
    from repro_torch.serve import DiscoveryEngine
    ix, _ = _skewed_index(cuda_device, 600)
    want = _sorted_pairs(ix.all_pairs(), ix._names, 10, absolute)
    eng = DiscoveryEngine(ix, tile=tile)
    for scan in range(2):
        batches = _counted_batches(monkeypatch)
        before = _launch_counts()
        res = eng.top_pairs(k=10, absolute=absolute)
        launches, tiles, compactions, plain = (
            x - y for x, y in zip(_launch_counts(), before))
        s = res.stats
        assert launches == len(batches) > 0
        assert tiles == sum(batches) * max(tile // 64, 1) ** 2
        assert compactions == (1 if scan == 0 else 0) and plain == 0
        assert sum(batches) >= s.kernel_launches == s.tiles_launched > 0
        assert s.tiles_launched + s.tiles_pruned == s.tiles_total
        assert res.items == want


def test_discovery_query_scan_equals_one_row_launch(cuda_device,
                                                    monkeypatch):
    """The query scan against one one-row launch of B5 over every row plus
    the sort, bit for bit, and its launches counted: a compaction of the
    query row a call, one tile-list join launch a batch."""
    from repro_torch.core import priority_sketch
    ix, X = _skewed_index(cuda_device, 600, seed=1)
    q = 0.7 * X[4] + 0.2 * X[9]
    sq = priority_sketch(torch.as_tensor(q, device=cuda_device), ix.m,
                         ix.seed)
    qb = tk.bucketize(sq, n_buckets=ix.n_buckets, slots=ix.slots)
    qc = tk.BucketizedSketch(qb.idx[None], qb.val[None], qb.tau.reshape(1),
                             torch.zeros(1, dtype=torch.int32,
                                         device=cuda_device))
    c = ix._corpus()
    est = tk.estimate_tile_rows(
        qc.idx, qc.val, tk.slot_inclusion_probs(qc), c.idx, c.val,
        tk.slot_inclusion_probs(c), [0], np.arange(len(ix))).cpu().numpy()[0]
    for scan, absolute in enumerate((False, True)):
        score = np.abs(est) if absolute else est
        order = np.lexsort((np.arange(est.size), -score))[:10]
        batches = _counted_batches(monkeypatch)
        before = _launch_counts()
        res = ix.top_k_for_query(q, k=10, absolute=absolute)
        launches, tiles, compactions, plain = (
            x - y for x, y in zip(_launch_counts(), before))
        # the query's row compacted each call, the index's layout once
        assert compactions == (2 if scan == 0 else 1) and plain == 0
        assert launches == len(batches) > 0 and tiles == sum(batches)
        assert tiles >= res.stats.kernel_launches > 0
        assert res.items == [(ix._names[i], float(est[i])) for i in order]


def test_discovery_after_add_many_equals_fresh_engine(cuda_device):
    """An engine that scanned before an ``add_many`` (high-norm rows that
    reorder the tiles, then low-norm rows that dirty the tail) answers as
    a fresh engine does, and as ``all_pairs()`` plus the sort."""
    from repro_torch.serve import DiscoveryEngine
    ix, X = _skewed_index(cuda_device, 300, seed=2)
    eng = DiscoveryEngine(ix, tile=64)
    eng.top_pairs(k=10)
    rng = np.random.default_rng(3)
    for names, rows in (
            ([f"hot{i}" for i in range(40)],
             X[:40] * 3.0 + rng.standard_normal(X[:40].shape,
                                                dtype=np.float32)),
            ([f"tiny{i}" for i in range(70)],
             np.full((70, X.shape[1]), 1e-4, np.float32))):
        refreshed = eng._summaries.refreshes
        ix.add_many(names, rows)
        got = eng.top_pairs(k=10, audit=True)
        want = DiscoveryEngine(ix, tile=64).top_pairs(k=10, audit=True)
        assert eng._summaries.refreshes > refreshed
        assert got.items == want.items == _sorted_pairs(
            ix.all_pairs(), ix._names, 10, False)
        assert got.audit == want.audit


def _shared_id_inputs(device, D, n_buckets, slots, seed):
    """(idx, val, p) of D rows that share most ids: each bucket's ids
    drawn from a pool of ``slots + 1``, each row taking ``slots`` of them,
    so a 64-row tile's bucket lists hold 64 x ``slots`` entries in runs of
    up to 64 equal ids (128 at S = 2: longer than the 64 the plain join
    stages; 256 at S = 4: longer than the 128 the tile-list join
    stages)."""
    rng = np.random.default_rng(seed)
    idx = np.empty((D, n_buckets, slots), dtype=np.int32)
    for b in range(n_buckets):
        pool = np.sort(rng.choice(1 << 24, slots + 1, replace=False))
        for r in range(D):
            idx[r, b] = np.sort(rng.choice(pool, slots, replace=False))
    val = rng.standard_normal(idx.shape).astype(np.float32)
    p = rng.uniform(0.05, 1.0, idx.shape).astype(np.float32)
    return tuple(torch.as_tensor(x, device=device) for x in (idx, val, p))


def _tile_rows(u, D, tile=64):
    return np.arange(u * tile, min(u * tile + tile, D))


@pytest.mark.parametrize("groups", [None, 1, 2, 4, 8, 16])
@pytest.mark.parametrize("slots", [2, 4])
def test_join_tiles_heavy_rows_equal_tile_rows(cuda_device, slots, groups):
    """Rows sharing most ids, D = 150 (a ragged last tile): each listed
    pair of the tile-list join (repeats, both orders, the diagonal)
    bit-equal to ``estimate_tile_rows`` on its rows and to ``all_pairs``'
    block, zeros in the padding, whatever the groups; one launch, its
    tiles counted; within tolerance of the plain version."""
    a = _shared_id_inputs(cuda_device, 150, 24, slots, 5)
    ent, cnt = tk.allpairs_compact(*a)
    assert int(cnt[:2].min()) == 64 * slots
    full = tk.allpairs_estimate(*a, *a).cpu()
    pairs = [(0, 0), (0, 1), (1, 0), (2, 2), (1, 2), (2, 0), (0, 0)]
    pt = torch.tensor(pairs, dtype=torch.int32, device=cuda_device)
    before = _launch_counts()
    got = tk.allpairs_join_tiles(ent, cnt, ent, cnt, pt, groups=groups)
    after = _launch_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (1, len(pairs))
    got = got.cpu()
    for n, (u, v) in enumerate(pairs):
        ru, rv = _tile_rows(u, 150), _tile_rows(v, 150)
        tile = got[n, :ru.size, :rv.size]
        assert_bits(tile, tk.estimate_tile_rows(*a, *a, ru, rv).cpu())
        assert_bits(tile, full[np.ix_(ru, rv)])
        assert not got[n, ru.size:].any() and not got[n, :, rv.size:].any()
    assert_close(got, allpairs_join_tiles_ref(ent, cnt, ent, cnt, pt).cpu())


def test_join_tiles_two_sides_and_out_of_range(cuda_device):
    """Two corpora (70 and 333 rows: ragged tiles, more on one side): a
    batch of every tile pair bit-equal to their blocks of the two-corpus
    ``all_pairs``, pairs outside the tiles zeros."""
    a = _card_corpus(cuda_device, 70, seed=13)
    b = _card_corpus(cuda_device, 333, seed=14)
    pa, pb = tk.slot_inclusion_probs(a), tk.slot_inclusion_probs(b)
    full = tk.allpairs_estimate(a.idx, a.val, pa, b.idx, b.val, pb).cpu()
    ca = tk.allpairs_compact(a.idx, a.val, pa)
    cb = tk.allpairs_compact(b.idx, b.val, pb)
    pairs = [(u, v) for u in range(2) for v in range(6)] + [(2, 0), (0, 6),
                                                            (-1, 0)]
    got = tk.allpairs_join_tiles(*ca, *cb, torch.tensor(
        pairs, dtype=torch.int32, device=cuda_device)).cpu()
    for n, (u, v) in enumerate(pairs):
        if not (0 <= u < 2 and 0 <= v < 6):
            assert not got[n].any()
            continue
        ru, rv = _tile_rows(u, 70), _tile_rows(v, 333)
        assert_bits(got[n, :ru.size, :rv.size], full[np.ix_(ru, rv)])


@pytest.mark.parametrize("tile", [8, 64, 128])
def test_scan_layout_and_batch_equal_tile_rows(cuda_device, tile):
    """The scan's layout of 300 rows in a random order (one compaction
    through a row list; a ragged last tile), bit-equal to the compaction
    of the rows gathered, and one batch of tile pairs (T = 8: slices of
    a join tile; T = 128: four join tiles a pair) bit-equal to
    ``estimate_tile_rows`` on each pair's rows."""
    c = _card_corpus(cuda_device, 300, seed=15)
    p = tk.slot_inclusion_probs(c)
    order = np.random.default_rng(16).permutation(300)
    rows = [order[i:i + tile] for i in range(0, 300, tile)]
    before = _launch_counts()
    lay = tk.scan_tiles(c.idx, c.val, p, rows, tile)
    assert _launch_counts()[2] - before[2] == 1
    flat = scan_row_list(rows, tile)
    take = torch.as_tensor(np.where(flat >= 0, flat, 0), device=cuda_device)
    live = torch.as_tensor(flat >= 0, device=cuda_device)[:, None, None]
    want = tk.allpairs_compact(
        torch.where(live, c.idx[take], 0x7FFFFFFF),
        torch.where(live, c.val[take], 0.0),
        torch.where(live, p[take], 1.0))
    assert_bits(lay.counts, want[1])
    used = torch.arange(lay.entries.shape[2], device=cuda_device) \
        < lay.counts[..., None]
    assert_bits(lay.entries[used], want[0][used])
    rng = np.random.default_rng(17)
    pairs = np.stack([rng.integers(0, len(rows), 40),
                      rng.integers(0, len(rows), 40)], 1)
    pairs[:2] = [[len(rows) - 1, len(rows) - 1], [0, len(rows) - 1]]
    before = _launch_counts()
    got = tk.scan_tile_batch(lay, lay, pairs)
    assert _launch_counts()[0] - before[0] == 1
    for (u, v), g in zip(pairs, got):
        assert_bits(g, tk.estimate_tile_rows(c.idx, c.val, p, c.idx, c.val,
                                             p, rows[u], rows[v]).cpu())


def _skewed_sharded(device, D, shards=4, seed=0, m=64, n=4096):
    """The rows of ``_skewed_index`` in a ``ShardedSketchIndex`` of
    ``shards`` shards, and the global index over them."""
    from repro_torch.serve import ShardedSketchIndex
    ix, X = _skewed_index(device, D, seed=seed, m=m, n=n)
    sh = ShardedSketchIndex(num_shards=shards, m=m, n_buckets=128, slots=4,
                            device=device)
    sh.add_many(ix._names, X)
    return sh, ix, X


def test_sharded_all_pairs_and_query_equal_global(cuda_device):
    """A cell of B5 depends on its two rows, a row of B4 on the row and
    the query: the sharded ``all_pairs`` and ``query`` are bit-equal to
    the global index's on the same rows, each shard one launch."""
    sh, ix, X = _skewed_sharded(cuda_device, 300)
    before = tk.allpairs_estimate.launches
    assert_bits(sh.all_pairs(), ix.all_pairs())
    assert tk.allpairs_estimate.launches - before == 16 + 1
    for q in (X[3], 0.5 * X[0] - X[7]):
        before = tk.intersect_estimate.launches
        got = sh.query(q)
        assert tk.intersect_estimate.launches - before == 4
        assert [n for n, _ in got] == [n for n, _ in ix.query(q)]
        assert_bits(np.array([e for _, e in got], np.float32),
                    np.array([e for _, e in ix.query(q)], np.float32))


@pytest.mark.parametrize("absolute", [False, True])
def test_sharded_fanout_counts_every_launch(cuda_device, absolute,
                                            monkeypatch):
    """A 4-shard fan-out in 8 threads: the tile-list join's launch and
    tile counts rise by the tasks' batches and their tiles exactly (the
    counters are taken under a lock), every visited tile pair in a batch,
    and the answer is bit-equal to the global scan's and to
    ``all_pairs()`` plus the sort."""
    from repro_torch.serve import ShardedDiscoveryEngine
    sh, ix, _ = _skewed_sharded(cuda_device, 700, seed=4)
    want = _sorted_pairs(ix.all_pairs(), ix._names, 10, absolute)
    eng = ShardedDiscoveryEngine(sh, tile=16, max_workers=8)
    for _ in range(3):
        batches = _counted_batches(monkeypatch)
        before = _launch_counts()
        res = eng.top_pairs(k=10, absolute=absolute)
        launches, tiles, _, plain = (
            x - y for x, y in zip(_launch_counts(), before))
        s = res.stats
        assert launches == len(batches) and tiles == sum(batches)
        assert plain == 0 and tiles >= s.kernel_launches
        assert s.kernel_launches == s.tiles_launched > 10
        assert res.items == want
        assert res.items == ix.top_pairs(k=10, absolute=absolute).items
        assert not res.degraded and res.coverage == 1.0


def test_concurrent_first_loads_run_one_nvcc_a_source(cuda_device,
                                                      tmp_path, monkeypatch):
    """8 threads' first launches into an empty build directory: one
    ``nvcc`` a source, every launch right."""
    import subprocess
    import threading
    from repro_torch.kernels import _build
    runs = []
    popen = subprocess.Popen

    def counting(cmd, *a, **kw):
        runs.append(str(cmd[-1]))
        return popen(cmd, *a, **kw)

    monkeypatch.setattr(_build, "_build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_BOUND", set())
    monkeypatch.setattr(_build.subprocess, "Popen", counting)
    rng = np.random.default_rng(12)
    A = torch.as_tensor(sparse_block(rng, 16, 4096, 300), device=cuda_device)
    want = build_priority_corpus_ref(A, 64, 11)
    got = [None] * 8
    errors = []
    barrier = threading.Barrier(8)

    def first(i):
        try:
            barrier.wait(timeout=60)
            got[i] = tk.build_priority_corpus(A, 64, 11)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    pool = [threading.Thread(target=first, args=(i,)) for i in range(8)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(timeout=600)
    assert not any(th.is_alive() for th in pool)
    assert errors == []
    assert sorted(runs) == sorted(str(_build.CSRC / f"{s}.cu")
                                  for s in _build.SOURCES)
    for sk in got:
        for g, w in zip(sk, want):
            assert_bits(g, w)


# ----------------------------------------------------------- resilience

def _durable_ops(dur, device, V):
    """add_many, a snapshot, a dense and a sparse add, a batch of left
    halves and the merge of their right halves (B6) from a peer."""
    n = V.shape[1]
    dur.add_many([f"r{d}" for d in range(24)], V[:24])
    dur.snapshot()
    dur.add("r24", V[24])
    nz = np.flatnonzero(V[25])
    dur.add("r25", indices=nz, values=V[25][nz])
    left, right = V[26:30].copy(), V[26:30].copy()
    left[:, n // 2:] = 0.0
    right[:, : n // 2] = 0.0
    dur.add_many([f"w{d}" for d in range(4)], left)
    peer = SketchIndex(64, n_buckets=128, slots=4, seed=5, device=device)
    peer.add_many([f"r{d}" for d in range(26)],
                  np.zeros((26, n), np.float32))
    peer.add_many([f"w{d}" for d in range(4)], right)
    dur.merge_from(peer)


def test_snapshot_of_card_index_loads_on_cpu_bit_equal(cuda_device,
                                                       tmp_path):
    """An index and a store built on the card snapshot and load on the
    CPU with the same bits (and back), and the loaded index's row
    summaries equal the card index's."""
    import shutil
    from repro_torch.serve import load_snapshot, save_snapshot
    rng = np.random.default_rng(40)
    V = sparse_block(rng, 40, 4096, 400)
    ix = SketchIndex(64, n_buckets=128, slots=4, seed=5, device=cuda_device)
    ix.add_many([f"r{d}" for d in range(32)], V[:32])
    for d in range(32, 40):
        nz = np.flatnonzero(V[d])
        ix.add(f"r{d}", indices=nz, values=V[d][nz])
    st = MatrixSketchStore(32, dim=8, seed=5, device=cuda_device)
    for k in range(6):
        st.add(f"M{k}", rng.normal(size=(300, 8)).astype(np.float32))
    for src, keys in ((ix, ("_idx", "_val", "_tau", "_dropped")),
                      (st, ("_idx", "_rows", "_tau"))):
        path = save_snapshot(src, str(tmp_path / type(src).__name__))
        cpu, _ = load_snapshot(path, device="cpu")
        back, _ = load_snapshot(save_snapshot(cpu, str(tmp_path / "back")),
                                device=cuda_device)
        for got in (cpu, back):
            assert got._names == src._names
            for k in keys:
                assert_bits(getattr(got, k)[: len(src)],
                            getattr(src, k)[: len(src)])
        if src is ix:
            for g, w in zip(cpu.row_summaries(), ix.row_summaries()):
                assert_bits(g, w)
            q = V[3] + 0.1 * rng.normal(size=4096).astype(np.float32)
            assert back.query(q) == ix.query(q)
            assert_close(np.array([e for _, e in cpu.query(q)]),
                         np.array([e for _, e in ix.query(q)]))
        shutil.rmtree(tmp_path / "back")


def test_durable_recover_on_card_is_bit_equal(cuda_device, tmp_path):
    """A durable index on the card, crashed with a torn journal tail,
    recovers on the card bit-equal, its queries bit-equal; the replay
    runs the merge kernel once (B6) and the build kernels."""
    from repro_torch.serve import DurableSketchIndex
    rng = np.random.default_rng(41)
    V = sparse_block(rng, 30, 4096, 400)
    kw = dict(m=64, n_buckets=128, slots=4, seed=5, device=cuda_device)
    dur = DurableSketchIndex(str(tmp_path), **kw)
    _durable_ops(dur, cuda_device, V)
    dur.journal.close()
    with open(dur.journal.path) as f:
        last = f.readlines()[-1]
    with open(dur.journal.path, "a") as f:
        f.write(last[: len(last) // 2])
    merges = tk.merge_bucketized.launches
    builds = tk.hash_rank_hist.launches
    rec = DurableSketchIndex.recover(str(tmp_path), **kw)
    assert tk.merge_bucketized.launches - merges == 1
    assert tk.hash_rank_hist.launches > builds
    assert (rec.replayed_ops, rec.dropped_tail) == (4, 1)
    assert rec.index._names == dur.index._names
    for k in ("_idx", "_val", "_tau", "_dropped", "_g", "_kn"):
        assert_bits(getattr(rec.index, k)[: len(dur)],
                    getattr(dur.index, k)[: len(dur)])
    for q in (V[1], V[27] - 0.5 * V[3]):
        assert rec.query(q) == dur.query(q)
    assert rec.index.top_pairs(5).items == dur.index.top_pairs(5).items


@pytest.mark.parametrize("kills", [(), (2,), (0, 3)])
def test_resilient_index_on_card_equals_cpu(cuda_device, kills):
    """Degraded reads on the card against the CPU's on the same rows: the
    same down shards, coverage and bounds (host float64 and float32
    arithmetic on the same slice norms), estimates within tolerance; the
    degraded ``all_pairs`` is the sum of the surviving shards' own."""
    from repro_torch.serve import ResilientSketchIndex, RetryPolicy
    rng = np.random.default_rng(42)
    V = sparse_block(rng, 48, 8192, 800)
    qs = [V[5] + 0.05 * rng.normal(size=8192).astype(np.float32),
          rng.normal(size=8192).astype(np.float32)]
    res = {}
    for dev in (cuda_device, "cpu"):
        ix = ResilientSketchIndex(8192, num_shards=4, m=64, n_buckets=128,
                                  seed=11, retry=RetryPolicy(
                                      attempts=1, deadline=None),
                                  device=dev)
        ix.add_many([f"r{d}" for d in range(48)], V)
        for p in kills:
            ix.kill_shard(p)
        res[str(dev)] = [ix.query(q) for q in qs] + [ix.all_pairs()]
        if dev == cuda_device:
            surv = [p for p in range(4) if p not in kills]
            want = sum(ix._shards[p].all_pairs().astype(np.float64)
                       for p in surv).astype(np.float32)
            assert_bits(res[str(dev)][-1].estimates, want)
    for got, want in zip(res[str(cuda_device)], res["cpu"]):
        assert got.down_shards == want.down_shards == tuple(kills)
        assert got.coverage == want.coverage
        for f in ("bound", "sampling_bound", "lost_mass_bound"):
            assert_bits(np.asarray(getattr(got, f)),
                        np.asarray(getattr(want, f)))
        assert_close(got.estimates, want.estimates)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b",
                                  "mamba2-370m", "recurrentgemma-2b",
                                  "whisper-small", "phi-3-vision-4.2b"])
def test_family_loss_and_grads_on_card_match_cpu(cuda_device, arch):
    """Each new family's reduced config (float32, TF32 off) on the card
    from the CPU's weights (each attention group's wq / wk times 1/4:
    the scores O(1)) and batch: the loss within 1e-5, each gradient leaf
    within 1e-4 of the CPU leaf's scale; the MoE leaves' gradients
    repeat bit for bit from run to run (the dispatch and combine are
    gathers both ways, no float atomics)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM, frontend_stubs
    from repro_torch.models import init_params, loss_fn, param_leaves
    from repro_torch.models.tree import tree_map
    from repro_torch.train import value_and_grad
    cfg = get_config(arch).reduced()
    params = init_params(cfg, 0, device="cpu")
    for g in params["groups"].values():
        if "wq" in g:
            g["wq"] = g["wq"] * 0.25
            g["wk"] = g["wk"] * 0.25
    batch = SyntheticLM(cfg.vocab_size, 64, 2, seed=3,
                        device="cpu").batch_at(0)
    batch.update(frontend_stubs(cfg, 2, 64, seed=3, device="cpu"))
    lfn = lambda p, b: loss_fn(cfg, p, b)  # noqa: E731
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        (c_loss, _), c_g = value_and_grad(lfn, params, batch)
        on = lambda t: tree_map(lambda x: x.to(cuda_device), t)  # noqa
        runs = [value_and_grad(lfn, on(params), on(batch)) for _ in range(2)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    (g_loss, _), g_g = runs[0]
    assert abs(float(g_loss) - float(c_loss)) <= \
        1e-5 * max(1.0, abs(float(c_loss)))
    for (path, c), (_, g) in zip(param_leaves(c_g), param_leaves(g_g)):
        scale = max(float(c.abs().max()), 1e-30)
        assert float((g.cpu() - c).abs().max()) <= 1e-4 * scale, path
    if cfg.n_experts:
        for (path, a), (_, b) in zip(param_leaves(g_g),
                                     param_leaves(runs[1][1])):
            if "moe" in path:
                assert_bits(a, b)


def _serve_setup(arch: str):
    """``arch``'s reduced config, CPU weights (each attention group's
    wq / wk times 1/4) and a (2, 56) token block with the prompt stubs."""
    from repro_torch.configs import get_config
    from repro_torch.data import frontend_stubs
    from repro_torch.models import init_params
    cfg = get_config(arch).reduced()
    params = init_params(cfg, 0, device="cpu")
    for g in params["groups"].values():
        if "wq" in g:
            g["wq"] = g["wq"] * 0.25
            g["wk"] = g["wk"] * 0.25
    tokens = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 56)).astype(np.int32))
    return cfg, params, tokens, frontend_stubs(cfg, 2, 48, seed=9,
                                               device="cpu")


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-moe-a2.7b",
                                  "mamba2-370m", "recurrentgemma-2b",
                                  "whisper-small", "phi-3-vision-4.2b"])
def test_prefill_decode_on_card_match_cpu(cuda_device, arch):
    """A reduced config's prefill of 48 tokens (horizon 56: the local
    rings wrap) and 8 decode steps on the card against the CPU from the
    same weights, float32, TF32 off: each step's logits within 1e-5 of
    their largest magnitude, the final state's float leaves within 1e-5
    of their scale, its int32 leaves equal."""
    from repro_torch.models import decode_fn, param_leaves, prefill_fn
    from repro_torch.models.tree import tree_map
    cfg, params, tokens, stubs = _serve_setup(arch)
    on = lambda t: tree_map(lambda x: x.to(cuda_device), t)  # noqa: E731
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = []
        for move in (lambda t: t, on):
            p = move(params)
            logits, state = prefill_fn(cfg, max_len=56)(
                p, move({"tokens": tokens[:, :48], **stubs}))
            out = [logits.cpu()]
            step = decode_fn(cfg)
            for t in range(48, 56):
                logits, state = step(p, state, move(tokens[:, t:t + 1]))
                out.append(logits.cpu())
            runs.append((out, state))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    (c_out, c_state), (g_out, g_state) = runs
    for c, g in zip(c_out, g_out):
        assert float((g - c).abs().max()) <= 1e-5 * max(
            1.0, float(c.abs().max()))
    for (path, c), (_, g) in zip(param_leaves(c_state),
                                 param_leaves(g_state)):
        g = g.cpu()
        if c.dtype == torch.int32:
            assert torch.equal(g, c), path
        elif c.numel():
            assert float((g - c).abs().max()) <= 1e-5 * max(
                float(c.abs().max()), 1e-30), path


def test_decode_in_place_write_stays_in_its_group(cuda_device):
    """The stacked caches own their storage (no ``expand`` aliasing): a
    decode step on the card changes slot ``pos % C`` of each group's own
    slice and no other slot of any group."""
    from repro_torch.models import (decode_fn, init_decode_state,
                                    param_leaves, prefill_fn)
    from repro_torch.models.tree import tree_map
    cfg, params, tokens, _ = _serve_setup("gemma2-2b")
    params = tree_map(lambda x: x.to(cuda_device), params)
    tokens = tokens.to(cuda_device)
    empty = init_decode_state(cfg, 2, 40, device=cuda_device)
    for path, x in param_leaves(empty["groups"]):
        assert 0 not in x.stride(), path
    _, state = prefill_fn(cfg, max_len=40)(params, {"tokens": tokens[:, :16]})
    before = {p: x.clone() for p, x in param_leaves(state)}
    _, state = decode_fn(cfg)(params, state, tokens[:, 16:17])
    for path, x in param_leaves(state):
        if path[0] != "groups" or path[-1] not in ("k", "v", "pos"):
            continue
        keep = torch.ones(x.shape[2], dtype=torch.bool, device=x.device)
        keep[16 % x.shape[2]] = False
        for g in range(cfg.n_groups):
            assert torch.equal(x[g][:, keep], before[path][g][:, keep]), \
                (path, g)
            assert not torch.equal(x[g][:, ~keep],
                                   before[path][g][:, ~keep]), (path, g)


def test_two_engines_greedy_agree_on_card(cuda_device):
    """Two engines on the same reduced weights on the card give the same
    greedy tokens (two waves), each below the vocabulary."""
    from repro_torch.models.tree import tree_map
    from repro_torch.serve import Engine, Request
    cfg, params, _, _ = _serve_setup("gemma2-2b")
    params = tree_map(lambda x: x.to(cuda_device), params)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 12, 20, 9)]
    outs = []
    for _ in range(2):
        eng = Engine(cfg, params, batch_size=3, max_len=64,
                     device=cuda_device)
        done = eng.serve([Request(rid=i, prompt=p, max_new_tokens=6)
                          for i, p in enumerate(prompts)])
        outs.append([tuple(r.output) for r in done])
    assert outs[0] == outs[1]
    assert all(len(o) == 6 and all(0 <= t < cfg.vocab_size for t in o)
               for o in outs[0])


@pytest.fixture
def one_rank_mesh(cuda_device, tmp_path):
    """A one-rank NCCL group (``file://`` rendezvous in ``tmp_path``) and a
    (1, 1) ("data", "model") ``DeviceMesh`` over it; the group is
    destroyed after the test."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-moe-a2.7b"])
def test_mesh_step_on_card_matches_plain(one_rank_mesh, arch):
    """One AdamW step on DTensors laid out by the sharding rules on a
    (1, 1) NCCL mesh = the plain step on the same weights and batch, bit
    for bit (loss, every parameter and moment), the reduced config in
    float32 with TF32 off."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.sharding import (batch_shardings, gather,
                                                  opt_state_shardings,
                                                  param_shardings, place)
    from repro_torch.models import init_params, param_leaves
    from repro_torch.train import adamw, make_train_step
    mesh = one_rank_mesh
    cfg = get_config(arch).reduced()
    params = init_params(cfg, 0, device="cuda")
    batch = SyntheticLM(cfg.vocab_size, 64, 4, seed=3,
                        device="cuda").batch_at(0)
    opt = adamw(1e-3)
    step = make_train_step(cfg, opt)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p1, s1, m1 = step(params, opt.init(params), batch)
        p_sh = param_shardings(cfg, mesh)
        dp1, ds1, dm1 = step(place(params, p_sh),
                             place(opt.init(params),
                                   opt_state_shardings(p_sh, mesh)),
                             place(batch, batch_shardings(mesh, batch)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    assert_bits(gather({"l": dm1["loss"]})["l"], m1["loss"])
    full_p, full_s = gather(dp1), gather(ds1)
    for got, want in ((full_p, p1), (full_s.mu, s1.mu), (full_s.nu, s1.nu)):
        for (path, g), (_, w) in zip(param_leaves(got), param_leaves(want)):
            assert g.device.type == "cuda", path
            assert_bits(g, w)


def test_sharded_checkpoint_round_trip_on_card(one_rank_mesh, tmp_path):
    """A tree of CUDA DTensors saved sharded (one file a distinct shard)
    restores bit for bit onto the plain CUDA tree and back onto the
    mesh by the rules."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (gather, param_shardings,
                                                  place)
    from repro_torch.models import init_params, param_leaves
    from repro_torch.train import Checkpointer
    mesh = one_rank_mesh
    cfg = get_config("gemma2-2b").reduced()
    params = init_params(cfg, 1, device="cuda")
    p_sh = param_shardings(cfg, mesh)
    ck = Checkpointer(str(tmp_path / "ck"), keep=1)
    ck.save(7, {"params": place(params, p_sh)})
    step, plain = ck.restore({"params": params})
    step2, sharded = ck.restore({"params": params},
                                shardings={"params": p_sh})
    assert step == step2 == 7
    for (path, w), (_, a), (_, b) in zip(param_leaves(params),
                                         param_leaves(plain["params"]),
                                         param_leaves(gather(
                                             sharded["params"]))):
        assert type(a) is torch.Tensor and a.device.type == "cuda", path
        assert_bits(a, w)
        assert_bits(b, w)
