"""The port's batched matrix-product kernel (``kernels/matrix_sketch``) on
the CPU, where its wrapper runs the plain version, against the
reference's oracle (``repro.kernels.matrix_products_ref``) and its Pallas
kernel in interpret mode, on the same bucketized inputs; and the layout
and bucketized path around it (``bucketize_matrix_sketches``,
``matrix_slot_probs``, ``engine.bucketized_products``).

Estimates within the float32 summation tolerance of ``_torch_common``;
layouts bit for bit."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_common import assert_bits, assert_close, to_np
from _torch_common import release_jax_executables  # noqa: F401

from repro.kernels import (bucketize_matrix_sketches as j_bucketize,
                           matrix_products_ref as j_products_ref,
                           matrix_slot_probs as j_slot_probs)
from repro.kernels.matrix_sketch.matrix_sketch import matrix_products_pallas
import repro.matrix as jm

import repro_torch.kernels as tk
from repro_torch.engine import bucketized_products
from repro_torch.engine.containers import BucketizedPayloads
from repro_torch.kernels.matrix_sketch import matrix_products_ref
import repro_torch.matrix as tm
from repro_torch.matrix import stack_matrix_sketches

from test_torch_matrix import make_matrix_pair, t_sketch

INVALID = np.iinfo(np.int32).max


def _stack_j(mats, m, seed=5):
    return jm.stack_matrix_sketches(
        [jm.priority_matrix_sketch(jnp.asarray(X), m, seed) for X in mats])


def _inputs(a_mats, b_mats, *, m=64, n_buckets=128, slots=4, pad_pair=False):
    """Reference-bucketized (idx, rows, p) triples of both sides as numpy;
    with ``pad_pair`` the last pair's A side is a padding sketch (all
    INVALID, tau = 1) as the store's unused rows are."""
    SA, SB = _stack_j(a_mats, m), _stack_j(b_mats, m)
    if pad_pair:
        SA = jm.MatrixSketch(SA.row_idx.at[-1].set(INVALID),
                             SA.rows.at[-1].set(0.0), SA.tau.at[-1].set(1.0))
    out = []
    for S in (SA, SB):
        bc = j_bucketize(S, n_buckets=n_buckets, slots=slots)
        out.append((np.array(bc.idx), np.array(bc.rows),
                    np.array(j_slot_probs(bc)), np.array(bc.dropped)))
    return out


def _check_against_reference(a, b):
    (ai, ar, ap, _), (bi, br, bp, _) = a, b
    got = tk.matrix_products(*(torch.as_tensor(x)
                               for x in (ai, ar, ap, bi, br, bp)))
    ref = j_products_ref(*(jnp.asarray(x) for x in (ai, ar, ap, bi, br, bp)))
    pal = matrix_products_pallas(*(jnp.asarray(x)
                                   for x in (ai, ar, ap, bi, br, bp)),
                                 interpret=True)
    assert got.shape == (ai.shape[0], ar.shape[-1], br.shape[-1])
    assert_close(got, ref)
    assert_close(got, pal)
    return got


def _mats(rng, P, n, d, overlap=0.5):
    pairs = [make_matrix_pair(rng, n=n, d=d, overlap=overlap)
             for _ in range(P)]
    return [a for a, _ in pairs], [b for _, b in pairs]


@pytest.mark.parametrize("slots", [2, 3, 4])
def test_plain_version_matches_reference(slots):
    rng = np.random.default_rng(slots)
    A, B = _mats(rng, 4, 600, 6)
    _check_against_reference(*_inputs(A, B, slots=slots))


def test_plain_version_unequal_widths_padding_pair_and_inf_tau():
    """d_a = 8 against d_b = 3; the last A side a padding sketch (its
    products must be 0); one pair with fewer nonzero rows than m, so
    tau = inf and every row is kept."""
    rng = np.random.default_rng(7)
    A = [make_matrix_pair(rng, n=500, d=8)[0] for _ in range(3)]
    B = [make_matrix_pair(rng, n=500, d=3)[1] for _ in range(3)]
    A[1][40:] = 0.0                       # 40 nonzero rows < m = 64
    B[1][:] = 0.0
    B[1][:50] = rng.standard_normal((50, 3)).astype(np.float32)
    a, b = _inputs(A, B, pad_pair=True)
    got = _check_against_reference(a, b)
    assert np.all(to_np(got[-1]) == 0.0)
    sa = jm.priority_matrix_sketch(jnp.asarray(A[1]), 64, 5)
    assert float(sa.tau) == np.inf
    # everything of A[1] kept and B[1] kept: the estimate is exact
    np.testing.assert_allclose(to_np(got[1]), A[1].T @ B[1], rtol=1e-4,
                               atol=1e-4)


def test_plain_version_with_bucket_drops():
    """16 buckets x 4 slots for 64-row sketches: the layout drops rows,
    the kernel estimates what the layout holds."""
    rng = np.random.default_rng(8)
    A, B = _mats(rng, 3, 800, 5, overlap=1.0)
    a, b = _inputs(A, B, n_buckets=16)
    assert a[3].sum() > 0 and b[3].sum() > 0
    _check_against_reference(a, b)


def test_query_side_broadcast_equals_copies():
    """A leading dim of 1 on the A side (one query against every pair's B
    side) gives the same bits as the query copied P times."""
    rng = np.random.default_rng(9)
    A, B = _mats(rng, 5, 600, 4)
    (ai, ar, ap, _), (bi, br, bp, _) = _inputs(A, B)
    q = [torch.as_tensor(x[:1]) for x in (ai, ar, ap)]
    rest = [torch.as_tensor(x) for x in (bi, br, bp)]
    got = tk.matrix_products(*q, *rest)
    copies = tk.matrix_products(*(x.expand(5, *x.shape[1:]).contiguous()
                                  for x in q), *rest)
    assert_bits(got, copies)


def test_bucketize_and_slot_probs_against_reference():
    rng = np.random.default_rng(10)
    A, _ = _mats(rng, 4, 700, 8)
    SJ = _stack_j(A, 96)
    ST = stack_matrix_sketches([t_sketch(jm.MatrixSketch(i, r, t))
                                for i, r, t in zip(SJ.row_idx, SJ.rows,
                                                   SJ.tau)])
    for nb, slots in ((256, 4), (16, 2)):
        got = tk.bucketize_matrix_sketches(ST, n_buckets=nb, slots=slots)
        ref = j_bucketize(SJ, n_buckets=nb, slots=slots)
        for g, r in zip(got, ref):
            assert_bits(g, r)
        p = tk.matrix_slot_probs(got)
        assert_close(p, j_slot_probs(ref))
        pad = to_np(got.idx) == INVALID
        assert np.all(to_np(p)[pad] == 1.0)
        assert np.all((to_np(p)[~pad] > 0) & (to_np(p)[~pad] <= 1.0))
    kept = int((to_np(got.idx) != INVALID).sum())
    assert int(to_np(got.dropped).sum()) > 0
    assert kept + int(to_np(got.dropped).sum()) == int(to_np(ST.size()).sum())
    # one (cap, d) sketch lifts to P = 1
    one = tk.bucketize_matrix_sketches(tm.MatrixSketch(*(x[0] for x in ST)))
    assert one.idx.shape == (1, 512, 4)


def test_bucketized_estimate_equals_sorted_where_no_drop():
    rng = np.random.default_rng(11)
    A, B = _mats(rng, 6, 1024, 8)
    sas = [tm.priority_matrix_sketch(torch.as_tensor(X), 96, 5) for X in A]
    sbs = [tm.priority_matrix_sketch(torch.as_tensor(X), 96, 5) for X in B]
    BA = tk.bucketize_matrix_sketches(stack_matrix_sketches(sas))
    BB = tk.bucketize_matrix_sketches(stack_matrix_sketches(sbs))
    clean = (to_np(BA.dropped) == 0) & (to_np(BB.dropped) == 0)
    assert clean.sum() >= 4
    est = tk.matrix_products_bucketized(BA, BB)
    for p in np.flatnonzero(clean):
        assert_close(est[p], tm.estimate_matrix_product(sas[p], sbs[p]))


def test_bucketized_products_layouts_and_d1():
    rng = np.random.default_rng(12)
    A, B = _mats(rng, 2, 400, 4)
    SA = stack_matrix_sketches([tm.priority_matrix_sketch(
        torch.as_tensor(X), 32, 5) for X in A])
    SB = stack_matrix_sketches([tm.priority_matrix_sketch(
        torch.as_tensor(X), 32, 5) for X in B])
    BA = tk.bucketize_matrix_sketches(SA, n_buckets=64)
    BB = tk.bucketize_matrix_sketches(SB, n_buckets=32)
    with pytest.raises(ValueError, match="layouts"):
        tk.matrix_products_bucketized(BA, BB)
    # d = 1 payloads: (P, 1, 1) inner-product estimates
    one = BucketizedPayloads(BA.idx, BA.rows[..., :1].contiguous(), BA.tau,
                             BA.dropped)
    out = bucketized_products(one, one)
    assert out.shape == (2, 1, 1)
    ref = matrix_products_ref(one.idx, one.payload,
                              tk.matrix_slot_probs(tk.BucketizedMatrixSketch(
                                  *one)), one.idx, one.payload,
                              tk.matrix_slot_probs(tk.BucketizedMatrixSketch(
                                  *one)))
    assert_bits(out, ref)


def test_shared_memory_layout_follows_d_only():
    """A block stages whole matched rows, one at least: the wrapper's limit
    grows with d_a + d_b and not with the buckets or slots."""
    from repro_torch.kernels.matrix_sketch import matrix_sketch as ms
    assert ms.smem_bytes(512, 4, 16, 16) == ms.MAX_SLOT_BYTES + 128
    assert ms.smem_bytes(16384, 4, 4, 4) == ms.smem_bytes(1, 1, 4, 4)
    widest = (ms.SMEM_BYTES - ms.MAX_SLOT_BYTES) // 8
    assert ms.smem_bytes(1, 1, widest, widest) <= ms.SMEM_BYTES
    assert ms.smem_bytes(1, 1, widest + 1, widest + 1) > ms.SMEM_BYTES
