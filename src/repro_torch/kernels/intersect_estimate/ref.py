"""Plain PyTorch versions of the bucketized intersection estimators.

Same arithmetic as the CUDA kernels and as ``repro.kernels
.intersect_estimate.ref``: the query estimator uses the divide form
``q*c / min(pq, pc)``, the all-pairs estimator the reciprocal-max form
``va*vb*max(1/pa, 1/pb)`` with padding remapped to -1 / -2 (the two are not
bit-identical).  ``ct`` chunks the corpus side of the all-pairs version so
its intermediates are (D1, ct, B), not (D1, D2, B).
"""
from __future__ import annotations

import torch

from repro_torch.core.sketches import INVALID_IDX

MOMENT_CHANNELS = ("n", "sum_x", "sum_y", "xy", "sum_x2", "sum_y2")


def intersect_estimate_ref(q_idx, q_val, q_tau, c_idx, c_val, c_tau
                           ) -> torch.Tensor:
    """(B, S) query vs (C, B, S) corpus -> (C,) estimates."""
    qv = q_val.to(torch.float32)
    cv = c_val.to(torch.float32)
    pq = torch.clamp(q_tau * (qv * qv), max=1.0)                  # (B, S)
    pc = torch.clamp(c_tau.reshape(-1, 1, 1) * (cv * cv), max=1.0)
    # (C, B, Sq, Sc) equality of query slot sq with corpus slot sc
    eq = ((q_idx[None, :, :, None] == c_idx[:, :, None, :])
          & (q_idx != INVALID_IDX)[None, :, :, None])
    p = torch.minimum(pq[None, :, :, None], pc[:, :, None, :])
    p = torch.where(eq, p, torch.ones_like(p))
    terms = qv[None, :, :, None] * cv[:, :, None, :] / p
    terms = torch.where(eq, terms, torch.zeros_like(terms))
    return terms.sum(dim=(1, 2, 3))


def _allpairs_block(a_idx, av, ar, b_idx, bv, br, moments: bool):
    D1, B, S = a_idx.shape
    D2 = b_idx.shape[0]
    n_ch = len(MOMENT_CHANNELS) if moments else 1
    acc = [torch.zeros((D1, D2), dtype=torch.float32, device=av.device)
           for _ in range(n_ch)]
    for sq in range(S):
        ai = a_idx[:, :, sq][:, None, :]                          # (D1, 1, B)
        va = av[:, :, sq][:, None, :]
        ra = ar[:, :, sq][:, None, :]
        for sc in range(S):
            bi = b_idx[:, :, sc][None, :, :]                      # (1, D2, B)
            vb = bv[:, :, sc][None, :, :]
            rb = br[:, :, sc][None, :, :]
            eq = ai == bi                                         # (D1, D2, B)
            if moments:
                inv = torch.where(eq, torch.maximum(ra, rb),
                                  torch.zeros((), device=av.device))
                acc[0] += inv.sum(dim=2)
                acc[1] += (va * inv).sum(dim=2)
                acc[2] += (vb * inv).sum(dim=2)
                acc[3] += (va * vb * inv).sum(dim=2)
                acc[4] += (va * va * inv).sum(dim=2)
                acc[5] += (vb * vb * inv).sum(dim=2)
            else:
                terms = va * vb * torch.maximum(ra, rb)
                acc[0] += torch.where(eq, terms,
                                      torch.zeros((), device=av.device)
                                      ).sum(dim=2)
    return torch.stack(acc, dim=-1) if moments else acc[0]


def allpairs_estimate_ref(a_idx, a_val, a_p, b_idx, b_val, b_p, *,
                          moments: bool = False,
                          ct: int | None = None) -> torch.Tensor:
    """(D1, B, S) x (D2, B, S) corpora with per-slot inclusion
    probabilities -> (D1, D2) estimates, or (D1, D2, 6) co-moment channels
    (``MOMENT_CHANNELS`` order) when ``moments``.  ``ct`` chunks D2."""
    av = a_val.to(torch.float32)
    bv = b_val.to(torch.float32)
    ar = 1.0 / a_p
    br = 1.0 / b_p
    a_idx = torch.where(a_idx == INVALID_IDX, -1, a_idx)
    b_idx = torch.where(b_idx == INVALID_IDX, -2, b_idx)
    D2 = b_idx.shape[0]
    ct = D2 if not ct else ct
    return torch.cat([_allpairs_block(a_idx, av, ar, b_idx[j:j + ct],
                                      bv[j:j + ct], br[j:j + ct], moments)
                      for j in range(0, D2, ct)], dim=1)


# rows of a tile of the compacted all-pairs layout (and of the join's
# output tiles)
COMPACT_TILE = 64


def allpairs_compact_ref(idx, val, p, rows=None):
    """The all-pairs kernel's compacted layout of one (D, B, S) corpus.

    For each tile of ``COMPACT_TILE`` rows and each bucket, the occupied
    slots (``idx != INVALID_IDX``) of those rows in (id, row, slot) order,
    as int32 quadruples (id, row in the tile + 256 x the number of entries
    with this id in the list, bits of v, bits of 1/p), then zeros.  Returns (entries (T, B, tile*S, 4) int32, counts (T, B)
    int32), T = ceil(D / tile).  With ``rows`` (a (T * tile,) integer row
    list) tile t holds the rows ``rows[t * tile:(t + 1) * tile]`` instead,
    an id outside [0, D) (-1) an empty row: the compaction of those rows
    gathered."""
    if rows is not None:
        D, B, S = idx.shape
        r = torch.as_tensor(rows, device=idx.device).to(torch.int64)
        r = torch.where((r >= 0) & (r < D), r, D)     # D: the empty row
        idx = torch.cat([idx, idx.new_full((1, B, S), INVALID_IDX)])[r]
        val = torch.cat([val, val.new_zeros((1, B, S))])[r]
        p = torch.cat([p, p.new_ones((1, B, S))])[r]
    tile = COMPACT_TILE
    D, B, S = idx.shape
    T = -(-D // tile)
    pad = T * tile - D
    dev = idx.device
    if pad:
        idx = torch.cat([idx, torch.full((pad, B, S), INVALID_IDX,
                                         dtype=idx.dtype, device=dev)])
        val = torch.cat([val, val.new_zeros((pad, B, S))])
        p = torch.cat([p, p.new_ones((pad, B, S))])

    def lay(x):          # (T*tile, B, S) -> (T, B, tile*S), (row, slot) order
        return x.reshape(T, tile, B, S).permute(0, 2, 1, 3).reshape(
            T, B, tile * S)

    i4 = lay(idx.to(torch.int32))
    valid = i4 != INVALID_IDX
    counts = valid.sum(dim=-1).to(torch.int32)
    rows = (torch.arange(tile * S, device=dev, dtype=torch.int32) // S
            ).expand(T, B, -1)
    fields = torch.stack([
        i4, rows, lay(val.to(torch.float32)).view(torch.int32),
        (1.0 / lay(p.to(torch.float32))).view(torch.int32)], dim=-1)
    # occupied slots by id, ties in (row, slot) order; padding last
    key = torch.where(valid, i4.to(torch.int64), 1 << 32)
    order = torch.argsort(key, dim=-1, stable=True)
    out = torch.gather(fields, 2, order[..., None].expand(-1, -1, -1, 4))
    pos = torch.arange(tile * S, device=dev)
    used = pos[None, None, :] < counts[..., None]
    # each entry's run of equal ids in the sorted list: from the last run
    # start at or before it to the first run end at or after it
    ids = out[..., 0]
    new = torch.ones_like(used)
    new[..., 1:] = ids[..., 1:] != ids[..., :-1]
    end = torch.ones_like(used)
    end[..., :-1] = new[..., 1:]
    start = torch.cummax(torch.where(new, pos, 0), dim=-1).values
    stop = torch.flip(torch.cummin(torch.flip(
        torch.where(end, pos, tile * S), [-1]), dim=-1).values, [-1])
    out[..., 1] += 256 * (stop - start + 1).to(torch.int32)
    return torch.where(used[..., None], out, torch.zeros_like(out)), counts


def allpairs_join_ref(a_entries, a_counts, b_entries, b_counts, D1: int,
                      D2: int, *, moments: bool = False) -> torch.Tensor:
    """The join of two compacted corpora (:func:`allpairs_compact_ref`):
    every pair of entries with the same bucket and id adds
    ``va * vb * max(1/pa, 1/pb)`` (or the six moment terms) to its cell.
    -> (D1, D2), or (D1, D2, 6) when ``moments``."""
    def flat(entries, counts):
        cap = entries.shape[2]
        used = (torch.arange(cap, device=entries.device)[None, None, :]
                < counts[..., None])
        t, b, j = used.nonzero(as_tuple=True)
        e = entries[t, b, j]
        return (b, e[:, 0], t * COMPACT_TILE + e[:, 1] % 256,
                e[:, 2].contiguous().view(torch.float32),
                e[:, 3].contiguous().view(torch.float32))

    ba, ida, ra, va, rca = flat(a_entries, a_counts)
    bb, idb, rb, vb, rcb = flat(b_entries, b_counts)
    ia, ib = ((ba[:, None] == bb[None, :])
              & (ida[:, None] == idb[None, :])).nonzero(as_tuple=True)
    va, vb = va[ia], vb[ib]
    inv = torch.maximum(rca[ia], rcb[ib])
    if moments:
        terms = torch.stack([inv, va * inv, vb * inv, va * vb * inv,
                             va * va * inv, vb * vb * inv], dim=-1)
    else:
        terms = (va * vb * inv)[:, None]
    out = torch.zeros((D1 * D2, terms.shape[1]), dtype=torch.float32,
                      device=terms.device)
    out.index_add_(0, (ra[ia] * D2 + rb[ib]).to(torch.int64), terms)
    return out.reshape(D1, D2, -1) if moments else out.reshape(D1, D2)


def allpairs_join_tiles_ref(a_entries, a_counts, b_entries, b_counts, pairs
                            ) -> torch.Tensor:
    """The tile-list join: for each listed pair ``(ta, tb)`` (an (N, 2)
    integer tensor) the (64, 64) tile of the join of compacted tile ``ta``
    of the A side with tile ``tb`` of the B side (zeros for a pair outside
    the tiles) -> (N, 64, 64).  A sort-merge join of (pair, bucket, id)
    keys: each A entry's run of equal keys on the B side, its pairs added
    to their cells with ``index_add_``."""
    tile = COMPACT_TILE
    dev = a_entries.device
    pairs = torch.as_tensor(pairs, device=dev).to(torch.int64).reshape(-1, 2)
    N = pairs.shape[0]
    out = torch.zeros((N * tile * tile,), dtype=torch.float32, device=dev)

    def flat(entries, counts, t):
        T, B, cap, _ = entries.shape
        ok = (t >= 0) & (t < T)
        tt = torch.where(ok, t, 0)
        used = ((torch.arange(cap, device=dev)[None, None, :]
                 < counts[tt][..., None]) & ok[:, None, None])
        n, b, j = used.nonzero(as_tuple=True)
        e = entries[tt[n], b, j]
        # keys ascend: (pair, bucket) major, each bucket's ids sorted
        key = (n * B + b) * (1 << 31) + e[:, 0].to(torch.int64)
        return (key, n, e[:, 1] % 256, e[:, 2].contiguous().view(torch.float32),
                e[:, 3].contiguous().view(torch.float32))

    ka, na, ra, va, rca = flat(a_entries, a_counts, pairs[:, 0])
    kb, _, rb, vb, rcb = flat(b_entries, b_counts, pairs[:, 1])
    lo = torch.searchsorted(kb, ka, side="left")
    run = torch.searchsorted(kb, ka, side="right") - lo
    ia = torch.repeat_interleave(torch.arange(ka.numel(), device=dev), run)
    start = torch.cumsum(run, 0) - run
    ib = lo[ia] + torch.arange(ia.numel(), device=dev) - start[ia]
    terms = va[ia] * vb[ib] * torch.maximum(rca[ia], rcb[ib])
    cell = (na[ia] * tile + ra[ia]) * tile + rb[ib]
    out.index_add_(0, cell.to(torch.int64), terms)
    return out.reshape(N, tile, tile)
