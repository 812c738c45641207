#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one CUDA card.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one card, ``nvcc`` and
``nvidia-smi``; it builds the port's CUDA kernels from
``src/repro_torch/csrc`` and imports nothing of JAX or of the JAX package.
Phases, each printing one JSON line (any failure raises and the script
exits nonzero with no result line):

1. ``device``    the card, its count, name and power limit;
2. ``build``     one ``nvcc`` per source, started together;
3. ``parity``    each kernel against its plain PyTorch version on the card,
                 at the main path's shapes (build and merge kernels bit for
                 bit, estimators within float32 summation tolerance);
4. ``main_path`` ``SketchIndex`` at its published widths (m=256,
                 n_buckets=512, slots=4, seed=11): 4032 vectors over
                 n=65536 with 2000 nonzeros each through ``add_many`` in
                 512-row blocks, 64 sparse ``add`` calls (D=4096), 256
                 planted near-duplicate queries (top-1 must be the
                 source), the quickstart's asserts, one ``all_pairs``
                 checked against ``query`` rows and exact squared norms;
5. ``threshold_path`` the same 4096 x 65536 corpus through
                 ``sketch_corpus(method="threshold", backend="kernel")`` in
                 512-row blocks, each bit-equal to the build on the
                 kernels' plain versions; mean size within 2% of m; every
                 row's self-estimate within 8/sqrt(m); the partitioned
                 build (P=4) against the one-shot build; the quickstart;
6. ``merge_path`` two more indexes ingest the corpus split by coordinate
                 at n/2 and ``merge_from`` folds one into the other: bit-equal
                 blocks, queries and ``all_pairs`` to the main path's index
                 on every row where neither partition dropped an entry;
7. ``timing``    end-to-end and per-kernel CUDA-event times with each
                 kernel's bound, and the per-step split of ``add_many``,
                 ``query`` and ``merge_from``;
8. ``kernels``   one line per the port's kernel table.

Each path (4-6) zeroes every kernel's launch counter before it runs and
reads them after; each of its kernels must have launched.

The last lines are ``nvidia-smi``'s name and power limit and then
``{"ok": true, "device": {...}}``.
"""
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM published peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12        # CUDA cores, outside the tensor cores
RTOL = 2e-5                   # estimates: float32 sums in another order

M, N_BUCKETS, SLOTS, SEED = 256, 512, 4, 11
N, NNZ, D_BATCH, D_SPARSE, BLOCK_ROWS = 65536, 2000, 4032, 64, 512
N_QUERIES = 256
CAP = 320                     # payload_capacity(256): threshold capacity
PARTITIONS = 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def max_abs_err(got, ref) -> float:
    g, r = got.double(), ref.double()
    fin = torch.isfinite(r)
    check(bool(torch.equal(torch.isfinite(g), fin)), "finite masks differ")
    check(bool(torch.equal(g[~fin], r[~fin])), "non-finite values differ")
    return float((g[fin] - r[fin]).abs().max()) if bool(fin.any()) else 0.0


def assert_bits(got, ref, what: str) -> float:
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{what}: {got.dtype} {tuple(got.shape)} vs "
          f"{ref.dtype} {tuple(ref.shape)}")
    view = torch.int32 if got.element_size() == 4 else got.dtype
    ok = torch.equal(got.contiguous().view(view), ref.contiguous().view(view))
    check(ok, f"{what}: kernel and plain version differ in bits")
    return 0.0


def assert_close(got, ref, what: str) -> float:
    err = max_abs_err(got, ref)
    r = ref.double()
    fin = torch.isfinite(r)
    scale = max(1.0, float(r[fin].abs().max())) if bool(fin.any()) else 1.0
    ok = bool(((got.double() - r).abs()[fin]
               <= 2e-5 * scale + RTOL * r.abs()[fin]).all())
    check(ok, f"{what}: max abs err {err} beyond rtol={RTOL}, "
          f"atol={2e-5 * scale}")
    return err


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def make_data(rng):
    """The main path's vectors as (indices, values), U(-1, 1) on 2000
    random coordinates of 65536 (as ``examples/serve_sketch_index.py``)."""
    total = D_BATCH + D_SPARSE
    idx = np.empty((total, NNZ), np.int64)
    for d in range(total):
        idx[d] = np.sort(rng.choice(N, NNZ, replace=False))
    val = rng.uniform(-1, 1, (total, NNZ)).astype(np.float32)
    return idx, val


def dense_rows(idx, val, rows) -> np.ndarray:
    out = np.zeros((len(rows), N), np.float32)
    np.put_along_axis(out, idx[list(rows)], val[list(rows)], axis=1)
    return out


def run_path(kernels, fn):
    """Zero every launch counter, run one path, read the counters."""
    for k in kernels:
        k.launches = 0
    out = fn()
    return out, {k.__name__: k.launches for k in kernels}


def quiet(fn, *args, **kw):
    """Call ``fn`` with its printed lines kept off this script's output."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {os.path.basename(__file__)}: "
             "run from the root of a checkout")
    sys.path.insert(0, SRC)
    from repro_torch import quickstart
    from repro_torch.kernels import _build
    import repro_torch.kernels as tk
    from repro_torch.core import (INVALID_IDX, Sketch, estimate_inner_product,
                                  hash_unit, priority_sketch, sketch_corpus,
                                  weight)
    from repro_torch.distributed import partitioned_sketch_corpus
    from repro_torch.kernels.hash_rank import (hash_rank_batched_ref,
                                               hash_rank_ref)
    from repro_torch.kernels.intersect_estimate import (
        allpairs_estimate_ref, intersect_estimate_ref)
    from repro_torch.kernels.sketch_build import (hash_rank_hist_ref,
                                                  rank_hist_ref)
    from repro_torch.kernels.sketch_merge import merge_bucketized_ref
    from repro_torch.serve import SketchIndex
    from repro_torch.serve.validation import check_finite, check_vector

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    smi_line = smi.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ----------------------------------------------------------------- build
    t0 = time.perf_counter()
    logs = _build.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln] for k, v in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.BUILD_SECONDS, "ptxas": ptxas})

    # ---------------------------------------------------------------- parity
    err = {}
    gen = torch.Generator(device=dev).manual_seed(1234)

    def rand_block(rows, n):
        v = torch.rand((rows, n), generator=gen, device=dev) * 2 - 1
        keep = torch.rand((rows, n), generator=gen, device=dev) < NNZ / N
        return torch.where(keep, v, torch.zeros((), device=dev))

    traps = torch.tensor([1e-20, -1e-20, 1e-40, 1.1e-19, 1e19, -1e19, 1e20,
                          3e18], device=dev)

    def with_traps(x):
        pick = torch.rand(x.shape, generator=gen, device=dev) < 0.01
        return torch.where(pick, traps[torch.randint(
            0, len(traps), x.shape, generator=gen, device=dev)], x)

    blk = rand_block(BLOCK_ROWS, N)
    got = tk.hash_rank_hist(blk, SEED)
    ref = hash_rank_hist_ref(blk, SEED)
    for g, r, what in zip(got, ref, ("h", "rank", "hist")):
        assert_bits(g, r, f"hash_rank_hist {what}")
    for g, r, what in zip(tk.hash_rank_batched(blk, SEED),
                          hash_rank_batched_ref(blk, SEED), ("h", "rank")):
        assert_bits(g, r, f"hash_rank_batched {what}")
    ragged = with_traps(rand_block(BLOCK_ROWS, N + 77))
    for variant in ("l2", "l1", "uniform"):
        got = tk.hash_rank_hist(ragged, SEED, variant=variant)
        ref = hash_rank_hist_ref(ragged, SEED, variant=variant)
        for g, r, what in zip(got, ref, ("h", "rank", "hist")):
            assert_bits(g, r, f"hash_rank_hist {variant} ragged {what}")
        for g, r, what in zip(
                tk.hash_rank_batched(ragged, SEED, variant=variant),
                hash_rank_batched_ref(ragged, SEED, variant=variant),
                ("h", "rank")):
            assert_bits(g, r, f"hash_rank_batched {variant} ragged {what}")
    err["hash_rank_hist"] = 0.0
    err["hash_rank_batched"] = 0.0
    vec = with_traps(rand_block(1, 100_000)[0])
    for variant in ("l2", "l1", "uniform"):
        for g, r, what in zip(tk.hash_rank(vec, SEED, variant=variant),
                              hash_rank_ref(vec, SEED, variant=variant),
                              ("h", "rank")):
            assert_bits(g, r, f"hash_rank {variant} n=100000 {what}")
    err["hash_rank"] = 0.0
    _, rank_l2, hist0_l2 = tk.hash_rank_hist(ragged, SEED)
    kth = tk.kth_smallest_ranks(rank_l2, M + 1, hist0=hist0_l2)
    assert_bits(kth, torch.kthvalue(rank_l2, M + 1, dim=1).values,
                "kth_smallest_ranks vs torch.kthvalue")
    bits = kth.view(torch.int32).to(torch.int64)
    for shift in (24, 16, 8, 0):
        prefix = ((bits >> (shift + 8)) if shift < 24
                  else torch.zeros_like(bits)).to(torch.int32)
        assert_bits(tk.rank_hist(rank_l2, prefix, shift=shift),
                    rank_hist_ref(rank_l2, prefix, shift=shift),
                    f"rank_hist shift {shift}")
    err["rank_hist"] = 0.0
    del rank_l2, hist0_l2

    corpus_blocks = [tk.bucketize_corpus(
        tk.build_priority_corpus(rand_block(BLOCK_ROWS, N), M, SEED,
                                 device=dev),
        n_buckets=N_BUCKETS, slots=SLOTS) for _ in range(8)]
    pc = tk.BucketizedSketch(*(torch.cat(parts) for parts in
                               zip(*corpus_blocks)))
    q = tk.BucketizedSketch(*(x[17] for x in pc))
    err["intersect_estimate"] = assert_close(
        tk.intersect_estimate(q.idx, q.val, q.tau, pc.idx, pc.val, pc.tau),
        intersect_estimate_ref(q.idx, q.val, q.tau, pc.idx, pc.val, pc.tau),
        "intersect_estimate C=4096")
    sub = tk.BucketizedSketch(*(x[:512] for x in pc))
    p_sub = tk.slot_inclusion_probs(sub)
    e_plain = assert_close(
        tk.allpairs_estimate(sub.idx, sub.val, p_sub, sub.idx, sub.val,
                             p_sub),
        allpairs_estimate_ref(sub.idx, sub.val, p_sub, sub.idx, sub.val,
                              p_sub, ct=64), "allpairs_estimate 512x512")
    got_m = tk.allpairs_estimate(sub.idx, sub.val, p_sub, sub.idx, sub.val,
                                 p_sub, moments=True)
    ref_m = allpairs_estimate_ref(sub.idx, sub.val, p_sub, sub.idx, sub.val,
                                  p_sub, moments=True, ct=64)
    e_mom = max(assert_close(got_m[..., c], ref_m[..., c],
                             f"allpairs moments channel {c}")
                for c in range(6))
    err["allpairs_estimate"] = max(e_plain, e_mom)
    del corpus_blocks, pc, sub, got_m, ref_m

    # B6 on two half-partition corpora of one block, and with 16 buckets,
    # where the merge itself overflows (m = 64 there, as the reference's
    # test has it: 16 x 4 slots a side must hold more than m/2 candidates
    # for the merged tau to exist)
    half = torch.rand(N, generator=gen, device=dev) < 0.5
    merge_drops = {}
    for nb, m in ((N_BUCKETS, M), (16, 64)):
        lo, hi = (tk.bucketize_corpus(tk.build_priority_corpus(
            torch.where(side, blk, torch.zeros((), device=dev)), m, SEED,
            device=dev), n_buckets=nb, slots=SLOTS) for side in (half, ~half))
        tau = tk.merged_tau_bucketized(lo, hi, SEED, m=m)
        got = tk.merge_bucketized(lo.idx, lo.val, hi.idx, hi.val, tau, SEED)
        ref = merge_bucketized_ref(lo.idx, lo.val, hi.idx, hi.val, tau, SEED)
        for g, r, what in zip(got, ref, ("idx", "val", "dropped")):
            assert_bits(g, r, f"merge_bucketized n_buckets={nb} {what}")
        merge_drops[nb] = int(got[2].sum())
    check(merge_drops[16] > 0, "the n_buckets=16 merge dropped nothing")
    err["merge_bucketized"] = 0.0
    del lo, hi, got, ref
    emit({"phase": "parity", "max_abs_err": err,
          "build_kernels": "bit-equal", "merge_kernel": "bit-equal",
          "merge_dropped": merge_drops, "estimators": f"rtol={RTOL}"})

    # ------------------------------------------------------------- main path
    rng = np.random.default_rng(2)
    vidx, vval = make_data(rng)
    D = D_BATCH + D_SPARSE
    names = [f"doc{d:04d}" for d in range(D)]
    sq_norms = (torch.as_tensor(vval, device=dev).double() ** 2).sum(dim=1)
    sources = rng.choice(D, N_QUERIES, replace=False)
    noise = rng.standard_normal((N_QUERIES, NNZ)).astype(np.float32)

    kernels = tk.KERNELS
    launches = {}

    def planted(qi, src):
        qv = np.zeros(N, np.float32)
        qv[vidx[src]] = vval[src] + 0.05 * noise[qi]
        return qv

    def main_path():
        index = SketchIndex(M, n_buckets=N_BUCKETS, slots=SLOTS, seed=SEED,
                            device=dev)
        block_ms = []
        t_ingest = time.perf_counter()
        for lo in range(0, D_BATCH, BLOCK_ROWS):
            rows = list(range(lo, min(lo + BLOCK_ROWS, D_BATCH)))
            block = dense_rows(vidx, vval, rows)
            t0 = time.perf_counter()
            index.add_many([names[r] for r in rows], block)
            block_ms.append((time.perf_counter() - t0) * 1e3)
        for d in range(D_BATCH, D):
            index.add(names[d], indices=vidx[d], values=vval[d])
        ingest_s = time.perf_counter() - t_ingest
        check(len(index) == D and index.capacity == D, "index size/capacity")

        query_ms, hits = [], 0
        for qi, src in enumerate(sources):
            qv = planted(qi, src)
            t0 = time.perf_counter()
            top = index.query(qv, top_k=5)
            query_ms.append((time.perf_counter() - t0) * 1e3)
            hits += top[0][0] == names[src]
        check(hits == N_QUERIES, f"planted top-1 recall {hits}/{N_QUERIES}")

        # the quickstart example's data and asserts, through the kernel
        # builds (raises if an assert fails)
        qs = quiet(quickstart.main, device=dev)

        t0 = time.perf_counter()
        ap = index.all_pairs()
        all_pairs_ms = (time.perf_counter() - t0) * 1e3
        check(ap.shape == (D, D) and bool(np.isfinite(ap).all()),
              "all_pairs shape/finite")
        row_err = 0.0
        for k in rng.choice(D_BATCH, 16, replace=False):
            row = np.array([e for _, e in index.query(
                dense_rows(vidx, vval, [k])[0])])
            row_err = max(row_err, assert_close(
                torch.as_tensor(ap[k]),
                torch.as_tensor(row.astype(np.float32)),
                f"all_pairs row {k} vs query"))
        diag = torch.as_tensor(np.diag(ap).astype(np.float64), device=dev)
        diag_scaled = float(((diag - sq_norms).abs() / sq_norms).max())
        check(diag_scaled < 8.0 / math.sqrt(M),
              f"all_pairs diagonal scaled error {diag_scaled}")
        return dict(index=index, ap=ap, block_ms=block_ms,
                    ingest_s=ingest_s, query_ms=query_ms, hits=hits, qs=qs,
                    all_pairs_ms=all_pairs_ms, row_err=row_err,
                    diag_scaled=diag_scaled)

    mp, launches["main_path"] = run_path(kernels, main_path)
    index, ap = mp["index"], mp["ap"]
    need = ("hash_rank_hist", "rank_hist", "intersect_estimate",
            "allpairs_estimate")
    check(all(launches["main_path"][k] > 0 for k in need),
          f"a kernel of the main path never launched: {launches}")
    emit({"phase": "main_path", "D": D, "n": N, "nnz": NNZ, "m": M,
          "n_buckets": N_BUCKETS, "slots": SLOTS,
          "total_dropped": index.total_dropped,
          "planted_top1": f"{mp['hits']}/{N_QUERIES}",
          "quickstart_scaled_error": mp["qs"]["scaled_error"],
          "quickstart_bound": mp["qs"]["bound"],
          "all_pairs_vs_query_max_abs_err": mp["row_err"],
          "diag_max_scaled_error": mp["diag_scaled"],
          "diag_bound": 8.0 / math.sqrt(M),
          "launches": launches["main_path"]})

    # -------------------------------------------------------- threshold path
    h_all = hash_unit(SEED, torch.arange(N, dtype=torch.int32, device=dev))

    def threshold_path():
        sizes, over, scaled, block_ms = [], 0, [], []
        for lo in range(0, D, BLOCK_ROWS):
            A = torch.as_tensor(dense_rows(vidx, vval,
                                           range(lo, lo + BLOCK_ROWS)),
                                device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sk = sketch_corpus(A, M, SEED, method="threshold",
                               backend="kernel", device=dev)
            torch.cuda.synchronize()
            block_ms.append((time.perf_counter() - t0) * 1e3)
            ref = tk.build_threshold_corpus(A, M, SEED, device=dev,
                                            use_kernel=False)
            for g, r, what in zip(sk, ref, ("idx", "val", "tau")):
                assert_bits(g, r, f"threshold build rows {lo}.. {what}")
            sizes.append((sk.idx != INVALID_IDX).sum(dim=1))
            W = weight(A, "l2")
            include = (W > 0) & (h_all[None] <= sk.tau[:, None] * W)
            over += int((include.sum(dim=1) > CAP).sum())
            self_sk = Sketch(sk.idx, sk.val, sk.tau[:, None])
            est = estimate_inner_product(self_sk, self_sk).double()
            true = (A.double() ** 2).sum(dim=1)
            scaled.append((est - true).abs() / true)
        sizes = torch.cat(sizes).double()
        worst = float(torch.cat(scaled).max())
        mean_size = float(sizes.mean())
        check(abs(mean_size - M) <= 0.02 * M,
              f"threshold mean sketch size {mean_size} not within 2% of {M}")
        check(worst < 8.0 / math.sqrt(M),
              f"threshold self-estimate scaled error {worst}")
        # map-reduce over 4 column slices of one block vs the one-shot build
        A = torch.as_tensor(dense_rows(vidx, vval, range(BLOCK_ROWS)),
                            device=dev)
        tau_rel = 0.0
        for method in ("priority", "threshold"):
            got = partitioned_sketch_corpus(A, M, SEED, method=method,
                                            num_partitions=PARTITIONS,
                                            device=dev)
            want = sketch_corpus(A, M, SEED, method=method, backend="kernel",
                                 device=dev)
            assert_bits(got.idx, want.idx, f"partitioned {method} idx")
            assert_bits(got.val, want.val, f"partitioned {method} val")
            if method == "priority":
                assert_bits(got.tau, want.tau, "partitioned priority tau")
            else:
                rel = ((got.tau.double() - want.tau.double()).abs()
                       / want.tau.double())
                tau_rel = float(rel.max())
                check(tau_rel <= 1e-5,
                      f"partitioned threshold tau rel err {tau_rel}")
        qs = quiet(quickstart.main, device=dev)
        return dict(mean_size=mean_size, size_min=float(sizes.min()),
                    size_max=float(sizes.max()), overflow_rows=over,
                    worst_scaled=worst, block_ms=block_ms, tau_rel=tau_rel,
                    qs=qs)

    tp, launches["threshold_path"] = run_path(kernels, threshold_path)
    need = ("hash_rank_batched", "hash_rank", "rank_hist")
    check(all(launches["threshold_path"][k] > 0 for k in need),
          f"a kernel of the threshold path never launched: {launches}")
    emit({"phase": "threshold_path", "D": D, "n": N, "m": M, "cap": CAP,
          "mean_sketch_size": tp["mean_size"],
          "sketch_size_range": [tp["size_min"], tp["size_max"]],
          "overflow_cut_rows": tp["overflow_rows"],
          "self_estimate_max_scaled_error": tp["worst_scaled"],
          "bound": 8.0 / math.sqrt(M),
          "partitioned_P": PARTITIONS,
          "partitioned_threshold_tau_max_rel_err": tp["tau_rel"],
          "quickstart_threshold_scaled_error":
              tp["qs"]["scaled_error"]["threshold"],
          "quickstart_threshold_size": tp["qs"]["threshold_size"],
          "launches": launches["threshold_path"]})

    # ------------------------------------------------------------ merge path
    def merge_path():
        lo_ix, hi_ix = (SketchIndex(M, n_buckets=N_BUCKETS, slots=SLOTS,
                                    seed=SEED, device=dev) for _ in range(2))
        for lo in range(0, D_BATCH, BLOCK_ROWS):
            rows = list(range(lo, min(lo + BLOCK_ROWS, D_BATCH)))
            block = dense_rows(vidx, vval, rows)
            low = block.copy()
            low[:, N // 2:] = 0.0
            block[:, :N // 2] = 0.0
            lo_ix.add_many([names[r] for r in rows], low)
            hi_ix.add_many([names[r] for r in rows], block)
        for d in range(D_BATCH, D):
            side = vidx[d] < N // 2
            lo_ix.add(names[d], indices=vidx[d][side], values=vval[d][side])
            hi_ix.add(names[d], indices=vidx[d][~side],
                      values=vval[d][~side])
        pre = {k: getattr(lo_ix, k)[:D].copy()
               for k in ("_idx", "_val", "_tau", "_dropped", "_head_idx",
                         "_head_val")}
        clean = (lo_ix._dropped[:D] == 0) & (hi_ix._dropped[:D] == 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lo_ix.merge_from(hi_ix)
        merge_ms = (time.perf_counter() - t0) * 1e3
        rows = np.flatnonzero(clean)
        for k in ("_idx", "_val", "_tau", "_dropped"):
            assert_bits(torch.as_tensor(getattr(lo_ix, k)[rows]),
                        torch.as_tensor(getattr(index, k)[rows]),
                        f"merged index {k} on rows no partition dropped")
        for qi, src in enumerate(sources):
            qv = planted(qi, src)
            got = np.array([e for _, e in lo_ix.query(qv)])[rows]
            want = np.array([e for _, e in index.query(qv)])[rows]
            check(bool(np.array_equal(got, want)),
                  f"merged index query {qi} differs on equal rows")
        ap_m = lo_ix.all_pairs()
        check(bool(np.array_equal(ap_m[np.ix_(rows, rows)],
                                  ap[np.ix_(rows, rows)])),
              "merged index all_pairs differs on equal rows")
        return dict(other_rows=int(D - rows.size), merge_ms=merge_ms,
                    pre=pre, hi=hi_ix, dropped=index.total_dropped,
                    merged_dropped=lo_ix.total_dropped)

    mg, launches["merge_path"] = run_path(kernels, merge_path)
    need = ("hash_rank_hist", "rank_hist", "merge_bucketized",
            "intersect_estimate", "allpairs_estimate")
    check(all(launches["merge_path"][k] > 0 for k in need),
          f"a kernel of the merge path never launched: {launches}")
    # a half-index row holds m entries in B buckets of S slots; with
    # Poisson(m / B) bucket loads it drops an entry with probability
    # 1 - P(load <= S)^B, so either half does for this share of the rows
    lam = M / N_BUCKETS
    fits = sum(math.exp(-lam) * lam ** j / math.factorial(j)
               for j in range(SLOTS + 1))
    expected = D * (1.0 - fits ** (2 * N_BUCKETS))
    check(mg["other_rows"] <= 2 * expected,
          f"{mg['other_rows']} rows had partition drops; the layout "
          f"predicts {expected:.0f}")
    emit({"phase": "merge_path", "D": D, "split_at": N // 2,
          "rows_bit_equal": D - mg["other_rows"],
          "rows_with_partition_drops": mg["other_rows"],
          "rows_with_partition_drops_predicted": expected,
          "full_index_dropped": mg["dropped"],
          "merged_index_dropped": mg["merged_dropped"],
          "merge_from_ms": mg["merge_ms"],
          "launches": launches["merge_path"]})

    # ---------------------------------------------------------------- timing
    corpus = index._corpus()
    C, B, S = corpus.idx.shape
    blk = torch.as_tensor(dense_rows(vidx, vval, range(BLOCK_ROWS)),
                          device=dev)
    Db, nb = blk.shape
    _, rank, hist0 = tk.hash_rank_hist(blk, SEED)
    kth = tk.kth_smallest_ranks(rank, M + 1, hist0=hist0)
    prefix16 = (kth.view(torch.int32) >> 24).contiguous()
    qv = np.zeros(N, np.float32)
    qv[vidx[sources[0]]] = vval[sources[0]]
    q = tk.bucketize(priority_sketch(torch.as_tensor(qv, device=dev), M,
                                     SEED), n_buckets=N_BUCKETS, slots=SLOTS)
    p_c = tk.slot_inclusion_probs(corpus)
    # compares the join needs: pairs of valid slots sharing a bucket
    per_bucket = (corpus.idx != INVALID_IDX).sum(dim=(0, 2)).double()
    join_ops = float((per_bucket * per_bucket).sum())
    qa = torch.as_tensor(quickstart.make_vectors()[0], device=dev)
    qn = qa.shape[0]

    def host_corpus(arrays):
        return tk.BucketizedSketch(*(torch.as_tensor(a, device=dev)
                                     for a in arrays))

    pre = mg["pre"]
    hi_ix = mg["hi"]
    mine = host_corpus([pre[k] for k in ("_idx", "_val", "_tau",
                                         "_dropped")])
    theirs = host_corpus([a[:D] for a in (hi_ix._idx, hi_ix._val,
                                          hi_ix._tau, hi_ix._dropped)])
    m_tau = tk.merged_tau_bucketized(mine, theirs, SEED, m=M)

    t = {}
    t["hash_rank_hist"] = (cuda_ms(lambda: tk.hash_rank_hist(blk, SEED)),
                           cuda_ms(lambda: hash_rank_hist_ref(blk, SEED),
                                   iters=5), None,
                           (2 * Db * nb + nb + Db * 256) * 4, "bytes")
    t["rank_hist"] = (cuda_ms(lambda: tk.rank_hist(rank, prefix16, shift=16)),
                      cuda_ms(lambda: rank_hist_ref(rank, prefix16, shift=16),
                              iters=5),
                      cuda_ms(lambda: torch.kthvalue(rank, M + 1, dim=1),
                              iters=5),
                      (Db * nb + Db + Db * 256) * 4, "bytes")
    t["hash_rank_batched"] = (
        cuda_ms(lambda: tk.hash_rank_batched(blk, SEED)),
        cuda_ms(lambda: hash_rank_batched_ref(blk, SEED), iters=5), None,
        (2 * Db * nb + nb) * 4, "bytes")
    t["hash_rank"] = (cuda_ms(lambda: tk.hash_rank(qa, 42)),
                      cuda_ms(lambda: hash_rank_ref(qa, 42), iters=5), None,
                      3 * qn * 4, "bytes")
    selection_ms = cuda_ms(lambda: tk.kth_smallest_ranks(rank, M + 1,
                                                         hist0=hist0))
    threshold_ms = cuda_ms(lambda: tk.build_threshold_corpus(
        blk, M, SEED, device=dev), iters=10)
    threshold_plain_ms = cuda_ms(lambda: tk.build_threshold_corpus(
        blk, M, SEED, device=dev, use_kernel=False), iters=5)
    threshold_bytes = Db * nb * 4 + Db * (CAP * 8 + 4)
    t["intersect_estimate"] = (
        cuda_ms(lambda: tk.intersect_estimate(q.idx, q.val, q.tau, corpus.idx,
                                              corpus.val, corpus.tau)),
        cuda_ms(lambda: intersect_estimate_ref(q.idx, q.val, q.tau,
                                               corpus.idx, corpus.val,
                                               corpus.tau), iters=5),
        None, C * B * S * 8 + C * 8 + B * S * 8 + 4, "bytes")
    ap_ms = cuda_ms(lambda: tk.allpairs_estimate(
        corpus.idx, corpus.val, p_c, corpus.idx, corpus.val, p_c),
        warmup=1, iters=3)
    ap_plain = cuda_ms(lambda: allpairs_estimate_ref(
        corpus.idx, corpus.val, p_c, corpus.idx, corpus.val, p_c, ct=64),
        warmup=0, iters=1)
    # the full D x D matrix against its plain version too (the parity
    # phase held a 512 x 512 block; this is the main path's shape)
    err["allpairs_estimate"] = max(err["allpairs_estimate"], assert_close(
        tk.allpairs_estimate(corpus.idx, corpus.val, p_c, corpus.idx,
                             corpus.val, p_c),
        allpairs_estimate_ref(corpus.idx, corpus.val, p_c, corpus.idx,
                              corpus.val, p_c, ct=64),
        f"allpairs_estimate {C}x{C}"))
    ap_bytes = 2 * C * B * S * 12 + C * C * 4
    t["allpairs_estimate"] = (ap_ms, ap_plain, None, ap_bytes, "ops")
    # the merge kernel at the merge path's shape, against its plain version
    got = tk.merge_bucketized(mine.idx, mine.val, theirs.idx, theirs.val,
                              m_tau, SEED)
    ref = merge_bucketized_ref(mine.idx, mine.val, theirs.idx, theirs.val,
                               m_tau, SEED)
    for g, r, what in zip(got, ref, ("idx", "val", "dropped")):
        assert_bits(g, r, f"merge_bucketized D={D} {what}")
    t["merge_bucketized"] = (
        cuda_ms(lambda: tk.merge_bucketized(mine.idx, mine.val, theirs.idx,
                                            theirs.val, m_tau, SEED)),
        cuda_ms(lambda: merge_bucketized_ref(mine.idx, mine.val, theirs.idx,
                                             theirs.val, m_tau, SEED),
                iters=3),
        None, D * B * S * 24 + D * 8, "bytes")
    bounds = {}
    for kname, (ms, plain, lib, nbytes, _) in t.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = (join_ops / FP32_OPS_PER_S * 1e3
                  if kname == "allpairs_estimate" else 0.0)
        bounds[kname] = (max(bytes_ms, ops_ms),
                         "operations" if ops_ms > bytes_ms else "bytes")
    # where one add_many block, one query and one merge_from spend their
    # time: each step of the calls, in order, host clock with the device
    # synchronised around each step
    def step_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    add_steps, query_steps, merge_steps = {}, {}, {}
    rows = list(range(BLOCK_ROWS))
    mat = dense_rows(vidx, vval, rows)
    scratch = SketchIndex(M, n_buckets=N_BUCKETS, slots=SLOTS, seed=SEED,
                          initial_capacity=BLOCK_ROWS, device=dev)
    mat, add_steps["check_finite"] = step_ms(lambda: check_finite(mat, "m"))
    At, add_steps["host_to_device"] = step_ms(
        lambda: torch.as_tensor(mat).to(dev))
    sk, add_steps["build"] = step_ms(
        lambda: tk.build_priority_corpus(At, M, SEED, device=dev))
    bc, add_steps["bucketize"] = step_ms(
        lambda: tk.bucketize_corpus(sk, n_buckets=N_BUCKETS, slots=SLOTS))
    host, add_steps["device_to_host"] = step_ms(
        lambda: [x.cpu().numpy() for x in bc])
    scratch._idx[:BLOCK_ROWS], scratch._val[:BLOCK_ROWS] = host[0], host[1]
    scratch._tau[:BLOCK_ROWS] = host[2]

    def heads():
        for k in rows:
            nz = np.flatnonzero(mat[k])
            scratch._set_head_row(k, nz, mat[k, nz])

    _, add_steps["head_rows"] = step_ms(heads)
    _, add_steps["row_summaries"] = step_ms(
        lambda: scratch._refresh_row_stats(0, BLOCK_ROWS))
    qv_host = np.zeros(N, np.float32)
    qv_host[vidx[sources[1]]] = vval[sources[1]]
    qv_host, query_steps["check_vector"] = step_ms(
        lambda: check_vector(qv_host, "q", dim=N))
    qt, query_steps["host_to_device"] = step_ms(
        lambda: torch.as_tensor(qv_host, device=dev))
    sq, query_steps["sketch"] = step_ms(lambda: priority_sketch(qt, M, SEED))
    qb, query_steps["bucketize"] = step_ms(
        lambda: tk.bucketize(sq, n_buckets=N_BUCKETS, slots=SLOTS))
    est, query_steps["kernel"] = step_ms(lambda: tk.query_corpus(qb, corpus))
    _, query_steps["device_to_host_top_k"] = step_ms(
        lambda: np.argsort(est.cpu().numpy()[:D])[-5:])
    # merge_from's steps, replayed on the merge path's pre-merge state
    both, merge_steps["host_to_device"] = step_ms(lambda: (
        host_corpus([pre[k] for k in ("_idx", "_val", "_tau", "_dropped")]),
        host_corpus([a[:D] for a in (hi_ix._idx, hi_ix._val, hi_ix._tau,
                                     hi_ix._dropped)])))
    tau_m, merge_steps["merged_tau"] = step_ms(
        lambda: tk.merged_tau_bucketized(*both, SEED, m=M))
    merged, merge_steps["merge_kernel"] = step_ms(
        lambda: tk.merge_bucketized_corpora(*both, SEED, m=M, tau=tau_m))
    host, merge_steps["device_to_host"] = step_ms(
        lambda: [x.cpu().numpy() for x in merged])
    heads_ix = SketchIndex(M, n_buckets=N_BUCKETS, slots=SLOTS, seed=SEED,
                           initial_capacity=D, device=dev)
    heads_ix._idx[:D], heads_ix._val[:D], heads_ix._tau[:D] = host[:3]
    heads_ix._head_idx[:D] = pre["_head_idx"]
    heads_ix._head_val[:D] = pre["_head_val"]

    def merged_heads():
        for d in range(D):
            hm, ho = heads_ix._head_idx[d], hi_ix._head_idx[d]
            heads_ix._set_head_row(
                d, np.concatenate([hm[hm >= 0], ho[ho >= 0]]),
                np.concatenate([heads_ix._head_val[d][hm >= 0],
                                hi_ix._head_val[d][ho >= 0]]))

    _, merge_steps["head_rows"] = step_ms(merged_heads)
    _, merge_steps["row_summaries"] = step_ms(
        lambda: heads_ix._refresh_row_stats(0, D))

    emit({"phase": "timing", "card": smi_line,
          "add_many_ms_per_block": float(np.mean(mp["block_ms"])),
          "add_many_block_ms": mp["block_ms"],
          "ingest_rows_per_s": D / mp["ingest_s"],
          "add_many_rows_per_s": D_BATCH / (sum(mp["block_ms"]) / 1e3),
          "query_p50_ms": float(np.percentile(mp["query_ms"], 50)),
          "query_p99_ms": float(np.percentile(mp["query_ms"], 99)),
          "all_pairs_ms": mp["all_pairs_ms"],
          "selection_ms": selection_ms,
          "threshold_path_block_ms": tp["block_ms"],
          "threshold_build_ms_per_block": threshold_ms,
          "threshold_build_plain_ms_per_block": threshold_plain_ms,
          "threshold_build_bound_ms":
              threshold_bytes / HBM_BYTES_PER_S * 1e3,
          "merge_from_ms": mg["merge_ms"],
          # the card's least time for the merge: both corpora read once,
          # the merged one written once (B6's bytes)
          "merge_from_bound_ms": bounds["merge_bucketized"][0],
          "add_many_block_steps_ms": add_steps,
          "query_steps_ms": query_steps,
          "merge_from_steps_ms": merge_steps,
          "allpairs_join_compares": join_ops,
          "kernel_ms": {k: v[0] for k, v in t.items()},
          "bound_ms": {k: v[0] for k, v in bounds.items()}})

    # --------------------------------------------------------------- kernels
    meta = {
        "hash_rank_hist": ("src/repro_torch/csrc/sketch_build.cu",
                           "src/repro/kernels/sketch_build/sketch_build.py:69",
                           "bit-equal"),
        "rank_hist": ("src/repro_torch/csrc/sketch_build.cu",
                      "src/repro/kernels/sketch_build/sketch_build.py:114",
                      "bit-equal"),
        "hash_rank_batched": ("src/repro_torch/csrc/sketch_build.cu",
                              "src/repro/kernels/hash_rank/hash_rank.py:111",
                              "bit-equal"),
        "hash_rank": ("src/repro_torch/csrc/sketch_build.cu",
                      "src/repro/kernels/hash_rank/hash_rank.py:75",
                      "bit-equal"),
        "intersect_estimate": (
            "src/repro_torch/csrc/intersect_estimate.cu",
            "src/repro/kernels/intersect_estimate/intersect_estimate.py:73",
            f"rtol={RTOL}"),
        "allpairs_estimate": (
            "src/repro_torch/csrc/intersect_estimate.cu",
            "src/repro/kernels/intersect_estimate/intersect_estimate.py:150",
            f"rtol={RTOL}"),
        "merge_bucketized": (
            "src/repro_torch/csrc/sketch_merge.cu",
            "src/repro/kernels/sketch_merge/sketch_merge.py:84",
            "bit-equal"),
    }
    rows = []
    for kname, (source, replaces, parity) in meta.items():
        ms, plain, lib, _, _ = t[kname]
        rows.append({"name": kname, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": sum(v[kname] for v in launches.values()),
                     "launches_by_path": {p: v[kname]
                                          for p, v in launches.items()},
                     "max_abs_err": err[kname], "ms": ms, "plain_ms": plain,
                     "bound_ms": bounds[kname][0],
                     "bound_by": bounds[kname][1], "library_ms": lib,
                     "parity": parity})
    check(all(r["launches"] > 0 for r in rows),
          f"a ported kernel never launched: {launches}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
