"""Time B9 (``jl_rademacher``), B7 (``matrix_products``) and B5's join
(``allpairs_estimate``, plain and moments) of one checkout on the card, with
B8 (``countsketch_scatter``, also a cluster launch) beside them, so that
checkouts can be compared process by process on one card (run A, B, B, A,
... with the same arguments).

    python3 src/repro_torch/kernels/kernel_ab.py [--src DIR] [--iters N]
        [--rounds R] [--label NAME] [--save FILE.npz] [--against FILE.npz]

imports ``repro_torch`` from ``--src`` (default: this file's checkout;
any checkout whose C entries have these signatures), builds its kernels
and prints one JSON line.  ``--save`` keeps each raw launch's output (of
the moments matrices, one row in eight); ``--against`` compares them with
those another checkout saved (bit-equal, and the largest absolute
difference; for the moments, also whether each pair is within rtol 2e-5 of
its own scale, ``chip_smoke.py``'s ``assert_moments``).  For each shape,
``rounds`` values of:

- ``wrapper_ms``: the wrapper a call, CUDA events over ``iters`` calls
  back to back (host-bound when a call's host work outlasts its kernel);
- ``entry_host_us``: the host time of the C entry alone a call
  (``perf_counter`` over ``iters`` raw launches, before the sync);
- ``device_ms``: the kernel a launch, ``iters`` raw launches captured in
  a CUDA graph and replayed under CUDA events.

Shapes: B9 at the join path's (n = 30000, m = 400) and the parity shape
(65536, 256); B8 at (30000, 400); B7 at the store query's (1024 pairs,
512 buckets x 4 slots, d = 16, the query side broadcast, ~18 matches a
pair) and the products call's (256 batched pairs, ~41 matches a pair).
B7's sketches are synthetic: distinct ids a bucket, a library slot taking
a query id with the probability that gives those match counts.  B5's join
(raw launches on corpora compacted once; the wrapper compacts too): the
moments mode at the correlation matrix's layout (4096, 4096, 1024 buckets,
4 slots) on ``chip_smoke.py``'s discovery corpus (built by the checkout's
combined build; ~32 entries in a tile's bucket, 64-row groups that share
ids), and its 64-row query launch (64, 4096); the plain mode at (4096,
4096, 512, 4) on a synthetic corpus of the same structure (m = 256).  The
moments join's launch shape (blocks and warps an SM, shared memory a
block) is printed where the checkout reports it.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--label", default="")
    ap.add_argument("--save")
    ap.add_argument("--against")
    args = ap.parse_args()
    # run as a file, this file's directory is sys.path[0]: not a package
    # root, so the checkout's src takes its place
    sys.path[0] = str(Path(args.src).resolve())
    import torch
    tk = importlib.import_module("repro_torch.kernels")
    build = importlib.import_module("repro_torch.kernels._build")
    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py needs a CUDA card")
    build.build_all()
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def events_ms(fn, iters):
        for _ in range(3):
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

    def host_us(fn, iters):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / iters * 1e6

    def graph_ms(fn, iters):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        return events_ms(g.replay, 3) / iters

    def entry(module, name):
        lib = importlib.import_module(f"repro_torch.kernels.{module}")._lib()
        fn = getattr(lib, name)

        def launch(*a):
            build.check(fn(*a, stream()), name)
        return launch

    rng = np.random.default_rng(0)
    cases = {}
    jl = entry("jl_rademacher.jl_rademacher", "repro_jl_rademacher")
    for n, m in ((30000, 400), (65536, 256)):
        v = torch.as_tensor(rng.uniform(-1, 1, n).astype(np.float32),
                            device=dev)
        seeds = torch.as_tensor(rng.integers(0, 2**32, m).astype(np.uint32)
                                .view(np.int32), device=dev)
        out = torch.empty(m, device=dev)
        cases[f"jl_rademacher n={n} m={m}"] = (
            lambda v=v, s=seeds: tk.jl_rademacher(v, s),
            lambda v=v, s=seeds, o=out, n=n, m=m: jl(
                v.data_ptr(), s.data_ptr(), n, m, o.data_ptr()), out)

    cs = entry("countsketch.countsketch", "repro_countsketch")
    v = torch.as_tensor(rng.uniform(-1, 1, 30000).astype(np.float32),
                        device=dev)
    cs_out = torch.empty(400, device=dev)
    cases["countsketch_scatter n=30000 m=400"] = (
        lambda v=v: tk.countsketch_scatter(v, 400, 17, 23),
        lambda v=v: cs(v.data_ptr(), 30000, 400, 17, 23, cs_out.data_ptr(),
                       None), cs_out)

    mp = entry("matrix_sketch.matrix_sketch", "repro_matrix_products")
    B, S, d = 512, 4, 16
    q_ids = rng.permutation(B * S).reshape(B, S)
    for P, matches, batched in ((1024, 18, False), (256, 41, True)):
        fresh = B * S + rng.permutation(P * B * S).reshape(P, B, S)
        hit = rng.random((P, B, S)) < matches / (B * S)
        lib_ids = np.where(hit, q_ids[None], fresh).astype(np.int32)
        a_ids = (np.broadcast_to(q_ids, (P, B, S)) if batched
                 else q_ids[None]).astype(np.int32)
        sides = []
        for ids in (a_ids, lib_ids):
            Pa = ids.shape[0]
            sides += [torch.as_tensor(np.ascontiguousarray(ids), device=dev),
                      torch.as_tensor(rng.standard_normal(
                          (Pa, B, S, d)).astype(np.float32), device=dev),
                      torch.as_tensor(rng.uniform(0.1, 1.0, (Pa, B, S))
                                      .astype(np.float32), device=dev)]
        out = torch.empty((P, d, d), device=dev)
        what = "products call, batched" if batched else "store query"
        cases[f"matrix_products P={P} ({what})"] = (
            lambda s=sides: tk.matrix_products(*s),
            lambda s=sides, o=out, P=P, b=int(batched): mp(
                *(x.data_ptr() for x in s), o.data_ptr(), P, b, B, S, d, d),
            out)

    ie = importlib.import_module(
        "repro_torch.kernels.intersect_estimate.intersect_estimate")
    join = entry("intersect_estimate.intersect_estimate",
                 "repro_allpairs_join")
    every8 = np.arange(0, 4096, 8) + np.arange(512) % 8
    smoke = chip_smoke()
    corpora = ((discovery_corpus(smoke, dev), 1024, 1, "discovery"),
               (grouped_corpus(rng, 4096, 256, 512, 4, dev), 512, 0,
                "grouped"))
    for full, B, moments, what in corpora:
        D = full[0].shape[0]
        cf = tk.allpairs_compact(*full)
        sides = [("", full, cf)]
        if moments:
            q = tuple(x[:64].contiguous() for x in full)
            sides.append((" query (64 rows)", q, tk.allpairs_compact(*q)))
        for tag, a, ca in sides:
            Da = a[0].shape[0]
            out = torch.empty((Da, D, 6) if moments else (Da, D), device=dev)
            mode = "moments" if moments else "plain"
            cases[f"allpairs {mode} {Da}x{D} B={B} S=4 {what}{tag}"] = (
                lambda a=a, f=full, mo=moments: tk.allpairs_estimate(
                    *a, *f, moments=bool(mo)),
                lambda ca=ca, cf=cf, o=out, Da=Da, D=D, B=B, mo=moments: join(
                    ca[0].data_ptr(), ca[1].data_ptr(), cf[0].data_ptr(),
                    cf[1].data_ptr(), o.data_ptr(), Da, D, B, 4, mo),
                out, 5 if moments else 20,
                every8 if moments and Da == D else None)
    shape_fn = getattr(ie, "moments_join_shape", None)
    moments_shape = shape_fn(4) if shape_fn else None

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    result = {"label": args.label, "src": args.src, "iters": args.iters,
              "card": card, "moments_launch_shape": moments_shape,
              "shapes": {}}
    outputs = {}
    for what, case in cases.items():
        wrapper, launch, out = case[:3]
        iters = case[3] if len(case) > 3 else args.iters
        rows = case[4] if len(case) > 4 else None
        result["shapes"][what] = {
            key: [fn(f, iters) for _ in range(args.rounds)]
            for key, fn, f in (("wrapper_ms", events_ms, wrapper),
                               ("entry_host_us", host_us, launch),
                               ("device_ms", graph_ms, launch))}
        result["shapes"][what]["iters"] = iters
        out.zero_()
        launch()
        kept = out if rows is None else out[torch.as_tensor(rows, device=dev)]
        outputs[what] = kept.cpu().numpy()
    if args.save:
        np.savez(args.save, **outputs)
    if args.against:
        other = np.load(args.against)
        result["against"] = {}
        for what, x in outputs.items():
            y = other[what]
            res = {"bit_equal": bool(np.array_equal(x.view(np.uint32),
                                                    y.view(np.uint32))),
                   "max_abs_diff": float(np.abs(x - y).max())}
            if "moments" in what:
                res.update(moments_within(smoke, x, y))
            result["against"][what] = res
    print(json.dumps(result), flush=True)


def chip_smoke():
    """``chip_smoke.py`` of this file's checkout, as a module: the
    discovery corpus's generator and the moments gate."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[3] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def discovery_corpus(cs, dev):
    """The correlation matrix's input in ``chip_smoke.py``'s
    join-correlation path: its 4096 discovery columns (64 groups of a
    query and 63 columns sharing its keys, over 2^18 keys) sketched with
    m = 512 by the checkout's combined build, 512 columns at a time, and
    bucketized into 1024 buckets x 4 slots with their inclusion
    probabilities."""
    import torch
    jc = importlib.import_module("repro_torch.core.join_correlation")
    column_to_vector = importlib.import_module(
        "repro_torch.data").column_to_vector
    cols, _ = cs.discovery_columns()
    blocks = []
    for lo in range(0, len(cols), 512):
        A = torch.as_tensor(np.stack([
            column_to_vector(k, v, cs.DISC_UNIVERSE)
            for k, v in cols[lo:lo + 512]]), device=dev)
        blocks.append(jc.combined_sketch_corpus(
            A, cs.DISC_M, cs.DISC_SEED, backend="kernel", device=dev))
        del A
    S = jc.CombinedSketch(*(torch.cat(f) for f in zip(*blocks)))
    return jc._bucketized_moment_inputs(S, cs.DISC_BUCKETS,
                                        cs.DISC_SLOTS)[:3]


def grouped_corpus(rng, D, m, n_buckets, slots, dev):
    """(idx, val, p) (D, n_buckets, slots) of D rows in groups of 64 that
    share ids: each row m distinct ids, 60% of them drawn from its group's
    pool of 2m and the rest from a pool of 4096 that every row draws from
    (so rows of different groups share a few), each id in bucket (id *
    2654435761 mod 2^32) mod n_buckets at its rank there (a full bucket
    drops the rest); values N(0, 1), inclusion probabilities U(0.05, 1)."""
    import torch
    idx = np.full((D, n_buckets, slots), 0x7FFFFFFF, dtype=np.int32)
    k = int(0.6 * m)
    common = rng.choice(np.arange(1 << 30, 1 << 31), 4096, replace=False)
    for g in range(0, D, 64):
        pool = rng.choice(1 << 30, 2 * m, replace=False)
        for r in range(g, min(g + 64, D)):
            ids = np.unique(np.concatenate([
                rng.choice(pool, k, replace=False),
                rng.choice(common, m - k, replace=False)]))
            b = (ids.astype(np.uint64) * 2654435761 % (1 << 32)) % n_buckets
            order = np.argsort(b, kind="stable")
            b, ids = b[order].astype(np.int64), ids[order]
            rank = np.arange(len(b)) - np.searchsorted(b, b)
            keep = rank < slots
            idx[r, b[keep], rank[keep]] = ids[keep]
    used = idx != 0x7FFFFFFF
    val = np.where(used, rng.standard_normal(idx.shape), 0.0)
    p = np.where(used, rng.uniform(0.05, 1.0, idx.shape), 1.0)
    return tuple(torch.as_tensor(x, device=dev) for x in
                 (idx, val.astype(np.float32), p.astype(np.float32)))


def moments_within(cs, x, ref) -> dict:
    """Each pair's six moments (D1, D2, 6) against ``ref``'s, held by
    ``chip_smoke.py``'s own gate, ``assert_moments`` (each pair within
    its RTOL of the pair's own scale)."""
    import torch
    names = ("n", "sum_x", "sum_y", "xy", "sum_x2", "sum_y2")
    got, want = ({k: torch.from_numpy(np.ascontiguousarray(a[..., c]))
                  for c, k in enumerate(names)} for a in (x, ref))
    try:
        worst = cs.assert_moments(got, want, torch.ones(x.shape[:2],
                                                        dtype=torch.bool),
                                  "moments")
    except AssertionError as e:
        return {"within_moments_tolerance": False, "failure": str(e)}
    return {"within_moments_tolerance": True,
            "max_err_of_pair_scale": worst}


if __name__ == "__main__":
    main()
