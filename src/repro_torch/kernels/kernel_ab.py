"""Time B9 (``jl_rademacher``) and B7 (``matrix_products``) of one checkout
on the card, with B8 (``countsketch_scatter``, also a cluster launch) beside
them, so that checkouts can be compared process by process on one card
(run A, B, B, A, ... with the same arguments).

    python3 src/repro_torch/kernels/kernel_ab.py [--src DIR] [--iters N]
        [--rounds R] [--label NAME] [--save FILE.npz] [--against FILE.npz]

imports ``repro_torch`` from ``--src`` (default: this file's checkout;
any checkout whose C entries have these signatures), builds its kernels
and prints one JSON line.  ``--save`` keeps each raw launch's output;
``--against`` compares them with those another checkout saved (bit-equal,
and the largest absolute difference).  For each shape, ``rounds`` values
of:

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
a query id with the probability that gives those match counts.
"""
from __future__ import annotations

import argparse
import importlib
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

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    result = {"label": args.label, "src": args.src, "iters": args.iters,
              "card": card, "shapes": {}}
    outputs = {}
    for what, (wrapper, launch, out) in cases.items():
        result["shapes"][what] = {
            key: [fn(f, args.iters) for _ in range(args.rounds)]
            for key, fn, f in (("wrapper_ms", events_ms, wrapper),
                               ("entry_host_us", host_us, launch),
                               ("device_ms", graph_ms, launch))}
        out.zero_()
        launch()
        outputs[what] = out.cpu().numpy()
    if args.save:
        np.savez(args.save, **outputs)
    if args.against:
        other = np.load(args.against)
        result["against"] = {
            what: {"bit_equal": bool(np.array_equal(x.view(np.uint32),
                                                    other[what].view(
                                                        np.uint32))),
                   "max_abs_diff": float(np.abs(x - other[what]).max())}
            for what, x in outputs.items()}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
