#!/usr/bin/env python
"""Sweep the discovery scans' batch schedule on a CUDA card.

``repro_torch.serve.discovery`` walks a scan's visit order in batches of
tile pairs: a first batch of ``_FIRST_BATCH`` pairs, each later one twice
the last, up to the pairs of ``_MAX_BATCH`` join tiles.  This script sets
each (first batch, largest batch) of a small grid in turn and times, at
each, ``chip_smoke.py``'s two discovery corpora as its ``discovery_path``
builds them: the skewed corpus (8192 Zipf-scaled columns, 256 buckets of
2 slots; its scan pruned to a few tiles) and the main path's corpus (4096
sparse vectors, 512 buckets of 4 slots; its scan visits every tile pair).
It prints one JSON object: per setting the p50 of ``TOPK_REPS``
``top_pairs`` calls on each corpus and of ``top_k_for_query`` over 5
planted queries on the main path's corpus.  Every setting's answers must
equal the defaults' (the batches change no answer); the script exits 1
otherwise, and 2 without a CUDA card.

    python scripts/discovery_batch_sweep.py [--out sweep.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

FIRSTS = (1, 4, 16)
CAPS = (128, 512, 2048)
QUERIES = 5


def p50_ms(calls) -> float:
    out = []
    for f in calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    from repro_torch.serve import DiscoveryEngine, SketchIndex
    from repro_torch.serve import discovery as disc
    dev = torch.device("cuda")

    # the skewed corpus, as discovery_path builds it
    X = cs.topk_corpus()
    skewed = SketchIndex(cs.TOPK_M, n_buckets=cs.TOPK_BUCKETS,
                         slots=cs.TOPK_SLOTS, seed=cs.SEED,
                         initial_capacity=cs.TOPK_D, device=dev)
    names_t = [f"c{i}" for i in range(cs.TOPK_D)]
    for lo in range(0, cs.TOPK_D, cs.BLOCK_ROWS):
        skewed.add_many(names_t[lo:lo + cs.BLOCK_ROWS],
                        X[lo:lo + cs.BLOCK_ROWS])
    del X
    # the main path's corpus and its planted queries, as main_path
    # builds them
    rng = np.random.default_rng(2)
    vidx, vval = cs.make_data(rng)
    D = cs.D_BATCH + cs.D_SPARSE
    names = [f"doc{d:04d}" for d in range(D)]
    sources = rng.choice(D, cs.N_QUERIES, replace=False)
    noise = rng.standard_normal((cs.N_QUERIES, cs.NNZ)).astype(np.float32)
    flat = SketchIndex(cs.M, n_buckets=cs.N_BUCKETS, slots=cs.SLOTS,
                       seed=cs.SEED, device=dev)
    for lo in range(0, cs.D_BATCH, cs.BLOCK_ROWS):
        rows = list(range(lo, min(lo + cs.BLOCK_ROWS, cs.D_BATCH)))
        flat.add_many([names[r] for r in rows], cs.dense_rows(vidx, vval,
                                                              rows))
    for d in range(cs.D_BATCH, D):
        flat.add(names[d], indices=vidx[d], values=vval[d])
    qs = []
    for qi in range(QUERIES):
        qv = np.zeros(cs.N, np.float32)
        qv[vidx[sources[qi]]] = vval[sources[qi]] + 0.05 * noise[qi]
        qs.append(qv)

    engines = {"skewed": DiscoveryEngine(skewed, tile=cs.TOPK_TILE),
               "flat": DiscoveryEngine(flat, tile=cs.TOPK_TILE)}

    def answers():
        return ([engines[w].top_pairs(cs.TOPK_K).items for w in engines]
                + [engines["flat"].top_k_for_query(q, cs.TOPK_K).items
                   for q in qs])

    want = answers()            # the defaults' (and every build, warmed)
    defaults = (disc._FIRST_BATCH, disc._MAX_BATCH)
    sweep, same = {}, True
    try:
        for first in FIRSTS:
            for cap in CAPS:
                disc._FIRST_BATCH, disc._MAX_BATCH = first, cap
                same = same and answers() == want
                sweep[f"{first}/{cap}"] = {
                    f"{w}_top_pairs_p50_ms": p50_ms(
                        [lambda e=e: e.top_pairs(cs.TOPK_K)] * cs.TOPK_REPS)
                    for w, e in engines.items()}
                sweep[f"{first}/{cap}"]["flat_top_k_for_query_p50_ms"] = \
                    p50_ms([lambda q=q: engines["flat"].top_k_for_query(
                        q, cs.TOPK_K) for q in qs])
    finally:
        disc._FIRST_BATCH, disc._MAX_BATCH = defaults
    out = {"device": torch.cuda.get_device_name(0),
           "defaults": f"{defaults[0]}/{defaults[1]}",
           "tile": cs.TOPK_TILE, "reps": cs.TOPK_REPS, "queries": QUERIES,
           "answers_equal_defaults": same, "first/cap": sweep}
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    sys.exit(0 if same else 1)


if __name__ == "__main__":
    main()
