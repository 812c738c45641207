#!/usr/bin/env python
"""The gradient norm of whisper-small at its published widths, by depth,
sequence length and dtype, in the port (``repro_torch``).

One set of weights (``init_params`` at seed 0 on the host, in float32,
with 12 + 12 layers; a depth-``k`` case takes the first ``k`` encoder and
decoder layers of each stack) and one batch (``SyntheticLM`` and
``frontend_stubs`` at seed 0, as ``chip_smoke.py``'s families path makes
them) go through ``loss_fn`` and its gradient for each case.  Each case
prints one JSON line: the loss, the global gradient norm (a float64 sum
of squares), whether every leaf is finite, and the three leaves with the
largest norm.  The last line is ``nvidia-smi``'s name and power limit
(``null`` on the CPU).

    python scripts/whisper_grad_norm.py [--device cpu]

The cases: depths 1, 2, 3, 4, 6, 8 and 12 at 2 x 128 tokens in float32,
then 12 + 12 layers at 2 x 512, 1024 and 4096 tokens in float32, and at
2 x 4096 in bfloat16 (the families path's case).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLM, frontend_stubs  # noqa: E402
from repro_torch.models import init_params, loss_fn  # noqa: E402
from repro_torch.models.tree import param_leaves, tree_map  # noqa: E402
from repro_torch.train import value_and_grad  # noqa: E402

CASES = ([(d, 128, "float32") for d in (1, 2, 3, 4, 6, 8, 12)]
         + [(12, s, "float32") for s in (512, 1024, 4096)]
         + [(12, 4096, "bfloat16")])


def cut(params: dict, depth: int) -> dict:
    """The first ``depth`` layers of each stack of 12 + 12-layer params:
    every leaf of the decoder's layer groups and of ``enc/blocks`` is
    stacked over the layer axis."""
    out = dict(params)
    out["groups"] = tree_map(lambda x: x[:depth], params["groups"])
    out["enc"] = dict(params["enc"],
                      blocks=tree_map(lambda x: x[:depth],
                                      params["enc"]["blocks"]))
    return out


def run_case(full, base, depth: int, seq: int, dtype: str, dev) -> dict:
    cfg = dataclasses.replace(base, n_layers=depth, enc_layers=depth,
                              dtype=dtype)
    cast = getattr(torch, dtype)
    params = tree_map(lambda x: x.to(dev, cast), cut(full, depth))
    batch = SyntheticLM(cfg.vocab_size, seq, 2, seed=0,
                        device=dev).batch_at(0)
    batch.update(frontend_stubs(cfg, 2, seq, seed=0, device=dev))
    (loss, _), grads = value_and_grad(lambda p, b: loss_fn(cfg, p, b),
                                      params, batch)
    norms = [("/".join(path), float(torch.sum(g.double() ** 2)))
             for path, g in param_leaves(grads)]
    finite = all(bool(torch.isfinite(g).all())
                 for _, g in param_leaves(grads))
    top = sorted(norms, key=lambda kv: -kv[1])[:3]
    return {"depth": f"{depth}+{depth}", "seq": seq,
            "frames": seq // cfg.enc_ratio, "batch": 2, "dtype": dtype,
            "loss": float(loss),
            "grad_norm": sum(v for _, v in norms) ** 0.5,
            "all_finite": finite,
            "largest_leaves": [[k, v ** 0.5] for k, v in top]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            sys.exit(2)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    base = get_config("whisper-small")
    full = init_params(dataclasses.replace(base, dtype="float32"), 0,
                       device="cpu")
    for depth, seq, dtype in CASES:
        print(json.dumps(run_case(full, base, depth, seq, dtype, dev)),
              flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    smi = None
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60,
                             check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
