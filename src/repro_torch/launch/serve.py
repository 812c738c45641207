"""Serving launcher (``repro.launch.serve``): batched LM generation with
the KV-cache engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --reduced --requests 6 --max-new 8

runs on the card (``--device cpu`` for the CPU), random weights from
seed 0.  whisper-small's frames and phi-3-vision's image embeddings are
the engine's zeros.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, 0, device=device)
    eng = Engine(cfg, params, batch_size=args.batch, max_len=256,
                 temperature=args.temperature, device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    done = eng.serve(reqs)
    for r in done:
        print(f"request {r.rid}: prompt={r.prompt.tolist()} -> {r.output}")
    return done


if __name__ == "__main__":
    main()
