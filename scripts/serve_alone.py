#!/usr/bin/env python
"""Run ``chip_smoke.py``'s serve path alone on a CUDA card.

Serves the LM exactly as ``chip_smoke.serve_path`` does inside the whole
script: each reduced config on the card against the CPU (gate A), cache
consistency at published widths (gate B), each of the six families at
full published depth in bfloat16 through ``serve.Engine`` (gate C: the
timings, traced decode step and peak bytes) and ``python -m
repro_torch.launch.serve --arch gemma2-2b``.  Prints each family's line,
the path's JSON line and the card's name and power limit.  Exits 1 on a
failed gate, 2 without a CUDA card.  No kernel of the port is on this
path, so nothing is built.

    python scripts/serve_alone.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        out = cs.serve_path(torch.device("cuda"))
    except AssertionError as e:
        print(f"serve_alone: {e}", file=sys.stderr)
        sys.exit(1)
    out["seconds"] = time.perf_counter() - t0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"serve_alone": out,
                      "nvidia_smi": smi.splitlines()[0]}), flush=True)


if __name__ == "__main__":
    main()
