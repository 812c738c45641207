#!/usr/bin/env python
"""Run ``chip_smoke.py``'s families path alone on a CUDA card.

Builds the port's kernels, then trains each model family of
``chip_smoke.FAMILIES`` at its published widths (the path's gates, step
times, splits, device traces and peak bytes), one SketchDP step pair on
mamba2-370m and each reduced config against the CPU, exactly as
``chip_smoke.families_path`` does inside the whole script, and prints
its JSON line and the card's name and power limit.  Exits 1 on a failed
gate, 2 without a CUDA card.

    python scripts/families_alone.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    from repro_torch.configs import SHAPES
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    try:
        out = cs.families_path(torch.device("cuda"),
                               SHAPES["train_4k"]["seq_len"])
    except AssertionError as e:
        print(f"families_alone: {e}", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"families_alone": out,
                      "nvidia_smi": smi.splitlines()[0]}), flush=True)


if __name__ == "__main__":
    main()
