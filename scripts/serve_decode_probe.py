#!/usr/bin/env python
"""Time and trace the LM decode step on a CUDA card, before and after
``chip_smoke.py``'s families path has run in the same process.

Each probe serves gemma2-2b at full depth through ``chip_smoke.serve_family``
(its decode step median), then times 20 plain decode steps of a 4 x 512
prefill (``max_len`` 2048; the median) and traces one step with the host
ops (``chip_smoke.trace_scan(host=True)``), and prints one JSON line with
the live threads and the count of objects the garbage collector tracks.
The probes run before the families path and twice after it, so that a
slower decode inside the whole script can be told from the host's own
spread.  Exits 2 without a CUDA card.

    python scripts/serve_decode_probe.py
"""
from __future__ import annotations

import gc
import json
import os
import sys
import threading
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def probe(tag: str, dev) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import decode_fn, init_params, prefill_fn
    fam = cs.serve_family("gemma2-2b", dev)
    cfg = get_config("gemma2-2b")
    params = init_params(cfg, 0, device=dev)
    tokens = torch.zeros((4, 512), dtype=torch.int32, device=dev)
    _, state = prefill_fn(cfg, max_len=2048)(params, {"tokens": tokens})
    step, tok = decode_fn(cfg), tokens[:, :1]
    ms = sorted(cs.step_ms(lambda: step(params, state, tok))[1]
                for _ in range(20))
    traced = cs.trace_scan(lambda: step(params, state, tok), host=True)
    print(json.dumps({"tag": tag,
                      "serve_decode_ms_median": fam["decode_ms_median"],
                      "plain_decode_ms_median": ms[10],
                      "threads": [t.name for t in threading.enumerate()],
                      "gc_objects": len(gc.get_objects()),
                      "traced": traced}), flush=True)
    del params, state
    cs.free_card()


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    probe("before-families", dev)
    t0 = time.perf_counter()
    cs.families_path(dev, 4096)
    print(json.dumps({"families_path_s": time.perf_counter() - t0}),
          flush=True)
    probe("after-families-1", dev)
    probe("after-families-2", dev)


if __name__ == "__main__":
    main()
