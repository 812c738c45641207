#!/usr/bin/env python
"""Run ``chip_smoke.py``'s mesh and dry-run paths alone on a CUDA card.

Builds the kernels (the mesh path's SketchDP step launches B3 and B2),
then runs ``chip_smoke.mesh_path`` (gemma2-2b at the train path's widths
on a one-rank (1, 1) NCCL mesh: the DTensor step against the plain one,
SketchDP over the mesh's data axis, a sharded checkpoint round trip) and
``chip_smoke.dryrun_path`` (the dry run's cells in subprocesses on fake
groups of 256 / 512 ranks).  With ``--debug-cells`` it also traces the
reduced config of every family for train, prefill and decode on a fake
(2, 4) mesh on the card, and ``EXTRA_CELLS``, as
``tests/test_torch_dryrun.py`` does on the CPU.  Prints each path's JSON
line and the card's name and power limit.  Exits 1 on a failed gate, 2
without a CUDA card.

    python scripts/mesh_alone.py [--debug-cells]
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


# reduced cells that failed, or held the whole batch's tensors, on the fake
# mesh before the MoE, the loss, decode attention and the prefill's decode
# state ran on each rank's own share (tests/test_torch_dryrun.py)
EXTRA_CELLS = [("qwen3-moe-235b-a22b", "train_4k", ("n_experts=4",)),
               ("qwen2-moe-a2.7b", "train_4k", ("n_experts=6",)),
               ("command-r-plus-104b", "train_4k", ("vocab_size=4096",)),
               ("phi-3-vision-4.2b", "prefill_32k", ("n_kv_heads=4",)),
               ("phi-3-vision-4.2b", "decode_32k", ("n_kv_heads=4",)),
               ("qwen2-moe-a2.7b", "decode_32k", ("n_kv_heads=4",))]


def debug_cells() -> dict:
    """Every family's reduced config, train / prefill / decode, on a fake
    (2, 4) mesh with fake tensors on the card: status and trace seconds
    a cell."""
    from repro_torch.configs import ARCH_IDS
    code = textwrap.dedent(f"""
        import json
        import repro_torch.launch.dryrun as D
        _full = D.get_config
        D.get_config = lambda arch: _full(arch).reduced()
        D.SHAPES = {{k: dict(v, seq_len=32, global_batch=8)
                    for k, v in D.SHAPES.items()}}
        out = []
        cells = [(a, shape, ()) for a in {list(ARCH_IDS)!r}
                 for shape in ("train_4k", "prefill_32k", "decode_32k")]
        cells += {EXTRA_CELLS!r}
        for a, shape, over in cells:
            try:
                r = D.run_cell(a, shape, multi_pod=False, mesh_shape=(2, 4),
                               device="cuda", overrides=over)
                out.append([a, shape, list(over), r["status"],
                            r["lower_s"]])
            except Exception as e:
                out.append([a, shape, list(over), "error", repr(e)[:300]])
        print("JSON", json.dumps(out))
    """)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=900,
                       env={**os.environ, "PYTHONPATH": cs.SRC})
    if r.returncode != 0 or "JSON" not in r.stdout:
        cs.fail(f"debug cells exited {r.returncode}: {r.stderr[-3000:]}")
    cells = json.loads(r.stdout.split("JSON", 1)[1])
    errors = [c for c in cells if c[3] != "ok"]
    cs.check(not errors, f"debug cells failed: {errors}")
    return {"cells": cells, "seconds": time.perf_counter() - t0}


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import KERNELS, _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    _build.build_all()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0,
             "torch": torch.__version__})
    dev = torch.device("cuda")
    failed = []

    def phase(name, fn):
        """Run one phase; a failure is reported and the next runs."""
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 (a failed gate exits)
            import traceback
            failed.append(name)
            print(f"PHASE {name} FAILED: {e!r}\n"
                  f"{traceback.format_exc()[-4000:]}", file=sys.stderr,
                  flush=True)

    def mesh():
        out, launches = cs.run_path(KERNELS, lambda: cs.mesh_path(dev))
        cs.emit({"phase": "mesh_path", **out, "launches": launches})

    def dryrun():
        t0 = time.perf_counter()
        dry = cs.dryrun_path(dev)
        dry["seconds"] = time.perf_counter() - t0
        for cell in dry["cells"]:
            print(cell["summary"], f"| wall {cell['wall_s']:.1f} s",
                  flush=True)
        cs.emit({"phase": "dryrun_path", **dry})

    phase("mesh_path", mesh)
    phase("dryrun_path", dryrun)
    if "--debug-cells" in sys.argv:
        phase("debug_cells",
              lambda: cs.emit({"phase": "debug_cells", **debug_cells()}))
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
