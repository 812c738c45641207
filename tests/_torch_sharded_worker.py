"""Ranks of ``repro_torch.distributed.partitioned_sketch_corpus_sharded``
on gloo, for ``tests/test_torch_sharded.py``.

    python tests/_torch_sharded_worker.py WORLD INIT_FILE OUT_DIR

Spawns WORLD ranks (``torch.multiprocessing.spawn``) that join one gloo
group through the ``file://`` rendezvous INIT_FILE and build the test
block with both methods on the CPU.  Rank r writes
``OUT_DIR/rank{r}.npz``: each method's idx, val and tau, and the text of
the error an indivisible n raises.  Imports no JAX.
"""
import os
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

D, N, M, SEED = 8, 4096, 64, 17


def block() -> np.ndarray:
    """(D, N) float32, 30% nonzero N(0, 1) (``tests/test_merge.py``'s
    sharded-build block)."""
    rng = np.random.default_rng(2)
    return np.where(rng.random((D, N)) < 0.3, rng.standard_normal((D, N)),
                    0.0).astype(np.float32)


def rank_main(rank: int, world: int, init_file: str, out_dir: str) -> None:
    from repro_torch.distributed import partitioned_sketch_corpus_sharded
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        A = block()
        out = {}
        for method in ("priority", "threshold"):
            sk = partitioned_sketch_corpus_sharded(A, M, SEED, method=method,
                                                   device="cpu")
            for f in ("idx", "val", "tau"):
                out[f"{method}_{f}"] = getattr(sk, f).numpy()
        try:
            partitioned_sketch_corpus_sharded(A[:, :N - 1], M, SEED,
                                              device="cpu")
            out["indivisible"] = np.array("no error")
        except ValueError as e:
            out["indivisible"] = np.array(str(e))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    world, init_file, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    mp.spawn(rank_main, args=(world, init_file, out_dir), nprocs=world,
             join=True)
