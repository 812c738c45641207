"""Ranks of ``repro_torch.distributed.make_sketchdp_grad_fn`` on gloo,
for ``tests/test_torch_grad_compress.py``.

    python tests/_torch_sketchdp_worker.py WORLD INIT_FILE OUT_DIR

Spawns WORLD ranks (``torch.multiprocessing.spawn``) that join one gloo
group through the ``file://`` rendezvous INIT_FILE and run SketchDP on
``gemma2-2b``'s reduced config (float32, ``init_params`` seed 0), each
on its rows of one global batch (B = 8, S = 32), as the reference's
``shard_map`` splits it.  Rank r writes ``OUT_DIR/rank{r}.npz``:

- ``exact_*``: one step with m >= n (threshold): the loss, the flat mean
  gradient, the largest |residual|, and the dense gradient of the whole
  batch with its loss (``tests/test_distributed.py``'s exactness test);
- ``ef_*``: two steps at m = n // 20 (threshold, then priority) with error
  feedback: each step's flat mean gradient, residual, and the rank's own
  flat gradient plus residual in, for the residual check.

Imports no JAX.
"""
import os
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

B, S = 8, 32


def rank_main(rank: int, world: int, init_file: str, out_dir: str) -> None:
    from repro_torch.configs import get_config
    from repro_torch.distributed import (init_ef_state, make_sketchdp_grad_fn,
                                         sketch_gradient)
    from repro_torch.distributed.grad_compress import step_seed
    from repro_torch.models import flatten_params, init_params, loss_fn
    from repro_torch.train import value_and_grad
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        cfg = get_config("gemma2-2b").reduced()
        params = init_params(cfg, 0, device="cpu")
        rng = np.random.default_rng(0)
        full = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                       dtype=torch.int32),
                "labels": torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                       dtype=torch.int32),
                "mask": torch.ones((B, S))}
        rows = slice(rank * B // world, (rank + 1) * B // world)
        mine = {k: v[rows] for k, v in full.items()}
        lfn = lambda p, b: loss_fn(cfg, p, b)  # noqa: E731
        n = flatten_params(params)[0].numel()
        out = {}
        grad_fn = make_sketchdp_grad_fn(lfn, m=n + 64, method="threshold")
        loss, grads, ef = grad_fn(params, mine, init_ef_state(params), 0)
        (d_loss, _), d_grads = value_and_grad(lfn, params, full)
        out.update(exact_loss=float(loss),
                   exact_mean=flatten_params(grads)[0].numpy(),
                   exact_ef=float(ef.abs().max()), dense_loss=float(d_loss),
                   dense=flatten_params(d_grads)[0].numpy())
        ef = init_ef_state(params)
        for step, method in ((0, "threshold"), (1, "priority")):
            fn = make_sketchdp_grad_fn(lfn, m=n // 20, method=method)
            (_, _), own = value_and_grad(lfn, params, mine)
            flat_in = flatten_params(own)[0] + ef
            loss, grads, new_ef = fn(params, mine, ef.clone(), step)
            idx, val, tau = sketch_gradient(flat_in, n // 20, step_seed(step),
                                            method=method)
            out[f"ef_{method}_in"] = flat_in.numpy()
            out[f"ef_{method}_idx"] = idx.numpy()
            out[f"ef_{method}_val"] = val.numpy()
            out[f"ef_{method}_tau"] = tau.numpy()
            out[f"ef_{method}_out"] = new_ef.numpy()
            out[f"ef_{method}_mean"] = flatten_params(grads)[0].numpy()
            out[f"ef_{method}_loss"] = float(loss)
            ef = new_ef
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    world, init_file, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    mp.spawn(rank_main, args=(world, init_file, out_dir), nprocs=world,
             join=True)
