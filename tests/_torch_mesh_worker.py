"""Ranks of the port's sharded LM path on gloo, for
``tests/test_torch_sharding.py``.

    python tests/_torch_mesh_worker.py WORK_DIR

Spawns 8 ranks (``torch.multiprocessing.spawn``) that join one gloo group
through a ``file://`` rendezvous in WORK_DIR and build a ``DeviceMesh``
on the CPU.  Imports no JAX.

1. 8 ranks, a (2, 4) ("data", "model") mesh: for each line ``CASE ARCH
   [key=value ...]`` of ``WORK_DIR/archs.txt`` (the reduced config of
   ARCH with the fields given replaced), from ``WORK_DIR/<CASE>.npz``
   (the config's float32 parameters as ``path/of/leaf`` arrays, and the
   batch under ``batch/<key>``), the parameters and batch are placed by
   ``distributed.sharding``'s rules and the DTensor loss and gradients
   are taken; rank 0 writes ``WORK_DIR/<CASE>.out.npz`` (``loss``, each
   gradient whole, the local shape of every parameter's shard).  The
   placed parameters of the first case are saved as a sharded
   checkpoint in ``WORK_DIR/port8``.  Then, for each line ``CASE ARCH
   [key=value ...]`` of ``WORK_DIR/serve.txt``, from ``WORK_DIR/<CASE>.
   npz`` (parameters, the prompt under ``batch/<key>``, the decode
   steps' tokens (steps, B, 1) under ``steps``), the sharded prefill to a
   horizon of the prompt's length plus the steps and one decode step a
   token; rank 0 writes ``WORK_DIR/<CASE>.out.npz`` (``logits/<i>``: the
   prefill's, then each step's; ``state/<path>``: the final decode state
   whole).  Then rank 0 writes ``WORK_DIR/port8.done``.
2. Ranks 0-3 join a new group of 4, a (2, 2) mesh, and, once
   ``WORK_DIR/ref8.done`` exists (another process's checkpoint), restore
   each checkpoint directory named in ``WORK_DIR/restore.txt`` onto it by
   the rules (``Checkpointer.restore(..., shardings=)``); rank 0 writes
   every leaf whole to ``WORK_DIR/<dir>.restored.npz``.
"""
import dataclasses
import os
import sys
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _tree(flat: dict) -> dict:
    out: dict = {}
    for path, arr in flat.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.as_tensor(arr)
    return out


def _flat(tree, prefix="") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "/"))
        else:
            out[key] = v
    return out


def _loss(rank: int, work: str) -> None:
    from repro_torch.distributed.sharding import (batch_shardings, gather,
                                                  param_shardings, place)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import loss_fn
    from repro_torch.train import Checkpointer, value_and_grad
    mesh = make_debug_mesh(2, 4)
    cases = [ln.split() for ln in open(os.path.join(work, "archs.txt"))
             if ln.strip()]
    for i, (case, arch, *over) in enumerate(cases):
        cfg = _config(arch, over)
        data = dict(np.load(os.path.join(work, f"{case}.npz")))
        batch = {k[6:]: torch.as_tensor(v) for k, v in data.items()
                 if k.startswith("batch/")}
        params = _tree({k: v for k, v in data.items()
                        if not k.startswith("batch/")})
        dparams = place(params, param_shardings(cfg, mesh))
        dbatch = place(batch, batch_shardings(mesh, batch))
        (loss, _), grads = value_and_grad(lambda p, b: loss_fn(cfg, p, b),
                                          dparams, dbatch)
        # (gathering is a collective: every rank takes part)
        full = _flat(gather(grads))
        whole_loss = float(loss.full_tensor())
        local = {f"local/{k}": np.array(v.to_local().shape)
                 for k, v in _flat(dparams).items()}
        if rank == 0:
            np.savez(os.path.join(work, f"{case}.out.npz"),
                     loss=np.array(whole_loss),
                     **{f"grad/{k}": v.numpy() for k, v in full.items()},
                     **local)
        if i == 0:
            ck = Checkpointer(os.path.join(work, "port8"), keep=1)
            ck.save(0, {"params": dparams})


def _serve(rank: int, work: str) -> None:
    from repro_torch.distributed.sharding import (batch_shardings, gather,
                                                  param_shardings, place,
                                                  replicated)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import decode_fn, prefill_fn
    mesh = make_debug_mesh(2, 4)
    cases = [ln.split() for ln in open(os.path.join(work, "serve.txt"))
             if ln.strip()]
    for case, arch, *over in cases:
        cfg = _config(arch, over)
        data = dict(np.load(os.path.join(work, f"{case}.npz")))
        steps = torch.as_tensor(data.pop("steps"))
        batch = {k[6:]: torch.as_tensor(v) for k, v in data.items()
                 if k.startswith("batch/")}
        params = place(_tree({k: v for k, v in data.items()
                              if not k.startswith("batch/")}),
                       param_shardings(cfg, mesh))
        horizon = batch["tokens"].shape[1] + steps.shape[0]
        logits, state = prefill_fn(cfg, max_len=horizon)(
            params, place(batch, batch_shardings(mesh, batch)))
        out = [logits.full_tensor()]
        step = decode_fn(cfg)
        for tok in steps:
            t = place({"t": tok}, {"t": replicated(mesh)} if cfg.serve_2d
                      else batch_shardings(mesh, {"t": tok}))["t"]
            logits, state = step(params, state, t)
            out.append(logits.full_tensor())
        whole = _flat(gather(state))
        if rank == 0:
            np.savez(os.path.join(work, f"{case}.out.npz"),
                     **{f"logits/{i}": v.numpy() for i, v in enumerate(out)},
                     **{f"state/{k}": v.numpy() for k, v in whole.items()})


def _config(arch: str, over):
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, **{
        k: type(getattr(cfg, k))(v) for k, v in
        (kv.split("=", 1) for kv in over)})


def _restore(rank: int, work: str) -> None:
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import gather, param_shardings
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import param_shapes
    from repro_torch.models.tree import tree_map
    from repro_torch.train import Checkpointer
    mesh = make_debug_mesh(2, 2)
    for line in open(os.path.join(work, "restore.txt")):
        if not line.strip():
            continue
        name, arch = line.split()
        cfg = get_config(arch).reduced()
        like = {"params": tree_map(lambda m: torch.empty(m.shape,
                                                         dtype=m.dtype),
                                   param_shapes(cfg))}
        step, back = Checkpointer(os.path.join(work, name)).restore(
            like, shardings={"params": param_shardings(cfg, mesh)})
        full = _flat(gather(back["params"]))
        local_ok = all(v.to_local().numel() <= v.numel()
                       for v in _flat(back["params"]).values())
        if rank == 0:
            np.savez(os.path.join(work, f"{name}.restored.npz"),
                     step=np.array(step), local_ok=np.array(local_ok),
                     **{k: v.numpy() for k, v in full.items()})


def _wait_for(path: str, seconds: float = 240.0) -> None:
    deadline = time.monotonic() + seconds
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.2)


def _join(rank: int, world: int, work: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{work}/rdv{world}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))


def rank_main(rank: int, work: str) -> None:
    torch.set_num_threads(1)
    _join(rank, 8, work)
    try:
        _loss(rank, work)
        _serve(rank, work)
        dist.barrier()
        if rank == 0:
            open(os.path.join(work, "port8.done"), "w").close()
    finally:
        dist.destroy_process_group()
    if rank >= 4:
        return
    _join(rank, 4, work)
    try:
        _wait_for(os.path.join(work, "ref8.done"))
        _restore(rank, work)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(sys.argv[1],), nprocs=8, join=True)
