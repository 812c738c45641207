"""Training launcher (``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

runs on the card (``--device cpu`` for the CPU).  ``--arch`` is any of
the ten configs; ``--reduced`` takes the smoke-scale config of the same
family.  whisper-small's frame embeddings and phi-3-vision's image
embeddings are seeded N(0, 0.02^2) stubs (``data.frontend_stubs``).
Resumes from the latest checkpoint in ``--ckpt-dir``, watches step
times, and with
``--sketchdp-m M`` under a ``torch.distributed`` launch of more than one
rank (``torchrun --nproc-per-node 2 -m repro_torch.launch.train ...``)
compresses the data-parallel gradient with SketchDP: each rank takes its
rows of the global batch, as the reference's ``shard_map`` does.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data import Prefetcher, SyntheticLM, frontend_stubs
from repro_torch.device import resolve_device
from repro_torch.models import init_params, loss_fn
from repro_torch.train import (Checkpointer, StepWatchdog, adamw,
                               make_train_step, train_loop, warmup_cosine)


def _init_distributed(device: torch.device) -> tuple:
    """(rank, world, device): joins the process group a ``torchrun``
    launch describes (``WORLD_SIZE`` > 1 in the environment), NCCL on the
    card, gloo on the CPU; each rank on the card takes ``cuda:LOCAL_RANK``."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    if not dist.is_initialized():
        return 0, 1, device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    return dist.get_rank(), dist.get_world_size(), device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sketchdp-m", type=int, default=0,
                    help="gradient-compression sketch size (0 = dense)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    rank, world, device = _init_distributed(device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if rank == 0:
        print(f"arch={cfg.name} params~{cfg.param_count():,} device={device}")
    params = init_params(cfg, args.seed, device=device)
    opt = adamw(warmup_cosine(args.lr, warmup=10, total=args.steps))
    opt_state = opt.init(params)
    start_step = 0
    ck = None
    if args.ckpt_dir:
        ck = Checkpointer(args.ckpt_dir)
        if ck.latest_step() is not None:
            start_step, restored = ck.restore(
                {"params": params, "opt_state": opt_state})
            params, opt_state = restored["params"], restored["opt_state"]
            print(f"resumed from step {start_step}")

    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed,
                       device=device)

    def batch_at(step: int) -> dict:
        batch = data.batch_at(step)
        batch.update(frontend_stubs(cfg, args.batch, args.seq,
                                    seed=args.seed, step=step,
                                    device=device))
        return batch

    def batches_from(step: int):
        # the steps left, no more: the prefetch thread ends with them
        for i in range(step, args.steps):
            yield batch_at(i)

    if args.sketchdp_m and world > 1:
        from repro_torch.distributed import (init_ef_state,
                                             make_sketchdp_grad_fn)
        if args.batch % world:
            raise ValueError(f"--batch {args.batch} does not divide over "
                             f"{world} ranks")
        rows = slice(rank * args.batch // world,
                     (rank + 1) * args.batch // world)
        grad_fn = make_sketchdp_grad_fn(lambda p, b: loss_fn(cfg, p, b),
                                        m=args.sketchdp_m)
        ef = init_ef_state(params)
        for i in range(start_step, args.steps):
            batch = {k: v[rows] for k, v in batch_at(i).items()}
            loss, grads, ef = grad_fn(params, batch, ef, i)
            params, opt_state, _ = opt.update(grads, opt_state, params)
            if i % 10 == 0 and rank == 0:
                print(f"step {i} loss {float(loss):.4f} "
                      f"(sketchdp m={args.sketchdp_m})")
        dist.destroy_process_group()
        return

    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches)
    watchdog = StepWatchdog()
    train_loop(cfg, params, opt_state, Prefetcher(batches_from(start_step)),
               step_fn, n_steps=args.steps, start_step=start_step,
               checkpointer=ck, checkpoint_every=args.ckpt_every,
               watchdog=watchdog)
    if watchdog.straggler_events:
        print(f"stragglers detected: {watchdog.straggler_events}")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
