"""Multi-pod dry run (``repro.launch.dryrun``): every (architecture x
input shape) on the production meshes, traced with fake tensors over a
fake process group, and its roofline terms.

    python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --out DIR

A cell joins a fake process group of 256 ranks (the (16, 16) mesh) or
512 (the (2, 16, 16) mesh) in one process, as rank 0.  Parameters, the
AdamW state, the batch and the decode state are placed by the sharding
rules (``distributed.sharding``) as DTensors over ``FakeTensorMode``
tensors, which allocate nothing, on ``--device`` (default ``cuda``; the
CPU with ``--device cpu``).  The train step (with
:func:`choose_microbatches`), prefill or decode then runs eagerly under
three modes, each seeing the local ops DTensor issues on rank 0's shards:
``FlopCounterMode`` (FLOPs), a collective counter over the
``_c10d_functional`` ops (kind, result bytes, group size, hence wire
bytes by ``roofline.analysis.wire_bytes``) and ``MemTracker`` (peak
bytes a device by category).  The fake group's collectives move no data:
the values are meaningless, the shapes, FLOPs, bytes and collectives are
the program's.

Each cell writes the reference's record; a key keeps its name where its
content is the same thing: ``status`` / ``reason`` (``skip`` for
``long_500k`` on full-attention archs), ``microbatches``,
``collectives`` ({kind: {bytes, count}}, every collective counted as it
is issued: eager execution runs every loop iteration; the port adds
``largest_collectives``, the five largest with their shape and the
model-code line that issued them), ``lower_s`` (the
trace's wall seconds), ``param_bytes_per_dev`` (the reference's formula
over the port's pspecs), ``analytic`` and ``roofline`` (the reference's
``as_dict`` keys; the collective term from the counted wire bytes),
``memory_analysis`` (``MemTracker``'s peak: ``peak_bytes`` and one entry
a category) and ``cost_analysis_raw.flops`` (``FlopCounterMode``'s count
on rank 0, a device's FLOPs; ``flops_global`` is it times the ranks).
Keys of the reference with no counterpart: ``compile_s`` (nothing is
compiled), ``collectives_static`` (the static HLO listing, before loop
weighting: there is no HLO), ``cost_analysis_raw.bytes_accessed`` (no
per-op byte count exists without a compiler's fusion decisions).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config


def choose_microbatches(cfg, seq_len: int, global_batch: int, dp_shards: int,
                        budget_bytes: float = 6e9) -> int:
    """Grad-accumulation factor so the scan-carry residuals fit HBM:
    saved activations ~= L * tokens_dev_mb * d_model * 2B  <= budget."""
    tokens_dev = seq_len * global_batch / max(dp_shards, 1)
    per_mb = cfg.n_layers * cfg.d_model * 2.0
    mb = 1
    while tokens_dev / mb * per_mb > budget_bytes and mb < global_batch:
        mb *= 2
    while global_batch % mb:
        mb *= 2
    return min(mb, global_batch)


def _apply_overrides(cfg, overrides):
    kw = {}
    for kv in overrides or ():
        k, v = kv.split("=", 1)
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            kw[k] = v.lower() in ("1", "true", "yes")
        else:
            kw[k] = type(cur)(v)
    return dataclasses.replace(cfg, **kw) if kw else cfg


# ----------------------------------------------------------------------------
# The collective counter
# ----------------------------------------------------------------------------

_KINDS = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all", "broadcast": "broadcast",
          "all_gather_into_tensor_coalesced": "all-gather",
          "all_reduce_coalesced": "all-reduce",
          "reduce_scatter_tensor_coalesced": "reduce-scatter"}


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = next(a for a in reversed(args) if isinstance(a, str))
    return _resolve_process_group(name).size()


def _counter_mode():
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from repro_torch.roofline.analysis import wire_bytes

    class CollectiveCounter(TorchDispatchMode):
        """Records each ``_c10d_functional`` collective issued inside it:
        {kind: {bytes (ring wire bytes from the result's size), count,
        result_bytes}}.  DTensor ops pass through (``NotImplemented``)
        so that the collectives they desugar into are seen."""

        def __init__(self, keep: int = 5):
            super().__init__()
            self.stats: dict = {}
            self.keep = keep
            self.largest: list = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if func.namespace == "_c10d_functional":
                kind = _KINDS.get(func._opname.rstrip("_"))
                if kind is not None:
                    nbytes = sum(t.numel() * t.element_size()
                                 for t in tree_leaves(out)
                                 if isinstance(t, torch.Tensor))
                    w = _group_size(args)
                    rec = self.stats.setdefault(
                        kind, {"bytes": 0, "count": 0, "result_bytes": 0})
                    wire = nbytes if kind == "broadcast" else wire_bytes(
                        kind, nbytes, w)
                    rec["bytes"] += int(wire)
                    rec["count"] += 1
                    rec["result_bytes"] += int(nbytes)
                    self._note(kind, int(wire), w, out)
            return out

        def _note(self, kind, wire, w, out):
            """Keep the ``keep`` largest collectives: kind, wire bytes,
            group size, result shape and the model-code line that
            issued it."""
            if len(self.largest) == self.keep and \
                    wire <= self.largest[-1]["bytes"]:
                return
            import traceback
            where = [f"{os.path.basename(fr.filename)}:{fr.lineno} "
                     f"{fr.name}" for fr in traceback.extract_stack()
                     if "repro_torch" in fr.filename
                     and not fr.filename.endswith("dryrun.py")]
            t = next((t for t in tree_leaves(out)
                      if isinstance(t, torch.Tensor)), None)
            self.largest.append({
                "kind": kind, "bytes": wire, "group": w,
                "shape": list(t.shape) if t is not None else None,
                "where": where[-2:]})
            self.largest.sort(key=lambda r: -r["bytes"])
            del self.largest[self.keep:]

    return CollectiveCounter()


def _flop_counter():
    """``FlopCounterMode`` counting the local ops DTensor issues (its own
    dispatch mode sees DTensor ops at their global shapes; this one lets
    DTensor run first, as ``MemTracker`` and ``CommDebugMode`` do)."""
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import FlopCounterMode, _FlopCounterMode

    class _LocalMode(_FlopCounterMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            return super().__torch_dispatch__(func, types, args, kwargs)

    class LocalFlopCounter(FlopCounterMode):
        def __enter__(self):
            self.flop_counts.clear()
            self.mod_tracker.__enter__()
            self.mode = _LocalMode(self)
            self.mode.__enter__()
            return self

    return LocalFlopCounter(display=False)


class _MetaOutsideCounters:
    """DTensor infers each op's output shape by running the op on fake
    tensors of the GLOBAL shapes (its sharding propagator; once an op
    signature, then cached).  Those runs are not the program: inside this
    context they run with every dispatch mode set aside, so that the
    counters (and ``MemTracker``) see only the local ops.  The
    propagator's method is wrapped while the context is open."""

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        from torch.utils._python_dispatch import _disable_current_modes
        name = ("_propagate_tensor_meta_non_cached"
                if hasattr(ShardingPropagator,
                           "_propagate_tensor_meta_non_cached")
                else "_propagate_tensor_meta")
        orig = getattr(ShardingPropagator, name)

        def outside(self_, *a, **k):
            with _disable_current_modes():
                return orig(self_, *a, **k)

        self._undo = (ShardingPropagator, name, orig)
        setattr(ShardingPropagator, name, outside)
        return self

    def __exit__(self, *exc):
        cls, name, orig = self._undo
        setattr(cls, name, orig)
        return False


# ----------------------------------------------------------------------------
# A cell
# ----------------------------------------------------------------------------


def _join_fake_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _mesh(multi_pod: bool, mesh_shape, device_type: str):
    from repro_torch.launch.mesh import make_production_mesh
    if mesh_shape is not None:
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh(device_type, tuple(mesh_shape),
                                mesh_dim_names=("data", "model"))
    return make_production_mesh(multi_pod=multi_pod, device_type=device_type)


def _chips(multi_pod: bool, mesh_shape) -> int:
    shape = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    n = 1
    for v in shape:
        n *= v
    return n


def param_bytes_per_dev(cfg, mesh) -> int:
    """Parameter bytes a device under the rules (the reference's formula:
    each leaf's bytes over the product of the mesh axes its spec
    names)."""
    from repro_torch.distributed.sharding import mesh_axes, pspec_for
    from repro_torch.models import param_specs
    from repro_torch.models.tree import param_leaves
    shape = mesh_axes(mesh)
    itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    total = 0
    for _, spec in param_leaves(param_specs(cfg)):
        pspec = pspec_for(spec, shape, fsdp=cfg.fsdp, strategy=cfg.strategy)
        shards = 1
        for ax in pspec:
            if ax is not None:
                if isinstance(ax, str):
                    shards *= shape[ax]
                else:
                    for a in ax:
                        shards *= shape[a]
        n = 1
        for v in spec.shape:
            n *= v
        total += n * itemsize / shards
    return int(total)


def _fake_tree(tree, device):
    from repro_torch.models.tree import tree_map
    return tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype,
                                          device=device), tree)


def _resolve(device: str) -> str:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to trace on the CPU)")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return device


def trace_cell(cfg, kind: str, seq: int, gbatch: int, mesh,
               device: str) -> dict:
    """Place the cell's inputs by the rules and run its step under the
    three counters -> the counted quantities."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.distributed.sharding import (
        batch_shardings, decode_state_shardings, mesh_axes,
        opt_state_shardings, param_shardings, place, replicated)
    from repro_torch.models import (decode_fn, decode_state_specs,
                                    make_batch_specs, param_shapes,
                                    prefill_fn)
    from repro_torch.train import adamw, make_train_step

    axes = mesh_axes(mesh)
    chips = 1
    for v in axes.values():
        chips *= v
    dp = chips // axes.get("model", 1)
    baxes = ("pod", "data", "model") if cfg.strategy == "fsdp" else None
    if baxes:
        dp = chips
    out: dict = {}
    with FakeTensorMode(allow_non_fake_inputs=True):
        p_shard = param_shardings(cfg, mesh)
        params = place(_fake_tree(param_shapes(cfg), device), p_shard)
        batch_specs = make_batch_specs(cfg, kind, seq, gbatch)
        b_shard = batch_shardings(mesh, batch_specs, baxes)
        batch = place(_fake_tree(batch_specs, device), b_shard)
        tracker = MemTracker()
        _track(tracker, params, "PARAM")
        if kind == "train":
            mb = choose_microbatches(cfg, seq, gbatch, dp)
            out["microbatches"] = mb
            opt = adamw(1e-4)
            with torch.no_grad():
                opt_state = place(opt.init(params),
                                  opt_state_shardings(p_shard, mesh))
            _track(tracker, (opt_state.mu, opt_state.nu), "OPT")
            step = make_train_step(cfg, opt, microbatches=mb)
            run = lambda: step(params, opt_state, batch)  # noqa: E731
        elif kind == "prefill":
            step = prefill_fn(cfg)
            run = lambda: step(params, batch)  # noqa: E731
        elif kind == "decode":
            state = place(_fake_tree(decode_state_specs(cfg, gbatch, seq),
                                     device),
                          decode_state_shardings(cfg, mesh, gbatch))
            _track(tracker, state, "OTH")
            token = batch["token"]
            if cfg.serve_2d:
                token = place({"t": token}, {"t": replicated(mesh)})["t"]
            step = decode_fn(cfg)
            run = lambda: step(params, state, token)  # noqa: E731
        else:
            raise ValueError(kind)
        flops, coll = _flop_counter(), _counter_mode()
        t0 = time.monotonic()
        with _MetaOutsideCounters(), tracker, flops, coll:
            run()
        out["trace_s"] = time.monotonic() - t0
        peak = tracker.get_tracker_snapshot("peak")
    out["flops_dev"] = float(flops.get_total_flops())
    out["collectives"] = coll.stats
    out["largest_collectives"] = coll.largest
    dev_peak = next(iter(peak.values()), {}) if peak else {}
    out["memory"] = {getattr(k, "name", str(k)): int(v)
                     for k, v in dev_peak.items()}
    return out


def _track(tracker, tree, category: str) -> None:
    """Register ``tree``'s local shards with ``MemTracker`` under its
    category (``track_external`` alone files them all as ``Other``)."""
    from torch.distributed._tools import mem_tracker as mt
    from torch.distributed.tensor import DTensor
    from repro_torch.models.tree import param_leaves
    leaves = []
    for part in (tree if isinstance(tree, tuple) else (tree,)):
        leaves += [x for _, x in param_leaves(part)]
    local = [x.to_local() if isinstance(x, DTensor) else x for x in leaves]
    ref = getattr(mt._MemRefType, category, mt._MemRefType.OTH)
    update = getattr(tracker, "_update_and_maybe_create_winfos", None)
    if update is None:
        tracker.track_external(*local)
        return
    for x in local:
        update(x, ref)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             overrides=(), mesh_shape=None, tag: str = "",
             device: str = "cuda") -> dict:
    from repro_torch.roofline.analysis import (Roofline, analytic_cost,
                                               model_flops)
    sh = SHAPES[shape_name]
    cfg = _apply_overrides(get_config(arch), overrides)
    if mesh_shape is not None:
        mesh_name = "x".join(map(str, mesh_shape))
    else:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    if tag:
        mesh_name += f"+{tag}"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "overrides": list(overrides or ()),
           "kind": sh["kind"], "seq_len": sh["seq_len"],
           "global_batch": sh["global_batch"], "status": "ok"}
    if shape_name == "long_500k" and not cfg.supports_long_context():
        rec["status"] = "skip"
        rec["reason"] = ("full-attention architecture; long_500k requires "
                         "sub-quadratic layers (DESIGN.md §6)")
        return rec
    device = _resolve(device)
    chips = _chips(multi_pod, mesh_shape)
    t0 = time.monotonic()
    _join_fake_group(chips)
    mesh = _mesh(multi_pod, mesh_shape, device)
    counted = trace_cell(cfg, sh["kind"], sh["seq_len"], sh["global_batch"],
                         mesh, device)
    rec["lower_s"] = round(time.monotonic() - t0, 1)
    rec["device"] = device
    if "microbatches" in counted:
        rec["microbatches"] = counted["microbatches"]
    mem = counted["memory"]
    rec["memory_analysis"] = {"peak_bytes": mem.get("Total", 0), **{
        k.lower() + "_bytes": v for k, v in mem.items() if k != "Total"}}
    rec["cost_analysis_raw"] = {"flops": counted["flops_dev"],
                                "flops_global": counted["flops_dev"] * chips}
    rec["collectives"] = counted["collectives"]
    rec["largest_collectives"] = counted["largest_collectives"]
    coll_bytes = sum(v["bytes"] for v in counted["collectives"].values())
    total = param_bytes_per_dev(cfg, mesh)
    rec["param_bytes_per_dev"] = total

    model_shards = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    ac = analytic_cost(cfg, sh["kind"], sh["seq_len"], sh["global_batch"],
                       chips=chips, model_shards=model_shards,
                       microbatches=rec.get("microbatches", 1),
                       param_bytes_dev=total)
    rec["analytic"] = ac
    mf = model_flops(cfg, sh["kind"], sh["seq_len"], sh["global_batch"])
    roof = Roofline(flops_dev=ac["flops_dev"], bytes_dev=ac["bytes_dev"],
                    coll_bytes_dev=coll_bytes, model_flops_global=mf,
                    chips=chips)
    rec["roofline"] = roof.as_dict()
    return rec


def format_summary(rec: dict) -> str:
    if rec["status"] == "skip":
        return (f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:10s} "
                f"SKIP ({rec['reason'][:40]}...)")
    r = rec["roofline"]
    return (f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:10s} "
            f"compute {r['compute_s']*1e3:9.2f} ms | mem "
            f"{r['memory_s']*1e3:9.2f} ms | "
            f"coll {r['collective_s']*1e3:9.2f} ms | {r['bottleneck']:10s} | "
            f"useful {r['useful_flops_ratio']*100:5.1f}% | "
            f"trace {rec['lower_s']:.0f}s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--all", action="store_true",
                    help="iterate every cell in subprocesses")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides key=value (hillclimb iterations)")
    ap.add_argument("--mesh-shape", default=None,
                    help="override mesh, e.g. 32x8 (axes data,model)")
    ap.add_argument("--tag", default="", help="suffix for the output file")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the fake tensors live (no allocation)")
    args = ap.parse_args(argv)
    mesh_shape = tuple(int(x) for x in args.mesh_shape.split("x")) \
        if args.mesh_shape else None
    os.makedirs(args.out, exist_ok=True)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                for mp in meshes:
                    mesh_name = "multi" if mp else "single"
                    tag = (f"{arch}__{shape}__"
                           f"{'pod2x16x16' if mp else 'pod16x16'}")
                    path = os.path.join(args.out, tag + ".json")
                    if os.path.exists(path) and not args.force:
                        with open(path) as f:
                            rec = json.load(f)
                        print("cached:", format_summary(rec)
                              if rec.get("status") != "error"
                              else f"{arch} {shape} ERROR")
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape,
                           "--mesh", mesh_name, "--out", args.out,
                           "--device", args.device]
                    proc = subprocess.run(cmd, capture_output=True,
                                          text=True)
                    if proc.returncode != 0:
                        rec = {"arch": arch, "shape": shape,
                               "mesh": "pod2x16x16" if mp else "pod16x16",
                               "status": "error",
                               "error": proc.stderr[-2000:]}
                        with open(path, "w") as f:
                            json.dump(rec, f, indent=1)
                        print(f"{arch:24s} {shape:12s} ERROR (see {path})")
                    else:
                        print(proc.stdout.strip().splitlines()[-1])
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    for mp in meshes:
        mesh_name = "x".join(map(str, mesh_shape)) if mesh_shape else \
            ("pod2x16x16" if mp else "pod16x16")
        if args.tag:
            mesh_name += f"+{args.tag}"
        tag = f"{args.arch}__{args.shape}__{mesh_name}"
        path = os.path.join(args.out, tag + ".json")
        try:
            rec = run_cell(args.arch, args.shape, multi_pod=mp,
                           overrides=args.override, mesh_shape=mesh_shape,
                           tag=args.tag, device=args.device)
        except Exception:
            rec = {"arch": args.arch, "shape": args.shape,
                   "mesh": mesh_name, "status": "error",
                   "error": traceback.format_exc()[-3000:]}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"ERROR {tag}\n{rec['error']}", file=sys.stderr)
            sys.exit(1)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(format_summary(rec))


if __name__ == "__main__":
    main()
