"""Atomic, async checkpointing (``repro.train.checkpoint``), in the
reference's on-disk layout:

    <dir>/step_<N>/manifest.json       # leaf keys, shapes, dtypes, shards
    <dir>/step_<N>/<leaf-key>.s0.npy   # one file per leaf

A leaf's key is its path in the tree joined with ``.``: dict keys as they
are, a NamedTuple field as ``.<name>`` (so ``AdamWState.mu`` under
``opt_state`` is ``opt_state..mu``), a list index as its number, which is
how ``jax.tree_util`` names them.  A plain tensor leaf is written as one
shard covering the whole array (``index`` ``[[null, null], ...]``, as the
reference writes a one-device array); a numpy leaf has ``index`` null.
A DTensor leaf (a tree laid out by ``distributed.sharding``) is written
one file a distinct local shard, ``<leaf>.s<k>.npy`` with ``k`` the
writing rank and ``index`` its ``[start, stop]`` a dim, by the ranks
that hold it (one copy of a replicated shard); rank 0 writes the
manifest once every rank's shards are on disk.
bfloat16 has no numpy dtype here: its leaves are written as the raw
16-bit payload (``<V2``, which is what ``np.save`` writes for the
reference's ``ml_dtypes.bfloat16`` arrays) under the manifest dtype
``"bfloat16"``, and read back the same way, so the port reads the
reference's bfloat16 checkpoints and float32 ones cross both ways.

Write path: copy the leaves to host memory synchronously, then a
background thread writes ``step_<N>.tmp`` and renames it atomically, so a
crash mid-write never corrupts the latest checkpoint; ``keep`` old steps
are removed; a tree holding DTensors is written synchronously (the ranks
meet at barriers around the manifest).  Restore rebuilds the tree of
``tree_like``, each leaf on that leaf's device, or laid out by
``shardings`` (a tree of ``sharding.NamedSharding``): every rank reads
the leaf whole and keeps its shard, so a checkpoint written on one mesh
restores on a smaller or larger one.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.dt import is_dt

_RAW16 = np.dtype("V2")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaf_paths(tree, prefix: tuple = ()) -> list:
    """(key, leaf) in ``jax.tree_util``'s order and naming."""
    if isinstance(tree, dict):
        return [kl for k in sorted(tree)
                for kl in _leaf_paths(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kl for name, v in zip(tree._fields, tree)
                for kl in _leaf_paths(v, prefix + ("." + name,))]
    if isinstance(tree, (list, tuple)):
        return [kl for i, v in enumerate(tree)
                for kl in _leaf_paths(v, prefix + (str(i),))]
    return [(".".join(prefix), tree)]


def _rebuild(tree, leaves: list):
    """``tree``'s structure with its leaves taken in order from
    ``leaves`` (consumed)."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return leaves.pop(0)


def _local_shard(leaf):
    """(local tensor, index [[start, stop], ...], whether this rank writes
    it: the first holder of each distinct shard) of a DTensor."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, pl = leaf.device_mesh, tuple(leaf.placements)
    shape, offset = compute_local_shape_and_global_offset(
        tuple(leaf.shape), mesh, pl)
    coord = mesh.get_coordinate()
    writes = all(c == 0 for c, p in zip(coord, pl) if not p.is_shard())
    index = [[int(o), int(o) + int(n)] for o, n in zip(offset, shape)]
    return leaf.to_local(), index, writes


def _host(t: torch.Tensor):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(_RAW16), "bfloat16"
    arr = t.cpu().numpy()
    return arr, str(arr.dtype)


def _to_host(leaf):
    """(array to write, manifest dtype, shard index)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        index = [[None, None]] * t.ndim
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(_RAW16), \
                "bfloat16", index
        arr = t.cpu().numpy()
        return arr, str(arr.dtype), index
    arr = np.asarray(leaf)
    return arr, str(arr.dtype), None


def _save(path: str, arr: np.ndarray, dtype: str) -> None:
    """``np.save``; a bfloat16 payload gets the header ``np.save`` writes
    for an ``ml_dtypes.bfloat16`` array (descr ``<V2``), so the file is
    byte for byte the reference's."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    arr = np.require(arr, requirements="C")
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


def _sharding_leaves(tree_like, shardings) -> list:
    """``shardings``' leaves in ``tree_like``'s leaf order (a sharding in
    place of a subtree applies to each of its leaves)."""
    from repro_torch.distributed.sharding import NamedSharding

    def walk(tree, sh):
        if sh is None or isinstance(sh, NamedSharding):
            return [sh] * len(_leaf_paths(tree))
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in walk(tree[k], sh[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v, s_ in zip(tree, sh) for x in walk(v, s_)]
        return [sh]

    return walk(tree_like, shardings)


def _placed(t: torch.Tensor, sharding):
    """``t`` (the whole leaf) laid out by ``sharding`` when given."""
    if sharding is None:
        return t
    from repro_torch.distributed.sharding import place_leaf
    return place_leaf(t.to(sharding.mesh.device_type), sharding)


def _to_tensor(arr: np.ndarray, dtype: str, like) -> torch.Tensor:
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    if dtype == "bfloat16":
        raw = np.require(arr, requirements="C").view(np.int16)
        return torch.from_numpy(raw).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.require(arr, requirements="C")).to(dev)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any) -> None:
        """Snapshot to host memory synchronously; write to disk (async; a
        tree of DTensors synchronously, every rank calling)."""
        paths = _leaf_paths(tree)
        if any(is_dt(leaf) for _, leaf in paths):
            self._save_sharded(step, paths)
            return
        leaves = []
        for key, leaf in paths:
            arr, dtype, index = _to_host(leaf)
            leaves.append((key, list(arr.shape), dtype, [(index, arr)]))
        if self.async_save:
            self._ensure_worker()
            self._queue.put((step, leaves))
        else:
            self._write(step, leaves)

    def wait(self) -> None:
        if self._worker is not None:
            self._queue.join()
        if self._error is not None:
            raise self._error

    # ------------------------------------------------------------------
    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    def _run(self):
        while True:
            step, leaves = self._queue.get()
            try:
                self._write(step, leaves)
            except BaseException as e:  # surfaced on wait()
                self._error = e
            finally:
                # the idle thread must not keep the last host copy alive
                leaves = None
                self._queue.task_done()

    def _write(self, step: int, leaves) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for key, shape, dtype, arrs in leaves:
            entry = {"key": key, "shape": shape, "dtype": dtype, "shards": []}
            for i, (index, arr) in enumerate(arrs):
                fname = f"{key}.s{i}.npy"
                _save(os.path.join(tmp, fname), arr, dtype)
                entry["shards"].append({"file": fname, "index": index})
            manifest["leaves"].append(entry)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._gc()

    def _save_sharded(self, step: int, paths) -> None:
        """Each rank writes its distinct shards into ``step_<N>.tmp``; rank
        0 gathers every rank's entries, writes the manifest and renames
        the directory."""
        import torch.distributed as dist
        self.wait()
        rank = dist.get_rank()
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        dist.barrier()
        mine, meta = [], []
        for key, leaf in paths:
            if is_dt(leaf):
                local, index, writes = _local_shard(leaf)
                arr, dtype = _host(local)
            else:
                arr, dtype, index = _to_host(leaf)
                writes = rank == 0
            meta.append((key, list(leaf.shape), dtype))
            if writes:
                fname = f"{key}.s{rank}.npy"
                _save(os.path.join(tmp, fname), arr, dtype)
                mine.append((key, {"file": fname, "index": index}))
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, mine)
        if rank == 0:
            shards: dict = {}
            for entries in everyone:
                for key, shard in entries:
                    shards.setdefault(key, []).append(shard)
            manifest = {"step": step, "leaves": [
                {"key": key, "shape": shape, "dtype": dtype,
                 "shards": shards.get(key, [])}
                for key, shape, dtype in meta]}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            self._gc()
        dist.barrier()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                shardings: Any = None) -> tuple[int, Any]:
        """Rebuild the tree of ``tree_like`` from checkpoint ``step``
        (default the latest): each leaf with the saved dtype and values, on
        the device of ``tree_like``'s leaf (the CPU for a non-tensor).
        ``shardings`` (same structure, ``sharding.NamedSharding`` leaves
        or None) lays a leaf out on its mesh, which may be smaller or
        larger than the one that saved it (elastic restore)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {e["key"]: e for e in manifest["leaves"]}
        shard_flat = None
        if shardings is not None:
            shard_flat = _sharding_leaves(tree_like, shardings)
        out = []
        for i, (key, like) in enumerate(_leaf_paths(tree_like)):
            entry = by_key[key]
            raw = entry["dtype"] == "bfloat16"
            full = np.zeros(entry["shape"], _RAW16 if raw else entry["dtype"])
            for sh in entry["shards"]:
                arr = np.load(os.path.join(d, sh["file"]))
                if raw:
                    arr = arr.view(_RAW16)
                if sh["index"] is None:
                    full = arr
                else:
                    full[tuple(slice(a, b) for a, b in sh["index"])] = arr
            out.append(_placed(_to_tensor(full, entry["dtype"], like),
                               shard_flat[i] if shard_flat else None))
        return step, _rebuild(tree_like, out)
