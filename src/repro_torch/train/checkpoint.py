"""Atomic, async checkpointing (``repro.train.checkpoint``), in the
reference's on-disk layout:

    <dir>/step_<N>/manifest.json       # leaf keys, shapes, dtypes, shards
    <dir>/step_<N>/<leaf-key>.s0.npy   # one file per leaf

A leaf's key is its path in the tree joined with ``.``: dict keys as they
are, a NamedTuple field as ``.<name>`` (so ``AdamWState.mu`` under
``opt_state`` is ``opt_state..mu``), a list index as its number, which is
how ``jax.tree_util`` names them.  A tensor leaf is written as one shard
covering the whole array (``index`` ``[[null, null], ...]``, as the
reference writes a one-device array); a numpy leaf has ``index`` null.
bfloat16 has no numpy dtype here: its leaves are written as the raw
16-bit payload (``<V2``, which is what ``np.save`` writes for the
reference's ``ml_dtypes.bfloat16`` arrays) under the manifest dtype
``"bfloat16"``, and read back the same way, so the port reads the
reference's bfloat16 checkpoints and float32 ones cross both ways.

Write path: copy the leaves to host memory synchronously, then a
background thread writes ``step_<N>.tmp`` and renames it atomically, so a
crash mid-write never corrupts the latest checkpoint; ``keep`` old steps
are removed.  Restore rebuilds the tree of ``tree_like``, each leaf on
that leaf's device.
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
        """Snapshot to host memory synchronously; write to disk (async)."""
        leaves = []
        for key, leaf in _leaf_paths(tree):
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

    def restore(self, tree_like: Any, step: Optional[int] = None
                ) -> tuple[int, Any]:
        """Rebuild the tree of ``tree_like`` from checkpoint ``step``
        (default the latest): each leaf with the saved dtype and values, on
        the device of ``tree_like``'s leaf (the CPU for a non-tensor)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {e["key"]: e for e in manifest["leaves"]}
        out = []
        for key, like in _leaf_paths(tree_like):
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
            out.append(_to_tensor(full, entry["dtype"], like))
        return step, _rebuild(tree_like, out)
