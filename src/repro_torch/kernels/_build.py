"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process into a shared library
with a plain C interface, all processes started together, and loaded with
``ctypes``.  Nothing here runs at import: the first kernel launch builds.
Libraries go to ``build/repro_torch/<hash>/`` at the repository root,
keyed by a hash of the sources and the flags, so a rebuild happens only
when a source changes.  ``nvcc`` is found through ``CUDA_HOME``, then
``PATH``, then ``/usr/local/cuda``.

Wrappers may launch from several threads at once (the sharded discovery
fan-out): a first load builds under one module lock, so concurrent first
calls run one ``nvcc`` a source, and :func:`count_launch` adds to a
wrapper's ``launches`` under a lock of its own.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("sketch_build", "radix_select", "intersect_estimate",
           "sketch_merge", "matrix_sketch", "countsketch", "jl_rademacher")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict = {}
_BOUND: set = set()        # (source, C entry) whose argtypes are set
BUILD_SECONDS: dict = {}   # source -> wall seconds of its nvcc run
# held by builds, loads and argtype binding
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return _build_dir() / f"lib{name}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all at once.  Returns ``{name: ptxas report}``; raises with the
    compiler's output if any build fails."""
    with _LOAD_LOCK:
        return _build_all()


def _build_all() -> dict:
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in SOURCES:
        if lib_path(name).exists():
            continue
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (rc={proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {name: (out_dir / f"{name}.log").read_text()
            for name in SOURCES if (out_dir / f"{name}.log").exists()}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed.  ``signatures`` maps each C entry the caller uses to its
    ``argtypes``; every entry returns a ``cudaError_t`` (int).  Several
    wrapper modules may bind entries of one library.  A library loaded
    with these entries bound returns without taking the lock."""
    lib = _LIBS.get(name)
    if lib is not None and all((name, fn) in _BOUND for fn in signatures):
        return lib
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not lib_path(name).exists():
                _build_all()
            lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in signatures.items():
            if (name, fn) not in _BOUND:
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
                _BOUND.add((name, fn))
        _LIBS[name] = lib
    return lib


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (a read-modify-write, so under a
    lock: wrappers launch from the fan-out's worker threads)."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def launch_on(dev, launch):
    """``launch(stream)`` with PyTorch's current stream of CUDA device
    ``dev``; the current device is switched only when ``dev`` is not it
    already.  Returns what ``launch`` returns (a ``cudaError_t``)."""
    if dev.index == torch.cuda.current_device():
        return launch(torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(dev):
        return launch(torch.cuda.current_stream().cuda_stream)


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError_t {err}")
