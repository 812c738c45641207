"""The port's dry run (``python -m repro_torch.launch.dryrun``) on a debug
mesh: a fake process group of 8 ranks as a (2, 4) ("data", "model")
mesh, the reduced config of one architecture of every family (dense,
MoE, SSM, hybrid, audio, VLM), for the train step, prefill and decode
(``run_cell(..., mesh_shape=(2, 4), device="cpu")`` with the module's
configs and shapes swapped for the reduced ones).

Each record has the reference's keys (``status``, ``collectives``,
``param_bytes_per_dev``, ``analytic``, ``roofline`` with its ``as_dict``
keys, ``memory_analysis``, ``cost_analysis_raw.flops``; ``microbatches``
for train); the train step counts collectives; ``param_bytes_per_dev`` is
the reference dry run's formula over the reference's own pspecs; every
roofline term and the useful-FLOPs ratio are positive, FLOPs are
counted.  (At these widths the tied embedding's lookup, which the model
FLOPs count as 2 N D but which does no arithmetic, is a large share of
the parameters: the published-size bounds on the counted FLOPs and the
ratio are ``chip_smoke.py``'s gates.)  A kind's cells run in one
subprocess (the fake group is the process's default group), the three
kinds at once and once a session.  Without a
card, ``--device cuda`` exits nonzero and writes an error record.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.distributed.sharding import pspec_for as j_pspec_for
from repro.models.transformer import ParamSpec as JParamSpec
from repro.models.transformer import param_specs as j_param_specs
from repro.roofline.analysis import Roofline as JRoofline
from repro_torch.configs import ARCH_IDS, get_config
from _torch_common import (once_per_session,
                           one_torch_thread,  # noqa: F401
                           release_jax_executables)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
SEQ, BATCH = 32, 8
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
# one of each family (``ModelConfig.family``)
FAMILY_ARCHS = ("gemma2-2b", "qwen2-moe-a2.7b", "mamba2-370m",
                "recurrentgemma-2b", "whisper-small", "phi-3-vision-4.2b")
KEYS = {"arch", "shape", "mesh", "kind", "status", "collectives",
        "param_bytes_per_dev", "analytic", "roofline", "memory_analysis",
        "cost_analysis_raw", "lower_s"}


# the dry run at the reduced configs, on SEQ-token sequences, BATCH a batch
DEBUG_CELLS = textwrap.dedent(f"""
    import repro_torch.launch.dryrun as D
    _full = D.get_config
    D.get_config = lambda arch: _full(arch).reduced()
    D.SHAPES = {{k: dict(v, seq_len={SEQ}, global_batch={BATCH})
                for k, v in D.SHAPES.items()}}
""")


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    return env


def _run(code: str, timeout: int = 600) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=timeout)


def _all_records(work: str) -> dict:
    """kind -> the families' records: one subprocess a kind, the three
    at once."""
    procs = {}
    for kind, shape in KINDS.items():
        code = DEBUG_CELLS + textwrap.dedent(f"""
            import json, torch
            torch.set_num_threads(1)
            out = [D.run_cell(a, {shape!r}, multi_pod=False,
                              mesh_shape=(2, 4), device="cpu")
                   for a in {list(FAMILY_ARCHS)!r}]
            print("JSON", json.dumps(out))
        """)
        procs[kind] = subprocess.Popen(
            [sys.executable, "-c", code], env=_env(), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out = {}
    for kind, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            proc.kill()
        assert proc.returncode == 0, stderr[-4000:]
        out[kind] = json.loads(stdout.split("JSON", 1)[1])
    return out


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """kind -> the families' records, made once a session
    (``once_per_session``)."""
    return once_per_session(tmp_path_factory, "torch_dryrun_records",
                            _all_records)[1]


def _ref_param_bytes(arch: str) -> int:
    """The reference dry run's formula, over the reference's pspecs on a
    (2, 4) mesh (its rules read ``mesh.shape`` only)."""
    cfg = j_get_config(arch).reduced()

    class M:
        shape = {"data": 2, "model": 4}

    total = 0
    for spec in jax.tree.leaves(j_param_specs(cfg),
                                is_leaf=lambda x: isinstance(x, JParamSpec)):
        pspec = j_pspec_for(spec, M, fsdp=cfg.fsdp, strategy=cfg.strategy)
        shards = 1
        for ax in pspec:
            if ax is not None:
                shards *= M.shape[ax] if isinstance(ax, str) else \
                    int(np.prod([M.shape[a] for a in ax]))
        total += int(np.prod(spec.shape)) * jnp.dtype(
            cfg.dtype).itemsize / shards
    return int(total)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_debug_mesh_records(kind, records):
    want_keys = set(JRoofline(1.0, 1.0, 1.0, 1.0, 1).as_dict())
    assert ({get_config(a).family for a in FAMILY_ARCHS}
            == {get_config(a).family for a in ARCH_IDS})
    got = records[kind]
    assert [rec["arch"] for rec in got] == list(FAMILY_ARCHS)
    for rec in got:
        arch = rec["arch"]
        assert rec["status"] == "ok", rec
        assert KEYS <= set(rec), (arch, KEYS - set(rec))
        assert rec["kind"] == kind and rec["mesh"] == "2x4"
        assert set(rec["roofline"]) == want_keys
        r = rec["roofline"]
        assert r["chips"] == 8
        assert min(r["compute_s"], r["memory_s"], r["collective_s"]) > 0, \
            (arch, r)
        assert r["useful_flops_ratio"] > 0, (arch, r)
        assert rec["cost_analysis_raw"]["flops"] > 0, arch
        assert rec["param_bytes_per_dev"] == _ref_param_bytes(arch), arch
        assert rec["memory_analysis"]["peak_bytes"] > 0
        assert rec["memory_analysis"]["param_bytes"] > 0
        if kind == "train":
            assert rec["microbatches"] >= 1
            assert sum(v["count"] for v in rec["collectives"].values()) > 0
            assert rec["memory_analysis"]["opt_bytes"] > 0


def test_cuda_device_without_a_card_fails(tmp_path):
    """``--device cuda`` never falls back to the CPU: no card, an error
    record and a nonzero exit."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(DEBUG_CELLS + "D.main(['--arch', 'gemma2-2b', '--shape', "
             "'train_4k', '--mesh-shape', '2x4', '--out', "
             f"{str(tmp_path)!r}])\n")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    rec = json.load(open(tmp_path / "gemma2-2b__train_4k__2x4.json"))
    assert rec["status"] == "error" and "roofline" not in rec
