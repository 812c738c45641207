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
kinds at once and once a session.  After the families,
``EXTRA_CELLS`` run in the same subprocesses: the MoE (its experts
split, and whole) and the loss of a wide vocabulary issue no collective
that holds the whole batch's tokens or rows (the record's
``batch_sized_collectives``), prefill and decode with kv heads that
divide the model axis trace, and none of them makes a tensor of the
whole batch's rows or tokens (``largest_tensors``).
Without a card, ``--device cuda`` exits nonzero and writes an error
record.
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
# cells that failed or held the whole batch's tensors on a rank before the
# MoE, the loss, decode attention and the prefill's decode state ran on
# each rank's own share: their sequence is SEQ2, so that the batch's token
# count (BATCH x SEQ2) and row count (BATCH) are no dim of any weight
SEQ2 = 40
EXTRA_CELLS = {
    # the experts split 4 ways (an all-to-all), and whole on every rank;
    # a vocabulary large enough that DTensor's own layout of the logits
    # product reduced the whole batch's rows of a loss chunk
    "train": (("qwen3-moe-235b-a22b", ("n_experts=4",)),
              ("qwen2-moe-a2.7b", ("n_experts=6",)),
              ("command-r-plus-104b", ("vocab_size=4096",))),
    # kv heads that divide the model axis, the batch split on data
    "prefill": (("phi-3-vision-4.2b", ("n_kv_heads=4",)),),
    "decode": (("phi-3-vision-4.2b", ("n_kv_heads=4",)),
               ("qwen2-moe-a2.7b", ("n_kv_heads=4",))),
}
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
    """kind -> the families' records, then its ``EXTRA_CELLS``': one
    subprocess a kind, the three at once."""
    procs = {}
    for kind, shape in KINDS.items():
        code = DEBUG_CELLS + textwrap.dedent(f"""
            import json, torch
            torch.set_num_threads(1)
            out = [D.run_cell(a, {shape!r}, multi_pod=False,
                              mesh_shape=(2, 4), device="cpu")
                   for a in {list(FAMILY_ARCHS)!r}]
            D.SHAPES = {{k: dict(v, seq_len={SEQ2})
                        for k, v in D.SHAPES.items()}}
            out += [D.run_cell(a, {shape!r}, multi_pod=False,
                               mesh_shape=(2, 4), device="cpu",
                               overrides=o)
                    for a, o in {list(EXTRA_CELLS.get(kind, ()))!r}]
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
    got = records[kind][:len(FAMILY_ARCHS)]
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


def _extra(records, kind: str, arch: str) -> dict:
    got = records[kind][len(FAMILY_ARCHS):]
    assert [r["arch"] for r in got] == [a for a, _ in EXTRA_CELLS[kind]]
    rec = next(r for r in got if r["arch"] == arch)
    assert rec["status"] == "ok" and rec["seq_len"] == SEQ2, rec
    return rec


def _whole_batch(shape) -> bool:
    """A shape that holds the whole batch's tokens, or its rows (a data
    shard holds BATCH / 2), in one of its first two dims."""
    return BATCH * SEQ2 in shape or BATCH in shape[:2]


def _made(rec) -> list:
    return [(t["shape"], t["where"]) for t in rec["largest_tensors"]
            if _whole_batch(t["shape"])]


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "qwen2-moe-a2.7b"])
def test_moe_train_holds_no_global_tokens(arch, records):
    """Each rank routes its own tokens: no collective's result holds the
    whole batch's tokens (BATCH x SEQ2 rows, or (BATCH, SEQ2, ...)) and
    no tensor a rank makes does; the experts' slots travel by all-to-all
    where the model axis splits the experts (qwen3-moe-235b-a22b's 4 of
    4), and stay on the rank where they are whole (6 experts)."""
    rec = _extra(records, "train", arch)
    bad = [(c["kind"], c["shape"], c["where"])
           for c in rec["batch_sized_collectives"]
           if BATCH * SEQ2 in c["shape"] or c["shape"][:2] == [BATCH, SEQ2]]
    assert not bad, bad
    assert not _made(rec), rec["largest_tensors"]
    assert ("all-to-all" in rec["collectives"]) == (
        arch == "qwen3-moe-235b-a22b"), rec["collectives"]


def test_loss_holds_no_global_rows(records):
    """Each rank computes the logits of its own rows: no collective's
    result is a (BATCH, positions, ...) tensor of the whole batch's rows
    (a data shard holds BATCH / 2), and no tensor a rank makes holds
    them."""
    rec = _extra(records, "train", "command-r-plus-104b")
    bad = [(c["kind"], c["shape"], c["where"])
           for c in rec["batch_sized_collectives"]
           if len(c["shape"]) == 3 and c["shape"][0] == BATCH]
    assert not bad, bad
    assert not _made(rec), rec["largest_tensors"]


def test_prefill_makes_only_own_state(records):
    """Prefill with kv heads split on the model axis makes only each
    rank's shards of the decode state (the (groups, BATCH, ...) caches of
    the whole batch are never made on a rank)."""
    rec = _extra(records, "prefill", "phi-3-vision-4.2b")
    assert rec["overrides"] == ["n_kv_heads=4"]
    assert rec["largest_tensors"] and not _made(rec), rec["largest_tensors"]


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "qwen2-moe-a2.7b"])
def test_decode_with_kv_heads_split(arch, records):
    """kv heads that divide the model axis (4 of 4) with the batch split
    on data: the score and value products run on each rank's own
    (batch, kv-head) block, and no rank makes a tensor of the whole
    batch's rows."""
    rec = _extra(records, "decode", arch)
    assert rec["overrides"] == ["n_kv_heads=4"]
    assert rec["cost_analysis_raw"]["flops"] > 0
    assert rec["largest_tensors"] and not _made(rec), rec["largest_tensors"]


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "gemma2-2b"])
def test_all_rounds_depth_cut_to_pattern_period(arch):
    """``--all``'s depth cut: up to a multiple of the layer pattern's
    period (recurrentgemma-2b's 3), never past the published depth."""
    from repro_torch.launch.dryrun import cut_overrides
    cfg = get_config(arch)
    p = cfg.pattern_period
    for n in (1, 2, 3, 4, cfg.n_layers, cfg.n_layers + 5):
        (got,) = cut_overrides(cfg, [f"n_layers={n}"])
        depth = int(got.split("=")[1])
        assert depth % p == 0 or depth == cfg.n_layers, got
        assert min(n, cfg.n_layers) <= depth <= min(n + p - 1,
                                                     cfg.n_layers), got
    assert cut_overrides(cfg, ["vocab_size=4096"]) == ["vocab_size=4096"]


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
