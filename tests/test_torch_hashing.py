"""Port parity: hashing, weights and sampling ranks are bit-equal to
``repro.core`` (coordination across packages is bit-level)."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _subproc import run_with_devices
from _torch_common import assert_bits, edge_values, to_np
from _torch_common import release_jax_executables  # noqa: F401

from repro.core import hashing as jh
from repro.core import sketches as js
from repro_torch.core import hashing as th
from repro_torch.core import sketches as ts

SEEDS = [0, 11, 0xB0C4, 2**31 - 1]
ALL_IDX = np.arange(1 << 20, dtype=np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_unit_bit_equal(seed):
    assert_bits(th.hash_unit(seed, torch.as_tensor(ALL_IDX)),
                jh.hash_unit(seed, jnp.asarray(ALL_IDX)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_buckets", [512, 300])
def test_hash_bucket_bit_equal(seed, n_buckets):
    assert_bits(th.hash_bucket(seed, torch.as_tensor(ALL_IDX), n_buckets),
                jh.hash_bucket(seed, jnp.asarray(ALL_IDX), n_buckets))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("variant", ["l2", "l1", "uniform"])
def test_sampling_ranks_bit_equal(seed, variant):
    rng = np.random.default_rng(seed & 0xFFFF)
    v = edge_values(rng, 1, ALL_IDX.size)[0]
    h_t = th.hash_unit(seed, torch.as_tensor(ALL_IDX))
    h_j = jh.hash_unit(seed, jnp.asarray(ALL_IDX))
    r_t = ts.sampling_ranks(ts.weight(torch.as_tensor(v), variant), h_t)
    r_j = js.sampling_ranks(js.weight(jnp.asarray(v), variant), h_j)
    assert_bits(r_t, r_j)


def test_mix32_fold_seed_sign_u32_bit_equal():
    x = np.concatenate([np.arange(4096, dtype=np.uint32),
                        np.array([2**32 - 1, 2**31, 0x9E3779B9], np.uint32)])
    got = to_np(th.mix32(torch.as_tensor(x.astype(np.int64))))
    assert np.array_equal(got.astype(np.uint32),
                          np.asarray(jh.mix32(jnp.asarray(x))))
    for seed in SEEDS:
        for stream in (0, 1, 7):
            assert int(th.fold_seed(seed, stream)) == \
                int(jh.fold_seed(seed, stream))
        idx = ALL_IDX[:5000]
        assert np.array_equal(
            to_np(th.hash_u32(seed, torch.as_tensor(idx))).astype(np.uint32),
            np.asarray(jh.hash_u32(seed, jnp.asarray(idx))))
        assert_bits(th.hash_sign(seed, torch.as_tensor(idx)),
                    jh.hash_sign(seed, jnp.asarray(idx)))


@pytest.mark.parametrize("variant", ["l2", "l1", "uniform"])
def test_weight_flushes_like_reference(variant):
    """The rank follows the reference wherever XLA's flush-to-zero
    changes it; the weight agrees wherever it is a normal number."""
    v = np.array([1e-40, -1e-40, 1e-20, 1e-19, 1.1e-19, 1e19, 1e20, 0.0,
                  -0.0, 3.0, np.nan], np.float32)
    w_t = to_np(ts.weight(torch.as_tensor(v), variant))
    w_j = np.asarray(js.weight(jnp.asarray(v), variant))
    normal = ~(np.abs(w_j) < np.finfo(np.float32).tiny) | (w_j == 0)
    assert_bits(w_t[normal], w_j[normal])
    h = th.hash_unit(0, torch.arange(v.size, dtype=torch.int32))
    assert_bits(ts.sampling_ranks(torch.as_tensor(w_t), h),
                js.sampling_ranks(jnp.asarray(w_j),
                                  jh.hash_unit(0, jnp.arange(v.size))))


def test_default_device_needs_a_card():
    from repro_torch import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_port_imports_no_jax_and_no_reference():
    """Importing every port module loads no ``jax*`` and no ``repro``
    module (the port stands alone on torch and numpy)."""
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.obs, repro_torch.core, "
        "repro_torch.engine, repro_torch.kernels, repro_torch.serve, "
        "repro_torch.distributed, repro_torch.quickstart\n"
        "import repro_torch.core.threshold, repro_torch.core.merge, "
        "repro_torch.core.variance, repro_torch.core.batched, "
        "repro_torch.engine.merge, repro_torch.kernels.hash_rank, "
        "repro_torch.kernels.sketch_merge, repro_torch.matrix, "
        "repro_torch.matrix.variance, repro_torch.engine.estimate, "
        "repro_torch.kernels.matrix_sketch, repro_torch.serve.convert\n"
        "import repro_torch.private, repro_torch.private.accountant, "
        "repro_torch.private.release, repro_torch.private.biasaware, "
        "repro_torch.core.baselines, repro_torch.kernels.countsketch.ops, "
        "repro_torch.kernels.jl_rademacher.ops\n"
        "import repro_torch.data, repro_torch.data.tables, "
        "repro_torch.data.synthetic, repro_torch.core.join_correlation, "
        "repro_torch.kernels.sketch_build.combined, "
        "repro_torch.serve.discovery, repro_torch.serve.resilience, "
        "repro_torch.train, repro_torch.train.fault_tolerance\n"
        "import repro_torch.obs.metrics, repro_torch.obs.tracing, "
        "repro_torch.obs.quality\n"
        "import repro_torch.configs, repro_torch.configs.paper_sketch, "
        "repro_torch.models, repro_torch.models.layers, "
        "repro_torch.models.transformer, repro_torch.models.convert, "
        "repro_torch.train.optimizer, repro_torch.train.loop, "
        "repro_torch.train.checkpoint, repro_torch.train.telemetry, "
        "repro_torch.data.pipeline, repro_torch.launch, "
        "repro_torch.launch.train, "
        "repro_torch.distributed.grad_compress, repro_torch.models.model, "
        "repro_torch.serve.engine, repro_torch.launch.serve\n"
        "from repro_torch.models import (prefill_fn, decode_fn, "
        "init_decode_state, state_from_reference, state_to_reference)\n"
        "from repro_torch.serve import Engine, Request\n"
        "from repro_torch.configs import get_config, ARCH_IDS\n"
        "[get_config(a) for a in ARCH_IDS]\n"
        "from repro_torch.obs import CanaryMonitor, observe_recovery\n"
        "from repro_torch.serve import (DurableSketchIndex, IngestJournal, "
        "ResilientSketchIndex, ResilientMatrixStore, save_snapshot)\n"
        "from repro_torch.kernels import _build\n"
        "import repro_torch.distributed.sharding, repro_torch.launch.mesh, "
        "repro_torch.launch.dryrun, repro_torch.roofline.analysis, "
        "repro_torch.models.dt\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    assert "BAD []" in run_with_devices(code, n_devices=1, timeout=300)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU exit")
def test_kernel_ab_script_needs_a_card():
    """``kernels/kernel_ab.py`` (the B7/B9 timing script for comparing
    checkouts) exits nonzero and prints no result without a card, and
    loads no jax while it does."""
    root = Path(__file__).resolve().parents[1]
    script = root / "src" / "repro_torch" / "kernels" / "kernel_ab.py"
    probe = ("import runpy, sys\n"
             f"sys.argv = [{str(script)!r}]\n"
             f"sys.path.insert(0, {str(script.parent)!r})\n"
             "try:\n"
             f"    runpy.run_path({str(script)!r}, run_name='__main__')\n"
             "finally:\n"
             "    print('JAX', any(m == 'jax' or m.startswith('jax.') "
             "for m in sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", probe], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "needs a CUDA card" in r.stderr
    assert "JAX False" in r.stdout
    assert "{" not in r.stdout
