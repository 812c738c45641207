"""Port parity: the roofline and the dry run's arithmetic
(``repro_torch.roofline.analysis``, ``launch.dryrun.choose_microbatches``
and ``param_bytes_per_dev``, the models' spec helpers) against
``repro.roofline.analysis`` / ``repro.launch.dryrun`` / ``repro.models``.

``analytic_cost``, ``model_flops``, ``_cache_bytes_dev``,
``choose_microbatches`` and the parameter bytes a device are exactly the
reference's over the ten configs and the four shapes (the same
arithmetic in the same order); the ring wire bytes of one collective
equal what ``collective_stats`` reads from an HLO line of each kind;
``make_batch_specs``, ``decode_state_specs`` and ``param_shapes`` have the
reference's shapes and dtypes.  Importing ``repro.launch.dryrun`` sets
XLA's host device count for the whole process, so its two functions are
called in a subprocess.
"""
import json
import textwrap

import numpy as np
import pytest
import torch
import jax

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.models import decode_state_specs as j_decode_state_specs
from repro.models import make_batch_specs as j_make_batch_specs
from repro.models import param_shapes as j_param_shapes
from repro.roofline import analysis as ja
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch.dryrun import choose_microbatches, param_bytes_per_dev
from repro_torch.models import (decode_state_specs, make_batch_specs,
                                param_leaves, param_shapes)
from repro_torch.roofline import analysis as ta
from _subproc import run_with_devices
from _torch_common import (one_torch_thread,  # noqa: F401
                           release_jax_executables)

MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _cells():
    for arch in ARCH_IDS:
        for shape in SHAPES:
            for mesh in MESHES:
                yield arch, shape, mesh


@pytest.fixture(scope="module")
def reference_dryrun():
    """The reference dry run's ``choose_microbatches`` and its
    parameter-bytes formula for every cell, from a subprocess."""
    code = textwrap.dedent(f"""
        import json
        import numpy as np
        import jax, jax.numpy as jnp
        from repro.launch.dryrun import choose_microbatches
        from repro.configs import get_config, SHAPES
        from repro.distributed.sharding import pspec_for
        from repro.models.transformer import param_specs, ParamSpec
        meshes = {MESHES!r}
        class M:
            def __init__(self, shape):
                self.shape = shape
        out = {{}}
        for arch in {list(ARCH_IDS)!r}:
            cfg = get_config(arch)
            for name, shape in meshes.items():
                mesh = M(shape)
                chips = int(np.prod(list(shape.values())))
                total = 0
                for spec in jax.tree.leaves(
                        param_specs(cfg),
                        is_leaf=lambda x: isinstance(x, ParamSpec)):
                    pspec = pspec_for(spec, mesh, fsdp=cfg.fsdp,
                                      strategy=cfg.strategy)
                    shards = 1
                    for ax in pspec:
                        if ax is not None:
                            shards *= mesh.shape[ax] if isinstance(ax, str) \\
                                else int(np.prod([mesh.shape[a] for a in ax]))
                    n = int(np.prod(spec.shape))
                    total += n * jnp.dtype(cfg.dtype).itemsize / shards
                out[f"{{arch}}|{{name}}|bytes"] = int(total)
                for s, sh in SHAPES.items():
                    dp = chips // shape.get("model", 1)
                    if cfg.strategy == "fsdp":
                        dp = chips
                    out[f"{{arch}}|{{name}}|{{s}}|mb"] = choose_microbatches(
                        cfg, sh["seq_len"], sh["global_batch"], dp)
        print("JSON", json.dumps(out))
    """)
    out = run_with_devices(code, n_devices=1, timeout=300)
    return json.loads(out.split("JSON", 1)[1])


def test_configs_and_shapes_are_the_reference_ones():
    assert SHAPES == J_SHAPES
    assert [get_config(a).param_count() for a in ARCH_IDS] == [
        j_get_config(a).param_count() for a in ARCH_IDS]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_cost_and_model_flops_equal_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for shape, sh in SHAPES.items():
        kind, seq, gb = sh["kind"], sh["seq_len"], sh["global_batch"]
        assert ta.model_flops(cfg, kind, seq, gb) == ja.model_flops(
            jcfg, kind, seq, gb)
        for mesh in MESHES.values():
            chips = int(np.prod(list(mesh.values())))
            for mb, pbytes in ((1, 0.0), (4, 1.5e9)):
                kw = dict(chips=chips, model_shards=mesh["model"],
                          microbatches=mb, param_bytes_dev=pbytes)
                assert ta.analytic_cost(cfg, kind, seq, gb, **kw) == \
                    ja.analytic_cost(jcfg, kind, seq, gb, **kw)
            assert ta._cache_bytes_dev(cfg, seq, gb, chips, 16) == \
                ja._cache_bytes_dev(jcfg, seq, gb, chips, 16)
        assert ta._fwd_flops_per_token(cfg, seq, decode=kind == "decode") \
            == ja._fwd_flops_per_token(jcfg, seq, decode=kind == "decode")
    assert ta.dtype_size(cfg.dtype) == ja.jnp_dtype_size(jcfg.dtype)


def test_microbatches_and_param_bytes_equal_reference(reference_dryrun):
    for arch, shape, mesh in _cells():
        cfg, sh = get_config(arch), SHAPES[shape]
        chips = int(np.prod(list(MESHES[mesh].values())))
        dp = chips if cfg.strategy == "fsdp" else \
            chips // MESHES[mesh]["model"]
        assert choose_microbatches(cfg, sh["seq_len"], sh["global_batch"],
                                   dp) == \
            reference_dryrun[f"{arch}|{mesh}|{shape}|mb"], (arch, shape)
        assert param_bytes_per_dev(cfg, MESHES[mesh]) == \
            reference_dryrun[f"{arch}|{mesh}|bytes"], (arch, mesh)


HLO = {
    "all-gather": ("  %ag = bf16[16,4096]{1,0} all-gather(bf16[1,4096] %x),"
                   " replica_groups=[16,16]<=[256], dimensions={0}"),
    "all-reduce": ("  %ar = f32[2048,512]{1,0} all-reduce(f32[2048,512] %y),"
                   " replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%add"),
    "reduce-scatter": ("  %rs = f32[128,64]{1,0} reduce-scatter(f32[2048,64]"
                       " %z), replica_groups=[16,16]<=[256], dimensions={0}"),
    "all-to-all": ("  %aa = bf16[8,1024]{1,0} all-to-all(bf16[8,1024] %w),"
                   " replica_groups=[32,8]<=[256]"),
    "collective-permute": ("  %cp = f32[4,4]{1,0} collective-permute(f32[4,4]"
                           " %v), source_target_pairs={{0,1}}"),
}
RESULT = {"all-gather": (2 * 16 * 4096, 16),
          "all-reduce": (4 * 2048 * 512, 8),
          "reduce-scatter": (4 * 128 * 64, 16),
          "all-to-all": (2 * 8 * 1024, 8),
          "collective-permute": (4 * 4 * 4, 1)}


@pytest.mark.parametrize("kind", sorted(HLO))
def test_wire_bytes_equal_collective_stats(kind):
    want = ja.collective_stats(HLO[kind])[kind]
    nbytes, w = RESULT[kind]
    assert want["count"] == 1
    assert int(ta.wire_bytes(kind, nbytes, w)) == want["bytes"]


def test_roofline_uses_the_h100_constants():
    r = ta.Roofline(flops_dev=989e12, bytes_dev=3.35e12, coll_bytes_dev=50e9,
                    model_flops_global=989e12 * 4, chips=8)
    assert r.compute_s == r.memory_s == r.collective_s == 1.0
    assert r.useful_flops_ratio == 0.5
    d = r.as_dict()
    want = ja.Roofline(1.0, 1.0, 1.0, 1.0, 1).as_dict()
    assert set(d) == set(want)
    import inspect
    src = inspect.getsource(ta)
    assert "197e12" not in src and "819e9" not in src


def _spec_tree(tree) -> dict:
    return {path: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for path, x in param_leaves(tree)}


def _ref_spec_tree(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(k.key for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in flat}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_helpers_match_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert _spec_tree(param_shapes(cfg)) == _ref_spec_tree(
        j_param_shapes(jcfg))
    for shape, sh in SHAPES.items():
        kind, seq, gb = sh["kind"], sh["seq_len"], sh["global_batch"]
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in make_batch_specs(cfg, kind, seq, gb).items()}
        want = {k: (tuple(v.shape), str(v.dtype))
                for k, v in j_make_batch_specs(jcfg, kind, seq, gb).items()}
        assert got == want, shape
    rcfg, rjcfg = cfg.reduced(), jcfg.reduced()
    got = _spec_tree(decode_state_specs(rcfg, 4, 64))
    want = _ref_spec_tree(j_decode_state_specs(rjcfg, 4, 64))
    assert got == want
    assert all(x.device.type == "meta" for _, x in param_leaves(
        decode_state_specs(cfg, 128, 32768)))
    assert torch.empty(0).device.type == "cpu"
