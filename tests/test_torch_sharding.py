"""Port parity: the LM sharding surface (``repro_torch.distributed.
sharding``, the mesh helpers, sharded checkpoints) against
``repro.distributed.sharding`` and ``repro.train.checkpoint``.

- The rules: ``param_pspecs``, ``batch_pspec`` and ``decode_state_pspecs``
  entry for entry the reference's, over the ten full configs on four
  meshes, under each config's own ``fsdp`` / ``strategy`` and under
  ``strategy="fsdp"``.  The reference reads only ``mesh.shape``, so it is
  called with a stub carrying that mapping.
- The layout: every rank's shard offset and shape on a (2, 4) mesh (a
  fake process group, rank by rank) equal JAX's ``NamedSharding(...).
  devices_indices_map`` for the same spec (8 host devices in a
  subprocess).
- The sharded loss: on an 8-rank gloo (2, 4) mesh (``_torch_mesh_worker.
  py``) the reduced configs of ``LOSS_CASES`` (gemma2-2b, and the MoE's
  three layouts, with and without forced drops), the reference's
  weights (q / k scaled by 1/4, as ``test_torch_models.py``) carried
  over: the DTensor loss within ``1e-5 max(1, |loss|)`` of the
  reference's ``loss_fn`` run unsharded here, every gradient leaf within
  ``1e-4`` of its scale of the port's unsharded gradient (the mesh sums
  the partial products in another order), the experts split 4 ways.
- Sharded serving: on the same ranks, the reduced configs of
  ``SERVE_CASES`` (kv heads that divide the model axis, the batch split
  on data) prefill a prompt and decode ``SERVE_STEPS`` tokens; every
  step's logits and the final decode state within ``1e-4`` of their
  scale of the port's unsharded prefill and decode.
- Checkpoints: the port's 8-rank sharded save restores bit for bit on 4
  ranks and in the reference on 4 devices; the reference's 8-device save
  restores bit for bit on the port's 4-rank mesh.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.distributed import sharding as js
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as ts
from repro_torch.models import (decode_fn, loss_fn, param_leaves,
                                params_from_reference, prefill_fn)
from repro_torch.train import value_and_grad
from _subproc import run_with_devices
from _torch_common import (once_per_session,
                           one_torch_thread,  # noqa: F401
                           release_jax_executables)

HERE = os.path.dirname(os.path.abspath(__file__))
MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4}, {"data": 8}]
B, S = 4, 64
# case -> (arch, reduced config overrides, sequence length): the MoE's
# three layouts on the (2, 4) mesh (the experts split along the model
# axis that splits the tokens: all-to-all; the experts whole: each rank
# runs every expert; the tokens whole along the model axis because its
# 126 a data shard do not divide by 4: each rank its own experts), with
# forced drops (capacity factor 0.5: the drops and the slot (0, 0) rule
# are the whole slab's)
LOSS_CASES = {
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}, S),
    "gemma2-2b": ("gemma2-2b", {}, S),
    "qwen3-moe-235b-a22b": ("qwen3-moe-235b-a22b", {}, S),
    "qwen3-moe-235b-a22b+drops": ("qwen3-moe-235b-a22b",
                                  {"capacity_factor": 0.5}, S),
    "qwen2-moe-a2.7b+drops": ("qwen2-moe-a2.7b", {"capacity_factor": 0.5},
                              S),
    "qwen2-moe-a2.7b+6-experts+drops": (
        "qwen2-moe-a2.7b", {"n_experts": 6, "capacity_factor": 0.5}, S),
    "qwen3-moe-235b-a22b+seq63+drops": ("qwen3-moe-235b-a22b",
                                        {"capacity_factor": 0.5}, 63),
}
LOSS_ARCHS = tuple(LOSS_CASES)
# case -> (arch, reduced config overrides): prefill of SERVE_PROMPT
# positions, then SERVE_STEPS decode steps, with the kv heads split over
# the model axis (the per-(batch, kv-head) decode attention, each rank's
# own decode-state shards, and the MoE and its shared experts in decode)
SERVE_CASES = {
    "phi-3-vision-4.2b+kv4": ("phi-3-vision-4.2b", {"n_kv_heads": 4}),
    "qwen2-moe-a2.7b+kv4": ("qwen2-moe-a2.7b", {"n_kv_heads": 4}),
}
SERVE_PROMPT, SERVE_STEPS = 32, 3
QK_SCALE = 0.25


class _StubMesh:
    """All the reference's rules read of a mesh."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _ref_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path):
            tuple(p) for path, p in flat}


def _port_leaves(tree) -> dict:
    return {path: tuple(p) for path, p in param_leaves(tree)}


def _configs(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    yield cfg, jcfg
    yield (dataclasses.replace(cfg, strategy="fsdp"),
           dataclasses.replace(jcfg, strategy="fsdp"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_equal_reference(arch):
    for mesh in MESHES:
        for cfg, jcfg in _configs(arch):
            want = _ref_leaves(js.param_pspecs(jcfg, _StubMesh(mesh)))
            got = _port_leaves(ts.param_pspecs(cfg, mesh))
            assert got == want, (mesh, cfg.strategy)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_pspecs_equal_reference(arch):
    for mesh in MESHES:
        for cfg, jcfg in _configs(arch):
            for batch in (1, 32, 128, 256):
                want = _ref_leaves(js.decode_state_pspecs(
                    jcfg, _StubMesh(mesh), batch))
                got = _port_leaves(ts.decode_state_pspecs(cfg, mesh, batch))
                assert got == want, (mesh, cfg.strategy, batch)


def test_batch_pspec_equal_reference():
    for mesh in MESHES:
        for batch in (1, 32, 128, 256):
            for extra in (0, 1, 2):
                for axes in (None, ("pod", "data", "model"), ("data",)):
                    want = tuple(js.batch_pspec(_StubMesh(mesh), batch,
                                                extra, axes))
                    got = tuple(ts.batch_pspec(mesh, batch, extra, axes))
                    assert got == want, (mesh, batch, extra, axes)
    assert ts.dp_axes(MESHES[1]) == js.dp_axes(_StubMesh(MESHES[1]))


# ----------------------------------------------------------------------------
# Shard offsets against JAX's NamedSharding
# ----------------------------------------------------------------------------

LAYOUTS = [((8, 12), ("data", None)), ((8, 12), (None, "model")),
           ((16, 6), (("data", "model"), None)), ((4, 8), ("data", "model")),
           ((8, 4, 6), ("model", None, "data")), ((6, 8), (None, None)),
           ((2, 16, 4), (None, ("data", "model"), None))]


def _jax_offsets() -> dict:
    code = textwrap.dedent(f"""
        import json, jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        mesh = jax.make_mesh((2, 4), ("data", "model"))
        out = []
        for shape, spec in {LAYOUTS!r}:
            idx = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
            per = []
            for d in mesh.devices.flat:
                per.append([[s.start or 0, s.stop if s.stop is not None
                             else n] for s, n in zip(idx[d], shape)])
            out.append(per)
        print("JSON", json.dumps(out))
    """)
    out = run_with_devices(code, n_devices=8, timeout=300)
    return json.loads(out.split("JSON", 1)[1])


def _port_offsets() -> list:
    code = textwrap.dedent(f"""
        import json
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.distributed.sharding import P, placements_for
        layouts = {LAYOUTS!r}
        out = [[None] * 8 for _ in layouts]
        for rank in range(8):
            dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                    world_size=8)
            mesh = init_device_mesh("cpu", (2, 4),
                                    mesh_dim_names=("data", "model"))
            for i, (shape, spec) in enumerate(layouts):
                pl = placements_for(P(*spec), mesh, shape)
                n, off = compute_local_shape_and_global_offset(shape, mesh,
                                                               pl)
                out[i][rank] = [[o, o + k] for o, k in zip(off, n)]
            dist.destroy_process_group()
        print("JSON", json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.split("JSON", 1)[1])


def test_shard_offsets_equal_jax_named_sharding():
    want, got = _jax_offsets(), _port_offsets()
    for (shape, spec), w, g in zip(LAYOUTS, want, got):
        assert g == w, (shape, spec)


# ----------------------------------------------------------------------------
# The sharded loss, and sharded checkpoints, on gloo
# ----------------------------------------------------------------------------


def _case_configs(case):
    """(the port's, the reference's) reduced config of a loss or serve
    case, and its sequence length."""
    arch, over, seq = LOSS_CASES.get(case) or (*SERVE_CASES[case],
                                               SERVE_PROMPT)
    return (dataclasses.replace(get_config(arch).reduced(), **over),
            dataclasses.replace(j_get_config(arch).reduced(), **over), seq)


def _serve_inputs(cfg) -> dict:
    """A serve case's prompt (``batch/<key>``) and decode tokens
    (``steps``, (SERVE_STEPS, B, 1))."""
    rng = np.random.default_rng(1)
    out = {"batch/tokens": rng.integers(0, cfg.vocab_size,
                                        (B, SERVE_PROMPT)).astype(np.int32),
           "steps": rng.integers(0, cfg.vocab_size,
                                 (SERVE_STEPS, B, 1)).astype(np.int32)}
    if cfg.vision_tokens:
        out["batch/image_embeds"] = (rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _serve_plain(cfg, params, inputs) -> dict:
    """The port's unsharded prefill and decode of a serve case: each
    step's logits (``logits/<i>``) and the final state (``state/<path>``)."""
    batch = {k[6:]: torch.as_tensor(v) for k, v in inputs.items()
             if k.startswith("batch/")}
    logits, state = prefill_fn(cfg, max_len=SERVE_PROMPT + SERVE_STEPS)(
        params, batch)
    out = [logits]
    for tok in inputs["steps"]:
        logits, state = decode_fn(cfg)(params, state, torch.as_tensor(tok))
        out.append(logits)
    return {**{f"logits/{i}": v.numpy() for i, v in enumerate(out)},
            **{f"state/{k}": v for k, v in _flat_np(state).items()}}


def _batch(cfg, seq=S):
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, seq)).astype(
               np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, seq)).astype(
               np.int32),
           "mask": (rng.random((B, seq)) < 0.9).astype(np.float32)}
    return out


def _scale_qk(params):
    out = jax.tree.map(lambda a: a, params)
    for g in out["groups"].values():
        if "wq" in g:
            g["wq"] = g["wq"] * QK_SCALE
            g["wk"] = g["wk"] * QK_SCALE
    return out


def _flat_np(tree) -> dict:
    return {"/".join(path): np.asarray(x) for path, x in param_leaves(tree)}


# The reference's side, on 8 host devices: its sharded save (the port
# restores it), then, once the port's 8-rank save is written, its restore
# of that save onto 4 of the devices by its rules.
REF_SIDE = """
import os, time
import numpy as np, jax
from jax.sharding import Mesh
from repro.configs import get_config
from repro.distributed.sharding import param_shardings
from repro.models import init_params
from repro.train.checkpoint import Checkpointer
work = {work!r}
cfg = get_config("gemma2-2b").reduced()
mesh = jax.make_mesh((2, 4), ("data", "model"))
params = jax.device_put(init_params(cfg, jax.random.PRNGKey(3)),
                        param_shardings(cfg, mesh))
ck = Checkpointer(os.path.join(work, "ref8"), keep=1, async_save=False)
ck.save(5, {{"params": params}})
flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(params))
np.savez(os.path.join(work, "ref8.full.npz"),
         **{{"/".join(k.key for k in p): np.asarray(v) for p, v in flat}})
open(os.path.join(work, "ref8.done"), "w").close()
deadline = time.monotonic() + 240
while not os.path.exists(os.path.join(work, "port8.done")):
    assert time.monotonic() < deadline, "the port's save did not appear"
    time.sleep(0.2)
cfg = get_config({arch!r}).reduced()
mesh4 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
like = {{"params": init_params(cfg, jax.random.PRNGKey(1))}}
step, back = Checkpointer(os.path.join(work, "port8")).restore(
    like, shardings={{"params": param_shardings(cfg, mesh4)}})
want = dict(np.load(os.path.join(work, {arch!r} + ".npz")))
flat, _ = jax.tree_util.tree_flatten_with_path(back["params"])
bad = [p for p, v in flat if not np.array_equal(
    np.asarray(v), want["/".join(k.key for k in p)])]
n_dev = {{len(v.sharding.device_set) for _, v in flat}}
print("RESTORED", step, len(flat), bad, sorted(n_dev))
"""


def _start(argv: list, work: str, name: str, n_devices: int = 0):
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"))
    if n_devices:
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_"
                            f"platform_device_count={n_devices}")
    out = open(os.path.join(work, f"{name}.log"), "w")
    return subprocess.Popen([sys.executable] + argv, env=env, stdout=out,
                            stderr=subprocess.STDOUT), out


def _finish(proc, out, work: str, name: str):
    """(exit code, output) of a process from :func:`_start`; one that
    outlives 300 s is killed."""
    try:
        rc = proc.wait(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    out.close()
    return rc, open(os.path.join(work, f"{name}.log")).read()


def _mesh_pass(work: str) -> dict:
    """The gloo ranks and the reference's checkpoint side run as two
    processes at once, while this process takes the reference's and the
    port's unsharded losses (and the port's gradients, kept in
    ``<arch>.grads.npz``)."""
    p0, batches = {}, {}
    for case in LOSS_ARCHS:
        cfg, jcfg, seq = _case_configs(case)
        batches[case] = _batch(cfg, seq)
        p0[case] = jax.device_get(_scale_qk(j_init_params(
            jcfg, jax.random.PRNGKey(0))))
        params = params_from_reference(cfg, p0[case], device="cpu")
        np.savez(os.path.join(work, f"{case}.npz"), **_flat_np(params),
                 **{f"batch/{k}": v for k, v in batches[case].items()})
    for case in SERVE_CASES:
        cfg, jcfg, _ = _case_configs(case)
        params = params_from_reference(cfg, jax.device_get(_scale_qk(
            j_init_params(jcfg, jax.random.PRNGKey(0)))), device="cpu")
        inputs = _serve_inputs(cfg)
        np.savez(os.path.join(work, f"{case}.npz"), **_flat_np(params),
                 **inputs)
        with torch.no_grad():
            np.savez(os.path.join(work, f"{case}.plain.npz"),
                     **_serve_plain(cfg, params, inputs))
    for name, cases in (("archs", LOSS_CASES), ("serve", SERVE_CASES)):
        with open(os.path.join(work, f"{name}.txt"), "w") as f:
            for case, (arch, over, *_) in cases.items():
                f.write(" ".join([case, arch] + [f"{k}={v}" for k, v in
                                                 over.items()]) + "\n")
    with open(os.path.join(work, "restore.txt"), "w") as f:
        f.write(f"port8 {LOSS_ARCHS[0]}\nref8 gemma2-2b\n")
    ranks = _start([os.path.join(HERE, "_torch_mesh_worker.py"), work],
                   work, "ranks")
    ref_side = _start(["-c", REF_SIDE.format(work=work, arch=LOSS_ARCHS[0])],
                      work, "ref_side", n_devices=8)
    ref, port = {}, {}
    try:
        for case in LOSS_ARCHS:
            cfg, jcfg, _ = _case_configs(case)
            jb = {k: jnp.asarray(v) for k, v in batches[case].items()}
            ref[case] = float(jax.jit(
                lambda p, b: j_loss_fn(jcfg, p, b)[0])(p0[case], jb))
            params = params_from_reference(cfg, p0[case], device="cpu")
            tb = {k: torch.as_tensor(v) for k, v in batches[case].items()}
            (loss, _), grads = value_and_grad(
                lambda p, b: loss_fn(cfg, p, b), params, tb)
            port[case] = float(loss)
            np.savez(os.path.join(work, f"{case}.grads.npz"),
                     **_flat_np(grads))
    finally:
        done = {name: _finish(*p, work, name)
                for name, p in (("ranks", ranks), ("ref_side", ref_side))}
    for name, (rc, text) in done.items():
        assert rc == 0, f"{name} failed (rc={rc}):\n{text[-4000:]}"
    return {"ref": ref, "port": port, "ref_restore": done["ref_side"][1]}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """One pass of everything on gloo: the losses (8 ranks), the
    reference's 8-device save, the 4-rank restores, the reference's
    4-device restore of the port's save, and the unsharded losses and
    gradients, once a session (``once_per_session``).  ``port``: arch ->
    (loss, gradients, parameters), unsharded."""
    work, result = once_per_session(tmp_path_factory, "torch_mesh_run",
                                    _mesh_pass)
    port = {}
    for arch in LOSS_ARCHS:
        params = dict(np.load(os.path.join(work, f"{arch}.npz")))
        port[arch] = (result["port"][arch],
                      dict(np.load(os.path.join(work, f"{arch}.grads.npz"))),
                      {k: v for k, v in params.items()
                       if not k.startswith("batch/")})
    return {"work": work, "ref": result["ref"], "port": port,
            "ref_restore": result["ref_restore"]}


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_sharded_loss_matches_reference(arch, mesh_run):
    got = np.load(os.path.join(mesh_run["work"], f"{arch}.out.npz"))
    want = mesh_run["ref"][arch]
    assert abs(float(got["loss"]) - want) <= 1e-5 * max(1.0, abs(want))


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_sharded_grads_match_unsharded(arch, mesh_run):
    got = np.load(os.path.join(mesh_run["work"], f"{arch}.out.npz"))
    _, grads, _ = mesh_run["port"][arch]
    errs = {}
    for path, want in grads.items():
        g = got[f"grad/{path}"]
        assert g.shape == want.shape, path
        errs[path] = float(np.max(np.abs(g - want))
                           / max(np.max(np.abs(want)), 1e-30))
    assert max(errs.values()) < 1e-4, errs


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_sharded_serve_matches_plain(case, mesh_run):
    """Prefill and decode on the (2, 4) mesh, kv heads split 4 ways: every
    step's logits and every leaf of the final decode state within 1e-4
    of its scale of the unsharded port's; the positions exact."""
    got = np.load(os.path.join(mesh_run["work"], f"{case}.out.npz"))
    want = np.load(os.path.join(mesh_run["work"], f"{case}.plain.npz"))
    assert sorted(got.files) == sorted(want.files)
    assert sum(k.startswith("logits/") for k in want.files) == \
        SERVE_STEPS + 1
    errs = {}
    for k in want.files:
        g, w = got[k], want[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if not np.issubdtype(w.dtype, np.floating):
            assert np.array_equal(g, w), k
            continue
        errs[k] = float(np.max(np.abs(g - w), initial=0.0)
                        / max(np.max(np.abs(w), initial=0.0), 1e-30))
    assert max(errs.values()) < 1e-4, errs


def test_experts_shard_four_ways(mesh_run):
    got = np.load(os.path.join(mesh_run["work"],
                               "qwen2-moe-a2.7b.out.npz"))
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    for w in ("w_gate", "w_up", "w_down"):
        local = got[f"local/groups/p0/moe/{w}"]
        assert local[1] == cfg.n_experts // 4, (w, local)
    # the router is replicated; the attention heads split 4 ways
    assert tuple(got["local/groups/p0/moe/router"]) == (
        cfg.n_groups, cfg.d_model, cfg.n_experts)
    assert got["local/groups/p0/wq"][2] == cfg.n_heads // 4


def test_sharded_checkpoint_restores_on_fewer_ranks(mesh_run):
    """Saved on 8 ranks, restored on a (2, 2) mesh: bit-equal."""
    back = np.load(os.path.join(mesh_run["work"], "port8.restored.npz"))
    _, _, params = mesh_run["port"][LOSS_ARCHS[0]]
    assert int(back["step"]) == 0 and bool(back["local_ok"])
    for path, want in params.items():
        assert np.array_equal(back[path], want), path
    manifest = json.load(open(os.path.join(
        mesh_run["work"], "port8", "step_00000000", "manifest.json")))
    wq = next(e for e in manifest["leaves"]
              if e["key"] == "params.groups.p0.wq")
    # heads over the model axis, replicated over data: 4 distinct shards
    assert len(wq["shards"]) == 4
    assert sorted(s["index"][2] for s in wq["shards"]) == [
        [0, 1], [1, 2], [2, 3], [3, 4]]


def test_reference_checkpoint_restores_on_port_mesh(mesh_run):
    """The reference's 8-device sharded save, restored by the port on 4
    ranks: bit-equal to the reference's arrays."""
    back = np.load(os.path.join(mesh_run["work"], "ref8.restored.npz"))
    want = np.load(os.path.join(mesh_run["work"], "ref8.full.npz"))
    assert int(back["step"]) == 5
    for path in want.files:
        assert np.array_equal(back[path], want[path]), path


def test_port_checkpoint_restores_in_reference(mesh_run):
    """The port's 8-rank sharded save, restored by the reference onto 4
    devices by its rules: bit-equal, every leaf on the 4 devices."""
    line = next(ln for ln in mesh_run["ref_restore"].splitlines()
                if ln.startswith("RESTORED"))
    assert line.endswith("[] [4]"), line
    assert line.split()[1] == "0"
