"""Port parity: LM serving (``repro_torch.models`` prefill / decode and
the decode state, ``repro_torch.serve.Engine``, ``repro_torch.launch.
serve``) against ``repro.models`` / ``repro.serve.engine``, on every one
of the ten reduced configs in float32.

The reference's parameters (``init_params`` at ``PRNGKey(0)``, each
attention group's ``wq`` / ``wk`` times 1/4 so that the scores are O(1),
as ``tests/test_torch_models.py`` takes them) are carried to the port
with ``params_from_reference``; both packages take the same numpy
prompts (with ``frames`` and ``image_embeds`` stubs, N(0, 0.02^2), where
the config has them).  Prompts are 48 tokens and the decode horizon 56,
so every local layer's ring (window 32) wraps in prefill and again in
decode.

Tolerances (float32 on both sides, sums in other orders): logits within
``1e-5 max(1, max|ref logits|)``; every float state leaf within ``2e-5``
of its largest reference magnitude; int32 leaves (``pos``, the caches'
``pos``) equal.  Measured: up to 1.4e-6 on the logits and 2.1e-6 on a
state leaf (recurrentgemma-2b's local-attention cache, which takes the
RG-LRU layers' output).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro import obs as jobs
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.models import decode_fn as j_decode_fn
from repro.models import init_params as j_init_params
from repro.models import layers as jl
from repro.models import prefill_fn as j_prefill_fn
from repro.models.model import init_decode_state as j_init_decode_state
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (decode_fn, init_decode_state, init_params,
                                param_leaves, params_from_reference,
                                prefill_fn, state_from_reference,
                                state_to_reference)
from repro_torch.models import layers as tl
from repro_torch.serve import Engine, Request
from _torch_common import release_jax_executables  # noqa: F401

ALL = list(J_ARCH_IDS)
B, S, STEPS = 2, 48, 8
HORIZON = S + STEPS
QK_SCALE = 0.25
LOGIT_TOL = 1e-5
STATE_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread: its tensors are a few KB,
    and the suite's workers already take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scale_qk(params):
    out = jax.tree.map(lambda a: a, params)
    for g in out["groups"].values():
        if "wq" in g:
            g["wq"] = g["wq"] * QK_SCALE
            g["wk"] = g["wk"] * QK_SCALE
    return out


def _inputs(cfg):
    """(B, S + STEPS) tokens (the prompt, then the decoded ones) and the
    prompt's stubs."""
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    extra = {}
    if cfg.vision_tokens:
        extra["image_embeds"] = (rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.is_encdec:
        extra["frames"] = (rng.standard_normal(
            (B, S // cfg.enc_ratio, cfg.d_model)) * 0.02).astype(np.float32)
    return tokens, extra


@pytest.fixture(scope="module")
def ref_runs():
    """arch -> the reference's run: params (numpy), the inputs, its
    prefill logits and state, each decode step's logits, the state after
    the last step, and its jitted decode step; one pair of jits a config,
    made the first time a test asks for the arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = j_get_config(arch).reduced()
            params = _scale_qk(j_init_params(cfg, jax.random.PRNGKey(0)))
            tokens, extra = _inputs(cfg)
            batch = {k: jnp.asarray(v) for k, v in extra.items()}
            batch["tokens"] = jnp.asarray(tokens[:, :S])
            prefill = jax.jit(j_prefill_fn(cfg, max_len=HORIZON))
            decode = jax.jit(j_decode_fn(cfg))
            logits, state = prefill(params, batch)
            state0 = jax.device_get(state)
            steps = []
            for t in range(S, S + STEPS):
                lg, state = decode(params, state,
                                   jnp.asarray(tokens[:, t:t + 1]))
                steps.append(np.asarray(lg))
            cache[arch] = {"params": jax.device_get(params), "tokens": tokens,
                           "extra": extra, "logits": np.asarray(logits),
                           "state0": state0, "steps": steps,
                           "state": jax.device_get(state), "decode": decode,
                           "jparams": params}
        return cache[arch]
    return get


def _port_prefill(arch, run):
    cfg = get_config(arch).reduced()
    params = params_from_reference(cfg, run["params"], device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in run["extra"].items()}
    batch["tokens"] = torch.as_tensor(run["tokens"][:, :S])
    logits, state = prefill_fn(cfg, max_len=HORIZON)(params, batch)
    return cfg, params, logits, state


def _port_decode(cfg, params, state, tokens):
    step, out = decode_fn(cfg), []
    for t in range(S, S + STEPS):
        lg, state = step(params, state, torch.as_tensor(tokens[:, t:t + 1]))
        out.append(lg.numpy())
    return out, state


def _assert_logits(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.max(np.abs(got - want)))
    assert err <= LOGIT_TOL * max(1.0, float(np.max(np.abs(want)))), \
        (what, err)


def _assert_state(got: dict, want: dict):
    """Every leaf of the reference's state: the same paths and shapes,
    int32 leaves equal, float leaves within STATE_TOL of their scale."""
    got, want = dict(param_leaves(got)), dict(param_leaves(want))
    assert set(got) == set(want)
    for path, w in want.items():
        g, w = np.asarray(got[path]), np.asarray(w)
        assert g.shape == w.shape, path
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=str(path))
            continue
        scale = max(float(np.max(np.abs(w))) if w.size else 0.0, 1e-30)
        err = float(np.max(np.abs(g - w))) if w.size else 0.0
        assert err <= STATE_TOL * scale, (path, err, scale)


def _torch_dtype(jdtype):
    return getattr(torch, np.dtype(jdtype).name)


@pytest.mark.parametrize("arch", ALL)
def test_init_decode_state_layout_matches_reference(arch):
    """Every leaf's path, shape, dtype and value (zeros; -1 for the
    caches' ``pos``) equal to the reference's empty state, with the
    whisper cross caches and recurrentgemma's unrolled tail; each stacked
    leaf owns its storage (no group aliases another)."""
    jc, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    want = dict(param_leaves(jax.device_get(j_init_decode_state(jc, 3, 40))))
    got = dict(param_leaves(init_decode_state(cfg, 3, 40, device="cpu")))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        assert g.dtype == _torch_dtype(w.dtype), path
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if path[0] != "pos" and path[1] != "tail":
            assert g.is_contiguous() and 0 not in g.stride(), path


@pytest.mark.parametrize("arch", ALL)
def test_prefill_matches_reference(arch, ref_runs):
    run = ref_runs(arch)
    _, _, logits, state = _port_prefill(arch, run)
    assert logits.dtype == torch.float32
    _assert_logits(logits, run["logits"], "prefill")
    assert int(state["pos"]) == S and state["pos"].dtype == torch.int32
    _assert_state(state_to_reference(state), run["state0"])


@pytest.mark.parametrize("arch", ALL)
def test_decode_matches_reference(arch, ref_runs):
    """Eight steps from the port's own prefill: each step's logits and
    the state after the last."""
    run = ref_runs(arch)
    cfg, params, _, state = _port_prefill(arch, run)
    steps, state = _port_decode(cfg, params, state, run["tokens"])
    for t, (got, want) in enumerate(zip(steps, run["steps"])):
        _assert_logits(got, want, f"step {t}")
    assert int(state["pos"]) == S + STEPS
    _assert_state(state_to_reference(state), run["state"])


@pytest.mark.parametrize("arch", ALL)
def test_state_crosses_packages(arch, ref_runs):
    """The reference's prefill state decoded by the port gives the
    port's own run (prefill and decode in the port); the port's prefill
    state decoded by the reference gives the reference's own run.  The
    carrier is exact both ways on float32 states."""
    run = ref_runs(arch)
    cfg, params, _, state = _port_prefill(arch, run)
    ref_state = state_to_reference(state)    # before decode writes into it
    own, _ = _port_decode(cfg, params, state, run["tokens"])

    carried = state_from_reference(cfg, run["state0"], device="cpu")
    for (pa, a), (pb, b) in zip(param_leaves(state_to_reference(carried)),
                                param_leaves(run["state0"])):
        assert pa == pb
        np.testing.assert_array_equal(a, np.asarray(b))
    mixed, _ = _port_decode(cfg, params, carried, run["tokens"])
    for t, (got, want) in enumerate(zip(mixed, own)):
        _assert_logits(got, want, f"reference state, port step {t}")

    jstate = jax.tree.map(jnp.asarray, ref_state)
    tokens = run["tokens"]
    for t in range(STEPS):
        lg, jstate = run["decode"](run["jparams"], jstate,
                                   jnp.asarray(tokens[:, S + t:S + t + 1]))
        _assert_logits(np.asarray(lg), run["steps"][t],
                       f"port state, reference step {t}")


def test_state_from_reference_rejects_another_layout(ref_runs):
    run = ref_runs("gemma2-2b")
    cfg = get_config("mamba2-370m").reduced()
    with pytest.raises(ValueError, match="state paths differ"):
        state_from_reference(cfg, run["state0"], device="cpu")


@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 0.0), (0, 30.0),
                                        (5, 30.0)])
def test_attention_decode_matches_reference(window, cap):
    """Twelve one-token steps at positions 0..11 on a ring of 8 slots (it
    wraps after step 8), with and without a window and a softcap: each
    step's output within 1e-5 of its scale, the cache (k, v, pos) equal
    to the reference's within 1e-6; the cache is written in place."""
    rng = np.random.default_rng(11)
    d, H, K, dh, C, Bq = 32, 4, 2, 8, 8, 2
    p = {"wq": rng.standard_normal((d, H, dh)) * 0.3,
         "wk": rng.standard_normal((d, K, dh)) * 0.3,
         "wv": rng.standard_normal((d, K, dh)) * 0.3,
         "wo": rng.standard_normal((H, dh, d)) * 0.3}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    jcache = jl.init_kv_cache(Bq, C, K, dh, jnp.float32)
    cache = tl.init_kv_cache(Bq, C, K, dh, torch.float32)
    k_store = cache["k"]
    for pos in range(12):
        x = rng.standard_normal((Bq, 1, d)).astype(np.float32)
        want, jcache = jl.attention_decode(
            p, jnp.asarray(x), jcache, pos=jnp.int32(pos), window=window,
            rope_theta=10000.0, cap=cap)
        got, cache = tl.attention_decode(
            tp, torch.as_tensor(x), cache,
            pos=torch.tensor(pos, dtype=torch.int32), window=window,
            rope_theta=10000.0, cap=cap)
        want = np.asarray(want)
        assert np.max(np.abs(got.numpy() - want)) <= \
            1e-5 * max(1.0, np.max(np.abs(want)))
        for key in ("k", "v", "pos"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       np.asarray(jcache[key]), rtol=1e-6,
                                       atol=1e-6)
    assert cache["k"] is k_store
    assert sorted(cache["pos"][0].tolist()) == list(range(4, 12))


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-370m",
                                  "recurrentgemma-2b", "granite-20b",
                                  "whisper-small", "qwen2-moe-a2.7b"])
def test_prefill_decode_matches_full_forward(arch):
    """The reference's ``test_prefill_decode_matches_full_forward`` on
    the port: prefill(t[:48]) with the horizon 64, then decodes of
    t[48:64], against prefill(t[:64]), rtol = atol = 2e-2 (the
    reference's own)."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, 2, device="cpu")
    rng = np.random.default_rng(0)
    Sf = 64
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, Sf)).astype(np.int32))
    extra = {}
    if cfg.vision_tokens:
        extra["image_embeds"] = torch.as_tensor((rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)) * 0.02).astype(np.float32))
    if cfg.is_encdec:
        extra["frames"] = torch.as_tensor((rng.standard_normal(
            (B, Sf // cfg.enc_ratio, cfg.d_model)) * 0.02).astype(np.float32))
    full, _ = prefill_fn(cfg)(params, {"tokens": tokens, **extra})
    qb = cfg.attn_q_block
    part = ((Sf - 1) // qb) * qb
    _, state = prefill_fn(cfg, max_len=Sf)(
        params, {"tokens": tokens[:, :part], **extra})
    step = decode_fn(cfg)
    for t in range(part, Sf):
        logits, state = step(params, state, tokens[:, t:t + 1])
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-2,
                               atol=2e-2)


def test_decode_leaves_other_groups_untouched():
    """A decode step writes each group's slot ``pos % C`` of its own
    slice: slots other than ``pos`` keep their bits in every group."""
    cfg = get_config("gemma2-2b").reduced()
    params = init_params(cfg, 3, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 17)).astype(np.int32))
    _, state = prefill_fn(cfg, max_len=40)(params, {"tokens": tokens[:, :16]})
    before = {p: x.clone() for p, x in param_leaves(state)}
    _, state = decode_fn(cfg)(params, state, tokens[:, 16:17])
    for path, x in param_leaves(state):
        if path[0] != "groups" or path[-1] not in ("k", "v", "pos"):
            continue
        old = before[path]
        assert x.shape[0] == cfg.n_groups
        for g in range(cfg.n_groups):
            keep = torch.ones(x.shape[2], dtype=torch.bool)
            keep[16 % x.shape[2]] = False
            assert torch.equal(x[g][:, keep], old[g][:, keep]), (path, g)
            assert not torch.equal(x[g][:, ~keep], old[g][:, ~keep]), \
                (path, g)


# ---------------------------------------------------------------------------
# The engine and the launcher
# ---------------------------------------------------------------------------


def test_engine_generates():
    """``tests/test_serve.py::test_engine_generates`` on the port."""
    cfg = get_config("gemma2-2b").reduced()
    params = init_params(cfg, 0, device="cpu")
    eng = Engine(cfg, params, batch_size=2, max_len=64, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 8)
                    .astype(np.int32), max_new_tokens=4) for i in range(3)]
    done = eng.serve(reqs)
    assert len(done) == 3
    for r in done:
        assert len(r.output) == 4
        assert all(0 <= t < cfg.vocab_size for t in r.output)


def test_engine_greedy_deterministic():
    """``tests/test_serve.py::test_engine_greedy_deterministic`` on the
    port, and a temperature run repeats under one seed."""
    cfg = get_config("mamba2-370m").reduced()
    params = init_params(cfg, 1, device="cpu")
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    for temperature in (0.0, 1.0):
        outs = []
        for _ in range(2):
            eng = Engine(cfg, params, batch_size=1, max_len=64,
                         temperature=temperature, seed=3, device="cpu")
            r = eng.serve([Request(rid=0, prompt=prompt,
                                   max_new_tokens=6)])[0]
            outs.append(tuple(r.output))
        assert outs[0] == outs[1]
        assert all(0 <= t < cfg.vocab_size for t in outs[0])


def _recording(fn, out: list):
    def call(*args):
        logits, state = fn(*args)
        out.append(np.asarray(logits))
        return logits, state
    return call


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-370m"])
def test_engine_greedy_matches_reference(arch):
    """Both engines on the same weights (5 requests of 5-20 tokens, two
    waves of 3, 6 new tokens): the port's greedy tokens are the
    reference's.  Where a token differs, the reference's top-2 margin
    there must be below 1e-4 (a near tie), and that request is compared
    no further."""
    jc, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = _scale_qk(j_init_params(jc, jax.random.PRNGKey(4)))
    params = params_from_reference(cfg, jax.device_get(jparams),
                                   device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(5, 21, 5)]
    new = 6
    ref_eng = JEngine(jc, jparams, batch_size=3, max_len=64)
    logits = []
    ref_eng._prefill = _recording(ref_eng._prefill, logits)
    ref_eng._decode = _recording(ref_eng._decode, logits)
    want = ref_eng.serve([JRequest(rid=i, prompt=p, max_new_tokens=new)
                          for i, p in enumerate(prompts)])
    got = Engine(cfg, params, batch_size=3, max_len=64, device="cpu").serve(
        [Request(rid=i, prompt=p, max_new_tokens=new)
         for i, p in enumerate(prompts)])
    assert len(logits) == 2 * new
    compared = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.rid == w.rid and len(g.output) == len(w.output) == new
        wave, row = divmod(i, 3)
        for t, (a, b) in enumerate(zip(g.output, w.output)):
            if a != b:
                top = np.sort(logits[wave * new + t][row, :cfg.vocab_size])
                assert top[-1] - top[-2] < 1e-4, (i, t, a, b)
                break
            compared += 1
    assert compared >= 20


def _lm_series(snap: dict) -> dict:
    """{(family, label values): value or histogram count}, the
    ``*_seconds`` values and the reference's JAX retrace counter left
    out."""
    out = {}
    for name, fam in snap.items():
        if name == "repro_engine_traces_total":
            continue
        for s in fam["series"]:
            key = (name, fam["kind"],
                   tuple(s["labels"][k] for k in fam["labels"]))
            if fam["kind"] == "histogram":
                out[key] = s["count"]
            elif not name.endswith("_seconds"):
                out[key] = s["value"]
    return out


def test_obs_after_waves_matches_reference():
    """Two waves through each engine with observability on: the same
    families, labels and counts (``repro_lm_waves_total``,
    ``repro_lm_tokens_total``, the ``serve.lm.wave`` op), and one
    ``serve.lm.wave`` span a wave with its ``requests``."""
    jc, cfg = (j_get_config("mamba2-370m").reduced(),
               get_config("mamba2-370m").reduced())
    jparams = j_init_params(jc, jax.random.PRNGKey(6))
    params = params_from_reference(cfg, jax.device_get(jparams),
                                   device="cpu")
    prompts = [np.arange(3 + i, dtype=np.int32) for i in range(3)]
    news = (2, 4, 3)
    for o in (obs, jobs):
        o.disable()
        o.reset()
        o.enable()
    try:
        JEngine(jc, jparams, batch_size=2, max_len=32).serve(
            [JRequest(rid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, news))])
        Engine(cfg, params, batch_size=2, max_len=32, device="cpu").serve(
            [Request(rid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, news))])
        got, want = _lm_series(obs.snapshot()), _lm_series(jobs.snapshot())
        assert got == want
        assert obs.registry().value("repro_lm_tokens_total") == sum(news)
        assert obs.registry().value("repro_lm_waves_total") == 2
        spans = [(e.attrs, e.ok) for e in obs.tracer().events()
                 if e.name == "serve.lm.wave"]
        ref_spans = [(e.attrs, e.ok) for e in jobs.tracer().events()
                     if e.name == "serve.lm.wave"]
        assert spans == ref_spans == [({"requests": 2}, True),
                                      ({"requests": 1}, True)]
    finally:
        for o in (obs, jobs):
            o.disable()
            o.reset()


def test_launcher_serves_on_cpu(capsys):
    done = launch_serve.main(["--arch", "whisper-small", "--reduced",
                              "--device", "cpu", "--requests", "3",
                              "--max-new", "4", "--batch", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and lines[0].startswith("request 0: prompt=")
    assert [len(r.output) for r in done] == [4, 4, 4]


def test_engine_and_launcher_need_a_card():
    """Without ``device`` both run on the card, so on a host without one
    they raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = get_config("gemma2-2b").reduced()
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "gemma2-2b", "--reduced"])
