"""whisper-small at its published widths (d 768, 12 heads, vocab 51865)
with ``depth`` encoder and ``depth`` decoder layers, in float32 on the
CPU, through both packages: how far each package's prefill of ``S0``
tokens followed by 16 decode steps drifts from its own prefill of all
``S0 + 16`` (max |logits difference|), at the reference's weights
(``PRNGKey(0)``) and with each decoder attention's ``wq`` / ``wk`` (self
and cross) times 1/4, as ``chip_smoke.py``'s serving gate B takes them;
and how far the two packages' full prefills are apart.  One numpy block
of 2 x (S0 + 16) tokens and 2 x (S0 + 16) / 4 frames (N(0, 0.02^2)).

Run as a script to print one JSON line a case:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/whisper_serve_drift.py \
        2:64 6:64 12:256

(``depth:S0``.)
"""
import dataclasses
import json
import sys

import numpy as np
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import decode_fn as j_decode_fn
from repro.models import init_params as j_init_params
from repro.models import prefill_fn as j_prefill_fn
from repro_torch.configs import get_config
from repro_torch.models import decode_fn, params_from_reference, prefill_fn

TAIL = 16


def _scaled(params, by: float):
    out = jax.tree.map(lambda a: a, params)
    for g in out["groups"].values():
        for att in (g, g["cross"]):
            att["wq"] = att["wq"] * by
            att["wk"] = att["wk"] * by
    return out


def _ref_drift(cfg, params, tokens, frames):
    S = tokens.shape[1]
    jb = {"frames": jnp.asarray(frames)}
    full, _ = jax.jit(j_prefill_fn(cfg))(params,
                                          {"tokens": jnp.asarray(tokens), **jb})
    _, state = jax.jit(j_prefill_fn(cfg, max_len=S))(
        params, {"tokens": jnp.asarray(tokens[:, :S - TAIL]), **jb})
    step = jax.jit(j_decode_fn(cfg))
    for t in range(S - TAIL, S):
        logits, state = step(params, state, jnp.asarray(tokens[:, t:t + 1]))
    return np.asarray(full), float(np.max(np.abs(np.asarray(logits)
                                                 - np.asarray(full))))


def _port_drift(cfg, params, tokens, frames):
    S = tokens.shape[1]
    tb = {"frames": torch.as_tensor(frames)}
    tokens = torch.as_tensor(tokens)
    full, _ = prefill_fn(cfg)(params, {"tokens": tokens, **tb})
    _, state = prefill_fn(cfg, max_len=S)(
        params, {"tokens": tokens[:, :S - TAIL], **tb})
    step = decode_fn(cfg)
    for t in range(S - TAIL, S):
        logits, state = step(params, state, tokens[:, t:t + 1])
    return full.numpy(), float((logits - full).abs().max())


def compare(depth: int, s0: int) -> dict:
    kw = dict(n_layers=depth, enc_layers=depth, dtype="float32")
    jcfg = dataclasses.replace(j_get_config("whisper-small"), **kw)
    tcfg = dataclasses.replace(get_config("whisper-small"), **kw)
    S = s0 + TAIL
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    frames = (rng.standard_normal((2, S // jcfg.enc_ratio, jcfg.d_model))
              * 0.02).astype(np.float32)
    p0 = j_init_params(jcfg, jax.random.PRNGKey(0))
    out = {"depth": depth, "S0": s0, "S": S}
    for name, by in (("init", 1.0), ("qk_quarter", 0.25)):
        jp = _scaled(p0, by)
        ref_full, ref = _ref_drift(jcfg, jp, tokens, frames)
        tp = params_from_reference(tcfg, jax.device_get(jp), device="cpu")
        port_full, port = _port_drift(tcfg, tp, tokens, frames)
        out[name] = {"ref_drift": ref, "port_drift": port,
                     "full_prefill_apart": float(np.max(np.abs(
                         port_full - ref_full))),
                     "logits_scale": float(np.max(np.abs(ref_full)))}
    return out


if __name__ == "__main__":
    for arg in sys.argv[1:]:
        d, s = (int(x) for x in arg.split(":"))
        print(json.dumps(compare(d, s)), flush=True)
