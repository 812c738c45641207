"""whisper-small at its published widths (d 768, 12 heads, vocab 51865)
with ``depth`` encoder and ``depth`` decoder layers, in float32 on the
CPU, through both packages: the reference's weights (``PRNGKey(0)``)
carried to the port, one numpy batch of 2 x ``seq`` tokens and
2 x ``seq / 4`` frames (N(0, 0.02^2)); the losses, the global gradient
norms (float64 sums of squares) and the reference's three largest
leaves.

``tests/test_torch_model_families.py`` holds the norms against each
other at short sequences; run as a script to print one JSON line a case:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/whisper_grad_norms.py \
        2:512 4:1024

(``depth:seq``; 4 + 4 layers at 1024 tokens take ~6 GB of host memory.)
"""
import dataclasses
import json
import sys

import numpy as np
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro_torch.configs import get_config
from repro_torch.models import loss_fn, params_from_reference
from repro_torch.models.tree import param_leaves
from repro_torch.train import value_and_grad


def compare(depth: int, seq: int) -> dict:
    jcfg = dataclasses.replace(j_get_config("whisper-small"), n_layers=depth,
                               enc_layers=depth, dtype="float32")
    tcfg = dataclasses.replace(get_config("whisper-small"), n_layers=depth,
                               enc_layers=depth, dtype="float32")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, seq)
                                    ).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (2, seq)
                                    ).astype(np.int32),
             "mask": np.ones((2, seq), np.float32),
             "frames": (rng.standard_normal((2, seq // jcfg.enc_ratio,
                                             jcfg.d_model)) * 0.02
                        ).astype(np.float32)}
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(jcfg, p, b), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_reference(tcfg, jax.device_get(jp), device="cpu")
    names = ["/".join(path) for path, _ in param_leaves(tp)]
    j_sq = [float(np.sum(np.asarray(g, np.float64) ** 2))
            for g in jax.tree.leaves(j_grads)]
    del jp, j_grads
    (t_loss, _), t_grads = value_and_grad(
        lambda p, b: loss_fn(tcfg, p, b), tp,
        {k: torch.as_tensor(v) for k, v in batch.items()})
    t_sq = [float(torch.sum(g.double() ** 2))
            for _, g in param_leaves(t_grads)]
    top = sorted(zip(j_sq, names), reverse=True)[:3]
    return {"depth": depth, "seq": seq, "ref_loss": float(j_loss),
            "port_loss": float(t_loss), "ref_grad_norm": sum(j_sq) ** 0.5,
            "port_grad_norm": sum(t_sq) ** 0.5,
            "ref_largest_leaves": [[n, v ** 0.5] for v, n in top]}


if __name__ == "__main__":
    for arg in sys.argv[1:]:
        d, s = (int(x) for x in arg.split(":"))
        print(json.dumps(compare(d, s)), flush=True)
