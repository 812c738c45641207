"""Private and bias-aware estimation (DESIGN.md §20 of the reference), as
``repro.private``:

- :mod:`repro_torch.private.accountant` — strict (epsilon, delta) ledgers
  with sequential, parallel and advanced composition;
- :mod:`repro_torch.private.release` — DP release of coordinated sampling
  sketches (HT rescale, decoy survival filter, Laplace noise) and the
  debiased dense / private-product estimators;
- :mod:`repro_torch.private.biasaware` — exact head + sampled-tail
  estimators for Zipfian data, with a median-of-k CountSketch tail on the
  CountSketch kernel.
"""
from .accountant import (PrivacyAccountant, PrivacyBudgetExceeded,
                         ReleaseRecord)
from .release import (DPParams, PrivateSketch, estimate_private_dense,
                      estimate_private_product, private_release,
                      private_release_corpus)
from .biasaware import (BiasAwareCSSketch, BiasAwareSketch,
                        bias_aware_cs_sketch, bias_aware_sketch,
                        estimate_bias_aware, estimate_bias_aware_cs,
                        head_split, head_tail_variance_bound)

__all__ = [
    "PrivacyAccountant", "PrivacyBudgetExceeded", "ReleaseRecord",
    "DPParams", "PrivateSketch", "estimate_private_dense",
    "estimate_private_product", "private_release", "private_release_corpus",
    "BiasAwareCSSketch", "BiasAwareSketch", "bias_aware_cs_sketch",
    "bias_aware_sketch", "estimate_bias_aware", "estimate_bias_aware_cs",
    "head_split", "head_tail_variance_bound",
]
