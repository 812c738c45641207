"""Privacy budget accounting for DP sketch releases (DESIGN.md §20 of the
reference; a standalone copy of ``repro.private.accountant``).

A :class:`PrivacyAccountant` is an explicit per-release ledger over one
``(epsilon, delta)`` budget.  The composition rules it implements are the
classical ones:

- **sequential** composition: releases computed on the *same* underlying
  records add up — ``eps_total = sum(eps_i)``, ``delta_total =
  sum(delta_i)``.  Every :meth:`spend` is a sequential charge.
- **parallel** composition: releases over *disjoint* record sets cost the
  *max*, not the sum (each record participates in exactly one of them).
  The serving index uses this: one corpus-wide release of D disjoint rows
  is a single ``eps`` charge, not ``D * eps``.
- **post-processing** is free: repeated queries against an already
  released :class:`~repro_torch.private.release.PrivateSketch` never touch the
  ledger — only producing a *new* release from raw data does.
- **advanced** composition (:meth:`advanced_epsilon`) for k-fold
  repetition at a ``delta`` slack, the sublinear
  ``eps * sqrt(2 k ln(1/delta'))`` regime.

The accountant is strict: a spend that would exceed the budget raises
:class:`PrivacyBudgetExceeded` *before* any data is released, and the
ledger is not charged.  Merging two sketches' releases merges their
ledgers sequentially (:meth:`merge_from`) — a merged release reveals both
inputs' randomness.

**Formal vs informal.**  Only the value-channel ``epsilon`` of a release
is formal DP and counted against the budget.  The membership channel of
:func:`~repro_torch.private.release.private_release` (decoy survival filter)
is appearance deniability, *not* a DP mechanism — its ``mem_epsilon``
knob is recorded per ledger entry and surfaced via
:attr:`PrivacyAccountant.informal_mem_epsilon` so the weaker guarantee
is visible, but it is never summed into ``spent_epsilon`` and never
gates the budget (DESIGN.md §20).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Tuple

_EPS_SLACK = 1e-9   # float-roundoff tolerance on budget comparisons


class PrivacyBudgetExceeded(RuntimeError):
    """A release would overdraw the accountant's (epsilon, delta) budget.

    Raised *before* the release is produced; the ledger is left
    unchanged, so the caller can inspect :attr:`PrivacyAccountant.ledger`
    and :attr:`~PrivacyAccountant.remaining_epsilon` to decide whether to
    re-budget or refuse the query."""


@dataclass(frozen=True)
class ReleaseRecord:
    """One ledger entry: what was spent and on which release.

    ``mem_epsilon`` is the release's informal membership-deniability
    parameter — annotation only, never part of the (epsilon, delta)
    guarantee (module docstring)."""
    label: str
    epsilon: float
    delta: float
    mem_epsilon: float = 0.0


class PrivacyAccountant:
    """Strict (epsilon, delta) ledger with sequential composition.

    ``epsilon_budget=None`` (or ``inf``) means unmetered — every spend is
    recorded but nothing ever raises; that is the default posture of a
    :class:`~repro_torch.serve.sketch_service.SketchIndex` unless the caller
    pins a finite ``privacy_budget``.
    """

    def __init__(self, epsilon_budget: Optional[float] = None,
                 delta_budget: float = 0.0):
        self.epsilon_budget = (math.inf if epsilon_budget is None
                               else float(epsilon_budget))
        self.delta_budget = float(delta_budget)
        if self.epsilon_budget < 0 or self.delta_budget < 0:
            raise ValueError("budgets must be nonnegative")
        self._ledger: list = []

    # -- state ----------------------------------------------------------

    @property
    def ledger(self) -> Tuple[ReleaseRecord, ...]:
        return tuple(self._ledger)

    @property
    def spent_epsilon(self) -> float:
        return float(sum(r.epsilon for r in self._ledger))

    @property
    def spent_delta(self) -> float:
        return float(sum(r.delta for r in self._ledger))

    @property
    def remaining_epsilon(self) -> float:
        return self.epsilon_budget - self.spent_epsilon

    @property
    def remaining_delta(self) -> float:
        return self.delta_budget - self.spent_delta

    @property
    def informal_mem_epsilon(self) -> float:
        """Sum of the recorded membership-deniability parameters — an
        *annotation* of how much informal membership exposure the ledger
        has seen, NOT a DP bound and NOT counted against the budget."""
        return float(sum(r.mem_epsilon for r in self._ledger))

    # -- charging -------------------------------------------------------

    def can_spend(self, epsilon: float, delta: float = 0.0) -> bool:
        return (self.spent_epsilon + epsilon
                <= self.epsilon_budget + _EPS_SLACK
                and self.spent_delta + delta
                <= self.delta_budget + _EPS_SLACK)

    def spend(self, epsilon: float, delta: float = 0.0, *,
              label: str = "release",
              mem_epsilon: float = 0.0) -> ReleaseRecord:
        """Charge one release sequentially; strict — raises without
        recording when the budget would be overdrawn.  ``mem_epsilon``
        annotates the entry with the release's informal deniability
        parameter (recorded, never budgeted)."""
        epsilon = float(epsilon)
        delta = float(delta)
        if epsilon < 0 or delta < 0 or mem_epsilon < 0:
            raise ValueError("cannot spend negative privacy budget")
        if not self.can_spend(epsilon, delta):
            raise PrivacyBudgetExceeded(
                f"release {label!r} needs (eps={epsilon:g}, delta={delta:g}) "
                f"but only (eps={self.remaining_epsilon:g}, "
                f"delta={self.remaining_delta:g}) of the "
                f"(eps={self.epsilon_budget:g}, "
                f"delta={self.delta_budget:g}) budget remains")
        rec = ReleaseRecord(label=str(label), epsilon=epsilon, delta=delta,
                            mem_epsilon=float(mem_epsilon))
        self._ledger.append(rec)
        return rec

    def merge_from(self, other: "PrivacyAccountant") -> None:
        """Sequential composition over a sketch merge: the merged release
        reveals both inputs, so the peer's whole ledger is charged here
        (strict — raises, charging nothing, if it does not fit)."""
        eps = other.spent_epsilon
        dlt = other.spent_delta
        if not self.can_spend(eps, dlt):
            raise PrivacyBudgetExceeded(
                f"merging a ledger worth (eps={eps:g}, delta={dlt:g}) "
                f"exceeds the remaining (eps={self.remaining_epsilon:g}, "
                f"delta={self.remaining_delta:g})")
        self._ledger.extend(other._ledger)

    # -- composition arithmetic (stateless helpers) ---------------------

    @staticmethod
    def sequential_epsilon(epsilons: Iterable[float]) -> float:
        """Same records, several releases: epsilons add."""
        return float(sum(epsilons))

    @staticmethod
    def parallel_epsilon(epsilons: Sequence[float]) -> float:
        """Disjoint records, several releases: the max epsilon governs."""
        eps = [float(e) for e in epsilons]
        return max(eps) if eps else 0.0

    @staticmethod
    def advanced_epsilon(epsilon_step: float, k: int,
                         delta_slack: float) -> float:
        """k-fold advanced composition (Dwork-Rothblum-Vadhan): total
        ``eps' = eps sqrt(2 k ln(1/delta')) + k eps (e^eps - 1)`` at an
        extra ``delta'`` failure slack — sublinear in k for small eps,
        where naive sequential composition charges ``k * eps``."""
        if k < 0:
            raise ValueError("k must be nonnegative")
        if not (0.0 < delta_slack < 1.0):
            raise ValueError("delta_slack must be in (0, 1)")
        e = float(epsilon_step)
        return (e * math.sqrt(2.0 * k * math.log(1.0 / delta_slack))
                + k * e * (math.exp(e) - 1.0))
