"""Decision provenance: why does week w hold this stack?

With ``TelemetryConfig(provenance=True)`` the rolling replay additionally
emits, per evaluated week, the tranche roll-offs and the flags needed to
label each pool's *binding constraint* — which rule actually sized the
buy:

    envelope       the per-horizon demand envelope (Algorithm 1's
                   quantile thresholds) set the target
    spot_cap       the spot floor truncated the committed stack (capacity
                   above it was routed to the preemptible band instead)
    convertible    live cloud-level convertible capacity suppressed the
                   standard purchase (the unstranding rule)
    carry          not a decision week (or nothing to buy): the stack is
                   whatever previous weeks' tranches still hold

materialized as a :class:`DecisionLog`: a queryable per-week record of
bands bought per SKU, roll-offs, the ``is_decision`` flag, and a
tranche-level :meth:`~DecisionLog.holdings` reconstruction that answers
"why does week w hold this stack" — every live width traced back to the
week that bought it and the week it expires.

On scenario-batched replays the log covers scenario 0 — the realized
trace — matching the tranche books and the cost ledger.  This module
imports only numpy (core imports obs, never the reverse).
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: binding-constraint labels, in suppression-priority order.
BINDINGS = ("convertible", "spot_cap", "envelope", "carry")


@dataclasses.dataclass
class DecisionLog:
    """Per-week decision records of one rolling replay (scenario 0)."""

    weeks: np.ndarray             # (S,) absolute week indices
    entities: tuple[str, ...]     # (P,) pool names
    skus: tuple[str, ...]         # (K,) standard option names
    term_weeks: np.ndarray        # (K,) option terms in weeks
    is_decision: np.ndarray       # (S,) decision-week flags
    targets: np.ndarray           # (S, P, K) solver targets
    increments: np.ndarray        # (S, P, K) tranches bought
    rolloffs: np.ndarray          # (S, P, K) widths expired at week start
    active: np.ndarray            # (S, P, K) stack after buys
    binding: np.ndarray           # (S, P) labels from :data:`BINDINGS`
    # Convertible band (None on convertible-free replays): cloud-level
    # records, axes (S, C, Kc) aligned with ``conv_clouds``/``conv_skus``.
    conv_clouds: "tuple[str, ...] | None" = None
    conv_skus: "tuple[str, ...] | None" = None
    conv_term_weeks: "np.ndarray | None" = None
    conv_increments: "np.ndarray | None" = None
    conv_rolloffs: "np.ndarray | None" = None
    conv_active: "np.ndarray | None" = None
    meta: dict = dataclasses.field(default_factory=dict)

    # -- indexing ----------------------------------------------------------

    def _week_index(self, week: int) -> int:
        idx = np.flatnonzero(self.weeks == week)
        if idx.size == 0:
            raise KeyError(
                f"week {week} not in log "
                f"({self.weeks[0]}..{self.weeks[-1]})"
            )
        return int(idx[0])

    @property
    def decision_weeks(self) -> np.ndarray:
        """(D,) absolute week indices where the policy decided."""
        return self.weeks[self.is_decision.astype(bool)]

    # -- queries -----------------------------------------------------------

    def holdings(self, week: int) -> dict:
        """The stack at ``week``, tranche by tranche: for every pool, the
        live (sku, width, bought_week, expires_week) entries — a purchase
        at week b with term t serves weeks [b, b + t).  This is the "why
        does week w hold this stack" answer: each width is traced to the
        decision week that bought it."""
        si = self._week_index(week)
        out: dict[str, list[dict]] = {}
        for pi, pool in enumerate(self.entities):
            tranches = []
            for sj in range(si + 1):
                for ki, sku in enumerate(self.skus):
                    wdt = float(self.increments[sj, pi, ki])
                    expires = int(
                        self.weeks[sj] + self.term_weeks[ki]
                    )
                    if wdt > 0.0 and expires > week:
                        tranches.append({
                            "sku": sku,
                            "width": wdt,
                            "bought_week": int(self.weeks[sj]),
                            "expires_week": expires,
                            "binding": str(self.binding[sj, pi]),
                        })
            out[pool] = tranches
        return out

    def explain(self, week: int) -> dict:
        """One week's decision record as a readable dict: what rolled
        off, what was bought under which binding constraint, and the
        resulting stack."""
        si = self._week_index(week)
        pools = {}
        for pi, pool in enumerate(self.entities):
            pools[pool] = {
                "binding": str(self.binding[si, pi]),
                "bought": {
                    sku: float(self.increments[si, pi, ki])
                    for ki, sku in enumerate(self.skus)
                    if self.increments[si, pi, ki] > 0.0
                },
                "rolled_off": {
                    sku: float(self.rolloffs[si, pi, ki])
                    for ki, sku in enumerate(self.skus)
                    if self.rolloffs[si, pi, ki] > 0.0
                },
                "target_top": float(self.targets[si, pi].sum()),
                "stack_top": float(self.active[si, pi].sum()),
            }
        out = {
            "week": int(week),
            "is_decision": bool(self.is_decision[si]),
            "pools": pools,
        }
        if self.conv_clouds is not None:
            out["clouds"] = {
                cloud: {
                    "bought": {
                        sku: float(self.conv_increments[si, ci, ki])
                        for ki, sku in enumerate(self.conv_skus)
                        if self.conv_increments[si, ci, ki] > 0.0
                    },
                    "rolled_off": {
                        sku: float(self.conv_rolloffs[si, ci, ki])
                        for ki, sku in enumerate(self.conv_skus)
                        if self.conv_rolloffs[si, ci, ki] > 0.0
                    },
                    "stack_top": float(self.conv_active[si, ci].sum()),
                }
                for ci, cloud in enumerate(self.conv_clouds)
            }
        return out

    def binding_counts(self) -> dict[str, int]:
        """How many (week, pool) decisions each constraint bound."""
        return {
            b: int((self.binding == b).sum()) for b in BINDINGS
        }

    def summary(self) -> dict:
        bought = self.increments > 0.0
        out = {
            "weeks": int(len(self.weeks)),
            "decision_weeks": int(self.is_decision.astype(bool).sum()),
            "tranches_bought": int(bought.sum()),
            "width_bought": float(self.increments.sum()),
            "width_rolled_off": float(self.rolloffs.sum()),
            "binding_counts": self.binding_counts(),
        }
        if self.conv_increments is not None:
            out["conv_tranches_bought"] = int(
                (self.conv_increments > 0.0).sum()
            )
            out["conv_width_bought"] = float(self.conv_increments.sum())
        out.update({k: v for k, v in self.meta.items()
                    if k in ("policy", "cadence")})
        return out


def decision_log_from_arrays(
    weeks,
    entities,
    skus,
    term_weeks,
    *,
    is_decision,
    targets,
    increments,
    rolloffs,
    active,
    spot_bound=None,
    conv_suppressed=None,
    conv_clouds=None,
    conv_skus=None,
    conv_term_weeks=None,
    conv_increments=None,
    conv_rolloffs=None,
    conv_active=None,
    purchase_eps: float = 1e-4,
    meta: "dict | None" = None,
) -> DecisionLog:
    """Assemble a :class:`DecisionLog` from replay-emitted arrays.

    The binding label per (week, pool) follows suppression priority: a
    week that bought nothing (or was not a decision week) is ``carry``;
    a convertible-suppressed buy is ``convertible``; a spot-floor-
    truncated target is ``spot_cap``; otherwise the demand ``envelope``
    sized the buy.  Called by ``core.replan`` with plain scenario-0
    arrays (obs never imports core)."""
    weeks = np.asarray(weeks)
    is_decision = np.asarray(is_decision).astype(bool)
    targets = np.asarray(targets, np.float64)
    increments = np.asarray(increments, np.float64)
    rolloffs = np.asarray(rolloffs, np.float64)
    active = np.asarray(active, np.float64)
    s_n, p_n, _ = increments.shape

    bought = increments.sum(-1) > purchase_eps          # (S, P)
    decided = bought & is_decision[:, None]
    binding = np.full((s_n, p_n), "carry", object)
    binding[decided] = "envelope"
    if spot_bound is not None:
        binding[decided & np.asarray(spot_bound).astype(bool)] = "spot_cap"
    if conv_suppressed is not None:
        sup = np.asarray(conv_suppressed).astype(bool)
        binding[decided & sup] = "convertible"

    return DecisionLog(
        weeks=weeks,
        entities=tuple(entities),
        skus=tuple(skus),
        term_weeks=np.asarray(term_weeks),
        is_decision=is_decision,
        targets=targets,
        increments=increments,
        rolloffs=rolloffs,
        active=active,
        binding=binding.astype(str),
        conv_clouds=tuple(conv_clouds) if conv_clouds is not None else None,
        conv_skus=tuple(conv_skus) if conv_skus is not None else None,
        conv_term_weeks=(
            np.asarray(conv_term_weeks)
            if conv_term_weeks is not None else None
        ),
        conv_increments=(
            np.asarray(conv_increments, np.float64)
            if conv_increments is not None else None
        ),
        conv_rolloffs=(
            np.asarray(conv_rolloffs, np.float64)
            if conv_rolloffs is not None else None
        ),
        conv_active=(
            np.asarray(conv_active, np.float64)
            if conv_active is not None else None
        ),
        meta=dict(meta or {}),
    )
