"""CSP pricing data the planner consumes: savings-plan discounts (paper
Table 2), the rows the planners turn into purchase options, and the
per-cloud spot markets the spot band prices.

This is the port's own copy of the data in ``repro.capacity.pricing``; the
parity tests hold the two equal row for row.  Hardware generations and
convertible haircuts come with the migration slice (ROADMAP Queue 1,
item 11).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SavingsPlan:
    cloud: str
    family: str
    discount_1y: float
    discount_3y: float


# Paper Table 2: savings-plan discounts vs on-demand.
SAVINGS_PLANS = [
    SavingsPlan("aws", "C6i", 0.28, 0.52),
    SavingsPlan("aws", "C7i", 0.28, 0.52),
    SavingsPlan("aws", "C7GD", 0.28, 0.52),
    SavingsPlan("aws", "M7GD", 0.27, 0.50),
    SavingsPlan("azure", "Std_Dd_v4", 0.31, 0.54),
    SavingsPlan("azure", "Std_Dpd_v5", 0.31, 0.54),
    SavingsPlan("gcp", "N2-Standard", 0.37, 0.55),
    SavingsPlan("gcp", "N4-Standard", 0.37, 0.55),
]


def mean_discount_3y() -> float:
    return sum(p.discount_3y for p in SAVINGS_PLANS) / len(SAVINGS_PLANS)


def on_demand_premium() -> float:
    """On-demand price relative to committed price.  Paper §3.1: committed
    = (1 - mean 3y discount) x on-demand => premium = 1/(1-d) ~= 2.1x."""
    return 1.0 / (1.0 - mean_discount_3y())


@dataclasses.dataclass(frozen=True)
class SpotMarket:
    """Per-cloud spot/preemptible capacity terms (Table-2-style data row).

    ``discount`` is the mean spot price discount vs on-demand;
    ``hazard_per_hour`` / ``recovery_per_hour`` are the two-state
    revocation-process rates (probability per hour of an available slice
    being revoked, and of a revoked slice coming back); ``price_band`` is
    the +/- fractional band hourly spot prices wander in around the mean.
    Stationary availability of the process is recovery / (hazard +
    recovery)."""

    cloud: str
    discount: float           # spot rate = (1 - discount) * on-demand rate
    hazard_per_hour: float    # P(available -> revoked) per hour
    recovery_per_hour: float  # P(revoked -> available) per hour
    price_band: float         # hourly spot price in mean * (1 +/- band)


# Spot market terms per cloud: deeper discounts ride with higher revocation
# hazard.  Rates are per hour on the same normalized price axis as
# SAVINGS_PLANS.
SPOT_MARKETS = [
    SpotMarket("aws", 0.68, 0.050, 0.50, 0.15),
    SpotMarket("azure", 0.62, 0.035, 0.45, 0.12),
    SpotMarket("gcp", 0.70, 0.060, 0.60, 0.10),
]


def spot_market(cloud: str) -> SpotMarket:
    """The spot terms for one cloud (``KeyError`` on an unknown cloud, so a
    typo'd pool key fails loudly instead of pricing at a default)."""
    for m in SPOT_MARKETS:
        if m.cloud == cloud:
            return m
    raise KeyError(f"no spot market data for cloud {cloud!r}")


def known_clouds() -> frozenset[str]:
    """The clouds commitments are sold on; every other table keys inside
    this set."""
    return frozenset(p.cloud for p in SAVINGS_PLANS)


def validate_tables() -> None:
    """Invariants of the pricing rows: savings-plan discounts in (0, 1) and
    monotone in term (a 3y lock cannot discount less than 1y); spot
    markets keyed inside the Table-2 clouds, with discounts and hourly
    rates in (0, 1) and price bands in [0, 1).  Raises ``ValueError`` on
    the first violated row, so a corrupted table fails at import instead
    of as an absurd plan."""
    for p in SAVINGS_PLANS:
        if not (0.0 < p.discount_1y < 1.0 and 0.0 < p.discount_3y < 1.0):
            raise ValueError(
                f"savings-plan discounts must be in (0, 1): {p}"
            )
        if p.discount_3y <= p.discount_1y:
            raise ValueError(
                f"discounts must be monotone in term (3y > 1y): {p}"
            )
    clouds = known_clouds()
    for m in SPOT_MARKETS:
        if m.cloud not in clouds:
            raise ValueError(f"spot market for unknown cloud: {m}")
        if not 0.0 < m.discount < 1.0:
            raise ValueError(f"spot discount must be in (0, 1): {m}")
        if not (0.0 < m.hazard_per_hour < 1.0
                and 0.0 < m.recovery_per_hour < 1.0):
            raise ValueError(f"spot rates must be in (0, 1): {m}")
        if not 0.0 <= m.price_band < 1.0:
            raise ValueError(f"spot price band must be in [0, 1): {m}")
