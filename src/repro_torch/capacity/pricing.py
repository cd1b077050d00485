"""CSP pricing data the planner consumes: savings-plan discounts (paper
Table 2), the rows the planners turn into purchase options, the per-cloud
spot markets the spot band prices, the hardware transitions and successor
table the generation-turnover model plants (paper Table 1, §2.3), the
software-efficiency drift (§2.4), and the per-cloud convertible haircuts.

This is the port's own copy of the data in ``repro.capacity.pricing``; the
parity tests hold the two equal row for row.
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


@dataclasses.dataclass(frozen=True)
class HardwareTransition:
    date: str
    cloud: str
    old: str
    new: str
    latency_reduction: float  # median query-latency reduction


# Paper Table 1: step-function performance gains, date-sorted.
HARDWARE_TRANSITIONS = [
    HardwareTransition("2022-05", "aws", "Graviton2", "Graviton3", 0.25),
    HardwareTransition("2022-09", "azure", "DPv5", "DPv6", 0.20),
    HardwareTransition("2024-04", "gcp", "X86", "Axion", 0.50),
    HardwareTransition("2024-08", "aws", "Graviton3", "Graviton4", 0.30),
]

# Paper §2.4: software performance improvement (Snowflake Performance Index).
SOFTWARE_EFFICIENCY_PER_YEAR = 0.12


@dataclasses.dataclass(frozen=True)
class Generation:
    """One hardware-generation turnover edge: demand on ``old_family`` pools
    migrates to ``new_family`` pools of the same cloud.

    ``launch_week`` is the adoption epoch relative to the trace start (the
    week cumulative adoption crosses ~10%); ``span_weeks`` the 10%->90%
    width of the logistic S-curve; ``perf_uplift`` the generational
    perf-per-dollar gain: one old-family VM of work needs
    1/(1 + perf_uplift) successor VMs."""

    cloud: str
    old_family: str
    new_family: str
    launch_week: int
    span_weeks: float
    perf_uplift: float

    @property
    def midpoint_week(self) -> float:
        """Week of 50% adoption (logistic midpoint)."""
        return self.launch_week + 0.5 * self.span_weeks


# Successor table: which Table-2 family each generation hands demand to,
# launch epochs staggered so multi-year traces see turnover mid-trace.
GENERATIONS = [
    Generation("aws", "C6i", "C7i", 26, 40.0, 0.25),
    Generation("aws", "C7GD", "M7GD", 78, 40.0, 0.30),
    Generation("azure", "Std_Dd_v4", "Std_Dpd_v5", 52, 48.0, 0.20),
    Generation("gcp", "N2-Standard", "N4-Standard", 104, 36.0, 0.50),
]


def generations_for_cloud(cloud: str) -> list[Generation]:
    return [g for g in GENERATIONS if g.cloud == cloud]


@dataclasses.dataclass(frozen=True)
class ConvertiblePlan:
    """Per-cloud convertible-commitment terms: a convertible tranche may be
    exchanged across machine families within its cloud at re-plan
    boundaries, for a discount *haircut* against the cloud's standard
    family-pinned savings plans (convertible discount = mean standard
    discount - haircut, per term)."""

    cloud: str
    haircut_1y: float
    haircut_3y: float


CONVERTIBLE_PLANS = [
    ConvertiblePlan("aws", 0.04, 0.07),
    ConvertiblePlan("azure", 0.04, 0.07),
    ConvertiblePlan("gcp", 0.05, 0.08),
]


def convertible_plan(cloud: str) -> ConvertiblePlan:
    for p in CONVERTIBLE_PLANS:
        if p.cloud == cloud:
            return p
    raise KeyError(f"no convertible plan data for cloud {cloud!r}")


def convertible_discounts(cloud: str) -> tuple[float, float]:
    """(discount_1y, discount_3y) of the cloud's convertible SKU: the mean
    standard discount across the cloud's Table-2 families minus the
    haircut."""
    rows = [p for p in SAVINGS_PLANS if p.cloud == cloud]
    if not rows:
        raise KeyError(f"no savings plans for cloud {cloud!r}")
    d1 = sum(p.discount_1y for p in rows) / len(rows)
    d3 = sum(p.discount_3y for p in rows) / len(rows)
    hc = convertible_plan(cloud)
    return d1 - hc.haircut_1y, d3 - hc.haircut_3y


def known_clouds() -> frozenset[str]:
    """The clouds commitments are sold on; every other table keys inside
    this set."""
    return frozenset(p.cloud for p in SAVINGS_PLANS)


def validate_tables() -> None:
    """Invariants of the pricing rows: savings-plan discounts in (0, 1) and
    monotone in term (a 3y lock cannot discount less than 1y); spot
    markets keyed inside the Table-2 clouds, with discounts and hourly
    rates in (0, 1) and price bands in [0, 1); transitions date-sorted;
    generations between two Table-2 families of one known cloud, with
    positive epochs and uplift and no chains; convertible haircuts that
    leave discounts in (0, 1), monotone in term.  Raises ``ValueError`` on
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
    dates = [t.date for t in HARDWARE_TRANSITIONS]
    if dates != sorted(dates):
        raise ValueError(
            f"HARDWARE_TRANSITIONS must be date-sorted, got {dates}"
        )
    families = {(p.cloud, p.family) for p in SAVINGS_PLANS}
    for g in GENERATIONS:
        if g.cloud not in clouds:
            raise ValueError(f"generation for unknown cloud: {g}")
        if (g.cloud, g.old_family) not in families or (
                g.cloud, g.new_family) not in families:
            raise ValueError(
                f"generation families must be Table-2 SKUs: {g}"
            )
        if g.old_family == g.new_family:
            raise ValueError(f"generation must change family: {g}")
        if g.launch_week < 0 or g.span_weeks <= 0:
            raise ValueError(f"generation epochs must be positive: {g}")
        if g.perf_uplift <= 0:
            raise ValueError(f"perf uplift must be positive: {g}")
    sources = {(g.cloud, g.old_family) for g in GENERATIONS}
    for g in GENERATIONS:
        if (g.cloud, g.new_family) in sources:
            raise ValueError(
                "chained generations are not modelled (successor is itself "
                f"a source): {g}"
            )
    for c in CONVERTIBLE_PLANS:
        if c.cloud not in clouds:
            raise ValueError(f"convertible plan for unknown cloud: {c}")
        d1, d3 = convertible_discounts(c.cloud)
        if not (0.0 < d1 < 1.0 and 0.0 < d3 < 1.0):
            raise ValueError(
                f"convertible haircut must leave a discount in (0, 1): {c}"
            )
        if d3 <= d1:
            raise ValueError(
                f"convertible discounts must stay monotone in term: {c}"
            )
    if not 0.0 < SOFTWARE_EFFICIENCY_PER_YEAR < 1.0:
        raise ValueError(
            "SOFTWARE_EFFICIENCY_PER_YEAR must be in (0, 1): "
            f"{SOFTWARE_EFFICIENCY_PER_YEAR}"
        )
