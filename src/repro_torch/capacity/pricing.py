"""CSP savings-plan discounts (paper Table 2): the pricing rows the rolling
planner turns into purchase options.

This is the port's own copy of the data in ``repro.capacity.pricing``; the
parity tests hold the two equal row for row.  Spot markets, hardware
generations and convertible haircuts are not needed by the rolling planner
yet and come with the spot and migration slices.
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


def validate_tables() -> None:
    """Invariants of the savings-plan rows: discounts in (0, 1) and
    monotone in term (a 3y lock cannot discount less than 1y).  Raises
    ``ValueError`` on the first violated row, so a corrupted table fails
    at import instead of as an absurd plan."""
    for p in SAVINGS_PLANS:
        if not (0.0 < p.discount_1y < 1.0 and 0.0 < p.discount_3y < 1.0):
            raise ValueError(
                f"savings-plan discounts must be in (0, 1): {p}"
            )
        if p.discount_3y <= p.discount_1y:
            raise ValueError(
                f"discounts must be monotone in term (3y > 1y): {p}"
            )
