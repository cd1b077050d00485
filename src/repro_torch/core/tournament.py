"""Adversarial policy tournament: competitive ratio and regret per path.

The paper scores one strategy on one realized trace; this rig scores every
:mod:`repro_torch.core.policy` policy across the §2 workload taxonomy
(``data.scenarios.FAMILIES``).  For each policy one replay runs over every
(family x seed) demand path at once: the (F*N) paths x P pools are the
rows of one replay, on the device, and each path's bill is reduced from
its own P rows.  The per-path hindsight-optimal constant stack (the
reference ``replan_fleet_pools`` reports regret against) is computed once
and shared by all policies.

Reported per (policy, family, seed):

    competitive ratio   realized cost / hindsight-optimal cost
    regret              realized cost - hindsight-optimal cost

The hedging policies' classical guarantees (<= 2 deterministic, <= e/(e-1)
randomized, Ambati et al. arXiv 2004.04302) hold against the per-band
offline optimum; the hindsight reference here is the best *constant*
stack, which a stack that varies over time can beat after a regime shift,
so a ratio below 1 is possible.

The replay is the lean commitments-only harness (no spot, migration or
convertible band): roll off expired tranches, let the policy decide, buy
increments on decision weeks, bill committed rates plus on-demand
overflow.  ``backend="loop"`` refits by re-accumulating the normal
equations each week and sums the weekly bills in a running total (the
reference's loop oracle); ``"scan"`` refits from prefix sums.

Under a process group of more than one rank the F*N paths are sharded
over the ranks (``launch.mesh.shard_rows``): each rank replays one
contiguous block of whole paths, and the per-path costs and hindsight
optima are gathered in path order (``launch.mesh.gather_rows``), so every
rank returns the one-rank report.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

import numpy as np
import torch

from repro_torch.capacity import pricing
from repro_torch.core import forecast as fc
from repro_torch.core import ladder as ld
from repro_torch.core import policy as pol
from repro_torch.core import portfolio as pf
from repro_torch.core.demand import HOURS_PER_WEEK
from repro_torch.data import scenarios as sc
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.obs import spans as obs_spans

pricing.validate_tables()

DEFAULT_POLICIES = (
    "rolling_portfolio", "one_shot", "deterministic_hedge",
    "randomized_hedge",
)


@dataclasses.dataclass
class TournamentReport:
    """Per-(policy, family, seed) outcome grid plus summaries."""

    policies: tuple[str, ...]
    families: tuple[str, ...]
    num_seeds: int
    start_weeks: int
    cadence_weeks: int
    horizon_weeks: int
    cost: np.ndarray               # (Pol, F, N) realized replay cost
    hindsight_cost: np.ndarray     # (F, N) per-path hindsight optimum
    competitive_ratio: np.ndarray  # (Pol, F, N) cost / hindsight
    regret: np.ndarray             # (Pol, F, N) cost - hindsight
    #: wall time, stamped by callers: the port reads no clock (rule R7)
    elapsed_s: float = 0.0

    def family_stats(self, policy: str, family: str) -> dict:
        i = self.policies.index(policy)
        j = self.families.index(family)
        cr, rg = self.competitive_ratio[i, j], self.regret[i, j]
        return {
            "cr_mean": float(cr.mean()),
            "cr_p95": float(np.quantile(cr, 0.95)),
            "cr_max": float(cr.max()),
            "regret_mean": float(rg.mean()),
            "regret_max": float(rg.max()),
        }

    def summary(self) -> dict:
        return {
            p: {f: self.family_stats(p, f) for f in self.families}
            for p in self.policies
        }

    def to_markdown(self) -> str:
        """Mean competitive ratio per policy x family, one screen."""
        head = "| policy | " + " | ".join(self.families) + " |"
        sep = "|---" * (len(self.families) + 1) + "|"
        rows = [head, sep]
        for i, p in enumerate(self.policies):
            cells = " | ".join(
                f"{self.competitive_ratio[i, j].mean():.3f}"
                for j in range(len(self.families))
            )
            rows.append(f"| {p} | {cells} |")
        return "\n".join(rows)


def _lean_replay(policy: pol.Policy, ctx: pol.PolicyContext, backend: str,
                 num_paths: int) -> torch.Tensor:
    """(num_paths,) float32 total replay cost of ``policy`` on each path of
    ``ctx``'s rows (paths stacked path-major): the commitments-only weekly
    harness (roll off, decide, buy increments, bill)."""
    pstate, decide = policy.setup(ctx)
    num_r, num_k = ctx.num_pools, ctx.num_options
    dev = ctx.demand.device
    sched_len = ctx.total_weeks + max(o.term_weeks for o in ctx.options) + 1
    demand_wk = ctx.demand.reshape(num_r, ctx.total_weeks, HOURS_PER_WEEK)
    opt_idx = torch.arange(num_k, device=dev)
    active = torch.zeros((num_r, num_k), device=dev)
    rolloff = torch.zeros((num_r, num_k, sched_len), device=dev)
    weekly = []
    for w in range(ctx.start_weeks, ctx.total_weeks):
        active = active - rolloff[:, :, w]
        d_prev = demand_wk[:, w - 1] if policy.needs_prev_demand else None
        pstate, dec = decide(pstate, pol.Observation(
            week=w, active=active, d_prev=d_prev))
        inc = torch.clamp(dec.targets - active, min=0.0)
        inc = torch.where((inc > ld.PURCHASE_EPS) & dec.is_decision, inc, 0.0)
        active = active + inc
        rolloff[:, opt_idx, w + ctx.term_weeks] += inc
        level = active.sum(-1)
        committed = (ctx.rates * active).sum(-1) * HOURS_PER_WEEK
        over = torch.clamp(demand_wk[:, w] - level[:, None], min=0.0).sum(-1)
        weekly.append(committed.reshape(num_paths, -1).sum(-1)
                      + ctx.od * over.reshape(num_paths, -1).sum(-1))
    if backend == "scan":
        # each path's weeks summed along its own contiguous row: the
        # reduction's order does not depend on how many paths there are
        return torch.stack(weekly, dim=-1).sum(-1)
    total = torch.zeros(num_paths, device=dev)
    for cost in weekly:
        total = total + cost
    return total


def _hindsight_cost(demand, *, options, clouds, od, start_weeks,
                    num_paths) -> torch.Tensor:
    """(num_paths,) per-path hindsight optimum: the optimal constant stack
    on each row's realized evaluation demand, billing lines
    (``term_weighting=0``)."""
    al0, be0, _ = pf.pool_option_lines(
        options, clouds, term_weighting=0.0, od_rate=od,
        device=demand.device,
    )
    total_weeks = demand.shape[-1] // HOURS_PER_WEEK
    ev = demand[:, start_weeks * HOURS_PER_WEEK:total_weeks * HOURS_PER_WEEK]
    widths = pf.optimal_portfolio_stack(ev, al0, be0, od_rate=od).widths
    rates = torch.tensor([o.rate for o in options], dtype=torch.float32,
                         device=demand.device)
    over = torch.clamp(ev - widths.sum(-1)[:, None], min=0.0).sum(-1)
    committed = ((rates * widths).sum(-1)
                 * (total_weeks - start_weeks) * HOURS_PER_WEEK)
    return (committed.reshape(num_paths, -1).sum(-1)
            + od * over.reshape(num_paths, -1).sum(-1))


def _path_costs(
    resolved: list[pol.Policy],
    paths: np.ndarray,
    *,
    start_weeks: int,
    cadence_weeks: int,
    horizon_weeks: int,
    options: list,
    od: float,
    cfg: fc.ForecastConfig,
    backend: str,
    device: torch.device,
    spans=None,
) -> tuple[np.ndarray, np.ndarray]:
    """(hindsight (M,), cost (Pol, M)) float64 on given (M, P, T) demand
    paths: one replay per policy over all M*P rows on ``device``, each
    bracketed by a span of ``spans`` (a ``SpanRecorder`` or None)."""
    num_paths, num_pools = paths.shape[:2]
    clouds = tuple(c for c, _, _ in sc.scenario_keys(num_pools)) * num_paths
    demand = torch.from_numpy(np.ascontiguousarray(
        paths.reshape(num_paths * num_pools, -1), np.float32)).to(device)
    with obs_spans.span(spans, "tournament/hindsight", phase="execute"):
        hindsight = _hindsight_cost(
            demand, options=options, clouds=clouds, od=od,
            start_weeks=start_weeks, num_paths=num_paths)
    solve_fn = fc.solve_prefix if backend == "scan" else fc.solve_prefix_direct
    ctx = pol.make_context(
        demand, options, clouds=clouds, od_rate=od, cfg=cfg,
        start_weeks=start_weeks, cadence_weeks=cadence_weeks,
        horizon_weeks=horizon_weeks, solve_fn=solve_fn,
        path_blocks=num_paths,
    )
    totals = []
    for p in resolved:
        with obs_spans.span(spans, f"tournament/{p.name}", phase="execute"):
            totals.append(_lean_replay(p, ctx, backend, num_paths))
    totals = torch.stack(totals)
    host = torch.cat([hindsight[None], totals]).cpu().numpy()
    return host[0].astype(np.float64), host[1:].astype(np.float64)


def _report(resolved, families, num_seeds, hindsight, cost, *,
            start_weeks, cadence_weeks, horizon_weeks) -> TournamentReport:
    """The report of path-major (F*N,) hindsight optima and (Pol, F*N)
    costs."""
    num_f = len(families)
    hind = hindsight.reshape(num_f, num_seeds)
    cost = cost.reshape(len(resolved), num_f, num_seeds)
    return TournamentReport(
        policies=tuple(p.name for p in resolved),
        families=families,
        num_seeds=num_seeds,
        start_weeks=start_weeks,
        cadence_weeks=cadence_weeks,
        horizon_weeks=horizon_weeks,
        cost=cost,
        hindsight_cost=hind,
        competitive_ratio=cost / hind[None],
        regret=cost - hind[None],
    )


def _run_on_paths(
    resolved: list[pol.Policy],
    families: tuple[str, ...],
    paths: np.ndarray,
    *,
    start_weeks: int,
    cadence_weeks: int,
    horizon_weeks: int,
    options: list,
    od: float,
    cfg: fc.ForecastConfig,
    backend: str,
    device: torch.device,
    spans=None,
) -> TournamentReport:
    """The tournament on given (F, N, P, T) demand paths, on this rank
    alone: one replay per policy over all F*N*P rows on ``device``, each
    bracketed by a span of ``spans`` (a ``SpanRecorder`` or None)."""
    num_f, num_seeds = paths.shape[:2]
    hind, cost = _path_costs(
        resolved, paths.reshape(num_f * num_seeds, *paths.shape[2:]),
        start_weeks=start_weeks, cadence_weeks=cadence_weeks,
        horizon_weeks=horizon_weeks, options=options, od=od, cfg=cfg,
        backend=backend, device=device, spans=spans)
    return _report(resolved, families, num_seeds, hind, cost,
                   start_weeks=start_weeks, cadence_weeks=cadence_weeks,
                   horizon_weeks=horizon_weeks)


def run_tournament(
    policies: Sequence["pol.Policy | str"] = DEFAULT_POLICIES,
    families: Sequence[str] = sc.FAMILIES,
    *,
    num_pools: int = 3,
    num_weeks: int = 48,
    num_seeds: int = 32,
    base_seed: int = 0,
    start_weeks: int = 20,
    cadence_weeks: int = 2,
    horizon_weeks: int = 8,
    options: list | None = None,
    od_rate: float | None = None,
    cfg: fc.ForecastConfig = fc.ForecastConfig(),
    backend: Literal["scan", "loop"] = "scan",
    spans=None,
    device: "torch.device | str | None" = None,
) -> TournamentReport:
    """Run the policy tournament on ``device`` (``None`` = the card):
    every policy's replay over every (family x seed) path from
    :func:`repro_torch.data.scenarios.scenario_paths`, scored against
    per-path hindsight.  Pool clouds cycle aws/azure/gcp as the synthetic
    fleet's do, so the Table-2 purchase options apply.

    ``spans`` (a :class:`repro_torch.obs.spans.SpanRecorder`) brackets the
    hindsight pass and each policy's replay with a span, phase
    "execute"; ``spans=None`` does no timing work."""
    if backend not in ("scan", "loop"):
        raise ValueError(
            f"unknown backend {backend!r}; known: ('scan', 'loop')"
        )
    dev = resolve_device(device)
    resolved = [pol.get_policy(p) for p in policies]
    families = tuple(families)
    paths = np.stack([
        sc.scenario_paths(f, num_pools=num_pools, num_weeks=num_weeks,
                          num_seeds=num_seeds, base_seed=base_seed)
        for f in families
    ])                                                     # (F, N, P, T)
    num_paths = len(families) * num_seeds
    kw = dict(start_weeks=start_weeks, cadence_weeks=cadence_weeks,
              horizon_weeks=horizon_weeks)
    # this rank's block of whole paths (all of them on one rank)
    lo, hi = mesh_mod.shard_rows(num_paths)
    hind, cost = _path_costs(
        resolved, paths.reshape(num_paths, *paths.shape[2:])[lo:hi],
        options=options if options is not None else pf.options_from_pricing(),
        od=od_rate if od_rate is not None else pricing.on_demand_premium(),
        cfg=cfg, backend=backend, device=dev, spans=spans, **kw)
    hind = mesh_mod.gather_rows(hind, num_paths)
    cost = mesh_mod.gather_rows(cost, num_paths, axis=1)
    return _report(resolved, families, num_seeds, hind, cost, **kw)
