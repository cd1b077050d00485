"""The commitment planner on PyTorch: one-shot and rolling.

  api        — PlanRequest front door, ``plan(request, device=None)``
  commitment — Eq. (1)'s cost and its quantile, golden and Brent solvers
  demand     — synthetic demand traces, §2.2 statistics, the PoolSet fleet
  forecast   — structural forecaster: the batched one-shot fit, prefix
               normal equations, ridge solves
  freepool   — §5: static and forecast-driven free-pool sizing, Fig. 12
  ladder     — staggered tranches, the per-pool and cloud-level tranche
               books, Fig. 9
  migration  — share-based forecasting and the driver decomposition of a
               fleet in generation turnover
  planner    — Algorithm 1: plan_commitment, plan_portfolio, the one-shot
               fleet plan, Fig. 8
  policy     — the weekly decision rules of the replay, the hedges
  portfolio  — purchase options, cost lines, exact and grid stack solvers,
               the real-dollar spend, the convertible band's helpers
  replan     — the rolling weekly replay, a loop over weeks on the device,
               batched over demand scenarios
  timeshift  — §4: EDF packing of deferrable jobs into the commitment's
               troughs, and the fluid water-fill on the device
  tournament — every policy over the workload families' paths, scored by
               competitive ratio and regret
"""
