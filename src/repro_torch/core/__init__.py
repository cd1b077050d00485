"""The commitment planner on PyTorch: one-shot and rolling.

  api        — PlanRequest front door, ``plan(request, device=None)``
  commitment — Eq. (1)'s cost and its quantile, golden and Brent solvers
  demand     — synthetic demand traces, §2.2 statistics, the PoolSet fleet
  forecast   — structural forecaster: the batched one-shot fit, prefix
               normal equations, ridge solves
  ladder     — staggered tranches, the per-pool tranche book, Fig. 9
  planner    — Algorithm 1: plan_commitment, plan_portfolio, the one-shot
               fleet plan, Fig. 8
  policy     — the weekly decision rules of the replay
  portfolio  — purchase options, cost lines, exact and grid stack solvers,
               the real-dollar spend
  replan     — the rolling weekly replay, a loop over weeks on the device
"""
