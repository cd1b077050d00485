"""The rolling commitment planner on PyTorch.

  api        — PlanRequest front door, ``plan(request, device=None)``
  demand     — synthetic demand traces and the PoolSet fleet container
  forecast   — structural forecaster: prefix normal equations, ridge solves
  ladder     — staggered tranches and the per-pool tranche book
  planner    — Algorithm 1 steps 3-4 (prefix quantiles, monotone stack)
  policy     — the weekly decision rules of the replay
  portfolio  — purchase options, cost lines, exact and grid stack solvers
  replan     — the rolling weekly replay, a loop over weeks on the device
"""
