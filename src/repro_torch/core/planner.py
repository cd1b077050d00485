"""Algorithm 1 steps 3-4 (paper §3.3.3), batched over pools.

Step 3 computes each option's threshold on every horizon prefix of the
forecast as a weighted quantile at the option's critical fractile; step 4
takes each option's minimum over the horizons within its term and
re-monotonizes the stack.  The one-shot planner built on these
(``plan_fleet_pools(mode="one_shot")``) is a later slice of the port.

Both functions take a leading pool axis the reference writes as a vmap.
Their sorts are stable (``stable=True``), as ``jnp.argsort`` is: tied
forecast hours and the ``inf`` depth of options off the envelope must keep
input order for the thresholds to match.
"""

from __future__ import annotations

import torch


def _prefix_weighted_quantiles(
    yhat: torch.Tensor, w_hours: torch.Tensor, qs: torch.Tensor
) -> torch.Tensor:
    """Thresholds (P, W, K): for each pool's horizon prefix yhat[p, :w] the
    quantile at each fractile qs[p, k] — one sort for all horizons x
    options.  yhat (P, H), w_hours (W,), qs (P, K)."""
    order = torch.argsort(yhat, dim=-1, stable=True)
    sorted_y = torch.gather(yhat, -1, order)
    valid = (order[:, None, :] < w_hours[None, :, None]).to(yhat.dtype)
    cum = torch.cumsum(valid, dim=-1)                    # (P, W, H)
    frac = cum / torch.clamp(cum[..., -1:], min=1.0)
    num_w = w_hours.shape[0]
    q = qs[:, None, :].expand(-1, num_w, -1).contiguous()
    # frac is nondecreasing along H, so the first index with frac >= q is
    # a left search; "none" (index H) maps to 0 like an argmax of all-False.
    idx = torch.searchsorted(frac, q, side="left")       # (P, W, K)
    idx = torch.where(idx >= yhat.shape[-1], 0, idx)
    return torch.gather(
        sorted_y[:, None, :].expand(-1, num_w, -1), -1, idx
    )


def _monotone_stack(
    per_horizon: torch.Tensor,
    qs: torch.Tensor,
    term_weeks: torch.Tensor,
    num_horizons: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Step 4 of Algorithm 1 for each pool's option stack.

    per_horizon (P, W, K) prefix thresholds, qs (P, K) critical fractiles
    -> (widths (P, K), levels (P, K)): each option's min over the horizons
    within its own term, then a running max in envelope-depth order since
    per-option minima over different horizon sets can cross."""
    dev = per_horizon.device
    weeks = torch.arange(1, num_horizons + 1, device=dev)[:, None]  # (W, 1)
    in_term = weeks <= torch.clamp(term_weeks[None, :], min=1)      # (W, K)
    mins = torch.where(in_term, per_horizon, torch.inf).amin(1)      # (P, K)
    on_env = qs > 0

    depth = torch.argsort(
        torch.where(on_env, qs, torch.inf), dim=-1, stable=True
    )
    inv = torch.argsort(depth, dim=-1, stable=True)
    mins_d = torch.gather(torch.where(on_env, mins, 0.0), -1, depth)
    tops_d = torch.cummax(mins_d, dim=-1).values
    prev_d = torch.cat(
        [torch.zeros_like(tops_d[:, :1]), tops_d[:, :-1]], dim=-1
    )
    widths_d = torch.where(
        torch.gather(on_env, -1, depth), tops_d - prev_d, 0.0
    )
    return torch.gather(widths_d, -1, inv), torch.gather(tops_d, -1, inv)
