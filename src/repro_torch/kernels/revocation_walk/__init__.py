"""Spot revocation walk: the two-state available/revoked Markov chain and
the in-band price AR(1), stepped hour by hour for every (draw, pool)
lane."""
