"""Generation turnover: demand moved from old-family pools to their
successors along logistic adoption curves, with every pool deflated by the
software-efficiency drift, evaluated for every (pool, hour)."""
