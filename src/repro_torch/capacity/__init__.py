"""Capacity data and models the port needs: the pricing tables (paper
Tables 1-2), the spot revocation process, generation turnover, the
deferrable-workload scheduler, and the fleet simulator with the spot
plan's replay."""
