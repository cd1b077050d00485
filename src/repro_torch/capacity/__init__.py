"""Capacity data the port needs: the pricing tables (paper Table 2)."""
