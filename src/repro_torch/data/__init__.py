"""Demand data for the port: the calibrated synthetic fleet, the
dataset loader, and the scenario families."""
