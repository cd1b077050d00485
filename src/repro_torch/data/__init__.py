"""Demand data for the port: the calibrated synthetic fleet."""
