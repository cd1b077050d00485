"""Logical-axis to mesh-axis sharding rules."""
