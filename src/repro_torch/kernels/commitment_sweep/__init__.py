"""Commitment-cost sweep: weighted over/under hinge integrals of a demand
batch against per-row candidate levels."""
