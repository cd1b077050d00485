"""Checkpoints: atomic, keep-k, asynchronous saves of tensor trees."""
