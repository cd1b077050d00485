"""Serving runtime of the port: the continuous-batching engine and the
free-pool replica autoscaler."""
