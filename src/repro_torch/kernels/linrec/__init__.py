"""Chunked RWKV6 linear recurrence: data-dependent decay linear attention
with a carried (dk, dv) state per head."""
