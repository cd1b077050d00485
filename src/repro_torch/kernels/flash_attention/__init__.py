"""Flash attention forward: online-softmax attention with GQA, a causal
mask, per-batch ``kv_len`` and decode alignment."""
