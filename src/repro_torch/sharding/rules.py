"""Logical-axis -> mesh-axis sharding rules (MaxText-style), the port of
``repro.sharding.rules``.

Mesh axes (:mod:`repro_torch.launch.mesh`): single-pod ("data", "model")
= (16, 16); multi-pod ("pod", "data", "model") = (2, 16, 16).

Strategy:
  * train   — FSDP("data") x TP("model") x DP("pod"): parameters and AdamW
    state shard embed->data and heads/ff/experts/vocab->model; batch shards
    over (pod, data).
  * prefill — weights TP over model (params resident, no FSDP gather per
    microbatch at inference); batch over (pod, data).
  * decode  — KV-cache *sequence* dim shards over "model" (context
    parallelism: kv-head counts rarely divide 16, cache length always does);
    batch over (pod, data); weights TP over model.

A partition spec in the port is a tuple with one entry per dimension, each
``None`` (replicated), a mesh-axis name, or a tuple of names.  The rules
size per-device bytes (:mod:`repro_torch.launch.cells`) and place the
model's parameters on a mesh of ranks
(``models.model.Model.param_shardings``, as DTensors by
:mod:`repro_torch.sharding.placement`); :func:`rules_on_mesh` drops the
axes a mesh lacks, as the dry run does (single-pod has no ``"pod"``).
"""

from __future__ import annotations

Rules = dict[str, str | tuple | None]
PartitionSpec = tuple

# Parameter logical axes:
#   embed   d_model dims of weights
#   heads/kv_heads/head_dim  attention projection dims
#   ff / moe_ff   MLP hidden dims
#   experts       MoE expert dim
#   vocab         embedding/head vocab dim
#   lora / state / layers / conv  never sharded
# Activation/cache logical axes:
#   batch, seq, cache_seq

TRAIN_RULES: Rules = {
    "embed": "data",         # FSDP: params/opt-state sharded over data
    "heads": "model",
    "ff": "model",
    "moe_ff": None,
    "experts": "model",      # expert parallelism
    "vocab": "model",
    "kv_heads": None,        # 4..48 kv heads rarely divide 16 -> replicate
    "head_dim": None,
    "batch": ("pod", "data"),
    "cache_seq": None,
}

PREFILL_RULES: Rules = {
    "embed": None,
    "heads": "model",
    "ff": "model",
    "moe_ff": None,
    "experts": "model",
    "vocab": "model",
    "kv_heads": None,
    "head_dim": None,
    "batch": ("pod", "data"),
    "cache_seq": "model",    # cache written sequence-sharded for decode
}

DECODE_RULES: Rules = {
    "embed": None,
    "heads": "model",
    "ff": "model",
    "moe_ff": None,
    "experts": "model",
    "vocab": "model",
    "kv_heads": None,
    "head_dim": None,
    "batch": ("pod", "data"),
    "cache_seq": "model",    # context parallelism over the KV cache
}

RULESETS: dict[str, Rules] = {
    "train": TRAIN_RULES,
    "prefill": PREFILL_RULES,
    "decode": DECODE_RULES,
}


def batch_spec(rules: Rules) -> PartitionSpec:
    """The batch dim's spec (``batch_pspec`` of the reference)."""
    return (rules.get("batch"),)


def data_spec(rules: Rules, ndim: int) -> PartitionSpec:
    """(B, S, ...) activations: batch sharded, rest replicated
    (``data_pspec`` of the reference)."""
    return (rules.get("batch"), *(None,) * (ndim - 1))


def rules_on_mesh(rules: Rules, axes) -> Rules:
    """``rules`` with every mesh axis that ``axes`` lacks dropped: a
    logical axis whose mesh axes are all absent is replicated."""
    def keep(part):
        if part is None:
            return None
        kept = tuple(p for p in (part if isinstance(part, (tuple, list))
                                 else (part,)) if p in axes)
        return kept if kept else None

    return {k: keep(v) for k, v in rules.items()}
