"""The analytic roofline: per-device bytes, model FLOPs and the three-term
roofline on the H100, the port of the analytic half of
``repro.launch.hlo_analysis``.

The reference reads FLOPs and bytes from XLA's compiled HLO and parses its
collectives (``parse_collectives``); the port compiles no HLO, so both
have no counterpart here, and the collective bytes are the caller's.  What
carries over is the analytic model the reference projects its memory
term with: per-device resident bytes under the sharding rules
(:func:`_local_bytes`), the HBM traffic of one step
(:func:`analytic_hbm_bytes`), the transient bytes
(:func:`analytic_temp_bytes`), the model FLOPs 6ND / 2ND
(:func:`model_flops_for`, N the active non-embedding parameters) and the
recurrences' chunk-scan FLOPs (:func:`inner_recurrence_flops`).

The reference's constants are a TPU v5e's.  The port's are the H100's, by
variant (:data:`PEAKS`, NVIDIA data sheets, dense, at the full power
limit), picked by the card's name (:func:`peaks_for`).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.models.params import (
    Spec,
    _spec_leaves,
    sanitize_partition_spec,
    shards,
)

#: Peak rates by H100 variant: FP32 on the CUDA cores, bf16 on the tensor
#: cores, HBM bandwidth, and one direction of the card's link to its peers
#: for the collective term.
PEAKS = {
    # H100 SXM5 80GB: HBM3, NVLink 4 (900 GB/s both directions)
    "sxm": {"fp32_flops": 67e12, "bf16_flops": 989e12, "bytes": 3.35e12,
            "link_bytes": 450e9},
    # H100 PCIe 80GB: HBM2e, PCIe Gen5 x16 (128 GB/s both directions)
    "pcie": {"fp32_flops": 51e12, "bf16_flops": 756e12, "bytes": 2.0e12,
             "link_bytes": 64e9},
}


def peaks_for(card_name: str) -> dict:
    """The peak rates of the H100 variant named ``card_name`` (as
    ``torch.cuda.get_device_name`` gives it)."""
    return PEAKS["pcie" if "PCIe" in card_name else "sxm"]


@dataclasses.dataclass
class Roofline:
    flops: float               # per device
    hbm_bytes: float           # per device (analytic model)
    collective_bytes: float    # per device
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float         # analytic 6ND / 2ND per device
    useful_ratio: float        # model_flops / flops

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_terms(
    flops: float,
    hbm_bytes: float,
    collective_bytes: float,
    model_flops: float,
    peaks: dict = PEAKS["sxm"],
) -> Roofline:
    """The three terms at ``peaks`` (bf16 tensor-core FLOPs, HBM bytes, link
    bytes) and the one that dominates."""
    compute_s = flops / peaks["bf16_flops"]
    memory_s = hbm_bytes / peaks["bytes"]
    collective_s = collective_bytes / peaks["link_bytes"]
    terms = {
        "compute": compute_s, "memory": memory_s, "collective": collective_s,
    }
    dominant = max(terms, key=terms.get)  # type: ignore[arg-type]
    return Roofline(
        flops=flops,
        hbm_bytes=hbm_bytes,
        collective_bytes=collective_bytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        useful_ratio=model_flops / max(flops, 1.0),
    )


# ---------------------------------------------------------------------------
# Analytic per-device bytes
# ---------------------------------------------------------------------------

def _local_bytes(specs, mesh_shape: dict, rules: dict,
                 default_dtype_bytes: int = 2) -> float:
    """Exact per-device resident bytes of a Spec tree (nested dicts and
    lists, or an iterable of Specs) under the sanitized sharding rules on
    a ``{axis: size}`` mesh shape.  A Spec without a dtype takes
    ``default_dtype_bytes`` (bf16), as the reference counts it."""
    total = 0.0
    for spec in _spec_leaves(specs):
        nbytes = (spec.dtype.itemsize if spec.dtype is not None
                  else default_dtype_bytes)
        pspec = sanitize_partition_spec(spec, rules, mesh_shape)
        total += float(math.prod(spec.shape)) * nbytes / shards(
            pspec, mesh_shape)
    return total


def _batch_shards(mesh_shape: dict, rules: dict) -> int:
    batch_axes = rules.get("batch") or ()
    if not isinstance(batch_axes, tuple):
        batch_axes = (batch_axes,)
    return math.prod(mesh_shape[a] for a in batch_axes) or 1


def analytic_hbm_bytes(cell, mesh_shape: dict, rules: dict) -> float:
    """Projected HBM bytes per device per step, the reference's model
    (``hlo_analysis.analytic_hbm_bytes``) of what a fused step moves:
      train:   3x params (fwd + bwd + remat-recompute reads) + 1x param
               write + opt state r/w (24B/param) + grads (8B/param)
               + activation IO (~14 bf16 tensor r/w per layer) + logits x3
               + MoE buffer r/w
      prefill: 1x params + activations + KV-cache write + KV re-read per
               query chunk + logits
      decode:  1x params + full KV-cache read + O(1) activations
    ``cell`` is a :class:`repro_torch.launch.cells.Cell`."""
    cfg = cell.cfg
    shape_cell = cell.cell
    n_model = mesh_shape.get("model", 1)
    n_batch = _batch_shards(mesh_shape, rules)

    params_loc = _local_bytes(cell.param_specs, mesh_shape, rules)
    n_params_loc = params_loc / 2  # bf16 resident copy

    b_loc = max(shape_cell.global_batch // n_batch, 1)
    s = shape_cell.seq_len
    d = cfg.d_model
    l_layers = cfg.num_layers + cfg.encoder_layers
    v_loc = cfg.vocab_size / n_model

    if shape_cell.kind == "train":
        param_io = 4 * params_loc + 32 * n_params_loc
        act_io = 14 * l_layers * b_loc * s * d * 2
        logits_io = 3 * b_loc * s * v_loc * 4
        moe_io = 0.0
        if cfg.num_experts:
            n_tokens = shape_cell.global_batch * s
            cap = cfg.top_k * n_tokens / cfg.num_experts \
                * cfg.moe_capacity_factor
            moe_layers = sum(
                cfg.is_moe_layer(i) for i in range(cfg.num_layers))
            moe_io = moe_layers * 6 * (cfg.num_experts / n_model) * cap \
                * d * 2
        return param_io + act_io + logits_io + moe_io

    cache_loc = _local_bytes(cell.cache_specs, mesh_shape, rules)

    if shape_cell.kind == "prefill":
        param_io = params_loc
        act_io = 8 * l_layers * b_loc * s * d * 2
        chunks = max(s // 2048, 1)
        kv_reread = (chunks - 1) * cache_loc  # flash streams KV per q chunk
        logits_io = b_loc * v_loc * 4  # next-token logits only
        return param_io + act_io + cache_loc + kv_reread + logits_io

    # decode: params once + read the whole (sharded) cache + tiny writes
    act_io = 8 * l_layers * b_loc * 1 * d * 2
    logits_io = b_loc * v_loc * 4
    return params_loc + cache_loc + act_io + logits_io


# ---------------------------------------------------------------------------
# Analytic model FLOPs: 6 N D train, 2 N D inference, N = active
# non-embedding parameters
# ---------------------------------------------------------------------------

def _counted(name: str) -> bool:
    """The reference's filter on its tree paths (``embed`` in the last key,
    ``lm_head``, ``_pos``), restated on the port's dotted names."""
    return not ("embed" in name.rsplit(".", 1)[-1]
                or name.endswith("lm_head") or "_pos" in name)


def active_params(cfg, named_specs: dict[str, Spec]) -> float:
    """Active parameter count: total minus embedding/lm_head/positional
    tables minus the non-routed fraction of MoE experts.  ``named_specs``
    maps the port's parameter names to their Specs
    (:func:`repro_torch.models.params.named_specs`); the port's per-layer
    names give the reference's totals (``tests/test_torch_cells.py``)."""
    total = 0.0
    for name, spec in named_specs.items():
        if not _counted(name):
            continue
        n = float(math.prod(spec.shape))
        if "experts" in spec.axes:
            e_axis = spec.axes.index("experts")
            if spec.shape[e_axis] == cfg.num_experts:
                n *= cfg.top_k / cfg.num_experts
        total += n
    return total


def analytic_temp_bytes(cfg, cell, n_data_shards: int, n_model_shards: int,
                        microbatches: int = 1) -> float:
    """Projected transient memory per device, the reference's model
    (``hlo_analysis.analytic_temp_bytes``):
      * remat residual stack: one (B_loc, S, d) bf16 per scan unit,
      * logits + CE backward buffer (B_loc, S, V_loc) f32 x2,
      * transient layer working set: ~6 activation-sized f32 buffers plus
        one attention score chunk (B_loc, H_loc, chunk, S) f32.
    ``cell`` is a :class:`repro_torch.models.config.ShapeCell`."""
    b_loc = max(cell.global_batch // n_data_shards // microbatches, 1)
    s = cell.seq_len if cell.kind != "decode" else 1
    d = cfg.d_model
    scan_units = cfg.num_layers
    if cfg.family == "hybrid" and cfg.attn_layer_period:
        scan_units = cfg.num_layers // cfg.attn_layer_period
    resid = scan_units * b_loc * s * d * 2 if cell.kind == "train" else 0
    v_loc = cfg.vocab_size / n_model_shards
    s_logits = s if cell.kind == "train" else 1  # prefill: last token only
    logits = 2 * b_loc * s_logits * v_loc * 4
    h_loc = max(cfg.num_heads // n_model_shards, 1)
    chunk = min(s, 1024 if cell.kind == "train" else 2048)
    kv_span = cell.seq_len
    scores = b_loc * h_loc * chunk * kv_span * 4 if cfg.family != "ssm" else 0
    ff_loc = max(cfg.d_ff, cfg.moe_d_ff or 0, cfg.ssm_d_inner
                 if cfg.family in ("hybrid",) else 0) / n_model_shards
    working = 6 * b_loc * s * d * 4 + 2 * b_loc * s * ff_loc * 4
    return float(resid + logits + scores + working)


def pick_chunk(seq_len: int, *, target_iters: int = 64, min_chunk: int = 32,
               max_chunk: int = 1024) -> int:
    """The reference's scan chunk length (``repro.models.scan_utils
    .pick_chunk``, a copy): ~target_iters iterations, divisor-aligned."""
    chunk = max(min_chunk, min(max_chunk, -(-seq_len // target_iters)))
    # round up to a multiple of min_chunk that divides seq_len if possible
    while seq_len % chunk and chunk < max_chunk:
        chunk += 1
    return min(chunk, seq_len)


def inner_recurrence_flops(cfg, cell) -> float:
    """GLOBAL FLOPs of the per-layer chunk scans of the Mamba and RWKV
    recurrences beyond one chunk, the reference's closed form
    (``hlo_analysis.inner_recurrence_flops``: XLA's cost analysis counts a
    scan body once, so it adds (nchunks - 1) / nchunks of the recurrence).
    The port has no HLO count; the dry run adds this to the model FLOPs
    for its compute term, as the reference adds it to its measured
    FLOPs."""
    if cell.kind == "decode":
        return 0.0  # single-step path has no chunk scan
    s = cell.seq_len
    tokens = cell.global_batch * s
    mult = 3.0 if cell.kind == "train" else 1.0  # bwd + remat recompute
    total = 0.0
    if cfg.family == "hybrid":
        chunk = pick_chunk(s, target_iters=16, max_chunk=2048)
        nchunks = max(s // chunk, 1)
        n_mamba = sum(
            1 for i in range(cfg.num_layers) if not cfg.is_attn_layer(i))
        # da/bx build (~6) + associative scan (~6 log2 L) + y einsum (~2)
        per_tok = cfg.ssm_d_inner * cfg.ssm_d_state * (
            8 + 6 * math.log2(max(chunk, 2)))
        total += n_mamba * tokens * per_tok * mult * (1 - 1 / nchunks)
    if cfg.family == "ssm":
        chunk = pick_chunk(s, target_iters=32, max_chunk=256)
        nchunks = max(s // chunk, 1)
        hs = cfg.rwkv_head_size
        # intra-chunk attention (~7 L d: decay build + 3-tensor einsum + PV)
        # + state propagation (~6 d hs)
        per_tok = 7 * chunk * cfg.d_model + 6 * cfg.d_model * hs
        total += cfg.num_layers * tokens * per_tok * mult * (1 - 1 / nchunks)
    return total


def model_flops_for(cfg, named_specs: dict[str, Spec], cell) -> float:
    """GLOBAL analytic model FLOPs of one step of ``cell`` (divide by the
    devices at the call site): 6 N D train, 2 N D prefill, 2 N B
    decode."""
    n_active = active_params(cfg, named_specs)
    if cell.kind == "train":
        return 6.0 * n_active * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n_active * cell.global_batch * cell.seq_len
    # decode: one token per sequence
    return 2.0 * n_active * cell.global_batch
