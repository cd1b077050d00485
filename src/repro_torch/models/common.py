"""Shared layer primitives: RMSNorm and RoPE (standard, partial and
qwen2-vl's M-RoPE), the token embedding with a deterministic gradient, and
the per-layer rematerialization of the train forward.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Spec


def rms_norm_spec(d: int) -> Spec:
    return Spec((d,), ("embed",), init="ones", dtype=torch.float32)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    """(dim/2,) inverse frequencies."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Standard rotary embedding on the last dim (rotated halves).
    x (B, S, H, D_rot), positions (B, S) integer."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                     # (d/2,)
    ang = positions[..., None].float() * inv                 # (B, S, d/2)
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: the head dim's rotated halves are split
    into (temporal, height, width) sections, each rotated by its own
    position stream.  x (B, S, H, D_rot), positions (3, B, S) integer,
    ``sections`` half-dims summing to D_rot / 2.  Three equal streams give
    the standard rotary embedding, bit for bit."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to half "
                         f"the rotary dim {d}")
    if len(sections) != positions.shape[0]:
        raise ValueError(f"{len(sections)} sections, {positions.shape[0]} "
                         "position streams")
    inv = rope_freqs(d, theta, x.device)                     # (d/2,)
    pos_full = torch.cat(
        [stream[..., None].float().expand(*stream.shape, sec)
         for sec, stream in zip(sections, positions)], -1)   # (B, S, d/2)
    ang = pos_full * inv
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def rope_for(cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of the configured kind; the caller slices the
    rotary part of a partial-rotary head.  With M-RoPE, (B, S) positions
    (the model's, text only) are repeated as all three streams; (3, B, S)
    are taken as they are."""
    if cfg.mrope_sections is not None:
        if positions.dim() == 2:
            positions = positions[None].expand(3, *positions.shape)
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


class _EmbedLookup(torch.autograd.Function):
    """``table[tokens]`` whose backward sums the rows of each token in a
    fixed order: tokens sorted (stably), each run of equal tokens summed
    by ``segment_reduce`` in float32, one write per distinct token.  The
    gather's own backward accumulates with atomics on CUDA, so two runs
    of one step could differ in the last bits."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.rows = table.shape[0]
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        with torch.profiler.record_function("embed_backward"):
            flat = tokens.reshape(-1)
            g = g.reshape(flat.numel(), g.shape[-1])
            toks, order = torch.sort(flat, stable=True)
            uniq, counts = torch.unique_consecutive(toks, return_counts=True)
            sums = torch.segment_reduce(g[order].float(), "sum",
                                        lengths=counts)
            grad = g.new_zeros((ctx.rows, g.shape[-1]))
            grad[uniq.long()] = sums.to(g.dtype)
        return grad, None


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` (V, d) at integer ``tokens`` (B, S) -> (B, S, d),
    with a deterministic gradient (:class:`_EmbedLookup`)."""
    return _EmbedLookup.apply(table, tokens)


# matmul outputs: what the reference's "dots" policy (dots_saveable) keeps
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def checkpoint_body(body, cfg: ModelConfig):
    """``body`` under ``torch.utils.checkpoint`` (non-reentrant) with the
    configured policy: ``"full"`` saves only the body's inputs and
    recomputes the rest in the backward pass (least memory); ``"dots"``
    also keeps every matmul output, so the backward recomputes no matmul.
    Hand kernels (flash attention, RWKV6) run again under either policy.
    No layer draws random numbers, so the RNG state is not stashed."""
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")

    def run(*args, **kwargs):
        return checkpoint(body, *args, **kw, **kwargs)

    return run
