"""Train and serve step builders: loss, gradients, update.

The port of ``repro.train.step``.  A model holds its own parameters (an
``nn.Module``), so the steps work on them in place: ``params`` is the
model's named-parameter dict (:func:`init_train_state` returns it), and a
train step computes the gradients of the model's loss with
``torch.autograd.grad`` and writes the AdamW update into those same
tensors.  The signatures keep the reference's argument order with the
parameters dropped where the model already holds them (the loss, the
serve and the prefill steps).

:func:`build_compressed_train_step` is the compressed-DP step: each rank
of a ``"pod"`` mesh takes the gradients of its shard of the batch and
averages them with the EF-int8 all-reduce of
:mod:`repro_torch.train.compression`.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state


def cross_entropy(
    logits: torch.Tensor,   # (B, S, V) float32
    labels: torch.Tensor,   # (B, S) integer
    *,
    z_loss: float = 1e-4,
) -> torch.Tensor:
    """Mean token cross-entropy plus ``z_loss`` times the mean squared
    log-partition (a 0-dim tensor)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    ce = (lse - gold).mean()
    if z_loss:
        ce = ce + z_loss * lse.square().mean()
    return ce


def to_device(batch: Mapping, device) -> dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def build_loss_fn(model: Model) -> Callable:
    """batch -> the loss of the model's parameters, with gradients (the
    train forward, every layer rematerialized).  Every input but
    ``labels`` goes to the model, as the reference passes them:
    {"tokens", "labels"}, {"embeds", "labels"} (vlm) or {"tokens",
    "enc_frames", "labels"} (audio)."""
    def loss_fn(batch: Mapping) -> torch.Tensor:
        batch = to_device(batch, model.device)
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        return cross_entropy(model(**inputs), batch["labels"])

    return loss_fn


def _leaves(model: Model, params: Mapping[str, torch.Tensor]):
    """The model's parameters in order, checked to be ``params``'s."""
    named = list(model.named_parameters())
    if len(named) != len(params) or any(
            params.get(n) is not p for n, p in named):
        raise ValueError("params must be the model's own named parameters "
                         "(init_train_state returns them)")
    return named


def build_train_step(model: Model,
                     opt_cfg: AdamWConfig = AdamWConfig()) -> Callable:
    """(params, opt_state, batch) -> (loss, params, opt_state): one AdamW
    step on the model's parameters, in place."""
    loss_fn = build_loss_fn(model)

    def train_step(params, opt_state, batch):
        named = _leaves(model, params)
        loss = loss_fn(batch)
        grads = torch.autograd.grad(loss, [p for _, p in named])
        params, opt_state = adamw_update(
            {n: g for (n, _), g in zip(named, grads)}, opt_state, opt_cfg,
            params)
        return loss.detach(), params, opt_state

    return train_step


def build_grad_accum_train_step(
    model: Model,
    opt_cfg: AdamWConfig = AdamWConfig(),
    num_microbatches: int = 4,
) -> Callable:
    """Gradient accumulation over the leading batch dim, python-unrolled:
    each microbatch's gradients are taken and freed before the next, summed
    in the parameters' dtype, and scaled by 1 / num_microbatches, as the
    reference sums them."""
    loss_fn = build_loss_fn(model)

    def train_step(params, opt_state, batch):
        named = _leaves(model, params)
        leaves = [p for _, p in named]
        size = next(iter(batch.values())).shape[0] // num_microbatches
        loss, grads = None, None
        for i in range(num_microbatches):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            li = loss_fn(mb)
            gi = torch.autograd.grad(li, leaves)
            li = li.detach()
            if grads is None:
                loss, grads = li, list(gi)
            else:
                loss = loss + li
                grads = [a + b for a, b in zip(grads, gi)]
        inv = 1.0 / num_microbatches
        loss = loss * inv
        grads = {n: g * inv for (n, _), g in zip(named, grads)}
        params, opt_state = adamw_update(grads, opt_state, opt_cfg, params)
        return loss, params, opt_state

    return train_step


def build_compressed_train_step(
    model: Model,
    mesh,
    opt_cfg: AdamWConfig = AdamWConfig(),
) -> Callable:
    """(params, opt_state, err_state, batch) -> (loss, params, opt_state,
    err_state): pod-local gradients, EF-int8 compressed all-reduce over
    the mesh's ``"pod"`` axis, then one AdamW step in place.

    ``batch`` is the global batch; the rank of the ``"pod"`` group takes
    its contiguous shard of the leading dim (the reference's batch spec
    over "pod"), computes the loss and gradients on it, syncs the
    gradients (:func:`~repro_torch.train.compression.compressed_pod_sync`)
    and averages the loss over the group (the reference's ``pmean``).
    ``err_state`` carries the error feedback
    (:func:`~repro_torch.train.compression.init_error_state`).  Each
    layer's parameter shares its quantization scale with the same
    parameter of the layers the reference stacks with it
    (:func:`~repro_torch.models.model.stacked_leaf`).  A mesh
    without a ``"pod"`` axis is the plain step with the error state passed
    through."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.models.model import stacked_leaf
    from repro_torch.train.compression import compressed_pod_sync, pod_group

    loss_fn = build_loss_fn(model)
    pods = "pod" in mesh_axes(mesh)
    scale_groups = {n: stacked_leaf(model.cfg, n)
                    for n, _ in model.named_parameters()}

    def local_shard(batch):
        if not pods:
            return batch
        group = pod_group(mesh)
        n, r = dist.get_world_size(group), dist.get_rank(group)
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{n} pods")
        size = rows // n
        return {k: v[r * size:(r + 1) * size] for k, v in batch.items()}

    def train_step(params, opt_state, err_state, batch):
        named = _leaves(model, params)
        loss = loss_fn(local_shard(batch))
        grads = torch.autograd.grad(loss, [p for _, p in named])
        grads, err_state = compressed_pod_sync(
            {n: g for (n, _), g in zip(named, grads)}, err_state, mesh,
            scale_groups)
        loss = loss.detach()
        if pods:
            group = pod_group(mesh)
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
            loss = loss / dist.get_world_size(group)
        params, opt_state = adamw_update(grads, opt_state, opt_cfg, params)
        return loss, params, opt_state, err_state

    return train_step


def build_serve_step(model: Model) -> Callable:
    """(cache, batch, pos) -> (logits, cache): one decode step against a
    cache at fill level ``pos``, the cache updated in place."""

    def serve_step(cache, batch, pos):
        return model.apply(**batch, mode="decode", cache=cache, pos=pos)

    return serve_step


def build_prefill_step(model: Model, cache_len: int) -> Callable:
    """batch -> (logits (B, 1, V), cache): the prompt's prefill into a new
    zeroed cache of ``cache_len``."""

    def prefill_step(batch):
        b = next(iter(batch.values())).shape[0]
        cache = model.init_cache(b, cache_len)
        return model.apply(**batch, mode="prefill", cache=cache, pos=0)

    return prefill_step


def init_train_state(model: Model, generator: torch.Generator):
    """Initialize the model's parameters from ``generator`` (on the
    model's device); returns (params, opt_state), params the model's
    named-parameter dict."""
    model.init(generator)
    params = dict(model.named_parameters())
    return params, init_opt_state(params)
