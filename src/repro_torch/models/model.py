"""Unified model API: ``build(cfg, device=None)`` -> a :class:`Model` with
``init``, ``init_cache`` and ``apply``, dispatching on the architecture
family.

A model is an ``nn.Module``: its parameters live on one device, its layers
in an ``nn.ModuleList``.  ``device=None`` means the card and raises without
one (:func:`repro_torch.device.resolve_device`); the tests pass
``device="cpu"``, which runs the kernels' plain versions; ``device="meta"``
builds a full-size model's shapes without allocating them.  The dense and
MoE families (``transformer``, with GQA or MLA attention) and the RWKV
family (``rwkv``) are ported; the vlm, hybrid and audio families and
embedding inputs raise (ROADMAP Queue 1, items 16.5-16.7).
:func:`num_params` counts any registry architecture from its family's
shape table without building a module.

Two forwards share the weights: :meth:`Model.apply` (no gradients) runs
prefill, decode and a train-mode forward for serving and checks, and
:meth:`Model.forward` is the training forward, with gradients, each layer
rematerialized in the backward pass by default (``remat=True``, the
configured ``remat_policy``), as the JAX package's train forward is.
Every built family trains: dense and MoE layers (the dense prefix too),
GQA and MLA attention, RWKV.

Caches are dictionaries of tensors stacked over layers, the slot (batch)
axis second: ``cache[name][layer, slot]``.  ``apply`` updates the cache it
is given in place and returns it, so a view of some slots
(:meth:`Model.slot_view`) is written through to the pool it views.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.common import (
    checkpoint_body,
    embed,
    rms_norm,
    rms_norm_spec,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (
    Spec,
    add_parameters,
    count_params,
    init_module,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Model(nn.Module):
    """Embedding, a stack of family layers, final norm and LM head.
    Subclasses set ``layer_cls`` (the class of layer ``i``) and
    ``cache_specs``."""

    @staticmethod
    def layer_cls(cfg: ModelConfig, i: int) -> type:
        raise NotImplementedError

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.embeds_input:
            raise NotImplementedError(
                f"{cfg.name}: embedding inputs are not ported yet (ROADMAP "
                "Queue 1, item 16.5)")
        self.cfg = cfg
        # "meta" allocates nothing: parameter and cache shapes only
        self.device = (torch.device("meta") if str(device) == "meta"
                       else resolve_device(device))
        self.dtype = _DTYPES[cfg.dtype]
        add_parameters(self, {
            "embed": Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          fan_in=1),
        }, self.dtype, self.device)
        self.layers = nn.ModuleList(
            self.layer_cls(cfg, i)(cfg, dtype=self.dtype, device=self.device)
            for i in range(cfg.num_layers))
        add_parameters(self, {
            "final_norm": rms_norm_spec(cfg.d_model),
            "lm_head": Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                            fan_in=cfg.d_model),
        }, self.dtype, self.device)

    # ---- params ----
    def init(self, generator: torch.Generator) -> "Model":
        """Initialize every parameter from ``generator``, which must live on
        the model's device; returns the model."""
        init_module(self, generator)
        return self

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # ---- caches ----
    @staticmethod
    def cache_specs(cfg: ModelConfig, batch: int, seq: int) -> dict[str, Spec]:
        raise NotImplementedError

    def init_cache(self, batch: int, seq: int) -> dict[str, torch.Tensor]:
        """Zeroed cache, each tensor (num_layers, batch, ...) on the
        model's device."""
        return {
            name: torch.zeros((self.cfg.num_layers, *s.shape),
                              dtype=s.dtype or self.dtype, device=self.device)
            for name, s in self.cache_specs(self.cfg, batch, seq).items()
        }

    @staticmethod
    def slot_view(cache: dict, slot: int) -> dict[str, torch.Tensor]:
        """The one-slot cache of ``slot``: views into ``cache``."""
        return {name: t[:, slot:slot + 1] for name, t in cache.items()}

    # ---- forward ----
    @torch.no_grad()
    def apply(self, tokens: torch.Tensor, *, mode: str = "train",
              cache: dict | None = None, pos=0):
        """tokens (B, S) integer -> (logits float32, cache), without
        gradients.  Logits are (B, S, V), or (B, 1, V) in prefill:
        next-token logits only.  ``pos`` is an int or a (B,) tensor of
        per-row offsets (decode: the fill levels).  ``cache`` is updated
        in place and returned."""
        return self._run(tokens, mode=mode, cache=cache, pos=pos,
                         remat=False)

    def forward(self, tokens: torch.Tensor, *, remat: bool = True):
        """The training forward: tokens (B, S) -> logits (B, S, V) float32
        with gradients, attention and the RWKV6 recurrence through their
        trainable ops.  ``remat`` checkpoints every layer
        (:func:`repro_torch.models.common.checkpoint_body`)."""
        logits, _ = self._run(tokens, mode="train", cache=None, pos=0,
                              remat=remat)
        return logits

    def _run(self, tokens, *, mode, cache, pos, remat):
        tokens = tokens.to(self.device)
        if isinstance(pos, torch.Tensor):
            pos = pos.to(self.device)
        # the sorted, deterministic gradient only where one is taken;
        # serving (prefill, decode) gathers directly
        x = (embed(self.embed, tokens) if torch.is_grad_enabled()
             else self.embed[tokens])
        positions = _positions(pos, *tokens.shape, self.device)
        for i, layer in enumerate(self.layers):
            cache_l = None if cache is None else {
                name: t[i] for name, t in cache.items()}
            body = checkpoint_body(layer, self.cfg) if remat else layer
            x = body(x, mode=mode, cache=cache_l, pos=pos,
                     positions=positions)
        if mode == "prefill":
            # next-token logits only: a long prompt's full (S, V) float32
            # logits are vocab-head work and traffic nobody reads
            x = x[:, -1:]
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return (x @ self.lm_head).float(), cache


def _positions(pos, b: int, s: int, device) -> torch.Tensor:
    """(B, S) absolute positions from an int or per-row (B,) offsets."""
    steps = torch.arange(s, device=device)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        return pos.to(torch.int64)[:, None] + steps[None, :]
    return (int(pos) + steps)[None, :].expand(b, s)


def build(cfg: ModelConfig, *, device=None) -> Model:
    """The model of ``cfg``'s family, parameters allocated (not yet
    initialized: call ``init``) on ``device`` (default the card)."""
    from repro_torch.models import rwkv, transformer

    families = {"dense": transformer.Transformer,
                "moe": transformer.Transformer, "ssm": rwkv.RWKV}
    if cfg.family not in families:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP Queue 1, "
            "item 16)")
    return families[cfg.family](cfg, device=device)


def param_specs(cfg: ModelConfig) -> dict:
    """The Spec tree of ``cfg``'s family: the reference's shape table."""
    from repro_torch.models import jamba, rwkv, transformer, whisper

    tables = {"dense": transformer, "moe": transformer, "vlm": transformer,
              "ssm": rwkv, "hybrid": jamba, "audio": whisper}
    return tables[cfg.family].param_specs(cfg)


def num_params(cfg: ModelConfig) -> int:
    """Parameters of ``cfg``'s model, counted from its shape table: nothing
    is allocated, and every family counts, built or not."""
    return count_params(param_specs(cfg))
