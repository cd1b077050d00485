"""Unified model API: ``build(cfg, device=None)`` -> a :class:`Model` with
``init``, ``init_cache`` and ``apply``, dispatching on the architecture
family.

A model is an ``nn.Module``: its parameters live on one device, its layers
in an ``nn.ModuleList``.  ``device=None`` means the card and raises without
one (:func:`repro_torch.device.resolve_device`); the tests pass
``device="cpu"``, which runs the kernels' plain versions; ``device="meta"``
builds a full-size model's shapes without allocating them.  Every family
of the registry builds: dense and MoE (``transformer``, with GQA or MLA
attention), the vlm backbone (``transformer`` on embedding inputs, with
M-RoPE), RWKV (``rwkv``), the audio encoder-decoder (``whisper``) and the
hybrid (``jamba``, Mamba and attention layers).  :func:`num_params` counts
any registry architecture from its family's shape table without building a
module.

Inputs: ``tokens`` (B, S) integer, or for a config with ``embeds_input``
(qwen2-vl) ``embeds`` (B, S, d) in their place; the audio family takes
``enc_frames`` (B, encoder_seq, d) beside its decoder tokens in train and
prefill mode.

Two forwards share the weights: :meth:`Model.apply` (no gradients) runs
prefill, decode and a train-mode forward for serving and checks, and
:meth:`Model.forward` is the training forward, with gradients, each layer
rematerialized in the backward pass by default (``remat=True``, the
configured ``remat_policy``), as the JAX package's train forward is.
Every family trains: dense and MoE (the dense prefix too, GQA and MLA
attention), RWKV, the vlm backbone on ``embeds``, the audio
encoder-decoder (non-causal attention through the trainable flash op)
and the hybrid (Mamba through the scan's trainable op).

Caches are dictionaries of tensors stacked over layers, the slot (batch)
axis second: ``cache[name][layer, slot]``.  A family whose layers hold
caches of several kinds stacks each kind over its own layers
(:meth:`Model.cache_groups`, :meth:`Model.layer_cache`: jamba's k/v over
its attention layers, conv tail and state over its Mamba layers).
``apply`` updates the cache it is given in place and returns it, so a view
of some slots (:meth:`Model.slot_view`) is written through to the pool it
views.
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
    """Embedding (unless the config takes embeddings), a stack of family
    layers, final norm and LM head.  Subclasses set ``layer_cls`` (the
    class of layer ``i``) and ``cache_specs``, or override
    :meth:`add_body`, :meth:`body_layers`, :meth:`_prelude` (what comes
    before the layers) and the cache hooks."""

    @staticmethod
    def layer_cls(cfg: ModelConfig, i: int) -> type:
        raise NotImplementedError

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        # "meta" allocates nothing: parameter and cache shapes only
        self.device = (torch.device("meta") if str(device) == "meta"
                       else resolve_device(device))
        self.dtype = _DTYPES[cfg.dtype]
        if not cfg.embeds_input:
            add_parameters(self, {
                "embed": Spec((cfg.vocab_size, cfg.d_model),
                              ("vocab", "embed"), fan_in=1),
            }, self.dtype, self.device)
        self.add_body(cfg)
        add_parameters(self, {
            "final_norm": rms_norm_spec(cfg.d_model),
            "lm_head": Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                            fan_in=cfg.d_model),
        }, self.dtype, self.device)

    def add_body(self, cfg: ModelConfig) -> None:
        """Register what lies between the embedding and the final norm:
        here ``layers``, one ``layer_cls(cfg, i)`` per layer."""
        self.layers = nn.ModuleList(
            self.layer_cls(cfg, i)(cfg, dtype=self.dtype, device=self.device)
            for i in range(cfg.num_layers))

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

    def cache_groups(self, batch: int,
                     seq: int) -> list[tuple[int, dict[str, Spec]]]:
        """The cache by kind: (layers stacked, one layer's specs) each;
        here one kind over every layer."""
        return [(self.cfg.num_layers, self.cache_specs(self.cfg, batch, seq))]

    def init_cache(self, batch: int, seq: int) -> dict[str, torch.Tensor]:
        """Zeroed cache, each tensor (layers of its kind, batch, ...) on
        the model's device."""
        return {
            name: torch.zeros((layers, *s.shape), dtype=s.dtype or self.dtype,
                              device=self.device)
            for layers, specs in self.cache_groups(batch, seq)
            for name, s in specs.items()
        }

    def layer_cache(self, cache: dict, i: int) -> dict[str, torch.Tensor]:
        """Layer ``i``'s cache: views into ``cache``."""
        return {name: t[i] for name, t in cache.items()}

    @staticmethod
    def slot_view(cache: dict, slot: int) -> dict[str, torch.Tensor]:
        """The one-slot cache of ``slot``: views into ``cache``."""
        return {name: t[:, slot:slot + 1] for name, t in cache.items()}

    # ---- forward ----
    @torch.no_grad()
    def apply(self, tokens: torch.Tensor | None = None, *,
              embeds: torch.Tensor | None = None,
              enc_frames: torch.Tensor | None = None, mode: str = "train",
              cache: dict | None = None, pos=0):
        """tokens (B, S) integer, or ``embeds`` (B, S, d) for a config with
        ``embeds_input`` (cast to the model's dtype), and for the audio
        family ``enc_frames`` (B, encoder_seq, d) in train and prefill ->
        (logits float32, cache), without gradients.  Logits are (B, S, V),
        or (B, 1, V) in prefill: next-token logits only.  ``pos`` is an int
        or a (B,) tensor of per-row offsets (decode: the fill levels).
        ``cache`` is updated in place and returned."""
        return self._run(tokens, embeds=embeds, enc_frames=enc_frames,
                         mode=mode, cache=cache, pos=pos, remat=False)

    def forward(self, tokens: torch.Tensor | None = None, *,
                embeds: torch.Tensor | None = None,
                enc_frames: torch.Tensor | None = None, remat: bool = True):
        """The training forward: the inputs of :meth:`apply` in train mode
        (tokens (B, S), or ``embeds`` for a config with ``embeds_input``;
        ``enc_frames`` for the audio family) -> logits (B, S, V) float32
        with gradients, attention, the RWKV6 recurrence and the Mamba scan
        through their trainable ops, and the same ``ValueError`` for an
        input that does not belong.  ``remat`` checkpoints every layer
        (:func:`repro_torch.models.common.checkpoint_body`), the audio
        family's encoder layers too."""
        logits, _ = self._run(tokens, embeds=embeds, enc_frames=enc_frames,
                              mode="train", cache=None, pos=0, remat=remat)
        return logits

    def _inputs(self, tokens, embeds) -> torch.Tensor:
        """The first layer's input (B, S, d): the embedding rows of
        ``tokens``, or ``embeds`` for a config that takes embeddings."""
        cfg = self.cfg
        if cfg.embeds_input:
            if embeds is None or tokens is not None:
                raise ValueError(f"{cfg.name} takes embeds (B, S, d), not "
                                 "tokens")
            return embeds.to(device=self.device, dtype=self.dtype)
        if tokens is None or embeds is not None:
            raise ValueError(f"{cfg.name} takes tokens (B, S), not embeds")
        tokens = tokens.to(self.device)
        # the sorted, deterministic gradient only where one is taken;
        # serving (prefill, decode) gathers directly
        return (embed(self.embed, tokens) if torch.is_grad_enabled()
                else self.embed[tokens])

    @property
    def prefill_inputs(self) -> tuple[str, ...]:
        """The inputs a prefill takes: ``embeds`` for a config with
        ``embeds_input``, else ``tokens``."""
        return ("embeds",) if self.cfg.embeds_input else ("tokens",)

    def body_layers(self) -> nn.ModuleList:
        """The layers :meth:`_run` walks, each with its cache slice
        ``layer_cache(cache, i)``."""
        return self.layers

    def _prelude(self, x, pos, mode: str, enc_frames, remat: bool = False):
        """Before the layers: (x, the layers' (B, S) positions, extra
        keywords for every layer).  Here the positions from ``pos``, and
        no ``enc_frames``; ``remat`` is the train forward's."""
        if enc_frames is not None:
            raise ValueError(f"{self.cfg.name} takes no enc_frames")
        return x, _positions(pos, *x.shape[:2], self.device), {}

    def _run(self, tokens, *, embeds=None, enc_frames=None, mode, cache,
             pos, remat):
        if isinstance(pos, torch.Tensor):
            pos = pos.to(self.device)
        x = self._inputs(tokens, embeds)
        x, positions, extra = self._prelude(x, pos, mode, enc_frames,
                                            remat)
        for i, layer in enumerate(self.body_layers()):
            cache_l = None if cache is None else self.layer_cache(cache, i)
            body = checkpoint_body(layer, self.cfg) if remat else layer
            x = body(x, mode=mode, cache=cache_l, pos=pos,
                     positions=positions, **extra)
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
    from repro_torch.models import jamba, rwkv, transformer, whisper

    families = {"dense": transformer.Transformer,
                "moe": transformer.Transformer,
                "vlm": transformer.Transformer, "ssm": rwkv.RWKV,
                "hybrid": jamba.Jamba, "audio": whisper.Whisper}
    return families[cfg.family](cfg, device=device)


def stacked_leaf(cfg: ModelConfig, name: str) -> str:
    """The reference's parameter leaf that holds the port's parameter
    ``name``: the port keeps one tensor per layer where the reference
    stacks layers on a leading axis (the inverse of
    :func:`repro_torch.convert.model_params_from_reference`).  Layer
    ``i``'s ``layers.<i>.<rest>`` is ``layers.<rest>`` (``prefix.<i>.<rest>``
    for the transformers' ``first_dense_layers``), jamba's is
    ``blocks.l<i mod 8>.<rest>``, whisper's ``enc_layers.<rest>`` /
    ``dec_layers.<rest>``; a parameter outside the layers is its own
    leaf."""
    head, _, tail = name.partition(".")
    index, _, rest = tail.partition(".")
    if head not in ("layers", "enc_layers", "dec_layers") or not (
            index.isdigit() and rest):
        return name
    i = int(index)
    if cfg.family == "hybrid":
        from repro_torch.models.jamba import PERIOD
        return f"blocks.l{i % PERIOD}.{rest}"
    if head == "layers" and i < cfg.first_dense_layers:
        return f"prefix.{i}.{rest}"
    return f"{head}.{rest}"


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
