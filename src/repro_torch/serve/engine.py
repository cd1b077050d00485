"""Serving engine: continuous batching over a fixed slot pool.

One engine holds a model and a slotted cache on the model's device.
Requests are admitted into free slots (each prefilled alone, into its
slot), every engine tick decodes ALL slots in one batched step with per-
slot positions, and finished sequences free their slots.

The pool cache is one set of tensors whose slot axis is known (axis 1,
after the layer axis), so a prefill writes through a one-slot view
straight into its slot (:meth:`Model.slot_view`): the reference's
prefill-then-merge, without the copy.  Slots the prefill does not write
keep what they held; the fill levels mask stale cache entries, and the
RWKV and Mamba states and whisper's cross-attention k/v are overwritten
whole.  The host keeps each slot's fill level; a tick copies the sampled
tokens back, which is its one sync.

As the JAX engine, it feeds the model tokens only: a model whose
``prefill_inputs`` are not tokens alone (qwen2-vl's ``embeds``,
whisper's ``enc_frames``) is refused with a ``ValueError`` at
construction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.model import Model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model: Model, *, num_slots: int, cache_len: int):
        if model.prefill_inputs != ("tokens",):
            raise ValueError(
                f"{model.cfg.name} prefills on "
                f"{', '.join(model.prefill_inputs)}, and the engine feeds "
                "tokens only (as the reference's does)")
        self.model = model
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.cache = model.init_cache(num_slots, cache_len)
        self.slot_req: list[Request | None] = [None] * num_slots
        self.slot_pos = np.zeros(num_slots, np.int32)
        self.slot_limit = np.zeros(num_slots, np.int32)

    # ------------------------------------------------------------ admission
    def try_admit(self, req: Request) -> bool:
        """Prefill ``req`` into the first free slot and take its first
        token; False when every slot is busy."""
        for slot, occupant in enumerate(self.slot_req):
            if occupant is None:
                tokens = torch.as_tensor(
                    np.asarray(req.prompt, np.int64)[None, :],
                    device=self.model.device)
                logits, _ = self.model.apply(
                    tokens, mode="prefill",
                    cache=self.model.slot_view(self.cache, slot), pos=0)
                req.generated.append(int(logits[0, -1].argmax()))
                self.slot_req[slot] = req
                self.slot_pos[slot] = len(req.prompt)
                self.slot_limit[slot] = len(req.prompt) + req.max_new_tokens
                return True
        return False

    @property
    def active_slots(self) -> int:
        return sum(r is not None for r in self.slot_req)

    # ----------------------------------------------------------------- tick
    def tick(self) -> None:
        """One decode step for every slot (idle slots decode a dummy token
        at their old position, as in the reference)."""
        if self.active_slots == 0:
            return
        tokens = np.zeros((self.num_slots, 1), np.int64)
        for slot, req in enumerate(self.slot_req):
            if req is not None:
                tokens[slot, 0] = req.generated[-1]
        dev = self.model.device
        logits, _ = self.model.apply(
            torch.as_tensor(tokens, device=dev), mode="decode",
            cache=self.cache, pos=torch.as_tensor(self.slot_pos, device=dev))
        nxt = logits[:, 0].argmax(-1).cpu().numpy()
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            req.generated.append(int(nxt[slot]))
            self.slot_pos[slot] += 1
            if self.slot_pos[slot] >= self.slot_limit[slot]:
                req.done = True
                self.slot_req[slot] = None
