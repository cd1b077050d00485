"""Entry point of the RWKV6 recurrence: layouts, decays and dispatch by
device.

A CUDA tensor goes to the hand-written kernel (``linrec.py``), a CPU tensor
to the chunked plain version (``ref.py``), and nothing else is taken.
There is no fallback between the two: on a CUDA tensor the kernel launches
or the call raises.  The kernel masks a ragged last chunk itself, so this
entry point pads nothing.

:func:`rwkv6_linear_attention_logw` takes log-decays, as the model computes
them (``logw = -exp(w_raw)``); :func:`rwkv6_linear_attention` keeps the
reference op's signature, decays ``w`` in (0, 1], and takes their log with
the reference's 1e-30 clip.  :func:`rwkv6_step` is the single-token decode
step, plain tensor math that needs no kernel.

:func:`rwkv6_trainable` is the training path's op, a
``torch.autograd.Function``: its forward is
:func:`rwkv6_linear_attention_logw` (the kernel on the card), its backward
autodiff of a recompute of the chunked algebra (``rwkv6_chunked_ref``, the
chunks of the kernel), which is the JAX package's own training backward
(autodiff of its chunked ``_chunked_wkv``).  It gives the gradients of r,
k, v, logw, u and the initial state.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.linrec import linrec as _kernel
from repro_torch.kernels.linrec.ref import rwkv6_chunked_ref

_TIME_DIM = {"bhtd": 2, "bthd": 1}


def rwkv6_linear_attention_logw(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor | None = None,
    *,
    layout: str = "bhtd",
):
    """Returns (y float32 in v's layout, final state (B, H, dk, dv) float32).

    ``layout="bhtd"``: r, k, logw (B, H, T, dk), v (B, H, T, dv);
    ``layout="bthd"``: (B, T, H, .), the model's projections, read in
    place.  ``logw <= 0``; ``state`` defaults to zeros."""
    if layout not in _TIME_DIM:
        raise ValueError(f"layout must be one of {sorted(_TIME_DIM)}")
    time_dim = _TIME_DIM[layout]
    b, h, dk, dv = r.shape[0], r.shape[3 - time_dim], r.shape[3], v.shape[3]
    devices = {x.device for x in (r, k, v, logw, u)}
    if state is not None:
        devices.add(state.device)
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    if state is None:
        state = torch.zeros(b, h, dk, dv, device=r.device)
    if r.device.type == "cuda":
        return _kernel.rwkv6_cuda(
            r.float(), k.float(), v.float(), logw.float(),
            u.float().contiguous(), state.float().contiguous(),
            time_dim=time_dim)
    if r.device.type != "cpu":
        raise ValueError(f"no RWKV6 recurrence for device {r.device}")
    if time_dim == 1:
        y, s = rwkv6_chunked_ref(
            *(x.transpose(1, 2) for x in (r, k, v, logw)), u, state,
            chunk=_kernel.CHUNK)
        return y.transpose(1, 2).contiguous(), s
    return rwkv6_chunked_ref(r, k, v, logw, u, state, chunk=_kernel.CHUNK)


def rwkv6_linear_attention(r, k, v, w, u, state=None):
    """The reference op's signature: decays ``w`` (B, H, T, dk) in (0, 1],
    (B, H, T, .) layout.  Returns (y (B, H, T, dv), final state), float32."""
    logw = torch.log(w.float().clamp(1e-30, 1.0))
    return rwkv6_linear_attention_logw(r, k, v, logw, u, state)


def rwkv6_step(r, k, v, w, u, state):
    """One decode step: r, k, w (B, H, dk), v (B, H, dv), u (H, dk), state
    (B, H, dk, dv) -> (y (B, H, dv), new state), float32."""
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))
    kv = k[..., :, None] * v[..., None, :]
    att = state + u[None, :, :, None] * kv
    y = torch.einsum("bhk,bhkv->bhv", r, att)
    return y, w[..., :, None] * state + kv



class _RWKV6Trainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, logw, u, state, layout):
        ctx.save_for_backward(r, k, v, logw, u, state)
        ctx.layout = layout
        ctx.set_materialize_grads(False)
        return rwkv6_linear_attention_logw(r, k, v, logw, u, state,
                                           layout=layout)

    @staticmethod
    def backward(ctx, gy, gs):
        saved = ctx.saved_tensors
        if gy is None and gs is None:
            return (None,) * 7
        with torch.enable_grad():
            ins = [None if x is None else x.detach().float().requires_grad_()
                   for x in saved]
            r, k, v, logw, u, state = ins
            if ctx.layout == "bthd":
                r, k, v, logw = (x.transpose(1, 2) for x in (r, k, v, logw))
                if gy is not None:
                    gy = gy.transpose(1, 2)
            y, s = rwkv6_chunked_ref(r, k, v, logw, u, state,
                                     chunk=_kernel.CHUNK)
            outs = [(o, g) for o, g in ((y, gy), (s, gs)) if g is not None]
            leaves = [x for x in ins if x is not None]
            grads = iter(torch.autograd.grad(
                [o for o, _ in outs], leaves, [g for _, g in outs],
                allow_unused=True))
        out = []
        for x, orig in zip(ins, saved):
            if x is None:
                out.append(None)
                continue
            gx = next(grads)
            out.append(None if gx is None else gx.to(orig.dtype))
        return (*out, None)


def rwkv6_trainable(r, k, v, logw, u, state=None, *, layout: str = "bhtd"):
    """:func:`rwkv6_linear_attention_logw` with a backward: returns (y,
    final state) as it does, and gives gradients to r, k, v, logw, u and
    ``state`` (when given).  The forward launches the kernel on a CUDA
    tensor and runs the chunked plain version on a CPU tensor; the
    backward recomputes the chunked algebra under autograd on either.
    Under ``torch.utils.checkpoint`` the forward runs again in the
    backward pass, so a remat'ed layer launches the kernel twice per
    step."""
    if layout not in _TIME_DIM:
        raise ValueError(f"layout must be one of {sorted(_TIME_DIM)}")
    return _RWKV6Trainable.apply(r, k, v, logw, u, state, layout)
