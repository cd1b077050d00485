"""Build, binding and launch of the CUDA selective-scan kernels: the
forward and its backward.

The kernels (``csrc/mamba_scan.cu``) take the place of the
``jax.lax.associative_scan`` in ``repro/models/mamba.py::_ssm_scan`` (the
scan at line 94) and of its autodiff; neither is a Pallas kernel.  Both
cut the sequence into chunks of ``ref.CHUNK`` steps, run every chunk in
parallel from a zero state (the backward: a zero adjoint), combine the
chunks serially per (batch, channel, state) with each chunk's decay, and
run every chunk again from its true start; the source's header says why
and what bounds them.  The forward's chunk-start states (B, C, D, N) are
what the backward reads (the third value :func:`mamba_scan_cuda`
returns).  The backward's gradient kernel reruns each chunk in 8-step
sub-chunks kept in registers, two exponentials a (step, channel, state),
and sums two steps at a time through reduce-scatter shuffles.  Its sums
over channels (dB, dC, one partial per ``CHANNELS_PER_BLOCK`` channels)
and over batch and time (da) come out of the kernels as partials, summed
here by torch in a fixed order: no float atomics, a rerun is bit for
bit.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``, at the first launch,
never at import (:mod:`repro_torch.kernels.build`).

:func:`mamba_scan_cuda` and :func:`mamba_scan_bwd_cuda` take CUDA tensors
only and raise on anything else; :mod:`ops` decides between them and the
plain versions by the device of the tensors.  ``LAUNCHES`` counts the
forward calls, ``BWD_LAUNCHES`` the backward calls (each call launches
three kernels and counts once).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.mamba_scan.ref import CHUNK

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
#: State sizes the kernel is built for: jamba's 16 and the reduced
#: configs' 8 (a new config's size gets its instance in ``mamba_scan.cu``).
STATE_SIZES = (8, 16)
_INT_MAX = 2**31 - 1

#: Forward calls made by :func:`mamba_scan_cuda` in this process.
LAUNCHES = 0
#: Backward calls made by :func:`mamba_scan_bwd_cuda` in this process.
BWD_LAUNCHES = 0
#: Channels per block of the backward's gradient kernel (``kCpb`` in the
#: source): its dB and dC partials come one per block of channels.
CHANNELS_PER_BLOCK = 128

_SIGNATURES = {
    "mamba_scan_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # delta, x, a
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # bm, cm, h0
        ctypes.c_void_p, ctypes.c_void_p,                   # y, h_out
        ctypes.c_void_p, ctypes.c_void_p,                   # states, dsum
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # B, S, D
        ctypes.c_int,                                       # N
        ctypes.c_void_p,                                    # stream
    ],
    "mamba_scan_bwd_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # delta, x, a
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # bm, cm, dy
        ctypes.c_void_p, ctypes.c_void_p,                   # states, dh_final
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ddelta, dx, dh0
        ctypes.c_void_p, ctypes.c_void_p,                   # gbuf, dsum
        ctypes.c_void_p, ctypes.c_void_p,                   # dbm, dcm partials
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # B, S, D
        ctypes.c_int,                                       # N
        ctypes.c_void_p,                                    # stream
    ],
}


def build() -> Path:
    """Compile the kernel if its library is not built yet; returns the
    library's path (its ``nvcc`` output beside it as ``<library>.log``)."""
    return _build.build(SOURCE)[0]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; declares the C signature."""
    return _build.load(SOURCE, _SIGNATURES)


def _check(name: str, x, device, shape) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(
            f"{name} is on {x.device}; the CUDA kernel takes CUDA tensors "
            "(ops.mamba_scan runs CPU tensors through the plain version)")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, delta is on {device}")


def _check_inputs(delta, x, a, bm, cm, **more):
    """Check the scan's inputs and ``more`` of them by name (``h0``,
    ``dy``, ``states``, ``dh_final``); returns (B, S, D, N)."""
    if not isinstance(delta, torch.Tensor) or delta.dim() != 3:
        raise ValueError("delta must be a (B, S, D) tensor")
    if not isinstance(a, torch.Tensor) or a.dim() != 2:
        raise ValueError("a must be a (D, N) tensor")
    b, s, d = delta.shape
    n = a.shape[1]
    shapes = {"delta": (b, s, d), "x": (b, s, d), "a": (d, n),
              "bm": (b, s, n), "cm": (b, s, n), "h0": (b, d, n),
              "dy": (b, s, d), "states": (b, -(-s // CHUNK), d, n),
              "dh_final": (b, d, n)}
    for name, t in dict(delta=delta, x=x, a=a, bm=bm, cm=cm, **more).items():
        _check(name, t, delta.device, shapes[name])
    if n not in STATE_SIZES:
        raise ValueError(f"the kernel takes state sizes {STATE_SIZES}, "
                         f"got {n}")
    if b * s * d > _INT_MAX or b * d * n > _INT_MAX:
        raise ValueError(f"scan of B={b}, S={s}, D={d}, N={n} exceeds the "
                         "kernel's index range")
    if b > 65535 or -(-s // CHUNK) > 65535:
        raise ValueError(f"scan of B={b}, S={s} exceeds the kernel's grid")
    return b, s, d, n


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def mamba_scan_cuda(
    delta: torch.Tensor,
    x: torch.Tensor,
    a: torch.Tensor,
    bm: torch.Tensor,
    cm: torch.Tensor,
    h0: torch.Tensor,
):
    """Launch the forward: delta, x (B, S, D); a (D, N); bm, cm (B, S, N);
    h0 (B, D, N), contiguous float32 on one CUDA device, N in
    ``STATE_SIZES`` -> (y (B, S, D), final h (B, D, N), the chunk-start
    states (B, ceil(S / CHUNK), D, N) that :func:`mamba_scan_bwd_cuda`
    reads) float32; enqueued on the current stream without
    synchronizing."""
    global LAUNCHES
    b, s, d, n = _check_inputs(delta, x, a, bm, cm, h0=h0)
    chunks = -(-s // CHUNK)
    y = torch.empty_like(delta)
    h_out = torch.empty_like(h0)
    states = torch.empty((b, chunks, d, n), dtype=torch.float32,
                         device=delta.device)
    out = (y, h_out, states)
    if b * d == 0:
        return out
    if s == 0:
        h_out.copy_(h0)
        return out
    dsum = torch.empty((b, chunks, d), dtype=torch.float32,
                       device=delta.device)
    lib = load()
    # Inputs, outputs and scratch live in PyTorch's caching allocator,
    # which reuses a freed block only for work queued later on the same
    # stream, so launching on the current stream keeps every buffer valid
    # until the kernels have run.
    with torch.cuda.device(delta.device):
        err = lib.mamba_scan_launch(
            delta.data_ptr(), x.data_ptr(), a.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
            states.data_ptr(), dsum.data_ptr(), b, s, d, n,
            _stream(delta.device))
    if err != 0:
        raise RuntimeError(
            f"mamba_scan kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out


def mamba_scan_bwd_cuda(
    delta: torch.Tensor,
    x: torch.Tensor,
    a: torch.Tensor,
    bm: torch.Tensor,
    cm: torch.Tensor,
    dy: torch.Tensor,
    states: torch.Tensor,
    dh_final: torch.Tensor | None = None,
):
    """Launch the backward: the forward's inputs (but h0), the output
    gradient ``dy`` (B, S, D), the forward's chunk-start ``states`` and
    the final state's gradient ``dh_final`` (B, D, N) or None ->
    (ddelta, dx (B, S, D), da (D, N), dbm, dcm (B, S, N), dh0 (B, D, N)),
    float32, enqueued on the current stream; the partial sums over
    channel blocks and over (batch, chunk) are summed by torch."""
    global BWD_LAUNCHES
    more = dict(dy=dy, states=states)
    if dh_final is not None:
        more["dh_final"] = dh_final
    b, s, d, n = _check_inputs(delta, x, a, bm, cm, **more)
    chunks = -(-s // CHUNK)
    blocks = -(-d // CHANNELS_PER_BLOCK)
    dev = delta.device
    ddelta, dx = torch.empty_like(delta), torch.empty_like(x)
    dh0 = torch.empty((b, d, n), dtype=torch.float32, device=dev)
    if b * d == 0 or s == 0:
        if dh_final is None:
            dh0.zero_()
        else:
            dh0.copy_(dh_final)
        return (ddelta.zero_(), dx.zero_(), torch.zeros_like(a),
                torch.zeros_like(bm), torch.zeros_like(cm), dh0)
    gbuf = torch.empty((b, chunks, d, n), dtype=torch.float32, device=dev)
    dsum = torch.empty((b, chunks, d), dtype=torch.float32, device=dev)
    dbm_part = torch.empty((b, blocks, s, n), dtype=torch.float32,
                           device=dev)
    dcm_part = torch.empty_like(dbm_part)
    lib = load()
    with torch.cuda.device(dev):
        err = lib.mamba_scan_bwd_launch(
            delta.data_ptr(), x.data_ptr(), a.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), dy.data_ptr(), states.data_ptr(),
            None if dh_final is None else dh_final.data_ptr(),
            ddelta.data_ptr(), dx.data_ptr(), dh0.data_ptr(),
            gbuf.data_ptr(), dsum.data_ptr(), dbm_part.data_ptr(),
            dcm_part.data_ptr(), b, s, d, n, _stream(dev))
    if err != 0:
        raise RuntimeError(
            f"mamba_scan backward launch failed with CUDA error {err}")
    BWD_LAUNCHES += 1
    # fixed-order sums of the kernels' partials (no atomics anywhere)
    return (ddelta, dx, gbuf.sum((0, 1)), dbm_part.sum(1), dcm_part.sum(1),
            dh0)
