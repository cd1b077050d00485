"""How far two float32 ways of taking the RWKV6 chunk decays sit from the
step-by-step recurrence, on the CPU, at the model's decay range.

    PYTHONPATH=src python tools/rwkv6_decay_precision.py [--seeds N] [--t T]

Both ways compute the chunked form (chunks of 32) from log-decays
logw = -exp(U(lo, hi)); the model clamps its raw decay to [-20, 10], so
logw reaches -e^10.  ``prefix_difference`` takes each decay as exp of a
difference of inclusive prefix sums from the chunk's start, and the
exclusive prefix as cum - logw (the JAX package's kernel and model);
``stretch`` is the port's plain version (``ref.rwkv6_chunked_ref``), each
decay summed over its own stretch.  For each range and seed it prints the
largest |y - y_step| and its share of the 2e-3 / 2e-3 tolerance, against
the step loop (``ref.rwkv6_ref``'s recurrence, decays exp(logw)) in
float64.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.kernels.linrec.ref import rwkv6_chunked_ref

RANGES = {"model (-20, 10)": (-20.0, 10.0), "tests (-6, 3)": (-6.0, 3.0)}


def prefix_difference(r, k, v, logw, u, s, chunk=32):
    """The chunked form with decays from prefix-sum differences; T a
    multiple of ``chunk``."""
    strict = torch.ones(chunk, chunk, dtype=torch.bool).tril(-1)
    ys = []
    for c0 in range(0, r.shape[2], chunk):
        rc, kc, vc, lc = (x[:, :, c0:c0 + chunk] for x in (r, k, v, logw))
        cum = lc.cumsum(2)
        cp = cum - lc
        y = torch.einsum("bhti,bhij->bhtj", rc * cp.exp(), s)
        decay = (cp[:, :, :, None] - cum[:, :, None, :]).masked_fill(
            ~strict[None, None, :, :, None], float("-inf")).exp()
        att = torch.einsum("bhti,bhsi,bhtsi->bhts", rc, kc, decay)
        diag = (rc * u[None, :, None, :] * kc).sum(-1)
        ys.append(y + att @ vc + diag[..., None] * vc)
        total = cum[:, :, -1]
        s = (total.exp()[..., None] * s
             + (kc * (total[:, :, None] - cum).exp()).transpose(2, 3) @ vc)
    return torch.cat(ys, 2), s


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--t", type=int, default=1024)
    args = ap.parse_args()
    torch.set_float32_matmul_precision("highest")
    b, h, d = 2, 3, 64
    for label, (lo, hi) in RANGES.items():
        for seed in range(args.seeds):
            rng = np.random.default_rng(seed)
            r, k, v = (torch.from_numpy(rng.normal(size=(b, h, args.t, d))
                                        .astype(np.float32))
                       for _ in range(3))
            logw = torch.from_numpy(-np.exp(rng.uniform(
                lo, hi, (b, h, args.t, d))).astype(np.float32))
            u = torch.from_numpy(rng.normal(size=(h, d)).astype(np.float32))
            s0 = torch.from_numpy(rng.normal(size=(b, h, d, d))
                                  .astype(np.float32))
            want = _step64(r, k, v, logw, u, s0)
            lim = 2e-3 + 2e-3 * want.abs()
            for name, fn in (("prefix_difference", prefix_difference),
                             ("stretch", rwkv6_chunked_ref)):
                y = fn(r, k, v, logw, u, s0)[0].double()
                err = (y - want).abs()
                print(f"{label:16s} seed {seed} {name:17s} max |err| "
                      f"{float(err.max()):.3e}, share of tolerance "
                      f"{float((err / lim).max()):.4f}")


def _step64(r, k, v, logw, u, s):
    """The step loop in float64: y (B, H, T, dv)."""
    r, k, v, u, s = (x.double() for x in (r, k, v, u, s))
    w = logw.double().exp()
    ys = []
    for i in range(r.shape[2]):
        kv = k[:, :, i, :, None] * v[:, :, i, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, :, i],
                               s + u[None, :, :, None] * kv))
        s = w[:, :, i, :, None] * s + kv
    return torch.stack(ys, 2)


if __name__ == "__main__":
    main()
