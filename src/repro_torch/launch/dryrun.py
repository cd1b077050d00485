"""Dry run of the shape cells on the meta device: does every (architecture
x input shape x production mesh) cell fit, and what bounds its step.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell for 512 placeholder TPU devices and reads XLA's memory and cost
analyses; the port builds each cell's full-size model on the meta device
(no storage, seconds for all 32 cells) and sizes it with the analytic
model the reference projects its TPU numbers with
(:mod:`repro_torch.launch.roofline`).  Per cell and mesh shape it reports
the per-device parameter, optimizer-state and cache bytes under the
cell's ruleset, the transient bytes (``analytic_temp_bytes``), whether
they fit the card's memory, and the roofline terms at the card's peaks
with the model FLOPs as the compute numerator (plus the recurrences'
chunk-scan FLOPs); the collective term is 0 here (no compiled program to
read collectives from).  Results are cached as JSON per cell under
``--out``, so reruns are incremental.

The memory budget is the card's (``torch.cuda.get_device_properties(0)
.total_memory``) and the peaks are its variant's, unless the caller passes
``memory_bytes=`` and ``card=`` (the CPU tests do).

Usage:
  python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import traceback

from repro_torch.launch import roofline as rf
from repro_torch.launch.cells import (
    all_cells,
    cell_rules,
    default_microbatches,
    make_cell,
)
from repro_torch.launch.mesh import production_mesh_shape


def card_budget(memory_bytes: int | None = None,
                card: str | None = None) -> tuple[int, str]:
    """(memory bytes, card name): the caller's, else the card's (raises
    without a card)."""
    if memory_bytes is None or card is None:
        import torch

        from repro_torch.device import resolve_device
        resolve_device(None)
        if memory_bytes is None:
            memory_bytes = torch.cuda.get_device_properties(0).total_memory
        if card is None:
            card = torch.cuda.get_device_name(0)
    return int(memory_bytes), card


def run_cell(
    arch: str,
    shape: str,
    *,
    multi_pod: bool = False,
    memory_bytes: int | None = None,
    card: str | None = None,
    verbose: bool = True,
) -> dict:
    """Size one cell on the production mesh shape; returns its record."""
    memory_bytes, card = card_budget(memory_bytes, card)
    mesh_shape = production_mesh_shape(multi_pod=multi_pod)
    nchips = math.prod(mesh_shape.values())
    cell = make_cell(arch, shape)
    rules = cell_rules(cell, mesh_shape)
    resident = cell.device_bytes(mesh_shape, rules)

    n_model = mesh_shape.get("model", 1)
    micro = default_microbatches(cell.cfg, cell.cell, mesh_shape)
    temp = rf.analytic_temp_bytes(cell.cfg, cell.cell, nchips // n_model,
                                  n_model, micro)
    total = sum(resident.values()) + temp

    specs = cell.param_specs
    model_flops = rf.model_flops_for(cell.cfg, specs, cell.cell)
    flops = (model_flops + rf.inner_recurrence_flops(cell.cfg, cell.cell)
             ) / nchips
    roof = rf.roofline_terms(
        flops, rf.analytic_hbm_bytes(cell, mesh_shape, rules), 0.0,
        model_flops / nchips, peaks=rf.peaks_for(card))
    record = {
        "arch": arch,
        "shape": shape,
        "kind": cell.cell.kind,
        "mesh": list(mesh_shape.values()),
        "mesh_axes": list(mesh_shape),
        "chips": nchips,
        "card": card,
        "memory": {
            "params_bytes": resident["params"],
            "opt_state_bytes": resident["opt_state"],
            "cache_bytes": resident["cache"],
            "temp_bytes": temp,
            "total_per_device": total,
            "budget_bytes": memory_bytes,
            "fits": bool(total < memory_bytes),
        },
        "roofline": roof.as_dict(),
        "microbatches": micro,
        "params_total": cell.model.num_params(),
        "params_active": rf.active_params(cell.cfg, specs),
        "model_flops_global": model_flops,
    }
    if verbose:
        m, r = record["memory"], record["roofline"]
        print(
            f"[{arch} x {shape} x {'multi' if multi_pod else 'single'}-pod] "
            f"mem/dev {total / 1e9:.2f} GB of {memory_bytes / 1e9:.1f} "
            f"(fits={m['fits']}) | compute {r['compute_s'] * 1e3:.2f} ms, "
            f"memory {r['memory_s'] * 1e3:.2f} ms -> {r['dominant']}-bound",
            flush=True,
        )
    return record


def cell_tag(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}__{shape}__{'multi' if multi_pod else 'single'}"


def run_all(cells, meshes, out: str, *, force: bool = False,
            memory_bytes: int | None = None, card: str | None = None,
            verbose: bool = True) -> tuple[list[dict], list]:
    """Each cell under each mesh (``multi_pod`` flags), each record cached
    as ``<out>/<arch>__<shape>__<single|multi>.json`` and reread from
    there unless ``force``; returns (records, failures)."""
    os.makedirs(out, exist_ok=True)
    records, failures = [], []
    for multi_pod in meshes:
        for arch, shape in cells:
            tag = cell_tag(arch, shape, multi_pod)
            path = os.path.join(out, tag + ".json")
            if os.path.exists(path) and not force:
                with open(path) as f:
                    records.append(json.load(f))
                if verbose:
                    print(f"[cached] {tag}", flush=True)
                continue
            try:
                rec = run_cell(arch, shape, multi_pod=multi_pod,
                               memory_bytes=memory_bytes, card=card,
                               verbose=verbose)
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                failures.append((tag, str(e)))
                rec = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                       "error": str(e)}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            records.append(rec)
    return records, failures


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--memory-bytes", type=int, default=None,
                    help="per-device budget (default: the card's memory)")
    ap.add_argument("--card", default=None,
                    help="card name for the peaks (default: the card's)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    _, failures = run_all(cells, meshes, args.out, force=args.force,
                          memory_bytes=args.memory_bytes, card=args.card)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err[:200]}")
        return 1
    print("\nAll dry-run cells sized.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
