"""Shaved Ice on PyTorch and CUDA: the one-shot and rolling commitment
planners and the serving engine, for an NVIDIA Hopper card.

This package mirrors ``src/repro`` module for module (``repro_torch.core.
replan`` ports ``repro.core.replan``) and never imports it: the JAX package
is the reference the tests compare against, not a dependency.  Tensors
carry an explicit device; the planner's entry points
(:func:`repro_torch.core.api.plan`,
:func:`repro_torch.core.replan.replan_fleet_pools`) run on ``"cuda"``
unless the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).

The one kernel of the planner's path, the commitment sweep, is a CUDA C++
kernel under ``kernels/commitment_sweep/csrc`` built with ``nvcc`` at first
use; on a CPU tensor its wrapper runs the plain PyTorch version instead.
"""
