"""Hand-written Hopper kernels of the port, each an ops/ref/kernel triad:
``ref.py`` (plain PyTorch, the spec), ``<name>.py`` (build, binding and
launch of the CUDA source under ``csrc/``) and ``ops.py`` (the entry point,
which dispatches on the device of the tensors it is given)."""
