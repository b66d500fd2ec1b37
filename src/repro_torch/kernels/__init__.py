"""Hand-written Hopper kernels of the port, one family per sub-package.

Each family has ``ref.py`` (the plain PyTorch version) and ``ops.py`` (the
wrapper).  A wrapper dispatches on the device of its input: a CPU tensor
goes to the plain version, a CUDA tensor launches the kernel or raises.
CUDA sources live in ``repro_torch/csrc`` and are built at first use by
:mod:`repro_torch.kernels._build`.
"""
