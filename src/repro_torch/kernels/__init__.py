"""Hand-written Hopper kernels of the port, one family per sub-package.

Each family has ``ref.py`` (the plain PyTorch version) and ``ops.py`` (the
wrapper, with the kernel's declared ``work``).  A wrapper dispatches on the
device of its input: a CPU tensor goes to the plain version, a CUDA tensor
launches the kernel or raises, and a ``meta`` tensor takes the launch's
checks and outputs and launches nothing (the dry run); any other device
raises.  Every call declares its work to the active cost counter
(:mod:`repro_torch.kernels._cost`).
CUDA sources live in ``repro_torch/csrc`` and are built at first use by
:mod:`repro_torch.kernels._build`.
"""
