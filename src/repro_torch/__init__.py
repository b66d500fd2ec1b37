"""PyTorch/CUDA port of the ELSA reproduction (``src/repro`` is the JAX
reference).  Nothing under this package imports ``jax`` or ``repro``.

Entry points take ``device`` and default to ``"cuda"``; the CPU is used
only when a caller passes ``device="cpu"``.
"""
