"""PyTorch/CUDA port of the FUSEE reproduction.

A second package beside the JAX one (``repro``), which stays the reference:
same module and class names, device-resident state in torch tensors on an
explicit ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``), and
hand-written Hopper kernels under ``csrc/`` for the TPU kernels on the
ported path.  It never imports ``jax`` or ``repro``.
"""
