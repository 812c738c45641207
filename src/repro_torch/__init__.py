"""repro_torch — the PyTorch/CUDA port of ``repro`` (Sampling Methods for
Inner Product Sketching) for NVIDIA Hopper.

The port imports ``torch`` and ``numpy`` only — never ``jax`` or
``repro`` — and mirrors ``repro``'s subpackages (``core``, ``engine``,
``kernels``, ``serve``, and for training ``configs``, ``models``,
``train``, ``data``, ``distributed``, ``launch``).  Every Pallas kernel on a ported path becomes a
hand-written CUDA kernel (``csrc/``) built with ``nvcc`` at first launch,
with a plain PyTorch version beside it for CPU tensors.  Entry points run
on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
