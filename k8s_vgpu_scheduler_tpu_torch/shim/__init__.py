"""In-container enforcement for the PyTorch/CUDA port: the shared
accounting region, the device-memory cap, the duty-cycle gate and host
swap (the JAX package's ``shim/`` for the GPU)."""

from .core import Native, Shim, autoinstall, gate, gated, install

__all__ = ["Native", "Shim", "autoinstall", "gate", "gated", "install"]
