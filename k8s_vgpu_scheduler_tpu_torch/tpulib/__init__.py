"""Device inventory of the PyTorch/CUDA port (the JAX package's
``tpulib/`` for GPUs: a fixture-driven mock, and the real cards through
NVML or torch)."""

from .backend import (H100_FIXTURE, Backend, MockBackend, NvmlBackend,
                      TorchBackend, detect)
from .types import ChipInfo, NodeInventory, TopologyDesc

__all__ = [
    "H100_FIXTURE",
    "Backend",
    "MockBackend",
    "NvmlBackend",
    "TorchBackend",
    "detect",
    "ChipInfo",
    "NodeInventory",
    "TopologyDesc",
]
