"""Device inventory of the PyTorch/CUDA port (the JAX package's
``tpulib/`` for GPUs: a fixture-driven mock and the real cards)."""

from .backend import H100_FIXTURE, Backend, MockBackend, TorchBackend, detect
from .types import ChipInfo, NodeInventory, TopologyDesc

__all__ = [
    "H100_FIXTURE",
    "Backend",
    "MockBackend",
    "TorchBackend",
    "detect",
    "ChipInfo",
    "NodeInventory",
    "TopologyDesc",
]
