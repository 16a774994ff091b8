"""Node-side usage accounting of the PyTorch/CUDA port: the monitor's
per-container counters (the JAX package's ``accounting/sampler.py``)."""

from .sampler import USAGE_FIELDS, UsageSampler

__all__ = ["USAGE_FIELDS", "UsageSampler"]
