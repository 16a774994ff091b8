"""The node monitor of the PyTorch/CUDA port: reads every container's
shared region, flips the priority switch and re-weights QoS duty (the JAX
package's ``monitor/`` for the GPU).  Its Prometheus exporter
(``metrics.py``) and NodeTPUInfo RPC (``noderpc.py``, the one module here
that imports grpc) are imported by their users, not here."""

from .feedback import FeedbackLoop
from .reader import Region, RegionReader, scan_container_dirs

__all__ = ["FeedbackLoop", "Region", "RegionReader", "scan_container_dirs"]
