"""Configuration of the port's node agent.

The port's copy of the JAX package's ``util/config.py``, cut to the fields
the node agent reads (the scheduler's wait for the scheduler slice).  One
immutable Config passed explicitly, where the reference scatters mutable
package globals (pkg/util/util.go:35–47, pkg/device-plugin/config:528–537).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ResourceNames:
    """Extended-resource names pods use to ask for a fraction of a GPU:
    the reference's defaults (--resource-name/-mem/-mem-percentage/-cores/
    -priority, util.go:35–47)."""

    count: str = "nvidia.com/gpu"
    memory: str = "nvidia.com/gpumem"
    memory_percentage: str = "nvidia.com/gpumem-percentage"
    cores: str = "nvidia.com/gpucores"
    priority: str = "nvidia.com/priority"


@dataclasses.dataclass(frozen=True)
class Config:
    resources: ResourceNames = dataclasses.field(default_factory=ResourceNames)

    # Node-agent knobs (reference pkg/device-plugin/config:528–537).
    device_split_count: int = 10
    device_memory_scaling: float = 1.0
    device_cores_scaling: float = 1.0
    disable_core_limit: bool = False
    node_name: str = ""
    scheduler_endpoint: str = "127.0.0.1:9090"

    # The node's install of the interposer (libvgpu_cuda.so and the
    # ld.so.preload naming it), and the per-container region directories
    # the node monitor scans (cmd/monitor.py's --container-root).
    shim_host_dir: str = "/usr/local/vgpu"
    cache_host_dir: str = "/tmp/vgpu/containers"

    # Sharing mode (reference MLU modes, cambricon.go:92–139):
    # - "mem-share":  split cards into virtual devices with memory caps;
    # - "env-share":  split cards WITHOUT memory caps (sharers time-slice
    #                 the whole card);
    # - "default":    exclusive whole cards (split count forced to 1).
    sharing_mode: str = "mem-share"

    def effective_split_count(self) -> int:
        """Virtual devices per card — the single source of truth for both
        kubelet fan-out and extender advertisement (sharing mode `default`
        means exclusive whole cards regardless of the split knob)."""
        return 1 if self.sharing_mode == "default" else self.device_split_count

