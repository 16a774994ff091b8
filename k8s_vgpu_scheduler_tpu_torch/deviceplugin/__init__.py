"""The port's node agent: the kubelet device plugin, its health cache, its
register stream to the scheduler, the kubelet path's slice allocator and
the MIG partition plugins.
Importing it loads neither grpc nor protobuf (their edges import them) and
never torch."""

from .allocator import (UNSATISFIABLE_ANNOTATION, SliceAllocator,
                        publish_unsatisfiable, unsatisfiable_sizes)
from .cache import DeviceCache
from .partition import (PartitionDevicePlugin, get_partition_plugins,
                        whole_chip_view)
from .plugin import GpuDevicePlugin
from .register import DeviceRegister, advertised_devices, inventory_to_request

__all__ = ["DeviceCache", "GpuDevicePlugin", "DeviceRegister",
           "PartitionDevicePlugin", "SliceAllocator",
           "UNSATISFIABLE_ANNOTATION", "advertised_devices",
           "get_partition_plugins", "inventory_to_request",
           "publish_unsatisfiable", "unsatisfiable_sizes",
           "whole_chip_view"]
