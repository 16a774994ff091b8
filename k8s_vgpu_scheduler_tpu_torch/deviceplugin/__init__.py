"""The port's node agent: the kubelet device plugin, its health cache, its
register stream to the scheduler and the kubelet path's slice allocator.
Importing it loads neither grpc nor protobuf (their edges import them) and
never torch."""

from .allocator import (UNSATISFIABLE_ANNOTATION, SliceAllocator,
                        publish_unsatisfiable, unsatisfiable_sizes)
from .cache import DeviceCache
from .plugin import GpuDevicePlugin
from .register import DeviceRegister, advertised_devices, inventory_to_request

__all__ = ["DeviceCache", "GpuDevicePlugin", "DeviceRegister",
           "SliceAllocator", "UNSATISFIABLE_ANNOTATION",
           "advertised_devices", "inventory_to_request",
           "publish_unsatisfiable", "unsatisfiable_sizes"]
