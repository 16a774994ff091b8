"""The port's node agent: the kubelet device plugin, its health cache and
its register stream to the scheduler.  Importing it loads neither grpc nor
protobuf (their edges import them) and never torch."""

from .cache import DeviceCache
from .plugin import GpuDevicePlugin
from .register import DeviceRegister, advertised_devices, inventory_to_request

__all__ = ["DeviceCache", "GpuDevicePlugin", "DeviceRegister",
           "advertised_devices", "inventory_to_request"]
