"""The port's scheduler extender (the reference's surface of the JAX
package's ``scheduler/``): the webhook, Filter and Bind, the register
stream's consumer and the HTTP routes.  It imports no torch; its core
imports neither grpc nor protobuf."""

from .core import FilterResult, Scheduler
from .nodes import DeviceInfo, NodeInfo, NodeManager
from .pods import PodInfo, PodManager

__all__ = ["FilterResult", "Scheduler", "DeviceInfo", "NodeInfo",
           "NodeManager", "PodInfo", "PodManager"]
