"""The port's OCI runtime wrapper (reference pkg/oci — C26 in SURVEY.md §2).

The counterpart of the JAX package's ``oci/``: a container-runtime
interposer that wraps the real OCI runtime (runc), rewrites a bundle's
spec on ``create`` to carry the port's enforcement contract, then execs
the wrapped runtime, so a container launched without kubelet (plain
containerd or runc) gets what the device plugin's Allocate gives a pod.
"""

from .runtime import ModifyingRuntimeWrapper, SyscallExecRuntime
from .spec import FileSpec, inject_vgpu

__all__ = [
    "FileSpec",
    "ModifyingRuntimeWrapper",
    "SyscallExecRuntime",
    "inject_vgpu",
]
