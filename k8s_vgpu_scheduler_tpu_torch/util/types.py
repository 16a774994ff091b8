"""Core scheduling types and the annotation vocabulary of the port's node
agent.

The port's copy of the JAX package's ``util/types.py`` (reference
``pkg/util/types.go:19–96``).  Pod annotations are the scheduling
database: every decision the scheduler extender makes crosses to the node
agent through them.  The annotation keys, bind phases and the node-lock key
are the JAX package's, byte for byte: the only scheduler in the repo writes
them, and a later scheduler slice may rename both ends together.  What
changes for the GPU is the device type (the reference's ``NvidiaGPUDevice``)
and the container env, which is the one the port's interposer and region
read (``csrc/vgpu/region.cc``'s ``apply_env_limits``).
"""

from __future__ import annotations

import dataclasses
from typing import List

# --- Annotation keys (the inter-process scheduling protocol) -----------------
ASSIGNED_TIME_ANNOTATION = "vtpu.dev/assigned-time"
ASSIGNED_IDS_ANNOTATION = "vtpu.dev/assigned-ids"
TO_ALLOCATE_ANNOTATION = "vtpu.dev/devices-to-allocate"
ASSIGNED_NODE_ANNOTATION = "vtpu.dev/assigned-node"
BIND_TIME_ANNOTATION = "vtpu.dev/bind-time"
BIND_PHASE_ANNOTATION = "vtpu.dev/bind-phase"

# GPU-type affinity, user-set (reference types.go:30–31, consumed by
# score.go:67–87): comma-separated, case-insensitive substrings of a card's
# type ("NVIDIA-h100").
GPU_USE_TYPE_ANNOTATION = "nvidia.com/use-gputype"
GPU_NOUSE_TYPE_ANNOTATION = "nvidia.com/nouse-gputype"

# SLO-tiered co-residency: the webhook-validated class, and the scheduler's
# placement-time per-class duty split, carried into the container env.
QOS_ANNOTATION = "vtpu.dev/qos"
QOS_DUTY_SPLIT_ANNOTATION = "vtpu.dev/qos-duty-split"
QOS_LATENCY_CRITICAL = "latency-critical"
QOS_BEST_EFFORT = "best-effort"
QOS_CLASSES = (QOS_LATENCY_CRITICAL, QOS_BEST_EFFORT)

# Host-memory oversubscription of a pod's grant.
OVERSUBSCRIBE_ANNOTATION = "vtpu.dev/oversubscribe"

# Multi-host gangs: the scheduler-assigned rank and group size, and the
# user's coordinator address (scheduler/gang.py's keys).
GANG_GROUP_ANNOTATION = "vtpu.dev/pod-group"
GANG_TOTAL_ANNOTATION = "vtpu.dev/pod-group-total"
GANG_RANK_ANNOTATION = "vtpu.dev/pod-group-rank"
GANG_COORDINATOR_ANNOTATION = "vtpu.dev/pod-group-coordinator"

# A pod's declared device mesh (placement/mesh.py), the bounds of an
# elastic mesh range, and the rung the resize controller assigns
# (elastic/ranges.py).
MESH_ANNOTATION = "vtpu.dev/mesh"
MESH_MIN_ANNOTATION = "vtpu.dev/mesh-min"
MESH_MAX_ANNOTATION = "vtpu.dev/mesh-max"
MESH_ASSIGNED_ANNOTATION = "vtpu.dev/mesh-assigned"

# Node annotation used as a cluster-wide mutex for the bind/allocate two-phase
# commit (reference: 4pd.io/mutex.lock, types.go:57; nodelock.go:144–230).
NODE_LOCK_ANNOTATION = "vtpu.dev/mutex.lock"
MAX_LOCK_RETRY = 5
NODE_LOCK_EXPIRE_SECONDS = 300.0

# Bind phases (reference types.go:33–35).
BIND_ALLOCATING = "allocating"
BIND_FAILED = "failed"
BIND_SUCCESS = "success"

# Topology placement policies for multi-card requests: whether a request
# may be met by cards that do not form a contiguous slice of the node's
# fabric (reference: the MLULink ring policies best-effort/restricted/
# guaranteed, types.go:44–46).
BEST_EFFORT = "best-effort"
RESTRICTED = "restricted"
GUARANTEED = "guaranteed"
TOPOLOGY_POLICIES = (BEST_EFFORT, RESTRICTED, GUARANTEED)

# The device type the node agent allocates (reference NvidiaGPUDevice,
# types.go:48–53); a card's type is "NVIDIA-<generation>" (tpulib).
NVIDIA_DEVICE = "NVIDIA"

# Per-container env read by the port's interposer and region
# (csrc/vgpu/region.cc apply_env_limits; reference plugin.go:353–371).
ENV_MEMORY_LIMIT_PREFIX = "CUDA_DEVICE_MEMORY_LIMIT_"  # MiB, i-th card
ENV_SM_LIMIT = "CUDA_DEVICE_SM_LIMIT"                 # percent, 0 = none
ENV_SHARED_CACHE = "CUDA_DEVICE_MEMORY_SHARED_CACHE"  # the region file
ENV_OVERSUBSCRIBE = "CUDA_OVERSUBSCRIBE"
ENV_TASK_PRIORITY = "CUDA_TASK_PRIORITY"             # written by the webhook
ENV_VISIBLE_DEVICES = "NVIDIA_VISIBLE_DEVICES"        # the cards' UUIDs
ENV_QOS_CLASS = "VTPU_QOS_CLASS"
ENV_QOS_DUTY_SPLIT = "VTPU_QOS_DUTY_SPLIT"

# Where a container finds what the node agent mounts into it: the
# interposer and the ld.so.preload that names it, and the pod's region
# file, in the per-container directory the monitor scans on the host.
SHIM_CONTAINER_DIR = "/usr/local/vgpu"
SHIM_LIBRARY = "libvgpu_cuda.so"
PRELOAD_FILE = "ld.so.preload"
CACHE_CONTAINER_DIR = "/tmp/vgpu"
CACHE_FILE = "cudevshr.cache"


@dataclasses.dataclass
class ContainerDevice:
    """One device grant to one container (reference ContainerDevice,
    types.go:79–84): ``usedmem`` MiB, ``usedcores`` a 0–100 percentage of
    one card's SMs."""

    uuid: str
    type: str
    usedmem: int
    usedcores: int


@dataclasses.dataclass
class ContainerDeviceRequest:
    """One container's decoded resource request (reference
    ContainerDeviceRequest, types.go:86–92).  ``memreq`` MiB wins over
    ``mem_percentage_req``; a percentage is resolved against a card's size
    when Filter fits it (score.go:146–148)."""

    nums: int
    type: str = NVIDIA_DEVICE
    memreq: int = 0
    mem_percentage_req: int = 0
    coresreq: int = 0


ContainerDevices = List[ContainerDevice]
PodDevices = List[ContainerDevices]
