"""Pod spec → device requests (the port's copy of the JAX package's
``util/resources.py``).

Reference: pkg/k8sutil/pod.go:121–208 (``Resourcereqs``): walk each
container's resource limits and build one ContainerDeviceRequest per
container.

- the count resource (``nvidia.com/gpu``) is the number of cards;
- memory is absolute MiB (``nvidia.com/gpumem``) or a percentage of each
  card's memory (``nvidia.com/gpumem-percentage``); absolute wins if both
  are set;
- neither set → ``default_mem``, and where that is 0, 100% of the card;
- cores (``nvidia.com/gpucores``) default to ``default_cores``.
"""

from __future__ import annotations

from typing import List

from .config import Config
from .types import NVIDIA_DEVICE, ContainerDeviceRequest


class QuantityError(ValueError):
    """A resource value an apiserver would have admitted but that cannot be
    read: the caller fails the pod, not the process."""


_SUFFIXES = (
    ("Ki", 1024), ("Mi", 1024 ** 2), ("Gi", 1024 ** 3),
    ("Ti", 1024 ** 4), ("Pi", 1024 ** 5), ("Ei", 1024 ** 6),
    ("k", 1000), ("M", 1000 ** 2), ("G", 1000 ** 3),
    ("T", 1000 ** 4), ("P", 1000 ** 5), ("E", 1000 ** 6),
)


def quantity_to_int(q) -> int:
    """A k8s resource quantity as an integer: plain integers (what extended
    resources hold), and the binary and decimal suffixes."""
    if isinstance(q, (int, float)):
        return int(q)
    s = str(q).strip()
    if s.isdigit():
        return int(s)
    mult = 1
    for suffix, m in _SUFFIXES:
        if s.endswith(suffix):
            mult = m
            s = s[: -len(suffix)]
            break
    try:
        return int(float(s) * mult)
    except ValueError as e:
        raise QuantityError(f"unparseable resource quantity {q!r}") from e


def _limits(ctr: dict) -> dict:
    res = ctr.get("resources", {})
    limits = dict(res.get("requests", {}))
    limits.update(res.get("limits", {}))
    return limits


def pod_priority(pod: dict, cfg: Config) -> int:
    """The pod's task priority: the lowest (most protected) priority limit
    among its containers that ask for cards, an absent or unreadable one
    counting as 0 (the webhook turns the same limit into
    ``CUDA_TASK_PRIORITY``)."""
    prios = []
    for ctr in pod.get("spec", {}).get("containers", []):
        limits = _limits(ctr)
        try:
            if quantity_to_int(limits.get(cfg.resources.count, 0)) <= 0:
                continue
        except QuantityError:
            continue
        try:
            prios.append(quantity_to_int(limits.get(cfg.resources.priority,
                                                    0)))
        except QuantityError:
            prios.append(0)
    return min(prios) if prios else 0


def container_requests(pod: dict, cfg: Config
                       ) -> List[ContainerDeviceRequest]:
    """One ContainerDeviceRequest per container (``nums`` 0 where the
    container asks for no card).  Raises QuantityError on an unreadable
    count, memory or cores."""
    res = cfg.resources
    out: List[ContainerDeviceRequest] = []
    for ctr in pod.get("spec", {}).get("containers", []):
        limits = _limits(ctr)
        nums = quantity_to_int(limits.get(res.count, 0))
        if nums <= 0:
            out.append(ContainerDeviceRequest(nums=0))
            continue
        memreq = quantity_to_int(limits.get(res.memory, 0))
        mem_pct = quantity_to_int(limits.get(res.memory_percentage, 0))
        if memreq == 0 and mem_pct == 0:
            if cfg.default_mem > 0:
                memreq = cfg.default_mem
            else:
                mem_pct = 100
        cores = quantity_to_int(limits.get(res.cores, cfg.default_cores))
        out.append(ContainerDeviceRequest(
            nums=nums, type=NVIDIA_DEVICE, memreq=memreq,
            mem_percentage_req=mem_pct, coresreq=cores))
    return out


def pod_requests_any(pod: dict, cfg: Config) -> bool:
    return any(r.nums > 0 for r in container_requests(pod, cfg))

