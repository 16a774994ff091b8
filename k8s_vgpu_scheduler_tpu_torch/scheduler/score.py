"""Card fit and node scoring (the port's copy of the JAX package's
``scheduler/score.py``).

Reference: pkg/scheduler/score.go:109–203 (``calcScore``).  The per-card
rules keep their reference semantics:

- the type white/blacklist from pod annotations (checkGPUtype,
  score.go:67–87);
- absolute and percentage memory requests resolved against the card's
  advertised size (score.go:146–148);
- ``coresreq == 100`` takes a card nobody uses (exclusive,
  score.go:155–157);
- a card whose cores are all granted takes nothing more, a 0-core job
  included (score.go:159–162);
- the virtual-slot capacity ``used_slots < total_slots``.

A multi-card request on a node with a fabric goes through the slice
engine (``topology/torus.py``) under the pod's topology policy
(``vtpu.dev/topology-policy``, else the configured default), and a pod
that declares ``vtpu.dev/mesh`` through ``placement/mesh.py``, as the JAX
package's Filter does.  On a node whose cards lack coordinates (a node
without a fabric) both refuse such a pod, ``topology-unverifiable``,
where it is ``guaranteed`` or declares a mesh.  Elsewhere cards are
chosen by the reference's plain rule (shared cards first, so whole cards
stay free for exclusive and multi-card requests).  The node score is the reference's spread rule
(the sum of the free fractions after the tentative placement, Filter
takes the largest), or its negation under ``binpack``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..placement.mesh import find_mesh_slice, local_mesh_for, parse_mesh
from ..topology import find_slice
from ..tpulib.types import TopologyDesc
from ..util.types import (
    BEST_EFFORT,
    GPU_NOUSE_TYPE_ANNOTATION,
    GPU_USE_TYPE_ANNOTATION,
    GUARANTEED,
    MESH_ANNOTATION,
    ContainerDevice,
    ContainerDeviceRequest,
    ContainerDevices,
)
from .nodes import NodeInfo
from .pods import PodInfo

Affinity = Tuple[Optional[List[str]], List[str]]

# Pod annotation selecting the topology policy of its multi-card grants.
TOPOLOGY_POLICY_ANNOTATION = "vtpu.dev/topology-policy"


@dataclasses.dataclass(slots=True)
class DeviceUsage:
    """Live usage of one card (reference DeviceUsage, nodes.go:242–258)."""

    id: str
    type: str
    health: bool
    coords: Tuple[int, ...]
    total_slots: int
    used_slots: int
    total_mem: int
    used_mem: int
    total_cores: int
    used_cores: int

    @property
    def free_mem(self) -> int:
        return self.total_mem - self.used_mem

    @property
    def free_cores(self) -> int:
        return self.total_cores - self.used_cores

    @property
    def free_slots(self) -> int:
        return self.total_slots - self.used_slots


def build_usage(node: NodeInfo, pods_on_node: List[PodInfo]
                ) -> Dict[str, DeviceUsage]:
    """Registered inventory less the grants of every scheduled pod
    (reference getNodesUsage, scheduler.go:176–222)."""
    usage = {d.id: DeviceUsage(d.id, d.type, d.health, tuple(d.coords),
                               d.count, 0, d.devmem, 0, d.cores, 0)
             for d in node.devices}
    for pod in pods_on_node:
        for container in pod.devices:
            for grant in container:
                u = usage.get(grant.uuid)
                if u is None:
                    continue  # the card left the inventory
                u.used_slots += 1
                u.used_mem += grant.usedmem
                u.used_cores += grant.usedcores
    return usage


def clone_usage(u: DeviceUsage) -> DeviceUsage:
    return DeviceUsage(u.id, u.type, u.health, u.coords, u.total_slots,
                       u.used_slots, u.total_mem, u.used_mem,
                       u.total_cores, u.used_cores)


class CowUsage:
    """Copy-on-write view over a usage mapping that is never written.

    ``fit_container`` clones a card through :meth:`own` only where a
    tentative placement changes it; reads merge the private overlay over
    the base, so a later container sees an earlier one's grant.  Views
    stack: gang placement (``gang.place_gang``) lays a trial view for
    each attempt and a probe view for each member and node on top."""

    __slots__ = ("_base", "_own")

    def __init__(self, base) -> None:
        self._base = base
        self._own: Dict[str, DeviceUsage] = {}

    def own(self, chip_id: str) -> DeviceUsage:
        """A private, mutable copy of one card (cloned once a view)."""
        u = self._own.get(chip_id)
        if u is None:
            u = clone_usage(self._base[chip_id])
            self._own[chip_id] = u
        return u

    def __getitem__(self, chip_id: str) -> DeviceUsage:
        got = self._own.get(chip_id)
        return got if got is not None else self._base[chip_id]

    def __len__(self) -> int:
        return len(self._base)

    def values(self):
        if not self._own:
            return self._base.values()
        own = self._own
        return [own.get(u.id) or u for u in self._base.values()]


def parse_affinity(annotations: Dict[str, str]) -> Affinity:
    """The type white/blacklist tokens.  The whitelist is None when the
    annotation is absent: a present one without tokens (" ", ",,") matches
    nothing."""
    use_raw = annotations.get(GPU_USE_TYPE_ANNOTATION, "")
    nouse_raw = annotations.get(GPU_NOUSE_TYPE_ANNOTATION, "")
    use = ([tok.strip().lower() for tok in use_raw.split(",") if tok.strip()]
           if use_raw else None)
    nouse = [tok.strip().lower() for tok in nouse_raw.split(",")
             if tok.strip()]
    return use, nouse


def type_allows(affinity: Affinity, dev_type: str) -> bool:
    """Comma-separated, case-insensitive substring match (checkGPUtype)."""
    use, nouse = affinity
    if use is None and not nouse:
        return True
    t = dev_type.lower()
    if use is not None and not any(tok in t for tok in use):
        return False
    return not (nouse and any(tok in t for tok in nouse))


def type_excluded(affinity: Affinity, usage: Dict[str, DeviceUsage]
                  ) -> Optional[str]:
    """The reject reason when the white/blacklist excludes every card type
    on the node (decided before any copy is made), else None."""
    use, nouse = affinity
    if use is None and not nouse:
        return None
    if any(type_allows(affinity, t) for t in {u.type for u in usage.values()}):
        return None
    n = len(usage)
    return f"type-mismatch: {n}/{n} type-mismatch"


def _resolve_mem(req: ContainerDeviceRequest, chip: DeviceUsage) -> int:
    if req.memreq > 0:
        return req.memreq
    pct = req.mem_percentage_req if req.mem_percentage_req > 0 else 100
    return chip.total_mem * pct // 100


def _chip_reject_reason(req: ContainerDeviceRequest, chip: DeviceUsage,
                        affinity: Affinity) -> Optional[str]:
    """The first per-card rule that fails, as a low-cardinality token."""
    if not chip.health:
        return "unhealthy"
    if not type_allows(affinity, chip.type):
        return "type-mismatch"
    if chip.free_slots <= 0:
        return "slots-exhausted"
    if chip.used_cores >= chip.total_cores:
        return "cores-exhausted"  # score.go:159–162
    if req.coresreq >= 100 and (chip.used_slots > 0 or chip.used_cores > 0):
        return "exclusive-chip-busy"  # score.go:155–157
    if req.coresreq > chip.free_cores:
        return "insufficient-cores"
    if _resolve_mem(req, chip) > chip.free_mem:
        return "insufficient-hbm"
    return None


def _reject_summary(req: ContainerDeviceRequest,
                    usage: Dict[str, DeviceUsage], affinity: Affinity) -> str:
    """The per-card reasons tallied into one line, the dominant token
    first (the rejection counter's key)."""
    tally: Dict[str, int] = {}
    for chip in usage.values():
        why = _chip_reject_reason(req, chip, affinity)
        if why is not None:
            tally[why] = tally.get(why, 0) + 1
    if not tally:
        return (f"too-few-chips: node has {len(usage)} chips, "
                f"request needs {req.nums}")
    detail = ", ".join(f"{n}/{len(usage)} {why}" for why, n in
                       sorted(tally.items(), key=lambda kv: -kv[1]))
    return f"{max(tally, key=tally.get)}: {detail}"


def fit_container(req: ContainerDeviceRequest, usage: Dict[str, DeviceUsage],
                  topo: Optional[TopologyDesc], annotations: Dict[str, str],
                  policy: str = BEST_EFFORT,
                  reasons: Optional[Dict[str, str]] = None
                  ) -> Optional[ContainerDevices]:
    """Place one container's request, mutating ``usage`` (or, for a
    :class:`CowUsage`, its overlay) on success.  On failure,
    ``reasons["reason"]`` (when given) says why."""
    if req.nums <= 0:
        return []
    affinity = parse_affinity(annotations)
    eligible = [u for u in usage.values()
                if _chip_reject_reason(req, u, affinity) is None]
    if len(eligible) < req.nums:
        if reasons is not None:
            reasons["reason"] = _reject_summary(req, usage, affinity)
        return None

    chosen: Optional[List[DeviceUsage]] = None
    mesh_value = annotations.get(MESH_ANNOTATION, "")
    if mesh_value and req.nums > 1:
        # The pod asked for axis structure, not only contiguous cards: the
        # grant must be a box realizing its local mesh under every policy
        # (a mesh has no scattered fallback).
        chosen = _fit_mesh(req, eligible, topo, mesh_value, reasons)
        if chosen is None:
            return None
    elif topo is not None and req.nums > 1:
        # Slice placement needs coordinates present and unique on every
        # eligible card; a node agent that sends none leaves the plain
        # choice, which cannot promise contiguity.
        coord_map = {u.coords: u for u in eligible if u.coords != ()}
        if len(coord_map) == len(eligible):
            coords = find_slice(topo, coord_map.keys(), req.nums, policy)
            if coords is None:
                if reasons is not None:
                    reasons["reason"] = (
                        f"no-ici-slice: no contiguous slice of "
                        f"{req.nums} chips under policy {policy}")
                return None
            chosen = [coord_map[c] for c in coords]
        elif policy == GUARANTEED:
            if reasons is not None:
                reasons["reason"] = ("topology-unverifiable: guaranteed "
                                     "policy but chip coords missing")
            return None
    if chosen is None:
        # Shared cards first, so whole cards stay free for exclusive and
        # multi-card requests.  The sort is stable under reverse=True:
        # among equals the node's registration order decides.
        chosen = sorted(eligible, key=lambda u: (u.used_slots, u.used_mem),
                        reverse=True)[:req.nums]
    grants: ContainerDevices = []
    # Against a CowUsage view, clone only the cards this grant changes; a
    # plain dict (a copy the caller owns) is changed in place.
    own = getattr(usage, "own", None)
    for chip in chosen:
        mem = _resolve_mem(req, chip)
        if own is not None:
            chip = own(chip.id)
        chip.used_slots += 1
        chip.used_mem += mem
        chip.used_cores += req.coresreq
        grants.append(ContainerDevice(uuid=chip.id, type=chip.type,
                                      usedmem=mem, usedcores=req.coresreq))
    return grants


def _fit_mesh(req: ContainerDeviceRequest, eligible: List[DeviceUsage],
              topo: Optional[TopologyDesc], mesh_value: str,
              reasons: Optional[Dict[str, str]]
              ) -> Optional[List[DeviceUsage]]:
    """The cards of a ``vtpu.dev/mesh`` request: a box of the fabric that
    realizes the pod's local mesh (``placement.mesh.find_mesh_slice``),
    or None with the reason.  The webhook validates the annotation at
    admission; Filter parses it again, so a caller without the webhook
    never sees a malformed mesh placed as a scatter."""
    def reject(token: str, detail: str):
        if reasons is not None:
            reasons["reason"] = f"{token}: {detail}"
        return None

    try:
        mesh = parse_mesh(mesh_value)
    except ValueError as e:
        return reject("bad-mesh", str(e))
    local, why = local_mesh_for(mesh, req.nums)
    if local is None:
        return reject("bad-mesh", why)
    if topo is None:
        return reject("topology-unverifiable",
                      "mesh declared but node advertises no ICI topology")
    coord_map = {u.coords: u for u in eligible if u.coords != ()}
    if len(coord_map) != len(eligible):
        return reject("topology-unverifiable",
                      "mesh declared but chip coords missing")
    coords = find_mesh_slice(topo, coord_map.keys(), local)
    if coords is None:
        return reject(
            "no-mesh-slice",
            f"no free box realizes local mesh "
            f"{'x'.join(map(str, local))} ({req.nums} chips)")
    return [coord_map[c] for c in coords]


def fit_pod(requests: List[ContainerDeviceRequest],
            usage: Dict[str, DeviceUsage], topo: Optional[TopologyDesc],
            annotations: Dict[str, str], default_policy: str = BEST_EFFORT,
            reasons: Optional[Dict[str, str]] = None
            ) -> Optional[List[ContainerDevices]]:
    """All containers or none; mutates ``usage`` as it goes (callers pass
    a copy per candidate node).  The pod's ``vtpu.dev/topology-policy``
    wins over ``default_policy``."""
    policy = annotations.get(TOPOLOGY_POLICY_ANNOTATION, default_policy)
    out: List[ContainerDevices] = []
    for i, req in enumerate(requests):
        got = fit_container(req, usage, topo, annotations, policy, reasons)
        if got is None:
            if reasons is not None and len(requests) > 1:
                # A suffix: the leading token stays the counter's key.
                reasons["reason"] = (reasons.get("reason", "no fit")
                                     + f" (container {i})")
            return None
        out.append(got)
    return out


def node_score(usage: Dict[str, DeviceUsage], policy: str = "spread"
               ) -> float:
    """The node's preference among fitting nodes; Filter takes the largest.
    ``spread`` (score.go:165–199): the most free capacity wins; ``binpack``:
    the least."""
    score = 0.0
    for u in usage.values():
        if u.total_mem > 0:
            score += u.free_mem / u.total_mem
        if u.total_cores > 0:
            score += u.free_cores / u.total_cores
    return -score if policy == "binpack" else score
