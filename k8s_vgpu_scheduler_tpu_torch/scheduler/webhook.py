"""Mutating admission webhook (the port's copy of the JAX package's
``scheduler/webhook.py``).

Reference: pkg/scheduler/webhook.go:170–247.  On pod CREATE:

- a pod with a privileged container is left as it is (it sees the host's
  cards anyway);
- a container with a priority limit gets ``CUDA_TASK_PRIORITY`` in its env,
  which the region reads (``csrc/vgpu/region.cc``);
- a pod that asks for cards gets ``spec.schedulerName`` pointed at this
  scheduler and a ``vtpu.dev/trace-id`` annotation: the id every later
  phase (Filter, Bind, Allocate) stamps its spans with;
- a card-using container that opted into low priority (>= 1) also gets the
  downward-API annotations volume, its mount and ``VTPU_PODINFO_ANNOTATIONS``,
  so the in-container ``PreemptionWatch`` finds the file;
- a pod that asks for cards in a namespace a capacity queue governs
  (``Config.quota_queues``) is held at creation: ``vtpu.dev/queue`` and
  ``vtpu.dev/queue-state: held``, which Filter refuses until the admission
  loop releases it.  A pod that already carries a queue state keeps it.

A pod is refused with a 422 where its ``vtpu.dev/mesh`` could never place
(the JAX package's messages: the shape parses, its volume is the pod's
card count, times the members of its gang, its local mesh fits a fabric
registered in the fleet), where
it declares an elastic mesh range (``vtpu.dev/mesh-min``/``-max``, placed
by the elastic slice, ROADMAP A.5), or where its ``vtpu.dev/qos`` class is
unknown.  AdmissionReview v1 in, a JSONPatch out.
"""

from __future__ import annotations

import base64
import json
import logging
from typing import List, Optional

from ..shim.preempt import PATH_ENV
from ..util import trace
from ..util.config import Config
from ..util.resources import container_requests
from ..placement.mesh import validate_mesh
from .gang import gang_of
from ..quota.queues import (QUEUE_ANNOTATION, QUEUE_STATE_ANNOTATION,
                            STATE_HELD, queue_for_namespace)
from ..util.types import (
    ENV_TASK_PRIORITY,
    MESH_ANNOTATION,
    MESH_MAX_ANNOTATION,
    MESH_MIN_ANNOTATION,
    QOS_ANNOTATION,
    QOS_CLASSES,
)

log = logging.getLogger(__name__)

#: The injected volume and its mount; a pod that already has one of these
#: names keeps its own.
PODINFO_VOLUME = "vtpu-podinfo"
PODINFO_MOUNT_PATH = "/etc/vtpu-podinfo"


def _is_privileged(container: dict) -> bool:
    return bool(container.get("securityContext", {}).get("privileged", False))


def _append(patches: List[dict], path: str, exists: bool, entry) -> None:
    """Add ``entry`` to the list at ``path``, creating the list where it
    does not ``exist``."""
    if exists:
        patches.append({"op": "add", "path": f"{path}/-", "value": entry})
    else:
        patches.append({"op": "add", "path": path, "value": [entry]})


def mutate_pod(pod: dict, cfg: Config, trace_id: str = "",
               info: Optional[dict] = None,
               namespace: str = "") -> List[dict]:
    """The JSONPatch ops for one pod (empty: no mutation).  ``info``, when
    given, receives ``wants_gpu``: whether the pod asks for cards.
    ``namespace`` is the AdmissionReview's (a pod CREATE often omits
    ``metadata.namespace``): the capacity queues' governance key."""
    containers = pod.get("spec", {}).get("containers", [])
    if any(_is_privileged(c) for c in containers):
        log.info("pod %s has a privileged container; not mutated",
                 pod.get("metadata", {}).get("name", "?"))
        return []
    try:
        requests = container_requests(pod, cfg)
    except ValueError as e:
        log.warning("webhook: unreadable resources: %s", e)
        return []

    patches: List[dict] = []
    wants_gpu = False
    needs_podinfo = []
    env_created: set = set()  # containers whose env list a patch created
    for i, (ctr, req) in enumerate(zip(containers, requests)):
        limits = dict(ctr.get("resources", {}).get("requests", {}))
        limits.update(ctr.get("resources", {}).get("limits", {}))
        if req.nums > 0:
            wants_gpu = True
        prio = limits.get(cfg.resources.priority)
        if prio is None:
            continue
        env = ctr.get("env", [])
        if not any(e.get("name") == ENV_TASK_PRIORITY for e in env):
            _append(patches, f"/spec/containers/{i}/env", bool(env),
                    {"name": ENV_TASK_PRIORITY, "value": str(prio)})
            if not env:
                env_created.add(i)
        try:
            low = int(str(prio).strip()) >= 1
        except ValueError:
            low = False
        if low and req.nums > 0:
            needs_podinfo.append(i)
    if needs_podinfo:
        patches.extend(_podinfo_patches(pod, needs_podinfo, env_created))
    if info is not None:
        info["wants_gpu"] = wants_gpu
    if not wants_gpu:
        return patches
    if pod.get("spec", {}).get("schedulerName", "") != cfg.scheduler_name:
        patches.append({"op": "add", "path": "/spec/schedulerName",
                        "value": cfg.scheduler_name})
    anns = pod.get("metadata", {}).get("annotations")
    new_anns: dict = {}
    if trace_id and (anns is None or trace.TRACE_ID_ANNOTATION not in anns):
        new_anns[trace.TRACE_ID_ANNOTATION] = trace_id
    q = _governing_queue(cfg, namespace or pod.get("metadata", {}).get(
        "namespace", "default"))
    if q is not None and (anns is None or QUEUE_STATE_ANNOTATION not in anns):
        new_anns[QUEUE_ANNOTATION] = q
        new_anns[QUEUE_STATE_ANNOTATION] = STATE_HELD
    if new_anns and anns is None:
        patches.append({"op": "add", "path": "/metadata/annotations",
                        "value": new_anns})
    else:
        for k, v in new_anns.items():
            # The '/' of the key, escaped for the JSON pointer.
            key = k.replace("~", "~0").replace("/", "~1")
            patches.append({"op": "add",
                            "path": f"/metadata/annotations/{key}",
                            "value": v})
    return patches


def _governing_queue(cfg: Config, namespace: str) -> Optional[str]:
    """The name of the capacity queue governing ``namespace`` (None:
    ungoverned, or no quota config)."""
    if not cfg.quota_queues:
        return None
    q = queue_for_namespace(cfg.quota_queues, namespace)
    return q.name if q is not None else None


def _podinfo_patches(pod: dict, container_idxs: List[int],
                     env_created: set) -> List[dict]:
    """The downward-API annotations volume, and each container's mount and
    env.  ``env_created``: containers whose env list an earlier patch of
    this mutation created (JSONPatch applies in order, so those take
    ``env/-``; a second ``add env`` would replace the first)."""
    patches: List[dict] = []
    spec = pod.get("spec", {})
    volumes = spec.get("volumes", [])
    if not any(v.get("name") == PODINFO_VOLUME for v in volumes):
        _append(patches, "/spec/volumes", bool(volumes), {
            "name": PODINFO_VOLUME,
            "downwardAPI": {"items": [{
                "path": "annotations",
                "fieldRef": {"fieldPath": "metadata.annotations"},
            }]},
        })
    containers = spec.get("containers", [])
    for i in container_idxs:
        ctr = containers[i]
        mounts = ctr.get("volumeMounts", [])
        if not any(m.get("name") == PODINFO_VOLUME for m in mounts):
            _append(patches, f"/spec/containers/{i}/volumeMounts",
                    bool(mounts),
                    {"name": PODINFO_VOLUME, "mountPath": PODINFO_MOUNT_PATH,
                     "readOnly": True})
        env = ctr.get("env", [])
        if not any(e.get("name") == PATH_ENV for e in env):
            _append(patches, f"/spec/containers/{i}/env",
                    bool(env) or i in env_created,
                    {"name": PATH_ENV,
                     "value": f"{PODINFO_MOUNT_PATH}/annotations"})
    return patches


def validate_pod_mesh(pod: dict, cfg: Config,
                      topologies=None) -> Optional[str]:
    """Admission-time ``vtpu.dev/mesh`` validation: the shape parses, its
    volume is the pod's card count times its gang's members (axis 0
    dividing across them), and its local mesh is realizable on at least
    one fabric in the fleet.  The user-facing refusal, or None.
    ``topologies`` is an iterable of TopologyDesc or a callable giving one
    (the extender passes ``Scheduler.known_topologies``); none skips the
    fleet check, so the first pod of a cluster whose agents have not
    registered yet is not refused."""
    anns = pod.get("metadata", {}).get("annotations") or {}
    mesh_value = anns.get(MESH_ANNOTATION, "")
    if not mesh_value:
        return None
    try:
        requests = container_requests(pod, cfg)
    except ValueError as e:
        return (f"{MESH_ANNOTATION} {mesh_value!r}: cannot validate "
                f"against unparseable resources: {e}")
    nums = max((r.nums for r in requests), default=0)
    gang = gang_of(pod)
    gang_total = gang[1] if gang is not None else 1
    topos = list(topologies() if callable(topologies)
                 else (topologies or ()))
    why = validate_mesh(mesh_value, nums, gang_total, topos)
    if why is None:
        return None
    return f"{MESH_ANNOTATION}: {why}"


def validate_pod_mesh_range(pod: dict) -> Optional[str]:
    """The refusal of a pod that declares an elastic mesh range, or None:
    the port places no elastic mesh yet."""
    anns = pod.get("metadata", {}).get("annotations") or {}
    if not (anns.get(MESH_MIN_ANNOTATION) or anns.get(MESH_MAX_ANNOTATION)):
        return None
    return (f"{MESH_MIN_ANNOTATION}/{MESH_MAX_ANNOTATION}: elastic mesh "
            "ranges are not placed by this scheduler: they are placed by "
            "the elastic slice (ROADMAP A.5)")


def validate_pod_qos(pod: dict) -> Optional[str]:
    """The user-facing refusal for an unknown ``vtpu.dev/qos`` class (it
    would run as best-effort, the region's default, without a word), or
    None."""
    anns = pod.get("metadata", {}).get("annotations") or {}
    value = anns.get(QOS_ANNOTATION)
    if value is None or value in QOS_CLASSES:
        return None
    return (f"{QOS_ANNOTATION}: unknown QoS class {value!r} "
            f"(expected one of: {', '.join(QOS_CLASSES)})")


def handle_admission_review(body: dict, cfg: Config,
                            topologies=None) -> dict:
    """AdmissionReview in, AdmissionReview out.  ``topologies``: the
    fleet's fabrics for the mesh check (see :func:`validate_pod_mesh`).
    Only pods that ask for cards get a trace id and a webhook span (the
    webhook sees every pod CREATE of the cluster)."""
    req = body.get("request", {})
    uid = req.get("uid", "")
    response = {"uid": uid, "allowed": True}
    pod = req.get("object")
    if isinstance(pod, dict) and req.get("operation", "CREATE") == "CREATE":
        why = validate_pod_mesh(pod, cfg, topologies) \
            or validate_pod_mesh_range(pod) or validate_pod_qos(pod)
        if why is not None:
            log.warning("webhook: refusing pod %s: %s",
                        pod.get("metadata", {}).get("name", "?"), why)
            return {
                "apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview",
                "response": {"uid": uid, "allowed": False,
                             "status": {"code": 422, "reason": "Invalid",
                                        "message": why}},
            }
        trace_id = trace.trace_id_of(pod) or trace.new_trace_id()
        info: dict = {}
        sp = trace.Span("webhook", trace_id)
        patches = mutate_pod(pod, cfg, trace_id=trace_id, info=info,
                             namespace=req.get("namespace", ""))
        if info.get("wants_gpu"):
            meta = pod.get("metadata", {})
            sp.set("pod", meta.get("name", "?"))
            sp.set("patch_ops", len(patches))
            qos = (meta.get("annotations") or {}).get(QOS_ANNOTATION, "")
            if qos:
                sp.set("qos", qos)
            trace.tracer().finish(sp)
            if patches:
                trace.tracer().event(meta.get("uid", ""), "webhook-mutated",
                                     trace_id=trace_id,
                                     patch_ops=len(patches))
        if patches:
            response["patchType"] = "JSONPatch"
            response["patch"] = base64.b64encode(
                json.dumps(patches).encode()).decode()
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "response": response}
