"""Multi-tenant capacity queues: quota, weighted fair share, borrowing
(the port's copy of the JAX package's ``quota/``).

Pods in governed namespaces are *held* at creation (``vtpu.dev/queue`` +
``vtpu.dev/queue-state: held``), an admission loop releases them in
weighted dominant-resource fair-share order against per-tenant nominal
quotas with cohort borrowing, and a starved in-quota tenant reclaims
*borrowed* grants through the scheduler's checkpoint-first preemption
requests.  Ungoverned namespaces bypass the layer entirely.  A ready pod
group is released all at once; while one accumulates members, smaller
pods are backfilled around its footprint, and a gang reclaims only once
it has all its members, for its whole footprint.  The elastic shrink pass
waits for the elastic slice (ROADMAP A.5).
"""

from .admission import AdmissionConfig, AdmissionLoop
from .fairshare import (dominant_share, effective_weight, fair_share_order,
                        queue_efficiencies)
from .queues import (
    QUEUE_ANNOTATION,
    QUEUE_POSITION_ANNOTATION,
    QUEUE_STATE_ANNOTATION,
    RUNTIME_ESTIMATE_ANNOTATION,
    STATE_ADMITTED,
    STATE_HELD,
    QueueConfig,
    QueueEntry,
    QueueUsage,
    QuotaManager,
    demand_of,
    grant_chips,
    parse_quota_config,
    queue_for_namespace,
)
from .reclaim import plan_reclaim

__all__ = [
    "AdmissionConfig",
    "AdmissionLoop",
    "QUEUE_ANNOTATION",
    "QUEUE_POSITION_ANNOTATION",
    "QUEUE_STATE_ANNOTATION",
    "RUNTIME_ESTIMATE_ANNOTATION",
    "STATE_ADMITTED",
    "STATE_HELD",
    "QueueConfig",
    "QueueEntry",
    "QueueUsage",
    "QuotaManager",
    "demand_of",
    "dominant_share",
    "effective_weight",
    "fair_share_order",
    "grant_chips",
    "parse_quota_config",
    "plan_reclaim",
    "queue_efficiencies",
    "queue_for_namespace",
]
