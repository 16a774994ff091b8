"""Multi-tenant capacity queues: quota, weighted fair share, borrowing
(the port's copy of the JAX package's ``quota/``).

Pods in governed namespaces are *held* at creation (``vtpu.dev/queue`` +
``vtpu.dev/queue-state: held``), an admission loop releases them in
weighted dominant-resource fair-share order against per-tenant nominal
quotas with cohort borrowing, and a starved in-quota tenant reclaims
*borrowed* grants through the scheduler's checkpoint-first preemption
requests.  Ungoverned namespaces bypass the layer entirely.  Pod groups
are refused at Filter until the gang slice (ROADMAP A.5), so no queue
entry is ever a gang member: the JAX loop's gang release, gang backfill
and gang reclaim are left out, and so is the elastic shrink pass.
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
