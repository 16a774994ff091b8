"""Capacity queues: per-tenant quota state and the Filter gate (the port's
copy of the JAX package's ``quota/queues.py``).

One :class:`QueueConfig` per tenant queue; its namespaces are what it
governs.  Queues group into *cohorts*: a queue may exceed its nominal quota
into its cohort's unused capacity, up to its borrowing limit and never past
the cohort's summed nominal, and everything above nominal is *borrowed*:
the set the reclaimer may evict.  :class:`QuotaManager` holds the held and
released entries by pod uid; usage is computed from the scheduler's grant
registry.  A restarted scheduler re-learns held and admitted pods from the
``vtpu.dev/queue-state`` annotations (the write-ahead log).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from ..k8s.client import pod_annotations, pod_name, pod_namespace, pod_uid
from ..util import perf
from ..util.types import ASSIGNED_NODE_ANNOTATION, QOS_ANNOTATION

#: Written by the webhook on governed pods: the capacity queue's name.
QUEUE_ANNOTATION = "vtpu.dev/queue"
#: ``held`` until the admission loop releases the pod; ``admitted`` after.
QUEUE_STATE_ANNOTATION = "vtpu.dev/queue-state"
#: Published by the admission loop while held ("position/total").
QUEUE_POSITION_ANNOTATION = "vtpu.dev/queue-position"
#: A user's hint of a pod's runtime, for the gang backfill rule: a held pod
#: declaring a runtime shorter than a waiting gang's reservation window
#: may be released ahead of the gang, into cards the gang will need.
RUNTIME_ESTIMATE_ANNOTATION = "vtpu.dev/estimated-runtime-seconds"

STATE_HELD = "held"
STATE_ADMITTED = "admitted"

#: A held entry no longer seen (no gate retry, no informer event: possible
#: only without a watch, where a DELETE never arrives) is dropped after
#: this long.
ENTRY_TTL_S = 1800.0


@dataclasses.dataclass(frozen=True)
class QueueConfig:
    """One tenant queue.  A zero nominal on cards means no entitlement
    (everything it holds is borrowed); a zero nominal on memory leaves that
    dimension unconstrained."""

    name: str
    namespaces: Tuple[str, ...]
    cohort: str = ""
    weight: float = 1.0
    nominal_chips: int = 0
    nominal_hbm_mib: int = 0
    borrow_limit_chips: int = 0
    borrow_limit_hbm_mib: int = 0


def parse_quota_config(doc) -> Tuple[QueueConfig, ...]:
    """``{"queues": [...]}`` (the --quota-config file and the chart's
    values) -> QueueConfig tuple.  Raises ValueError on a duplicate queue
    name, a namespace two queues govern, or a weight <= 0."""
    if not doc:
        return ()
    queues: List[QueueConfig] = []
    seen_ns: Dict[str, str] = {}
    for entry in doc.get("queues", []):
        quota = entry.get("quota", {})
        q = QueueConfig(
            name=entry["name"],
            namespaces=tuple(entry.get("namespaces", ())),
            cohort=entry.get("cohort", ""),
            weight=float(entry.get("weight", 1.0)),
            nominal_chips=int(quota.get("chips", 0)),
            nominal_hbm_mib=int(quota.get("hbm_mib", 0)),
            borrow_limit_chips=int(entry.get("borrow_limit_chips", 0)),
            borrow_limit_hbm_mib=int(entry.get("borrow_limit_hbm_mib", 0)),
        )
        if q.weight <= 0:
            raise ValueError(f"queue {q.name}: weight must be > 0")
        if any(q.name == p.name for p in queues):
            raise ValueError(f"duplicate queue name {q.name}")
        for ns in q.namespaces:
            if ns in seen_ns:
                raise ValueError(
                    f"namespace {ns} governed by both {seen_ns[ns]} "
                    f"and {q.name}")
            seen_ns[ns] = q.name
        queues.append(q)
    return tuple(queues)


def queue_for_namespace(queues: Iterable[Mapping or QueueConfig],
                        namespace: str) -> Optional[QueueConfig]:
    """The queue governing ``namespace`` (None: ungoverned), from parsed
    QueueConfigs or the raw dicts Config carries (the webhook's read)."""
    for q in queues:
        if isinstance(q, QueueConfig):
            if namespace in q.namespaces:
                return q
        elif namespace in q.get("namespaces", ()):
            return parse_quota_config({"queues": [q]})[0]
    return None


@dataclasses.dataclass
class QueueEntry:
    """One held or released pod of a queue."""

    uid: str
    name: str
    namespace: str
    queue: str
    chips: int
    mem_mib: int
    #: The pod group and its total (gang members release together).
    gang: Optional[str] = None
    gang_total: int = 0
    runtime_estimate_s: float = 0.0
    #: ``vtpu.dev/qos`` ("": unclassed).  A best-effort backfill also needs
    #: the fleet's measured idle cards (admission.py).
    qos: str = ""
    enqueued_at: float = 0.0
    last_seen: float = 0.0
    state: str = STATE_HELD
    released_at: Optional[float] = None
    #: The release ordinal ``release`` stamps: the fair-share order the
    #: admission loop let the pod through in.  A batched Filter cycle
    #: orders governed pods by it (clock readings tie on a simulated
    #: clock; the ordinal cannot).
    release_seq: Optional[int] = None
    #: The last published position ("pos/total", so a changed
    #: denominator is patched too).
    published_position: Optional[str] = None
    #: Whether the Queued event was sent (once an entry).
    hold_event_sent: bool = False


@dataclasses.dataclass
class QueueUsage:
    """Held capacity of one queue: granted pods plus released entries not
    yet placed (a release reserves quota until Filter places the pod)."""

    chips: int = 0
    mem_mib: int = 0

    def borrowed_chips(self, q: QueueConfig) -> int:
        return max(0, self.chips - q.nominal_chips)


def demand_of(requests) -> Tuple[int, int]:
    """(cards, MiB) a request list is charged as.  A percentage memory
    request resolves only at placement and charges 0 MiB here: cards are
    the primary quota axis."""
    chips = sum(r.nums for r in requests)
    mem = sum(r.nums * r.memreq for r in requests)
    return chips, mem


def grant_chips(pod_info) -> Tuple[int, int]:
    """(cards, MiB) a granted pod holds."""
    chips = mem = 0
    for container in pod_info.devices:
        for d in container:
            chips += 1
            mem += d.usedmem
    return chips, mem


class QuotaManager:
    """The queue registry.  Filter calls :meth:`gate`, the informer
    :meth:`observe_pod`, the admission loop reads and releases entries,
    all under one small lock."""

    def __init__(self, quota_queues=(), clock=None) -> None:
        self.queues: Dict[str, QueueConfig] = {}
        self._by_ns: Dict[str, QueueConfig] = {}
        for q in (quota_queues if quota_queues
                  and isinstance(quota_queues[0], QueueConfig)
                  else parse_quota_config({"queues": list(quota_queues)})):
            self.queues[q.name] = q
            for ns in q.namespaces:
                self._by_ns[ns] = q
        self._clock = clock or time.monotonic
        # Wait/hold telemetry under lock="quota" on /perfz.
        self._lock = perf.TimedLock("quota")
        self._entries: Dict[str, QueueEntry] = {}
        #: Released pods over the lifetime, per queue
        #: (vtpu_queue_admitted_total).
        self.admitted_total: Dict[str, int] = {
            name: 0 for name in self.queues}
        #: Reclaim plans issued (vtpu_reclaims_total).
        self.reclaims_total = 0
        #: Released entries whose admitted-state patch failed: retried
        #: next tick (the release in memory stands).
        self._release_unwritten: set = set()
        #: The source of QueueEntry.release_seq.
        self._release_counter = 0

    @property
    def enabled(self) -> bool:
        return bool(self.queues)

    def governed(self, namespace: str) -> Optional[QueueConfig]:
        return self._by_ns.get(namespace)

    # -- Filter gate -----------------------------------------------------------
    def gate(self, pod: dict, requests) -> Optional[str]:
        """None = pass (ungoverned, or admitted), else the hold reason
        Filter answers with.  A held pod the informer has not shown yet
        enters its queue here (kube-scheduler retries it)."""
        if not self.queues:
            return None
        q = self._by_ns.get(pod_namespace(pod))
        if q is None:
            return None
        uid = pod_uid(pod)
        if not uid:
            return None
        anns = pod_annotations(pod)
        now = self._clock()
        with self._lock:
            e = self._entries.get(uid)
            if e is None:
                # Admitted in a previous life, or already granted: never
                # held again.
                if anns.get(QUEUE_STATE_ANNOTATION) == STATE_ADMITTED \
                        or anns.get(ASSIGNED_NODE_ANNOTATION):
                    return None
                e = self._make_entry(pod, q, requests, now)
                self._entries[uid] = e
            e.last_seen = now
            if e.state == STATE_ADMITTED:
                return None
            pos, total = self._position_locked(e)
            return (f"held in capacity queue {q.name} "
                    f"(position {pos}/{total}; fair-share admission)")

    @staticmethod
    def _make_entry(pod: dict, q: QueueConfig, requests,
                    now: float) -> QueueEntry:
        # Deferred: the scheduler package imports the queues.
        from ..scheduler.gang import gang_of

        chips, mem = demand_of(requests)
        gang = gang_of(pod)
        anns = pod_annotations(pod)
        try:
            runtime = float(anns.get(RUNTIME_ESTIMATE_ANNOTATION, "0"))
        except ValueError:
            runtime = 0.0
        return QueueEntry(
            uid=pod_uid(pod), name=pod_name(pod),
            namespace=pod_namespace(pod), queue=q.name,
            chips=chips, mem_mib=mem,
            gang=gang[0] if gang else None,
            gang_total=gang[1] if gang else 0,
            runtime_estimate_s=max(0.0, runtime),
            qos=anns.get(QOS_ANNOTATION, "") or "",
            enqueued_at=now, last_seen=now)

    def _position_locked(self, e: QueueEntry) -> Tuple[int, int]:
        """(1-based position among e's queue's held entries, total held),
        FIFO by (enqueued_at, uid)."""
        held = sorted(
            (x for x in self._entries.values()
             if x.queue == e.queue and x.state == STATE_HELD),
            key=lambda x: (x.enqueued_at, x.uid))
        for i, x in enumerate(held):
            if x.uid == e.uid:
                return i + 1, len(held)
        return len(held), len(held)

    # -- informer sync ---------------------------------------------------------
    def observe_pod(self, event: str, pod: dict, requests_fn=None) -> None:
        """Keep the entries in step with the informer: a deleted or placed
        pod leaves its queue; a listed held or admitted pod never seen
        (after a restart) is learned from its annotations."""
        if not self.queues:
            return
        uid = pod_uid(pod)
        if not uid:
            return
        if event == "DELETED":
            self.forget(uid)
            return
        q = self._by_ns.get(pod_namespace(pod))
        if q is None:
            return
        anns = pod_annotations(pod)
        if anns.get(ASSIGNED_NODE_ANNOTATION):
            # Placed: its usage is charged through the grant registry now.
            self.forget(uid)
            return
        state = anns.get(QUEUE_STATE_ANNOTATION)
        if state not in (STATE_HELD, STATE_ADMITTED):
            return
        now = self._clock()
        with self._lock:
            e = self._entries.get(uid)
            if e is None:
                if requests_fn is None:
                    return
                try:
                    requests = requests_fn(pod)
                except Exception:  # noqa: BLE001 — a malformed pod never breaks the sync
                    return
                if not any(r.nums > 0 for r in requests):
                    return
                e = self._make_entry(pod, q, requests, now)
                self._entries[uid] = e
            e.last_seen = now
            if state == STATE_ADMITTED and e.state == STATE_HELD:
                # The log says a previous scheduler released it.
                e.state = STATE_ADMITTED
                e.released_at = now

    def forget(self, uid: str) -> None:
        with self._lock:
            self._entries.pop(uid, None)
            self._release_unwritten.discard(uid)

    def note_unplaced(self, uid: str) -> None:
        """Filter found no node for a released pod: the reclaimer's
        'stuck' signal (the admission loop reads released_at)."""
        with self._lock:
            e = self._entries.get(uid)
            if e is not None:
                e.last_seen = self._clock()

    # -- the admission loop's surface ------------------------------------------
    def release(self, uid: str) -> Optional[QueueEntry]:
        """Mark one held entry admitted (the truth in memory; the caller
        writes the annotation).  Returns the entry's snapshot."""
        with self._lock:
            e = self._entries.get(uid)
            if e is None or e.state != STATE_HELD:
                return None
            e.state = STATE_ADMITTED
            e.released_at = self._clock()
            self._release_counter += 1
            e.release_seq = self._release_counter
            self.admitted_total[e.queue] = \
                self.admitted_total.get(e.queue, 0) + 1
            return dataclasses.replace(e)

    def entries(self) -> List[QueueEntry]:
        with self._lock:
            return [dataclasses.replace(e) for e in self._entries.values()]

    def release_seq_of(self, uid: str) -> Optional[int]:
        """The release ordinal of an admitted pod (None for an ungoverned,
        held or unknown uid): a batched cycle's order among governed
        pods."""
        with self._lock:
            e = self._entries.get(uid)
            return e.release_seq if e is not None else None

    def entry(self, uid: str) -> Optional[QueueEntry]:
        with self._lock:
            e = self._entries.get(uid)
            return dataclasses.replace(e) if e is not None else None

    def set_published_position(self, uid: str, pos: Optional[str],
                               hold_event: bool = False) -> None:
        with self._lock:
            e = self._entries.get(uid)
            if e is not None:
                e.published_position = pos
                if hold_event:
                    e.hold_event_sent = True

    def prune_with(self, is_granted, now: Optional[float] = None) -> None:
        """Drop the released entries whose pod is placed (``is_granted``:
        a uid test; they are charged through the registry now) and the
        entries unseen past ENTRY_TTL_S."""
        now = self._clock() if now is None else now
        with self._lock:
            for uid in [u for u, e in self._entries.items()
                        if (e.state == STATE_ADMITTED and is_granted(u))
                        or now - e.last_seen > ENTRY_TTL_S]:
                del self._entries[uid]
                self._release_unwritten.discard(uid)

    # -- usage and quota arithmetic --------------------------------------------
    def usage(self, pods) -> Dict[str, QueueUsage]:
        """Per-queue held capacity: the granted pods of governed namespaces
        plus the released entries not yet granted (each pod once)."""
        out = {name: QueueUsage() for name in self.queues}
        granted = set()
        for p in pods:
            q = self._by_ns.get(p.namespace)
            granted.add(p.uid)
            if q is None:
                continue
            chips, mem = grant_chips(p)
            out[q.name].chips += chips
            out[q.name].mem_mib += mem
        with self._lock:
            for e in self._entries.values():
                if e.state == STATE_ADMITTED and e.uid not in granted:
                    out[e.queue].chips += e.chips
                    out[e.queue].mem_mib += e.mem_mib
        return out

    def usage_from(self, ns_usage, is_granted) -> Dict[str, QueueUsage]:
        """:meth:`usage` from per-namespace (cards, MiB) aggregates of the
        grant registry and a granted-uid test, both of one instant
        (``PodManager.ns_usage_snapshot``)."""
        out = {name: QueueUsage() for name in self.queues}
        for ns, (chips, mem) in ns_usage.items():
            q = self._by_ns.get(ns)
            if q is not None:
                out[q.name].chips += chips
                out[q.name].mem_mib += mem
        with self._lock:
            for e in self._entries.values():
                if e.state == STATE_ADMITTED and not is_granted(e.uid):
                    out[e.queue].chips += e.chips
                    out[e.queue].mem_mib += e.mem_mib
        return out

    def cohort_members(self, q: QueueConfig) -> List[QueueConfig]:
        """The queues of ``q``'s cohort; an empty cohort is private (the
        queue alone)."""
        if not q.cohort:
            return [q]
        return [m for m in self.queues.values() if m.cohort == q.cohort]

    def fits_quota(self, q: QueueConfig, usage: Dict[str, QueueUsage],
                   chips: int, mem_mib: int) -> Tuple[bool, str]:
        """Would admitting (chips, mem) keep ``q`` inside its nominal plus
        borrowing limit, and its cohort inside the members' summed nominal
        (borrowing redistributes unused entitlement, it adds none)?"""
        u = usage.get(q.name, QueueUsage())
        if u.chips + chips > q.nominal_chips + q.borrow_limit_chips:
            return False, (f"queue {q.name} at its borrowing limit "
                           f"({u.chips}+{chips} > {q.nominal_chips}"
                           f"+{q.borrow_limit_chips} chips)")
        if q.nominal_hbm_mib > 0 and mem_mib > 0 and \
                u.mem_mib + mem_mib > q.nominal_hbm_mib \
                + q.borrow_limit_hbm_mib:
            return False, f"queue {q.name} over its HBM quota"
        members = self.cohort_members(q)
        total_nominal = sum(m.nominal_chips for m in members)
        if total_nominal > 0:
            total_held = sum(usage.get(m.name, QueueUsage()).chips
                             for m in members)
            if total_held + chips > total_nominal:
                return False, (f"cohort {q.cohort or q.name} exhausted "
                               f"({total_held}+{chips} > {total_nominal} "
                               "chips)")
        nominal_hbm = sum(m.nominal_hbm_mib for m in members)
        if nominal_hbm > 0 and mem_mib > 0:
            held_hbm = sum(usage.get(m.name, QueueUsage()).mem_mib
                           for m in members)
            if held_hbm + mem_mib > nominal_hbm:
                return False, f"cohort {q.cohort or q.name} HBM exhausted"
        return True, ""

    # -- observability ---------------------------------------------------------
    def stats(self, pods) -> dict:
        """What the exporter and ``GET /queuez`` read, in one consistent
        read: usage from ``pods`` (the registry's list), the entries under
        the lock."""
        from .fairshare import dominant_share

        usage = self.usage(pods)
        entries = self.entries()
        rows = []
        for name, q in sorted(self.queues.items()):
            u = usage[name]
            held = sorted((e for e in entries
                           if e.queue == name and e.state == STATE_HELD),
                          key=lambda e: (e.enqueued_at, e.uid))
            released = [e for e in entries
                        if e.queue == name and e.state == STATE_ADMITTED]
            rows.append({
                "queue": name,
                "cohort": q.cohort,
                "weight": q.weight,
                "nominal_chips": q.nominal_chips,
                "nominal_hbm_mib": q.nominal_hbm_mib,
                "borrow_limit_chips": q.borrow_limit_chips,
                "held_chips": u.chips,
                "held_hbm_mib": u.mem_mib,
                "borrowed_chips": u.borrowed_chips(q),
                "fair_share": round(dominant_share(u, q) / q.weight, 6),
                "pending": len(held),
                "released_unplaced": len(released),
                "admitted_total": self.admitted_total.get(name, 0),
                "namespaces": list(q.namespaces),
                "pending_pods": [
                    {"pod": f"{e.namespace}/{e.name}", "position": i + 1,
                     "chips": e.chips, "gang": e.gang}
                    for i, e in enumerate(held)],
            })
        return {"queues": rows, "reclaims_total": self.reclaims_total}
