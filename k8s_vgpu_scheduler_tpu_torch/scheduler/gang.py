"""Gang scheduling: atomic placement of a multi-pod job (the port's copy of
the JAX package's ``scheduler/gang.py``).

A multi-process job (one ``torch.distributed`` process group across pods)
is N pods that must all start or none: a partial gang hangs the first
collective while it holds cards.  The reference schedules pods one at a
time and never enters this.

The mechanism, within the extender protocol:

- the job's pods carry ``vtpu.dev/pod-group: <name>`` and
  ``vtpu.dev/pod-group-total: <N>``;
- each member's Filter registers it with its group and fails with
  "waiting (k/N)" until all N have been seen (kube-scheduler retries an
  unschedulable pod, so the early members come back);
- the N-th member places the group atomically on one usage snapshot:
  every member gets a node and its cards, or none does;
- every member's grant is recorded at once in the pod registry, so no
  other Filter takes the reserved cards while the members' retries come
  in, and each member's retry collects its reserved node;
- each member gets a process rank, which the decision writes as
  ``vtpu.dev/pod-group-rank``: the node agent passes it to the container
  as ``VTPU_GANG_RANK`` and ``parallel/multihost.py`` hands it to
  ``torch.distributed``.

Placement prefers a set of nodes of one generation (a multi-node job is
built from identical hosts), and otherwise follows the same fit as a
single pod.  No torch, grpc or protobuf.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..util.types import (
    GANG_GROUP_ANNOTATION,
    GANG_TOTAL_ANNOTATION,
    ContainerDeviceRequest,
)
from .score import CowUsage

log = logging.getLogger(__name__)

#: Seconds after which a group whose members stopped filtering (its job
#: deleted mid-admission) loses its tentative grants.
GANG_EXPIRE_SECONDS = 600.0

#: An indexed Job's completion index: authoritative for the rank.
JOB_COMPLETION_INDEX_ANNOTATION = "batch.kubernetes.io/job-completion-index"


@dataclasses.dataclass
class GangMember:
    uid: str
    name: str
    namespace: str
    requests: List[ContainerDeviceRequest]
    #: The pod's annotations as observed: its type affinity and topology
    #: policy feed its fit at admission.
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Gang:
    key: str            # "<namespace>/<group>"
    total: int
    members: Dict[str, GangMember] = dataclasses.field(default_factory=dict)
    #: uid -> (node, devices) once admitted.
    placements: Dict[str, Tuple[str, list]] = dataclasses.field(
        default_factory=dict)
    #: uid -> process rank in [0, total).  A replacement member inherits
    #: its dead peer's rank; a survivor's rank never changes (its process
    #: holds it in the collective).
    ranks: Dict[str, int] = dataclasses.field(default_factory=dict)
    last_seen: float = 0.0

    @property
    def admitted(self) -> bool:
        """True once the group was placed (its members hold grants)."""
        return bool(self.placements)

    def assign_ranks(self, uids) -> None:
        """Rank the members of ``uids`` that have none.  Rank 0 must be
        the pod the user's ``pod-group-coordinator`` address names, so a
        member's ordinal comes first: its job-completion-index annotation,
        else a trailing ``-<n>`` in its name (indexed Jobs, StatefulSets).
        The rest take the lowest free rank in name order.  Never raises: a
        member beyond ``total`` stays unranked."""
        pending = [u for u in uids if u not in self.ranks]

        def ordinal(uid: str) -> Optional[int]:
            m = self.members.get(uid)
            if m is None:
                return None
            idx = m.annotations.get(JOB_COMPLETION_INDEX_ANNOTATION)
            if idx is not None and idx.isdigit():
                return int(idx)
            match = re.search(r"-(\d+)$", m.name)
            return int(match.group(1)) if match else None

        def by_name(uid: str) -> str:
            return self.members[uid].name if uid in self.members else uid

        taken = set(self.ranks.values())
        for u in sorted(pending, key=by_name):
            o = ordinal(u)
            if o is not None and 0 <= o < self.total and o not in taken:
                self.ranks[u] = o
                taken.add(o)
        free = iter(r for r in range(self.total) if r not in taken)
        for u in sorted(pending, key=by_name):
            if u in self.ranks:
                continue
            r = next(free, None)
            if r is None:
                log.warning("gang %s: no free rank for member %s (more "
                            "members than total=%d)", self.key, u,
                            self.total)
                continue
            self.ranks[u] = r
            taken.add(r)


def gang_of(pod: dict) -> Optional[Tuple[str, int]]:
    """(group name, total) where the pod declares a gang, else None."""
    anns = pod.get("metadata", {}).get("annotations") or {}
    group = anns.get(GANG_GROUP_ANNOTATION, "")
    if not group:
        return None
    try:
        total = int(anns.get(GANG_TOTAL_ANNOTATION, "0"))
    except ValueError:
        total = 0
    if total <= 0:
        return None
    return group, total


class GangConflictError(ValueError):
    """A member refused: a stale event of a deleted uid, a late member of
    a full admitted gang, or one past the total of a pending gang."""


class GangManager:
    """The group registry, under a lock of its own: a gang's Filter holds
    the scheduler's commit lock, but the informer and the rescuer read it
    too.  ``now`` (wall time by default; ``_now`` afterwards) dates the
    groups' progress and the tombstones."""

    def __init__(self, now=time.time) -> None:
        self._groups: Dict[str, Gang] = {}
        # uid -> time of its drop.  A deleted pod's uid never returns, so
        # a replayed ADDED of one is stale: admitted, it would bring a
        # dead pod's grant back; before admission, it would count a dead
        # member toward the quorum.
        self._dropped: Dict[str, float] = {}
        self._now = now
        self._lock = threading.RLock()

    def observe(self, namespace: str, group: str, total: int,
                member: GangMember) -> Gang:
        with self._lock:
            key = f"{namespace}/{group}"
            g = self._groups.get(key)
            if member.uid in self._dropped and \
                    self._now() - self._dropped[member.uid] \
                    <= GANG_EXPIRE_SECONDS and \
                    (g is None or member.uid not in g.members):
                raise GangConflictError(
                    f"gang {key}: stale event for dropped pod "
                    f"{member.name} ({member.uid}) rejected")
            if g is not None and g.placements:
                # An admitted gang's reservations outlive the informer's
                # churn.  A new member may only fill a freed slot (a dead
                # member's replacement); into a full gang it would re-run
                # the placement over bound members.
                if member.uid not in g.members and len(g.members) >= g.total:
                    raise GangConflictError(
                        f"gang {key}: already admitted with "
                        f"{g.total} members; late member {member.name} "
                        "rejected")
                if g.total != total:
                    log.warning("gang %s: ignoring conflicting total %d for "
                                "admitted group (total=%d)", key, total,
                                g.total)
            elif g is not None and g.total != total:
                g = None
            if g is not None and not g.placements \
                    and member.uid not in g.members \
                    and len(g.members) >= g.total:
                # More pending members than the total: more members than
                # ranks.  If a member dies, this pod's retry takes its slot.
                raise GangConflictError(
                    f"gang {key}: already has {g.total} pending members; "
                    f"extra member {member.name} rejected")
            if g is None:
                g = Gang(key=key, total=total)
                self._groups[key] = g
            g.members[member.uid] = member
            g.last_seen = self._now()
            return g

    def rank_of(self, uid: str) -> Optional[int]:
        """The uid's rank, or None where it is no ranked gang member."""
        with self._lock:
            for g in self._groups.values():
                if uid in g.ranks:
                    return g.ranks[uid]
        return None

    def is_reserved(self, uid: str) -> bool:
        """True while the pod holds an admitted gang placement: its grant
        must outlive an informer event without its decision."""
        if not self._groups:
            # The fast path of a fleet without gangs: the informer asks
            # for every pod event without a grant.
            return False
        with self._lock:
            return any(uid in g.placements for g in self._groups.values())

    def drop_member(self, uid: str, tombstone: bool = True) -> None:
        """Release one pod's membership, placement and rank.
        ``tombstone`` (an informer DELETE: the uid never returns) also
        records the uid, so a replayed ADDED is refused; a resync prune
        and the rescuer pass False (their view may be stale about a live
        pod)."""
        if not self._groups and not self._dropped:
            return
        with self._lock:
            now = self._now()
            for key in list(self._groups):
                g = self._groups[key]
                if tombstone and uid in g.members:
                    self._dropped[uid] = now
                g.members.pop(uid, None)
                g.placements.pop(uid, None)
                g.ranks.pop(uid, None)  # the replacement takes the rank
                if not g.members:
                    self._groups.pop(key)
            cutoff = now - GANG_EXPIRE_SECONDS
            self._dropped = {u: t for u, t in self._dropped.items()
                             if t >= cutoff}

    def expired(self) -> List[Gang]:
        """Groups without progress for GANG_EXPIRE_SECONDS.  Not removed:
        the caller releases what it can and calls :meth:`forget` once
        every member is resolved."""
        with self._lock:
            now = self._now()
            return [g for g in self._groups.values()
                    if now - g.last_seen > GANG_EXPIRE_SECONDS]

    def forget(self, key: str) -> None:
        with self._lock:
            self._groups.pop(key, None)

    def groups(self) -> Dict[str, Gang]:
        return self._groups


def place_gang(gang: Gang, usage_by_node: dict, fit_pod, node_score,
               default_policy: str, only_uids=None
               ) -> Optional[Dict[str, Tuple[str, list]]]:
    """Place every member (or only ``only_uids``: replacements joining an
    admitted gang whose placed peers are already charged) on one usage
    snapshot, all or none: uid -> (node, devices), or None.  The maps
    passed in are never written: each attempt lays a CowUsage trial view,
    each member and node a probe view over it, and a member's winning
    probe becomes the trial's, so later members see earlier members'
    grants and only the cards a placement touches are copied.

    Members go in uid order; nodes of one generation are tried first, the
    largest set first, then any node (for replacements: the generations
    holding the gang's placements first)."""
    by_gen: Dict[str, List[str]] = {}
    gen_of: Dict[str, str] = {}
    for name, (info, _usage) in usage_by_node.items():
        gen = info.topology.generation if info.topology else "?"
        gen_of[name] = gen
        by_gen.setdefault(gen, []).append(name)
    if only_uids is not None and gang.placements:
        placed_gens = {gen_of[node] for node, _ in gang.placements.values()
                       if node in gen_of}
        candidate_sets = sorted(
            (nodes for gen, nodes in by_gen.items() if gen in placed_gens),
            key=len, reverse=True)
        candidate_sets.append(list(usage_by_node.keys()))
    else:
        candidate_sets = sorted(by_gen.values(), key=len, reverse=True)
        if len(candidate_sets) > 1:
            candidate_sets.append(list(usage_by_node.keys()))

    for candidates in candidate_sets:
        trial = {name: (info, CowUsage(usage))
                 for name, (info, usage) in usage_by_node.items()}
        placements: Dict[str, Tuple[str, list]] = {}
        ok = True
        for uid in sorted(only_uids if only_uids is not None
                          else gang.members):
            m = gang.members[uid]
            best: Optional[Tuple[float, str, list, CowUsage]] = None
            for name in candidates:
                info, usage = trial[name]
                probe = CowUsage(usage)
                got = fit_pod(m.requests, probe, info.topology,
                              m.annotations, default_policy)
                if got is None:
                    continue
                s = node_score(probe)
                if best is None or s > best[0]:
                    best = (s, name, got, probe)
            if best is None:
                ok = False
                break
            _, name, got, probe = best
            trial[name] = (trial[name][0], probe)
            placements[uid] = (name, got)
        if ok:
            return placements
    return None
