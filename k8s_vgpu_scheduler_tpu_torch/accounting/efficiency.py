"""Granted-vs-actual join: efficiency scores and idle-grant findings (the
port's copy of the JAX package's ``accounting/efficiency.py``).

The scheduler's registry knows what every pod was *granted* (cards,
memory, cores); the ledger knows what each pod *actually* did
(GPU-seconds, byte-seconds).  This module joins the two:

- per-pod **efficiency** = actual chip-seconds / granted chip-seconds
  over a trailing window (granted chip-seconds = granted cards × window
  covered by reports: a pod holding 4 cards for 100 s was granted 400
  whether or not it launched anything);
- **idle grants**: pods whose grant has accrued ~nothing for longer than
  a configurable grace, surfaced instead of silently wasting the fleet;
- the ``--score-by-actual`` placement signal: a bounded bonus for nodes
  whose *measured* utilization is low, added to the granted-capacity
  score at selection time.

Standard library only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .ledger import UsageLedger


@dataclasses.dataclass(frozen=True)
class EfficiencyConfig:
    #: Trailing window the efficiency ratio is computed over.
    window_s: float = 300.0
    #: How long a grant must accrue ~nothing before it is an idle finding.
    idle_grace_s: float = 600.0
    #: Chip-seconds below this over the window count as "nothing".
    idle_epsilon: float = 1e-6


@dataclasses.dataclass
class PodEfficiency:
    uid: str
    name: str
    namespace: str
    node: str
    granted_chips: int
    granted_mem_mib: int
    granted_cores: int
    #: Window actually covered by reports (≤ cfg.window_s).
    window_s: float
    actual_chip_seconds: float
    granted_chip_seconds: float
    #: None = no usage reports for this pod (node without a monitor) —
    #: unknown, which is different from measured-zero.
    efficiency: Optional[float]
    idle_for_s: float
    idle: bool
    oversubscribe: bool


@dataclasses.dataclass
class FleetEfficiency:
    pods: List[PodEfficiency]
    #: The idle subset, sorted by wasted granted chip-seconds (worst first).
    idle: List[PodEfficiency]
    #: Fleet totals cover MEASURED pods only (efficiency is not None);
    #: :func:`showback` additionally charges unmeasured grants at the
    #: full window so namespace/fleet rollups can't flatter themselves.
    fleet_granted_chip_seconds: float
    fleet_actual_chip_seconds: float

    @property
    def fleet_efficiency(self) -> Optional[float]:
        if self.fleet_granted_chip_seconds <= 0:
            return None
        return (self.fleet_actual_chip_seconds
                / self.fleet_granted_chip_seconds)


def _grant_shape(pod) -> tuple:
    chips = mem = cores = 0
    for container in pod.devices:
        for d in container:
            chips += 1
            mem += d.usedmem
            cores += d.usedcores
    return chips, mem, cores


def grant_efficiency(pods, ledger: UsageLedger,
                     cfg: Optional[EfficiencyConfig] = None,
                     now: Optional[float] = None,
                     namespaces: Optional[Dict[str, str]] = None
                     ) -> FleetEfficiency:
    """Join live grants (``pods``: PodInfo list from the registry) against
    the ledger.  Pure function of its inputs — the virtual-clock tests and
    the simulator drive it with their own ``now``."""
    cfg = cfg or EfficiencyConfig()
    now = ledger.now() if now is None else now
    out: List[PodEfficiency] = []
    granted_total = actual_total = 0.0
    for pod in pods:
        chips, mem, cores = _grant_shape(pod)
        if chips == 0:
            continue
        acct = ledger.get(pod.uid)
        if acct is None:
            out.append(PodEfficiency(
                uid=pod.uid, name=pod.name, namespace=pod.namespace,
                node=pod.node, granted_chips=chips, granted_mem_mib=mem,
                granted_cores=cores, window_s=0.0,
                actual_chip_seconds=0.0, granted_chip_seconds=0.0,
                efficiency=None, idle_for_s=0.0, idle=False,
                oversubscribe=False))
            continue
        actual, _hbm, covered = ledger.window_usage(
            pod.uid, cfg.window_s, now=now)
        granted = chips * covered
        eff = (actual / granted) if granted > 0 else None
        idle_for = max(0.0, now - acct.last_active_at)
        idle = (idle_for >= cfg.idle_grace_s
                and actual <= cfg.idle_epsilon)
        out.append(PodEfficiency(
            uid=pod.uid, name=pod.name, namespace=pod.namespace,
            node=pod.node, granted_chips=chips, granted_mem_mib=mem,
            granted_cores=cores, window_s=covered,
            actual_chip_seconds=actual, granted_chip_seconds=granted,
            efficiency=eff, idle_for_s=idle_for, idle=idle,
            oversubscribe=acct.oversubscribe))
        granted_total += granted
        actual_total += actual
    idle = sorted((p for p in out if p.idle),
                  key=lambda p: -(p.granted_chip_seconds
                                  - p.actual_chip_seconds))
    return FleetEfficiency(pods=out, idle=idle,
                           fleet_granted_chip_seconds=granted_total,
                           fleet_actual_chip_seconds=actual_total)


def actual_idle_bonus(ledger: UsageLedger, node: str,
                      total_chips: int) -> float:
    """--score-by-actual placement signal: measured idle fraction of the
    node's chips, in [0, 1].  Comparable in magnitude to one chip's worth
    of the spread score (node_score sums per-chip free fractions), so it
    breaks ties toward measured-idle nodes without overriding a real
    granted-capacity difference of more than one chip.

    A node with no FRESH usage reports gets 0, not 1: 'unmonitored' is
    not 'idle', and handing unmeasured nodes the maximum bonus would
    steer placement toward exactly the nodes the signal knows nothing
    about.  (Stale accounts of deleted pods are likewise excluded by the
    ledger — see node_busy_chips.)"""
    if total_chips <= 0:
        return 0.0
    busy = ledger.node_busy_chips(node)
    if busy is None:
        return 0.0  # no fresh reports: no signal, neutral score
    return max(0.0, min(1.0, 1.0 - busy / total_chips))


def showback(pods, ledger: UsageLedger,
             cfg: Optional[EfficiencyConfig] = None,
             now: Optional[float] = None,
             window_s: Optional[float] = None) -> dict:
    """Per-namespace showback rows over a trailing window — the payload
    behind ``GET /usagez`` and the ``vgpu-report`` CLI.  Includes accounts
    whose pod already left the registry (they still used chips inside the
    window); their namespace is ``(unresolved)`` because the node-side
    container key carries uid+name only."""
    cfg = cfg or EfficiencyConfig()
    now = ledger.now() if now is None else now
    window = window_s if window_s is not None else cfg.window_s
    fleet = grant_efficiency(pods, ledger,
                             dataclasses.replace(cfg, window_s=window),
                             now=now)
    by_uid = {p.uid: p for p in fleet.pods}
    ns_rows: Dict[str, dict] = {}
    pod_rows = []

    def ns_row(namespace: str) -> dict:
        return ns_rows.setdefault(namespace, {
            "namespace": namespace, "pods": 0, "chip_seconds": 0.0,
            "hbm_byte_seconds": 0.0, "granted_chip_seconds": 0.0,
            "idle_grants": 0,
        })

    seen = set()
    ages = []
    for acct in ledger.accounts():
        chip_s, hbm_s, covered = ledger.window_usage(acct.uid, window,
                                                     now=now)
        pe = by_uid.get(acct.uid)
        namespace = pe.namespace if pe is not None else "(unresolved)"
        age = max(0.0, now - acct.last_recorded)
        ages.append(age)
        row = {
            "uid": acct.uid,
            "pod": pe.name if pe is not None else acct.name,
            "namespace": namespace,
            "node": acct.node,
            "chip_seconds": round(chip_s, 3),
            "hbm_byte_seconds": round(hbm_s, 3),
            "window_covered_s": round(covered, 3),
            # Freshness stamp: totals above are frozen at the newest
            # ledger sample — a consumer printing them must mark rows
            # STALE past its threshold instead of silently reporting
            # old numbers (vgpu-report / vgpu-smi staleness guard).
            "last_sample_age_s": round(age, 3),
            "granted_chips": pe.granted_chips if pe is not None else 0,
            "efficiency": (round(pe.efficiency, 4)
                           if pe is not None and pe.efficiency is not None
                           else None),
            "idle": pe.idle if pe is not None else False,
            "live": pe is not None,
        }
        pod_rows.append(row)
        agg = ns_row(namespace)
        agg["pods"] += 1
        agg["chip_seconds"] += chip_s
        agg["hbm_byte_seconds"] += hbm_s
        if pe is not None:
            agg["granted_chip_seconds"] += pe.granted_chip_seconds
            agg["idle_grants"] += int(pe.idle)
        seen.add(acct.uid)
    # Granted-but-never-reported pods still belong in their namespace's
    # granted column (their waste is 100% of the grant — invisible usage
    # must not look like efficient usage).  Charged at the full window
    # (the grant is held NOW and nothing was measured against it), with
    # zero measured chip-seconds, so a namespace full of unmonitored
    # grants rolls up to efficiency 0, never a flattering 1.0.  The
    # per-pod row keeps efficiency None — unknown stays distinguishable
    # from measured-idle at pod granularity.
    unmeasured_granted = 0.0
    for pe in fleet.pods:
        if pe.uid in seen:
            continue
        charged = pe.granted_chips * window
        unmeasured_granted += charged
        agg = ns_row(pe.namespace)
        agg["pods"] += 1
        agg["granted_chip_seconds"] += charged
        pod_rows.append({
            "uid": pe.uid, "pod": pe.name, "namespace": pe.namespace,
            "node": pe.node, "chip_seconds": 0.0, "hbm_byte_seconds": 0.0,
            "window_covered_s": 0.0, "granted_chips": pe.granted_chips,
            "last_sample_age_s": None,  # never reported ≠ stale
            "efficiency": None, "idle": False, "live": True,
        })
    for agg in ns_rows.values():
        g = agg["granted_chip_seconds"]
        agg["efficiency"] = (round(agg["chip_seconds"] / g, 4)
                             if g > 0 else None)
        agg["chip_seconds"] = round(agg["chip_seconds"], 3)
        agg["hbm_byte_seconds"] = round(agg["hbm_byte_seconds"], 3)
        agg["granted_chip_seconds"] = round(g, 3)
    fleet_granted = fleet.fleet_granted_chip_seconds + unmeasured_granted
    return {
        "window_s": window,
        "generated_at": now,
        # Fleet-level freshness: newest/oldest sample ages across every
        # retained account (None = no usage reports at all).  The CLIs'
        # staleness guard reads these before trusting any total.
        "newest_sample_age_s": round(min(ages), 3) if ages else None,
        "oldest_sample_age_s": round(max(ages), 3) if ages else None,
        "pods": sorted(pod_rows,
                       key=lambda r: (r["namespace"], r["pod"])),
        "namespaces": [ns_rows[k] for k in sorted(ns_rows)],
        "idle_grants": [dataclasses.asdict(p) for p in fleet.idle],
        "fleet": {
            "granted_chip_seconds": round(fleet_granted, 3),
            # Grants with no reports in the window, charged above —
            # surfaced so an operator can tell "low efficiency" from
            # "monitors not reporting".
            "unmeasured_granted_chip_seconds": round(
                unmeasured_granted, 3),
            "actual_chip_seconds": round(
                fleet.fleet_actual_chip_seconds, 3),
            "efficiency": (round(
                fleet.fleet_actual_chip_seconds / fleet_granted, 4)
                if fleet_granted > 0 else None),
        },
    }
