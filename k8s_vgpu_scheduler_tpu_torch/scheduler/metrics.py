"""Cluster-level Prometheus metrics of the port's scheduler extender (its
copy of the JAX package's ``scheduler/metrics.py``).

Reference: cmd/scheduler/metrics.go:179–355 (ClusterManagerCollector over
InspectAllNodesUsage and GetScheduledPods, served on :9395).  Every family
of the JAX collector is emitted, in its order, with its name, help, type
and labels, so dashboards and alerts written for the JAX chart read the
port's text (``util/exposition.py`` writes it; no ``prometheus_client``).

Families whose source the port has carry values: grants per card and per
pod, ``node_tpu_memory_percentage``, preemption requests, leases,
quarantine, rescue, usage and efficiency from the ledger, idle grants,
the capacity queues (pending, admitted, fair share, borrowed cards,
reclaims), the shard layer (epoch, nodes owned and orphaned, adoptions,
the fenced commits' failures), slice availability and the largest free box (over
``placement/frag.py``'s views of the scheduler's snapshot), the cards
held in slice reservations and the defragmenter's plans, migrations,
completions and aborts, the capacity forecast (each queue's demand,
forecast, upper band, starvation ETA and drift, and the current and
recommended node counts, from ``export_capacity``), QoS wait and weights,
the phase latency and rejections from the tracer, the performance
observatory's phases, locks, informer lag and GC collections
(``util/perf.py``), the optimistic commit's conflicts, the evaluation
pool's size and busy peak, the failed decision writes, and the batched
cycles (their sizes, latencies and fallbacks by cause, the batch gate's
queue depth) and solve workers (live count, restarts, each worker's
evaluation latency) from ``scheduler/batch.py``'s engine.  Families whose
subsystem waits for ROADMAP A.5 are emitted as the JAX collector emits
them with that subsystem off, zero-valued or empty, so no series a
dashboard names ever vanishes: see :data:`A5_FAMILIES`.  Standard library
only.
"""

from __future__ import annotations

from typing import Dict, Iterable

from ..monitor.metrics import _fold_hist, qos_wait_family
from ..placement import frag as frag_mod
from ..util import perf, trace
from ..util.exposition import (
    CounterMetricFamily,
    GaugeMetricFamily,
    HistogramMetricFamily,
    MetricsServer,
)
from .core import Scheduler

#: Families whose source waits for ROADMAP A.5, each with the A.5 item
#: that fills it.  They are emitted as the JAX collector emits them with
#: the subsystem off: zero-valued where the family has no labels (or a
#: fixed label set), empty where its labels name live objects.
A5_FAMILIES = {
    "vtpu_audit_findings": "fleet audit",
    "vtpu_audit_sweeps": "fleet audit",
    "vtpu_audit_sweep_seconds": "fleet audit",
    "vtpu_audit_last_clean_timestamp": "fleet audit",
    "vtpu_slo_attainment_ratio": "SLO engine",
    "vtpu_slo_error_budget_remaining_ratio": "SLO engine",
    "vtpu_slo_burn_rate": "SLO engine",
    "vtpu_slo_burn_alerts": "SLO engine",
}

class ClusterCollector:
    def __init__(self, scheduler: Scheduler) -> None:
        self.scheduler = scheduler

    def collect(self) -> Iterable[GaugeMetricFamily]:
        mem_limit = GaugeMetricFamily(
            "tpu_device_memory_limit_mib",
            "Advertised HBM capacity of a TPU chip",
            labels=["node", "deviceuuid"],
        )
        mem_alloc = GaugeMetricFamily(
            "tpu_device_memory_allocated_mib",
            "HBM granted to pods on a TPU chip",
            labels=["node", "deviceuuid"],
        )
        shared_num = GaugeMetricFamily(
            "tpu_device_shared_num",
            "Number of pod grants sharing a TPU chip",
            labels=["node", "deviceuuid"],
        )
        core_alloc = GaugeMetricFamily(
            "tpu_device_core_allocated",
            "Compute percentage granted on a TPU chip",
            labels=["node", "deviceuuid"],
        )
        mem_pct = GaugeMetricFamily(
            "node_tpu_memory_percentage",
            "Fraction of node TPU HBM allocated",
            labels=["node"],
        )
        for node, usage in self.scheduler.inspect_all_nodes_usage().items():
            total = used = 0
            for u in usage.values():
                mem_limit.add_metric([node, u.id], u.total_mem)
                mem_alloc.add_metric([node, u.id], u.used_mem)
                shared_num.add_metric([node, u.id], u.used_slots)
                core_alloc.add_metric([node, u.id], u.used_cores)
                total += u.total_mem
                used += u.used_mem
            if total:
                mem_pct.add_metric([node], used / total)

        pod_mem = GaugeMetricFamily(
            "vtpu_pod_device_allocated_mib",
            "HBM granted to one pod on one chip",
            labels=["podnamespace", "podname", "deviceuuid"],
        )
        pod_cores = GaugeMetricFamily(
            "vtpu_pod_core_allocated",
            "Compute percentage granted to one pod on one chip",
            labels=["podnamespace", "podname", "deviceuuid"],
        )
        for pod in self.scheduler.pods.list_pods():
            for container in pod.devices:
                for g in container:
                    pod_mem.add_metric([pod.namespace, pod.name, g.uuid], g.usedmem)
                    pod_cores.add_metric([pod.namespace, pod.name, g.uuid], g.usedcores)

        preempts = CounterMetricFamily(
            "vtpu_preemption_requests",
            "Eviction requests written to victim pods (each one imposes a "
            "checkpoint/restore cycle on a workload)",
        )
        preempts.add_metric([], self.scheduler.preemptions_requested)

        conflicts = CounterMetricFamily(
            "vtpu_filter_commit_conflicts",
            "Optimistic Filter commits that lost their revision "
            "generation race and re-evaluated (a high rate means many "
            "concurrent Filters chase the same node — check node-policy "
            "spread and fleet headroom)",
        )
        conflicts.add_metric([], self.scheduler.commit_conflicts)

        # Batched scheduling cycles (batch.py), emitted with the gate off
        # too (filter_many drives the engine whatever the flag says).
        batch_size = HistogramMetricFamily(
            "vtpu_filter_batch_size",
            "Pods decided per batched scheduling cycle (the drain size "
            "of one tick; sustained 1s mean the gate never aggregates — "
            "check --batch-tick-ms against the Filter arrival rate)",
        )
        batch_lat = HistogramMetricFamily(
            "vtpu_filter_batch_cycle_seconds",
            "Wall-clock latency of one batched scheduling cycle "
            "(snapshot refresh + vectorized evaluation + joint solve + "
            "group commit + per-pod fallbacks)",
        )
        engine = getattr(self.scheduler, "batch", None)
        if engine is not None:
            buckets, total = engine.stats.size_histogram()
            batch_size.add_metric([], buckets, total)
            buckets, total = engine.stats.latency_histogram()
            batch_lat.add_metric([], buckets, total)

        # Solve workers (parallelcp/): zero-valued with the pool off.
        solve_workers = GaugeMetricFamily(
            "vtpu_solve_workers",
            "Live solve worker processes mapping the shared-memory "
            "columnar fleet read-only (0 = class evaluations run "
            "in-process; raise --solve-workers on multi-core boxes)",
        )
        solve_restarts = CounterMetricFamily(
            "vtpu_solve_worker_restarts",
            "Solve worker processes respawned after a crash, a "
            "stale-generation refusal or an unresponsive evaluation "
            "(each respawn remaps the columnar segments fresh; any "
            "failed dispatch falls back to the in-process evaluator)",
        )
        solve_eval = HistogramMetricFamily(
            "vtpu_solve_worker_eval_seconds",
            "Wall-clock latency of one offloaded class evaluation over "
            "one solve worker's row shard (measured in the worker, "
            "recorded by the parent at reply collection)",
            labels=["worker"],
        )
        solve_pool = getattr(engine, "pool", None)
        if solve_pool is not None:
            solve_workers.add_metric([], solve_pool.alive_count())
            solve_restarts.add_metric([], solve_pool.restarts_total)
            for i, ring in enumerate(solve_pool.latency):
                buckets, total = ring.prom()
                solve_eval.add_metric([str(i)], buckets, total)
        else:
            solve_workers.add_metric([], 0)
            solve_restarts.add_metric([], 0)

        pool_size = GaugeMetricFamily(
            "vtpu_filter_worker_pool_size",
            "Candidate-evaluation worker pool size (0 until the pool is "
            "first used, or when evaluation is in-thread)",
        )
        pool_size.add_metric([], self.scheduler.worker_pool_size)
        busy_peak = GaugeMetricFamily(
            "vtpu_filter_workers_busy_peak",
            "High-water mark of concurrently busy candidate-evaluation "
            "workers (peak/size ~ 1 means the pool saturates and "
            "--filter-workers may be raised)",
        )
        busy_peak.add_metric([], self.scheduler.workers_busy_peak)

        # Fleet health (health/): the leases, quarantine and rescuer keep
        # their own small locks, so a scrape never blocks a decision.
        lease_state = GaugeMetricFamily(
            "vtpu_node_lease_state",
            "Node heartbeat-lease state (0 healthy, 1 suspect = excluded "
            "from new placements, 2 dead = grants being rescued)",
            labels=["node"],
        )
        states = self.scheduler.leases.states()
        for node, st in sorted(states.items()):
            lease_state.add_metric([node], int(st))
        leases_unhealthy = GaugeMetricFamily(
            "vtpu_node_leases_unhealthy",
            "Nodes whose lease is currently Suspect or Dead (many at once "
            "is a lease-expiry storm: suspect a scheduler-side partition "
            "or overload before believing in mass node death)",
        )
        leases_unhealthy.add_metric(
            [], sum(1 for st in states.values() if int(st) > 0))
        chips_quar = GaugeMetricFamily(
            "vtpu_chips_quarantined",
            "Chips currently quarantined out of the schedulable set "
            "(flap damping / slice-neighbor containment)",
        )
        chips_quar.add_metric([], self.scheduler.quarantine.count())
        quarantines = CounterMetricFamily(
            "vtpu_chip_quarantines",
            "Chip quarantine entries over this scheduler's lifetime",
        )
        quarantines.add_metric(
            [], self.scheduler.quarantine.quarantines_total)
        rescued = CounterMetricFamily(
            "vtpu_rescued_pods",
            "Grants rescinded by the rescue sweep (stranded on a dead "
            "node, a quarantined chip, or vanished inventory); each one "
            "forces a pod back through scheduling",
        )
        rescued.add_metric([], self.scheduler.rescuer.rescued_total)

        # Usage accounting (accounting/): actual use per pod from the
        # ledger, and the granted-vs-actual efficiency join.
        u_chip = CounterMetricFamily(
            "vtpu_usage_chip_seconds",
            "Chip-seconds actually consumed by one pod (from node usage "
            "reports; compare against its granted chips over time)",
            labels=["podnamespace", "podname"],
        )
        u_hbm = CounterMetricFamily(
            "vtpu_usage_hbm_byte_seconds",
            "HBM byte-seconds actually held by one pod (occupancy "
            "integrated over time, from node usage reports)",
            labels=["podnamespace", "podname"],
        )
        eff_ratio = GaugeMetricFamily(
            "vtpu_grant_efficiency_ratio",
            "Actual / granted chip-seconds over the efficiency window "
            "(1 = the grant is fully used; near 0 = the classic idle-"
            "grant waste the fractional scheduler exists to prevent)",
            labels=["podnamespace", "podname"],
        )
        idle_grants = GaugeMetricFamily(
            "vtpu_idle_grants",
            "Live grants that accrued ~no chip-seconds past the idle "
            "grace — capacity held but unused (see /usagez and "
            "vtpu-report for the per-pod list)",
        )
        # Capacity queues, from one stats snapshot (empty, and the reclaim
        # counter at 0, without a quota config).
        q_pending = GaugeMetricFamily(
            "vtpu_queue_pending",
            "Pods held in one capacity queue awaiting fair-share "
            "admission (sustained nonzero with zero admissions is "
            "starvation — see the VtpuQueueStarvation alert)",
            labels=["queue"],
        )
        q_admitted = CounterMetricFamily(
            "vtpu_queue_admitted",
            "Pods released from one capacity queue by the admission "
            "loop over this scheduler's lifetime",
            labels=["queue"],
        )
        q_share = GaugeMetricFamily(
            "vtpu_queue_fair_share",
            "Weighted dominant-resource share of one queue (held / "
            "nominal / weight; the admission loop releases lowest "
            "first, so sustained imbalance means quota or weight "
            "misconfiguration)",
            labels=["queue"],
        )
        q_borrowed = GaugeMetricFamily(
            "vtpu_borrowed_chips",
            "Chips one queue holds beyond its nominal quota (borrowed "
            "from its cohort's unused capacity; the reclaimable set)",
            labels=["queue"],
        )
        q_reclaims = CounterMetricFamily(
            "vtpu_reclaims",
            "Reclaim plans issued for starved in-quota tenants (each "
            "one checkpoint-evicts borrowed grants)",
        )
        # getattr: a collector stub without the quota surface reads as
        # quota off, as in the JAX collector.
        quota = getattr(self.scheduler, "quota", None)
        quota_stats = None
        if quota is not None and quota.enabled:
            quota_stats = stats = quota.stats(
                self.scheduler.pods.list_pods())
            for row in stats["queues"]:
                q_pending.add_metric([row["queue"]], row["pending"])
                q_admitted.add_metric([row["queue"]],
                                      row["admitted_total"])
                q_share.add_metric([row["queue"]], row["fair_share"])
                q_borrowed.add_metric([row["queue"]],
                                      row["borrowed_chips"])
            q_reclaims.add_metric([], stats["reclaims_total"])
        else:
            q_reclaims.add_metric([], 0)

        # Placement: slice availability and the largest free box from
        # each node's whole free cards, the reservations and the
        # defragmenter's counters.
        slice_avail = GaugeMetricFamily(
            "vtpu_slice_availability",
            "Disjoint contiguous free boxes of one slice size (chips) "
            "admissible fleet-wide right now without any eviction — "
            "the fragmentation number large gangs live and die by",
            labels=["shape"],
        )
        max_box = GaugeMetricFamily(
            "vtpu_fleet_max_free_box",
            "Largest contiguous free box in the fleet (chips): the "
            "biggest slice/mesh grant that can admit without the "
            "defragmenter compacting",
        )
        reserved = GaugeMetricFamily(
            "vtpu_reserved_chips",
            "Chips held in slice reservations (a defrag compaction's "
            "assembled box awaiting its beneficiary; excluded from the "
            "schedulable set and the quota release throttle)",
        )
        defrag_plans = CounterMetricFamily(
            "vtpu_defrag_plans",
            "Compaction plans issued by the defragmenter (each migrates "
            "checkpointable victims to assemble a contiguous slice)",
        )
        defrag_migrations = CounterMetricFamily(
            "vtpu_defrag_migrations",
            "Victims asked to checkpoint-migrate by defrag plans (each "
            "one is a checkpoint/restore cycle imposed on a workload)",
        )
        defrag_completed = CounterMetricFamily(
            "vtpu_defrag_completed",
            "Compaction plans whose victims all checkpointed and "
            "exited (the assembled slice went to reservation)",
        )
        defrag_aborted = CounterMetricFamily(
            "vtpu_defrag_aborted",
            "Compaction plans aborted (a victim missed the checkpoint "
            "grace; requests rescinded, reservation returned)",
        )
        snap_fn = getattr(self.scheduler, "snapshot", None)
        if snap_fn is not None:
            views = frag_mod.fleet_views(snap_fn())
            for size, count in sorted(frag_mod.slice_availability(
                    views).items()):
                slice_avail.add_metric([str(size)], count)
            max_box.add_metric([], frag_mod.largest_free_box(views))
        # getattr: a collector stub without the placement surface reads
        # as the JAX collector reads it, zero.
        reservations = getattr(self.scheduler, "reservations", None)
        reserved.add_metric(
            [], reservations.total_chips() if reservations else 0)
        defrag = getattr(self.scheduler, "defrag", None)
        defrag_plans.add_metric(
            [], defrag.plans_total if defrag else 0)
        defrag_migrations.add_metric(
            [], defrag.migrations_total if defrag else 0)
        defrag_completed.add_metric(
            [], defrag.completed_total if defrag else 0)
        defrag_aborted.add_metric(
            [], defrag.aborted_total if defrag else 0)

        # Elastic mesh resizing (elastic/): always emitted, zero-valued
        # with --enable-elastic off or no elastic gang, over the bounded
        # requester and state vocabularies, never raw requester keys.
        resizes = CounterMetricFamily(
            "vtpu_resizes",
            "Gang mesh resizes begun (checkpoint-restart at a new "
            "rung), by direction (shrink/grow) and requesting "
            "subsystem (reclaim/defrag/grow/admission)",
            labels=["direction", "requester"],
        )
        elastic_pods = GaugeMetricFamily(
            "vtpu_elastic_pods",
            "Member pods of gangs declaring a mesh range, by state "
            "(at-max: running at mesh-max; shrunk: running below it; "
            "resizing: mid checkpoint-restart; pending: not admitted)",
            labels=["state"],
        )
        resize_thrash = CounterMetricFamily(
            "vtpu_resize_thrash",
            "Grow attempts suppressed by hysteresis right after a "
            "shrink (counted once per resize) — a rising rate means "
            "capacity is oscillating and --resize-hysteresis is "
            "absorbing shrink/grow ping-pong (VtpuResizeThrash)",
        )
        elastic = getattr(self.scheduler, "elastic", None)
        for direction in ("shrink", "grow"):
            for req in ("reclaim", "defrag", "grow", "admission"):
                resizes.add_metric(
                    [direction, req],
                    elastic.resizes_total.get((direction, req), 0)
                    if elastic else 0)
        states = elastic.pod_states() if elastic else {}
        for state in ("at-max", "shrunk", "resizing", "pending"):
            elastic_pods.add_metric([state], states.get(state, 0))
        resize_thrash.add_metric(
            [], elastic.thrash_total if elastic else 0)

        # Active replicas (shard/): the epoch, the nodes owned and orphaned,
        # the adoptions and the fenced commits' failures by token.
        shard_epoch = GaugeMetricFamily(
            "vtpu_shard_epoch",
            "Shard-map epoch this replica operates under (replicas "
            "disagreeing for more than a tick means the coordination "
            "object is unreachable; 0 = shard layer inert)",
        )
        shards_owned = GaugeMetricFamily(
            "vtpu_shards_owned",
            "Registered nodes this replica owns placements for under "
            "the current shard map (the whole fleet when the shard "
            "layer is inert)",
        )
        shards_orphaned = GaugeMetricFamily(
            "vtpu_shards_orphaned",
            "Registered nodes whose owner replica's lease is Dead but "
            "whose shards have not been reassigned yet — nonzero for "
            "longer than an epoch bump + adoption grace means "
            "rebalancing is stuck (VtpuShardOrphaned)",
        )
        shard_rebalances = CounterMetricFamily(
            "vtpu_shard_rebalances",
            "Epoch transitions this replica adopted shards on (each "
            "one replays the adopted nodes' decision-annotation WAL)",
        )
        cas_failures = CounterMetricFamily(
            "vtpu_commit_cas_failures",
            "Sharded decision commits that failed closed, by reason "
            "(stale-map / lost-ownership / adopting: the epoch fence; "
            "rv-conflict / already-decided: a concurrent peer decision "
            "on the same pod; pod-gone / read-failed / write-failed: "
            "apiserver I/O) — every one requeues its pod",
            labels=["reason"],
        )
        shards = getattr(self.scheduler, "shards", None)
        if shards is not None:
            shard_epoch.add_metric([], shards.epoch())
            shards_owned.add_metric([], shards.owned_count())
            shards_orphaned.add_metric([], len(shards.orphaned_nodes()))
            shard_rebalances.add_metric([], shards.rebalances_total)
            for reason, n in sorted(dict(shards.cas_failures).items()):
                cas_failures.add_metric([reason], n)

        # Performance observatory (A.5): empty, gauges and the
        # per-generation gc counts at 0.
        cycle_phase = HistogramMetricFamily(
            "vtpu_cycle_phase_seconds",
            "Wall-clock cost of one control-plane phase per tick "
            "(drain, snapshot, columnar-refresh vs -rebuild, "
            "vector-eval, solve, slice-stage, group-commit, "
            "decision-write, decision-flush, opt-evaluate/commit, "
            "informer-apply/-resync, register-apply, "
            "quota/defrag/shard/capacity ticks, gc-pause, cycle-total "
            "— where a tick's time goes; see GET /perfz for windowed "
            "p50/p99 and the slow-tick table)",
            labels=["phase"],
        )
        lock_wait = HistogramMetricFamily(
            "vtpu_lock_wait_seconds",
            "Time spent WAITING for a contended control-plane lock "
            "(commit / pods / nodes / quota / leases / snapshot-cache; "
            "uncontended acquires record nothing, and the hottest "
            "locks observe 1-in-N sampled acquires — the count is the "
            "sampled contention count)",
            labels=["lock"],
        )
        lock_hold = HistogramMetricFamily(
            "vtpu_lock_hold_seconds",
            "Time a control-plane lock was HELD per acquire (sampled "
            "1-in-N on the hottest locks; a hold distribution moving "
            "up is the convoy precursor the wait histogram confirms)",
            labels=["lock"],
        )
        lock_acquires = CounterMetricFamily(
            "vtpu_lock_acquires",
            "Acquires of one control-plane lock (exact; the hottest "
            "locks observe wait/hold on 1-in-N sampled acquires, so "
            "the contention ratio is vtpu_lock_wait_seconds_count "
            "over the SAMPLED count — GET /perfz computes it)",
            labels=["lock"],
        )
        lock_sampled = CounterMetricFamily(
            "vtpu_lock_sampled_acquires",
            "Acquires on which one control-plane lock's wait/hold "
            "telemetry was observed (ceil(acquires / 2**sample_shift) — "
            "the sampled acquire is the first of each block; the "
            "contention-ratio denominator — dividing the wait count by "
            "RAW acquires understates contention by the per-lock "
            "sampling factor)",
            labels=["lock"],
        )
        informer_lag = GaugeMetricFamily(
            "vtpu_informer_lag_seconds",
            "Pod-informer apply latency: p99 of the recent event-apply "
            "window (callback entry -> registries updated).  The "
            "dispatch loop is synchronous, so growth here is what "
            "backs the watch up; transport-side queueing upstream of "
            "the callback is not included",
        )
        informer_resync = GaugeMetricFamily(
            "vtpu_informer_resync_seconds",
            "Wall-clock cost of the most recent full informer resync "
            "(list + chunked re-apply + prune).  The reconcile yields "
            "between chunks so cycles interleave, but a growing figure "
            "still means the safety net is re-walking a fleet the watch "
            "should be keeping current — see the informer-resync phase "
            "on GET /perfz for history",
        )
        pending_depth = GaugeMetricFamily(
            "vtpu_pending_queue_depth",
            "Pods queued at the batch gate awaiting their scheduling "
            "cycle (sustained growth = ticks can't keep up with "
            "arrivals; see drain_age_s on GET /perfz)",
        )
        gc_collections = CounterMetricFamily(
            "vtpu_gc_collections",
            "Python garbage collections in this scheduler process, by "
            "generation (gen2 spikes stall every scheduling thread; "
            "pause durations are the gc-pause phase of "
            "vtpu_cycle_phase_seconds)",
            labels=["generation"],
        )
        reg = perf.registry()
        for name, ring in sorted(reg.phase_rings().items()):
            buckets, sum_s = ring.prom()
            cycle_phase.add_metric([name], buckets, sum_s)
        for name, st in sorted(reg.lock_tables().items()):
            buckets, sum_s = st.wait.prom()
            lock_wait.add_metric([name], buckets, sum_s)
            buckets, sum_s = st.hold.prom()
            lock_hold.add_metric([name], buckets, sum_s)
            lock_acquires.add_metric([name], st.acquires)
            lock_sampled.add_metric([name], st.sampled_acquires())
        informer_lag.add_metric([], reg.informer_lag_s())
        informer_resync.add_metric(
            [], reg.gauge("informer_resync_last_s"))
        pending_depth.add_metric(
            [], len(engine._queue) if engine is not None
            else reg.gauge("pending_queue_depth"))
        for gen, n in enumerate(reg.gc.collections):
            gc_collections.add_metric([str(gen)], n)

        batch_fallbacks = CounterMetricFamily(
            "vtpu_filter_batch_fallbacks",
            "Batched-cycle jobs resolved via the per-pod path, by cause "
            "(slice-no-fit: the in-cycle slice stage found no box; "
            "no-fit: the joint solver found no node; commit-conflict: "
            "lost a revision race in the group commit; error: cycle-"
            "internal failure)",
            labels=["reason"],
        )
        if engine is not None:
            for reason, n in sorted(
                    engine.stats.fallback_reason_counts().items()):
                batch_fallbacks.add_metric([reason], n)

        # Serving QoS: per-class dispatch-wait histograms and per-pod
        # duty weights, from the qos fields the usage reports carry.
        pod_qos_weight = GaugeMetricFamily(
            "vtpu_pod_qos_duty_weight",
            "Current duty-cycle weight of one QoS-classed pod (percent "
            "of its core grant; 100 = neutral, shifted by the node "
            "monitor's p99 feedback loop — vtpu-smi top shows this next "
            "to the waste view)",
            labels=["podnamespace", "podname", "class"],
        )

        # Predictive capacity (accounting/planner.py): the names come
        # from planner.CAPACITY_FIELD_METRICS, the one mapping the
        # /capacityz JSON, this exporter and the dashboard's "Capacity"
        # row share.  Emitted always (empty without observations);
        # getattr: a collector stub without the capacity surface emits
        # them empty.
        cap_demand = GaugeMetricFamily(
            "vtpu_capacity_queue_demand_chips",
            "Chips one capacity queue (or namespace, when ungoverned) "
            "wants right now: held grants plus pending requests — the "
            "demand series the forecaster learns",
            labels=["queue"],
        )
        cap_forecast = GaugeMetricFamily(
            "vtpu_capacity_forecast_demand_chips",
            "Forecast demand of one queue at the horizon end (EWMA "
            "level + additive seasonality over the ledger-tick demand "
            "series; GET /capacityz carries the full per-bucket curve)",
            labels=["queue"],
        )
        cap_upper = GaugeMetricFamily(
            "vtpu_capacity_forecast_upper_chips",
            "Upper confidence band of one queue's forecast demand at "
            "the horizon end (the conservative bound starvation ETAs "
            "and scale recommendations read)",
            labels=["queue"],
        )
        cap_eta = GaugeMetricFamily(
            "vtpu_capacity_queue_starvation_eta_seconds",
            "Seconds until this queue's forecast demand (upper band) "
            "exceeds what it can admit — 0 = starving now, +Inf = the "
            "horizon stays clear (VtpuQueueStarvationForecast pages on "
            "a finite ETA)",
            labels=["queue"],
        )
        cap_err = GaugeMetricFamily(
            "vtpu_capacity_forecast_error_ratio",
            "Forecast-vs-actual drift of one queue's demand series: "
            "EWMA |one-bucket-ahead error| / EWMA |actual| (~0 = the "
            "model tracks the tenant; sustained high = forecasts are "
            "noise and capacity answers should not be trusted — "
            "VtpuCapacityForecastDrift)",
            labels=["queue"],
        )
        cap_nodes_cur = GaugeMetricFamily(
            "vtpu_capacity_nodes_current",
            "Nodes currently registered (the scale recommendation's "
            "baseline)",
        )
        cap_nodes_rec = GaugeMetricFamily(
            "vtpu_capacity_nodes_recommended",
            "Nodes the demand forecast needs: peak of the summed "
            "per-queue upper bands over the horizon, in whole nodes "
            "(analytic; verify with a vtpu-simulate capacity replay "
            "before buying hardware — docs/observability.md)",
        )
        cap_fn = getattr(self.scheduler, "export_capacity", None)
        if cap_fn is not None:
            # The quota-stats snapshot the queue gauges read (one registry
            # walk a scrape), and no per-bucket curves (detail=False: they
            # would be built each scrape under the tracker's lock).
            doc = cap_fn(quota_stats=quota_stats, detail=False)
            for row in doc["queues"]:
                q = [row["queue"]]
                cap_demand.add_metric(q, row["demand_chips"])
                cap_forecast.add_metric(q, row["forecast_demand_chips"])
                cap_upper.add_metric(q, row["forecast_upper_chips"])
                cap_eta.add_metric(
                    q, row["starvation_eta_s"]
                    if row["starvation_eta_s"] is not None
                    else float("inf"))
                if row["forecast_error_ratio"] is not None:
                    cap_err.add_metric(q, row["forecast_error_ratio"])
            cap_nodes_cur.add_metric([], doc["nodes_current"])
            cap_nodes_rec.add_metric([], doc["nodes_recommended"])

        # Usage-series freshness: age of each pod's newest ledger sample
        # (the vgpu-report / vgpu-smi staleness guard reads it).
        series_age = GaugeMetricFamily(
            "vtpu_usage_series_age_seconds",
            "Seconds since the ledger last absorbed a usage report for "
            "one pod (high = its node's monitor stopped reporting; "
            "totals for it are frozen, not zero)",
            labels=["podnamespace", "podname"],
        )

        # Fleet audit (A.5): the sweep counters at 0, no findings.
        audit_findings = GaugeMetricFamily(
            "vtpu_audit_findings",
            "Open cross-plane audit findings by type (the fleet truth "
            "auditor's live disagreements between grant registry, "
            "decision-annotation WAL, snapshot/columnar views, shim-"
            "region usage reports and the quota/reservation ledgers; "
            "0 everywhere = the five planes agree — see GET /auditz "
            "and vtpu-audit for subjects and lifecycle)",
            labels=["type"],
        )
        audit_sweeps = CounterMetricFamily(
            "vtpu_audit_sweeps",
            "Audit sweeps run, by mode (delta = dirty nodes only, "
            "cost tracks churn; full = whole fleet + kube/ledger/"
            "quota/reservation planes, the bounded-rate backstop)",
            labels=["mode"],
        )
        audit_sweep_s = GaugeMetricFamily(
            "vtpu_audit_sweep_seconds",
            "Wall-clock cost of the most recent audit sweep (the "
            "audit-sweep phase of vtpu_cycle_phase_seconds carries "
            "the distribution; delta sweeps should stay near zero on "
            "a quiet fleet)",
        )
        audit_last_clean = GaugeMetricFamily(
            "vtpu_audit_last_clean_timestamp",
            "Unix time of the last audit sweep that ended with ZERO "
            "open findings (0 = never since boot; time() minus this "
            "growing while vtpu_audit_findings is nonzero is the "
            "VtpuAuditFindingPersistent signal)",
        )
        audit_sweeps.add_metric(["full"], 0)
        audit_sweeps.add_metric(["delta"], 0)
        audit_sweep_s.add_metric([], 0.0)
        audit_last_clean.add_metric([], 0.0)

        # SLO engine (A.5): the severity taxonomy zero-valued.
        slo_attainment = GaugeMetricFamily(
            "vtpu_slo_attainment_ratio",
            "Fraction of good events over each objective's budget "
            "window (compare against the declared target; absent "
            "until the objective has seen any event — GET /sloz and "
            "vtpu-slo carry targets, budgets and per-window detail)",
            labels=["objective"],
        )
        slo_budget = GaugeMetricFamily(
            "vtpu_slo_error_budget_remaining_ratio",
            "Unspent fraction of each objective's error budget over "
            "its budget window, clamped to [0, 1] (0 = the promise is "
            "fully broken for this window; the burn-rate gauges say "
            "how fast it got there)",
            labels=["objective"],
        )
        slo_burn = GaugeMetricFamily(
            "vtpu_slo_burn_rate",
            "Error-budget consumption speed per evaluation window, as "
            "a multiple of 'exactly on budget' (1.0 = burning the "
            "whole budget in one budget window; the multi-window rule "
            "fires a signal only while BOTH a pair's windows exceed "
            "its threshold)",
            labels=["objective", "window"],
        )
        slo_alerts = GaugeMetricFamily(
            "vtpu_slo_burn_alerts",
            "Active multi-window burn signals by severity (page = the "
            "fast 1h/5m pair, ticket = the slow 24h/6h pair; any "
            "sustained nonzero fires VtpuErrorBudgetBurnFast/Slow — "
            "vtpu-slo for the objective, burn rates and triage)",
            labels=["severity"],
        )
        for severity in ("page", "ticket"):
            slo_alerts.add_metric([severity], 0)

        # Decision-write failures by reason: the transport, or the shard
        # commit's fence or CAS.
        dwf = CounterMetricFamily(
            "vtpu_decision_write_failures",
            "Decision-annotation writes that failed after their path's "
            "retries, by reason (transport: the apiserver write itself "
            "failed — batched AND single paths; shard-fence / "
            "shard-cas: the sharded commit failed closed; every one "
            "rolled its tentative grant back and requeued the pod)",
            labels=["reason"],
        )
        failures = dict(getattr(self.scheduler, "decision_write_failures",
                                None) or {})
        for reason in sorted(set(failures)
                             | {"shard-cas", "shard-fence", "transport"}):
            dwf.add_metric([reason], failures.get(reason, 0))

        fleet = self.scheduler.grant_efficiency()
        by_uid = {p.uid: p for p in fleet.pods}
        qos_by_class: Dict[str, tuple] = {}
        qos_weights: Dict[tuple, float] = {}
        # Pruned accounts' folded-in totals first: the per-class sums
        # must never go backwards when the ledger GCs a retired pod
        # (Prometheus would read the dip as a counter reset).
        retired = self.scheduler.ledger.qos_retired()
        for cls, (hist, s) in retired.items():
            _fold_hist(qos_by_class, cls, hist, s)
        for acct in self.scheduler.ledger.accounts():
            if not acct.qos_class:
                continue
            _fold_hist(qos_by_class, acct.qos_class,
                       acct.qos_wait_hist, acct.qos_wait_seconds_total)
            pe = by_uid.get(acct.uid)
            namespace = pe.namespace if pe is not None else "(unresolved)"
            name = pe.name if pe is not None else acct.name
            # Latest wins on (ns, name, class) collisions — same dedup
            # discipline as the efficiency gauges below.
            qos_weights[(namespace, name, acct.qos_class)] = \
                acct.qos_weight_pct
        for (namespace, name, cls), w in sorted(qos_weights.items()):
            pod_qos_weight.add_metric([namespace, name, cls], w)
        # Aggregate by label pair BEFORE emitting: two retained accounts
        # can resolve to the same (namespace, name) — successive
        # incarnations of a restarted pod, both "(unresolved)" — and
        # duplicate series would invalidate the whole exposition.
        # Summing is correct for lifetime counters.
        sums: Dict[tuple, list] = {}
        ages: Dict[tuple, float] = {}
        ledger_now = self.scheduler.ledger.now()
        for acct in self.scheduler.ledger.accounts():
            pe = by_uid.get(acct.uid)
            namespace = pe.namespace if pe is not None else "(unresolved)"
            name = pe.name if pe is not None else acct.name
            agg = sums.setdefault((namespace, name), [0.0, 0.0])
            agg[0] += acct.chip_seconds
            agg[1] += acct.hbm_byte_seconds
            # Freshest incarnation wins on (ns, name) collisions: the
            # age gauge answers "is anything still reporting here".
            age = max(0.0, ledger_now - acct.last_recorded)
            prev = ages.get((namespace, name))
            if prev is None or age < prev:
                ages[(namespace, name)] = age
        for (namespace, name), (chip_s, hbm_s) in sorted(sums.items()):
            u_chip.add_metric([namespace, name], chip_s)
            u_hbm.add_metric([namespace, name], hbm_s)
        for (namespace, name), age in sorted(ages.items()):
            series_age.add_metric([namespace, name], age)
        # Same dedup discipline: a delete/recreate race can briefly hold
        # two uids under one (namespace, name); latest registry entry wins.
        ratios: Dict[tuple, float] = {}
        for pe in fleet.pods:
            if pe.efficiency is not None:
                ratios[(pe.namespace, pe.name)] = pe.efficiency
        for (namespace, name), ratio in sorted(ratios.items()):
            eff_ratio.add_metric([namespace, name], ratio)
        idle_grants.add_metric([], len(fleet.idle))

        return [mem_limit, mem_alloc, shared_num, core_alloc, mem_pct,
                pod_mem, pod_cores, preempts, conflicts, batch_size,
                batch_lat, batch_fallbacks, cycle_phase, lock_wait,
                lock_hold, lock_acquires, lock_sampled, informer_lag,
                informer_resync, pending_depth,
                gc_collections, pool_size, busy_peak,
                solve_workers, solve_restarts, solve_eval,
                lease_state, leases_unhealthy, chips_quar, quarantines,
                rescued, q_pending, q_admitted, q_share, q_borrowed,
                q_reclaims, slice_avail, max_box, reserved,
                defrag_plans, defrag_migrations, defrag_completed,
                defrag_aborted, resizes, elastic_pods, resize_thrash,
                shard_epoch, shards_owned,
                shards_orphaned, shard_rebalances, cas_failures,
                cap_demand, cap_forecast, cap_upper, cap_eta, cap_err,
                cap_nodes_cur, cap_nodes_rec,
                audit_findings, audit_sweeps, audit_sweep_s,
                audit_last_clean, slo_attainment, slo_budget,
                slo_burn, slo_alerts, dwf, series_age,
                u_chip, u_hbm, eff_ratio, idle_grants,
                qos_wait_family(qos_by_class),
                pod_qos_weight] + list(phase_metrics())


def phase_metrics():
    """Per-phase scheduling latency histograms + node-rejection-reason
    counters, read out of this process's tracer (util/trace.py) — the
    aggregate face of the spans /debug/tracez shows one pod at a time."""
    latency = HistogramMetricFamily(
        "vtpu_scheduling_phase_latency_seconds",
        "Wall-clock latency of one scheduling phase (webhook, filter, "
        "decision-write, bind, allocate), by the pod's QoS class "
        "(empty = unclassed) so tiered scheduling latency slices the "
        "same way vtpu.dev/qos slices traces",
        labels=["phase", "qos"],
    )
    for (phase, qos), (buckets, _count, sum_s) in \
            trace.tracer().histogram_snapshot().items():
        latency.add_metric([phase, qos], buckets, sum_s)
    rejections = CounterMetricFamily(
        "vtpu_filter_rejections",
        "Nodes rejected during Filter, by dominant reason token "
        "(from scheduler/score.py per-chip rules)",
        labels=["reason"],
    )
    for reason, n in trace.tracer().rejection_snapshot().items():
        rejections.add_metric([reason], n)
    return [latency, rejections]


def start_metrics_server(scheduler: Scheduler, port: int = 9395,
                         host: str = "0.0.0.0") -> MetricsServer:
    """Serve ``/metrics`` with the cluster collector alone, started; the
    server's ``port`` is the bound one (port 0 picks a free one)."""
    collector = ClusterCollector(scheduler)
    return MetricsServer(collector.collect, host=host, port=port).start()
