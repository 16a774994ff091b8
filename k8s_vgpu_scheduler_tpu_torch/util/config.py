"""Configuration of the port's node agent and scheduler extender.

The port's copy of the JAX package's ``util/config.py``, cut to the fields
the node agent and the scheduler extender read, with the JAX defaults.  One immutable
Config passed explicitly, where the reference scatters mutable package
globals (pkg/util/util.go:35–47, pkg/device-plugin/config:528–537).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ResourceNames:
    """Extended-resource names pods use to ask for a fraction of a GPU:
    the reference's defaults (--resource-name/-mem/-mem-percentage/-cores/
    -priority, util.go:35–47)."""

    count: str = "nvidia.com/gpu"
    memory: str = "nvidia.com/gpumem"
    memory_percentage: str = "nvidia.com/gpumem-percentage"
    cores: str = "nvidia.com/gpucores"
    priority: str = "nvidia.com/priority"


@dataclasses.dataclass(frozen=True)
class Config:
    resources: ResourceNames = dataclasses.field(default_factory=ResourceNames)
    scheduler_name: str = "vgpu-scheduler"

    # Defaults applied when a pod asks for cards but no memory or cores
    # (reference --default-mem/--default-cores, cmd/scheduler/main.go:50–63;
    # default_mem 0 means the whole card's memory).
    default_mem: int = 0
    default_cores: int = 0

    # The topology policy of a multi-card request whose pod names none
    # (``vtpu.dev/topology-policy``), and the node agent's policy for
    # kubelet's preferred allocation.
    topology_policy: str = "best-effort"

    # Node choice among fitting nodes: "spread" (most free capacity wins,
    # the reference's rule) or "binpack" (the fullest fitting node wins).
    node_scheduler_policy: str = "spread"

    # The optimistic Filter (scheduler/core.py): candidates are fitted
    # without a lock on an immutable snapshot, and the commit lock is held
    # only to re-check the winner's revisions and record the grant.  False
    # decides each pod whole under one lock (--serial-filter).
    optimistic_commit: bool = True
    # Candidate-evaluation worker pool: 0 = auto (min(8, cpu count)),
    # 1 = evaluate in the calling thread, N > 1 = pool size.
    filter_workers: int = 0
    # Optimistic commits that lose their revision race re-evaluate on a
    # fresh snapshot at most this many times, then decide serially.
    commit_retries: int = 4
    # Batched scheduling cycles (scheduler/batch.py): concurrent Filters
    # collapse into cycles (one snapshot, a vectorized pods x cards
    # evaluation over a columnar fleet, a joint solve, one revision-
    # validated group commit a node).  Off by default: the per-pod
    # optimistic path decides until an operator opts in
    # (--filter-batch); filter_many drives the engine either way.
    filter_batch: bool = False
    # How long the first Filter into an idle batch gate waits for others
    # to join its cycle (ms); 0 = no wait.
    batch_tick_ms: float = 2.0
    # Pods a cycle at most: bounds a cycle's latency; a deeper backlog
    # drains over successive cycles.
    batch_max: int = 256
    # The joint solver: "regret" (greedy with regret: a pod with one
    # feasible node is served before a flexible pod takes it) or "fifo"
    # (sequential argmax in fair-share order, the serial path's answer).
    batch_solver: str = "regret"
    # Solve worker processes (parallelcp/) that map the columnar fleet's
    # shared-memory segments read-only and run the class evaluations
    # row-sharded outside the GIL; 0 = in-process, with the same bits.
    solve_workers: int = 0

    # Priority preemption (scheduler/preempt.py): a pod that fits nowhere
    # may ask strictly lower-priority pods to checkpoint and leave.  Off
    # by default: eviction is the operator's choice (--enable-preemption).
    enable_preemption: bool = False

    # Node leases (health/lease.py): seconds without a register-stream
    # message before a node takes no new placements, and how many more of
    # those periods before it is dead and its grants are rescued.
    lease_ttl_s: float = 15.0
    lease_grace_beats: int = 2
    # Card quarantine (health/quarantine.py): this many health flips
    # inside the window quarantine a card until it has stayed healthy for
    # the probation.
    quarantine_flap_threshold: int = 3
    quarantine_flap_window_s: float = 60.0
    quarantine_probation_s: float = 30.0
    # The rescue sweep (health/rescuer.py): its period, how long a victim
    # asked to checkpoint off a quarantined card gets before its grant is
    # rescinded, and how long a Dead lease is kept once nothing is left
    # on it.  enable_rescue gates the daemon's sweep thread; detection
    # and the quarantine's gating are always on.
    rescue_interval_s: float = 5.0
    rescue_checkpoint_grace_s: float = 120.0
    lease_retention_s: float = 900.0
    enable_rescue: bool = True

    # Usage accounting (accounting/): the trailing window of the
    # granted-vs-actual efficiency join (vtpu_grant_efficiency_ratio, the
    # /usagez default), how long a grant must accrue ~no GPU-seconds
    # before it is an idle grant (flagged, never evicted), and how long
    # the ledger keeps an account after its node stops reporting it.
    efficiency_window_s: float = 300.0
    idle_grant_grace_s: float = 600.0
    usage_retention_s: float = 900.0
    # Candidate selection adds a bounded bonus (at most one card's worth
    # of the spread score) for nodes whose MEASURED utilization is low.
    score_by_actual: bool = False
    # Predictive capacity (accounting/forecast.py + planner.py).  Demand
    # per queue (or per namespace when ungoverned) is sampled every
    # capacity_interval_s, bucketed for the Holt-Winters forecaster, and
    # served on GET /capacityz and the vtpu_capacity_* gauges.  Buckets
    # per seasonal cycle: 24 x 60 s is hourly seasonality (3600 s buckets
    # make it diurnal).  The default forecast horizon of /capacityz
    # (``?horizon=`` overrides), and how long a pod must wait unplaced
    # before its queue starves (the ETA the forecast predicts toward).
    capacity_interval_s: float = 30.0
    capacity_bucket_s: float = 60.0
    capacity_season_buckets: int = 24
    capacity_horizon_s: float = 1800.0
    capacity_starve_after_s: float = 300.0
    # Capacity queues (quota/): the --quota-config file's "queues" list as
    # a tuple of dicts (empty: the admission layer is off and every
    # namespace bypasses it), the admission loop's period, how long a
    # released pod may sit unplaced before its under-nominal queue
    # reclaims borrowed grants, gang-aware backfill on or off
    # (--no-queue-backfill), reclaim on or off (--no-reclaim), the
    # release throttle's multiplier over registered cards, and whether
    # measured grant efficiency demotes idle tenants' weights.
    quota_queues: tuple = ()
    admission_interval_s: float = 2.0
    queue_reclaim_grace_s: float = 15.0
    enable_queue_backfill: bool = True
    enable_reclaim: bool = True
    queue_fleet_headroom: float = 1.0
    fair_share_usage_informed: bool = False
    # Placement (placement/).  The defragmenter compacts fragmented nodes
    # by checkpoint-migrating movable pods so blocked large slice/mesh
    # demands can admit.  Off by default — migration imposes
    # checkpoint/restore cycles, so the operator opts in
    # (--enable-defrag); the mesh-aware fit, the demand registry and the
    # slice-availability metrics are always on.  Then: the loop's period;
    # how long a demand without a fresh slice rejection is remembered;
    # how long an asked victim gets to checkpoint and exit before the plan
    # aborts and its reservation returns; how long an assembled
    # (reserved) slice waits for its beneficiary; the priority from which
    # (numerically >=) a pod is movable (1: the preemptible tier); and
    # the largest victim set a plan may ask.
    enable_defrag: bool = False
    defrag_interval_s: float = 10.0
    defrag_demand_fresh_s: float = 120.0
    defrag_checkpoint_grace_s: float = 120.0
    defrag_reservation_ttl_s: float = 300.0
    defrag_min_victim_priority: int = 1
    defrag_max_victims: int = 8
    # Elastic mesh resizing (elastic/).  Gangs that declare a
    # vtpu.dev/mesh-min/-max range may be stepped between the range's
    # rungs: quota reclaim and defrag SHRINK them instead of evicting, the
    # resize controller GROWS them back when capacity frees, and blocked
    # pending gangs are downgraded until they fit.  Off by default —
    # resizing imposes checkpoint-restart cycles, so the operator opts in
    # (--enable-elastic); with it off every existing path is
    # byte-identical.  Then: the loop's period; the quiet window after a
    # resize before the same gang may grow (a grow attempt inside it right
    # after a shrink is thrash: suppressed and counted); how long resized
    # members get to checkpoint and exit before the resize aborts and
    # vtpu.dev/mesh-assigned rolls back; and how long a pending elastic
    # gang must stay Filter-rejected before it is stepped down a rung.
    enable_elastic: bool = False
    elastic_interval_s: float = 10.0
    resize_hysteresis_s: float = 300.0
    resize_checkpoint_grace_s: float = 120.0
    elastic_downgrade_after_s: float = 30.0
    # Active-active extender replicas (shard/).  shard_replica is this
    # replica's name (the chart passes the pod name); empty: the shard
    # layer is inert and the single-replica path runs as without it.
    # Then: seconds without a coordination beat before a peer replica is
    # suspect, and how many more of those periods before it is dead and
    # its nodes are adopted; the coordination tick's period; how old the
    # map may be when a decision is committed (older: the commit fails
    # closed and the pod requeues); how long an adopted node stays
    # unplaceable after the epoch bump (at least the stale TTL); and the
    # Node the map is compare-and-swapped on.
    shard_replica: str = ""
    shard_ttl_s: float = 15.0
    shard_grace_beats: int = 2
    shard_tick_s: float = 3.0
    shard_stale_ttl_s: float = 10.0
    shard_adoption_grace_s: float = 12.0
    shard_coord_object: str = "vtpu-shard-coordination"
    # The extender's /debug endpoints (stacks, profile, vars, tracez,
    # events); unauthenticated, so off unless asked for.
    enable_debug: bool = False
    # The performance observatory (util/perf.py: phase rings, lock
    # wait/hold telemetry, /perfz); --no-perf switches it off.  Opt-in
    # tracemalloc puts the top allocation sites on /perfz, at the cost of
    # tracing every allocation.
    perf_enabled: bool = True
    perf_tracemalloc: bool = False

    # Node-agent knobs (reference pkg/device-plugin/config:528–537).
    device_split_count: int = 10
    device_memory_scaling: float = 1.0
    device_cores_scaling: float = 1.0
    disable_core_limit: bool = False
    node_name: str = ""
    scheduler_endpoint: str = "127.0.0.1:9090"

    # Card partitions (deviceplugin/partition.py): "none", "single" or
    # "mixed" over the MIG instances NVML reports, and the UUIDs of the
    # MIG cards to partition (empty: every one).
    partition_strategy: str = "none"
    partition_chips: tuple = ()

    # The node's install of the interposer (libvgpu_cuda.so and the
    # ld.so.preload naming it), and the per-container region directories
    # the node monitor scans (cmd/monitor.py's --container-root).
    shim_host_dir: str = "/usr/local/vgpu"
    cache_host_dir: str = "/tmp/vgpu/containers"

    # Sharing mode (reference MLU modes, cambricon.go:92–139):
    # - "mem-share":  split cards into virtual devices with memory caps;
    # - "env-share":  split cards WITHOUT memory caps (sharers time-slice
    #                 the whole card);
    # - "default":    exclusive whole cards (split count forced to 1).
    sharing_mode: str = "mem-share"

    def effective_split_count(self) -> int:
        """Virtual devices per card — the single source of truth for both
        kubelet fan-out and extender advertisement (sharing mode `default`
        means exclusive whole cards regardless of the split knob)."""
        return 1 if self.sharing_mode == "default" else self.device_split_count

