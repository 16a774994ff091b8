# Development entrypoints (the reference drives everything through
# hack/build.sh + a Makefile; here each surface is one target).

.PHONY: all native test test-fast test-slow chaos-smoke quota-sim \
        defrag-sim ha-sim qos-sim capacity-sim steady-sim explain-sim \
        audit-sim elastic-sim slo-sim bench-multicore batch-protocol \
        shard-protocol \
        lint-dashboards lint-torch-dashboards dryrun scenarios controlplane \
        bench-controlplane bench-steady bench-explain bench wheel clean

all: native

# Same lock as util/nativebuild.py: detached bench/scenario workers
# build concurrently and an unserialized make would race the .o files.
native:                       ## C++ enforcement layer → lib/tpu/build/
	flock lib/tpu/.build.lock $(MAKE) -C lib/tpu

test: native                  ## full suite on a virtual 8-device CPU mesh
	python -m pytest tests/ -q

test-fast: native             ## control plane + shim + e2e (<2 min, 1 core)
	python -m pytest tests/ -q -m "not slow"

test-slow: native             ## model/parallelism tier (compiles networks)
	python -m pytest tests/ -q -m slow

# Seeded + deterministic: every scenario replays bit-identically (virtual
# clock, fixed seeds), so a failure here is a real regression, not flake.
chaos-smoke: native           ## fault-injection suite in the simulator
	python -m pytest tests/ -q -m chaos

# Contended two-tenant + gang capacity-queue scenario through the REAL
# admission loop on the virtual clock (docs/quota.md).  Deterministic
# (fixed arrival schedule, SimClock, uid tie-breaks everywhere), so the
# verdict gates CI: fair-share convergence to the configured weights,
# utilization at the FIFO baseline, reclaim victims all borrowed, zero
# double-booking.
quota-sim:                    ## capacity-queue fairness A/B in the simulator
	python -m k8s_vgpu_scheduler_tpu.cmd.simulate \
	    --workload examples/workload-queueing.json --nodes 2 --chips 4 --json \
	  | python -c "import json,sys; v = json.load(sys.stdin)['queueing']['verdict']; assert v['ok'], v; print('quota-sim:', v)"

# Fragmentation A/B through the REAL scheduler + defrag loop on the
# virtual clock (docs/placement.md): churn fragments the fleet, a
# mesh-declared gang arrives and blocks, the defragmenter compacts via
# checkpoint-first migration, the gang admits.  Deterministic; the
# verdict gates CI: gang admitted strictly sooner with defrag on,
# slice availability strictly better, every victim checkpoint-first
# and re-placed, zero double-booking.
defrag-sim:                   ## fragmentation/defrag A/B in the simulator
	python -m k8s_vgpu_scheduler_tpu.cmd.simulate \
	    --workload examples/workload-fragmentation.json \
	    --nodes 2 --chips 8 --mesh 4x2 --json \
	  | python -c "import json,sys; v = json.load(sys.stdin)['fragmentation']['verdict']; assert v['ok'], v; print('defrag-sim:', v)"

# Active-active HA failover through the REAL shard layer on the virtual
# clock (docs/scheduler-concurrency.md "Sharded control plane"): three
# replicas converge on a shard map, a seeded replica is killed
# mid-storm, survivors bump the epoch and adopt the orphaned shards,
# and every pod that pended through the window re-places.  Deterministic
# (SimClock, seeded kill, rendezvous hashing); the verdict gates CI:
# all shards adopted, all pending pods re-placed, no grant lost or
# duplicated, zero overbooked chips.
ha-sim:                       ## replica-kill failover A/B in the simulator
	python -m k8s_vgpu_scheduler_tpu.cmd.simulate \
	    --workload examples/workload-ha.json --nodes 6 --chips 4 --json \
	  | python -c "import json,sys; v = json.load(sys.stdin)['ha']['verdict']; assert v['ok'], v; print('ha-sim:', v)"

# SLO-tiered co-residency A/B through the REAL native limiters + monitor
# feedback loop on virtual clocks (docs/serving.md): a latency-critical
# serve-decode stream next to a best-effort training neighbor, flat
# duty-cycle limiter vs QoS tiers.  Deterministic (manual clocks, fixed
# schedule, no RNG); the verdict gates CI: burst credit beats the flat
# p99 in every bursty phase, the re-weighting loop beats the flat mean
# under sustained overload, duty shifted AND returned (hysteresis),
# best-effort goodput within tolerance, zero grant-limit violations.
qos-sim: native               ## serving-QoS tiered-vs-flat A/B in the simulator
	python -m k8s_vgpu_scheduler_tpu.cmd.simulate \
	    --workload examples/workload-serving.json --json \
	  | python -c "import json,sys; v = json.load(sys.stdin)['serving']['verdict']; assert v['ok'], v; print('qos-sim:', v)"

# Predictive capacity over the three NAMED arrival scenarios (bursty /
# diurnal / flash-crowd; benchmarks/scenarios.py ARRIVAL_SCENARIOS)
# through the REAL forecaster + admission loop on the virtual clock
# (docs/observability.md "Capacity planning").  Deterministic and
# CPU-only by construction (SimClock, no RNG — the chip-outage-proof
# tier), emits CAPACITY_<round>.json.  The verdict gates CI: starvation
# ETA predicted within one forecast bucket of actual for bursty and
# diurnal, the flash-crowd scale recommendation keeps the
# latency-critical queue unstarved with zero overbooking when applied
# against the ACTUAL trace, forecast-vs-actual error in the artifact,
# and the replica-loss what-if keeps every shard-protocol invariant.
capacity-sim:                 ## forecast + what-if capacity verdicts (simulator)
	python benchmarks/scenarios.py capacity --strict

# Short deterministic CPU-only variant of bench_steady_state (ISSUE 12):
# a sustained storm — open-loop arrivals, completions, heartbeats, quota
# + defrag + capacity ticks live — over a small sharded 2-replica fleet
# with a pinned mid-run replica kill.  No RNG (fixed schedule, FIFO
# completions, round-robin routing); the verdict gates CI on the
# protocol invariants: zero double-booking, no grant lost, every pod
# placed, all shards adopted by the survivor, admission p99 bounded
# through the kill.  Throughput ratios are NOT gated here (CI noise);
# the full-scale gate lives in `make bench-steady` → STEADY_<round>.json.
steady-sim:                   ## sustained-storm invariants through a replica kill
	python benchmarks/controlplane.py steady-ci

# Multicore solve-worker smoke (ISSUE 17): a reduced-scale
# bench_multicore — the seeded parity stream with --solve-workers 2 vs
# 0, plus a 2-replica concurrent storm (replicas genuinely driven
# simultaneously, solve workers mapping the shared columnar segments,
# audit sweeps live at every wave) against the same storm drained
# sequentially in-process.  Gates the DETERMINISTIC invariants only —
# bit-identical decisions, zero audit findings, zero double-booked
# chips, every pod placed, zero worker restarts — never timing ratios
# (same CI-noise rule as steady-sim); the scaling/sustained gates live
# in `python benchmarks/controlplane.py multicore` → STEADY_<round>.json.
bench-multicore:              ## solve-worker bit-identity + audit smoke
	python benchmarks/controlplane.py multicore-ci

# Decision-provenance chaos verdict through the REAL sharded control
# plane on the virtual clock (docs/observability.md "Decision
# provenance"): the ha-sim storm over a 48-node fleet with a seeded
# mid-run replica kill, then an audit that EVERY terminal pod returns a
# gap-free /explainz timeline from EVERY surviving replica whose final
# record agrees with the grant on the annotation WAL — including pods
# the survivors only know through WAL adoption — plus one deterministic
# chaos eviction whose final record must carry the rescuer's requester
# key.  Deterministic (SimClock, seeded kill, no wall-clock in the
# verdict); gates CI next to ha-sim/steady-sim.
explain-sim:                  ## gap-free explain timelines through a replica kill
	python -m k8s_vgpu_scheduler_tpu.cmd.simulate \
	    --workload examples/workload-explain.json --nodes 48 --chips 4 --json \
	  | python -c "import json,sys; r = json.load(sys.stdin)['ha']; v = r['verdict']; e = r['explain']['verdict']; assert v['ok'] and e['ok'], (v, e); print('explain-sim:', e)"

# Fleet-truth-auditor adversarial proof through the REAL sharded
# scheduler on the virtual clock (docs/observability.md "Fleet
# audit"): a clean storm with usage reports and mid-storm completions
# must produce ZERO findings at every sweep (the auditor can never be
# a false-alarm generator), then every seeded corruption class
# (forged annotation, forged shard owner, fence-raced double grant,
# phantom grant, snapshot/columnar corruption, reservation leak,
# dropped usage publish, resurrected region slot) must be detected
# within ONE sweep, attributed to the correct finding type, and
# auto-clear after repair; the paired sweep-vs-drain overhead on the
# 256-pod batched drain gates <2%.  Deterministic apart from the
# wall-clock overhead section; the verdict gates CI.
audit-sim:                    ## cross-plane corruption-injection proof (simulator)
	python -m k8s_vgpu_scheduler_tpu.cmd.simulate \
	    --workload examples/workload-audit.json \
	    --nodes 24 --chips 4 --hbm 2000 --json \
	  | python -c "import json,sys; v = json.load(sys.stdin)['audit']['verdict']; assert v['ok'], v; print('audit-sim:', v)"

# Elastic mesh resizing A/B through the REAL admission/reclaim/resize
# loops on the virtual clock (elastic/; docs/placement.md "Elastic
# meshes"): an elastic gang borrowing cohort capacity shrinks a rung
# for a latency burst instead of dying, then grows back under
# hysteresis.  Deterministic; the verdict gates CI: goodput and burst
# JCT strictly better than kill-based reclaim, zero kills on the
# elastic leg, the gang's hash-chain trajectory resumes bit-identically
# at every resize point, zero double-booking, elastic-off leg inert.
elastic-sim:                  ## elastic resize-vs-kill A/B in the simulator
	python -m k8s_vgpu_scheduler_tpu.cmd.simulate \
	    --workload examples/workload-elastic.json \
	    --nodes 2 --chips 16 --mesh 4x4 --json \
	  | python -c "import json,sys; v = json.load(sys.stdin)['elastic']['verdict']; assert v['ok'], v; print('elastic-sim:', v)"

# Fleet SLO engine adversarial proof (slo/; docs/observability.md
# "SLOs"): three acts on the virtual clock — clean storm (100%
# attainment, zero burn signals), overload + replica kill (exactly the
# two targeted objectives breach, fast/page pairs fire within one short
# window of the first bad event and strictly before slow/ticket,
# budgets deplete monotonically), recovery (every signal auto-clears,
# budgets still show the damage).  Deterministic apart from the
# wall-clock overhead A/B, which gates the engine sweep <2% of the
# 256-pod batched drain.  The verdict gates CI.
slo-sim:                      ## burn-rate/error-budget three-act proof (simulator)
	python -m k8s_vgpu_scheduler_tpu.cmd.simulate \
	    --workload examples/workload-slo.json \
	    --nodes 6 --chips 4 --hbm 8000 --json \
	  | python -c "import json,sys; v = json.load(sys.stdin)['slo']['verdict']; assert v['ok'], v; print('slo-sim:', v)"

# The ISSUE 13 emit-overhead gate at full bench scale: decision
# provenance ON vs --no-provenance, ABBA per-cycle alternation on
# bench_batch_cycle's drain, pooled-median verdict asserted <2%.
# Minutes of CPU; not in CI.
bench-explain:                ## provenance emit-overhead A/B (<2% budget)
	python benchmarks/controlplane.py provenance-overhead

# Full-scale sustained-storm proof (10k nodes / 100k live pods, replica
# kill mid-run, /perfz breakdown embedded) + the ≤2% instrumentation-
# overhead A/B → STEADY_<round>.json.  Minutes of CPU; not in CI.
bench-steady:                 ## steady-state storm artifact (full scale)
	python benchmarks/controlplane.py steady

# The scheduler-concurrency protocol suite (racing filter/bind/delete,
# zero over-grant, conflict convergence) re-run with the batched Filter
# on (--filter-batch; scheduler/batch.py), plus the batch-specific
# parity and protocol units — proves batched cycles keep every invariant
# of docs/scheduler-concurrency.md.
batch-protocol:               ## concurrency protocol suite, batched Filter on
	VTPU_TEST_FILTER_BATCH=1 python -m pytest \
	    tests/test_scheduler_concurrency.py tests/test_scheduler_batch.py -q

# The multi-replica shard protocol suite (two replicas racing one shard
# map, epoch fencing, seeded-kill adoption determinism, no-double-evict
# across handoffs), plus the EXISTING concurrency stress suite re-run
# with the shard layer active (VTPU_TEST_SHARD_FENCE=1: every decision
# passes the epoch fence and commits via pod-resourceVersion CAS) —
# proves the sharded commit keeps every invariant of
# docs/scheduler-concurrency.md under the same racing load.
shard-protocol:               ## shard suite + concurrency stress, CAS commit on
	python -m pytest tests/test_shard.py -q
	VTPU_TEST_SHARD_FENCE=1 python -m pytest \
	    tests/test_scheduler_concurrency.py -q

# Dashboard/alert ↔ code pinning, standalone (the same tests also run in
# the default tier): every panel/alert expression must name a metric a
# collector actually registers, and every registered metric must be
# dashboarded or allowlisted with a reason (tests/test_vtpu_cluster.py).
lint-dashboards:              ## validate Grafana panels + alert rules vs code
	python -m pytest tests/test_vtpu_cluster.py -q \
	    -k "dashboard or alert or emitted"

# The port's chart (charts/vgpu): its dashboards and alert rules against
# the port's collectors, both ways.
lint-torch-dashboards:        ## validate charts/vgpu panels + alerts vs the port
	python -m pytest tests/test_torch_chart.py -q \
	    -k "dashboard or alert or emitted"

# dryrun_multichip pins the CPU platform + device count itself,
# appending to (not clobbering) any user-set XLA_FLAGS.
dryrun:                       ## multi-chip sharding proof (all families)
	python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

scenarios: native             ## capability proofs, degraded CPU mode
	SCENARIO_FORCE_CPU=1 python benchmarks/scenarios.py all --strict

# Tracing is on by construction (the process-global tracer always
# records spans), so the numbers include span overhead — the production
# configuration.  Emits CONTROLPLANE_<round>.json (BENCH-style, round
# from tests/artifact_manifest.json), including the concurrent-filter
# serial-vs-optimistic A/B (docs/scheduler-concurrency.md).
bench-controlplane:           ## scheduling-path perf artifact (tracing on)
	python benchmarks/controlplane.py

controlplane: bench-controlplane  ## alias (historical name)

bench: native                 ## reference benchmark matrix (real chip)
	python bench.py

# --no-build-isolation: build with the environment's setuptools so
# air-gapped hosts (like TPU build boxes) need no network; requires
# setuptools>=68 present (plain `pip wheel .` works when online).
wheel:                        ## pip-installable control plane
	pip wheel --no-deps --no-build-isolation -w dist .

clean:
	$(MAKE) -C lib/tpu clean || true
	rm -rf dist build *.egg-info
