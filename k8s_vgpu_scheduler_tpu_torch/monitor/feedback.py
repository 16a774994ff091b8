"""Priority feedback loop of the PyTorch/CUDA port's node monitor.

The port's own copy of the JAX package's ``monitor/feedback.py``, over
``libvgpu_torch`` regions (reference: cmd/vGPUmonitor/feedback.go:161–248).
Every tick the monitor:

1. rescans the container dirs and (re)opens regions;
2. ages each region's ``recent_kernel`` activity counter (a process that
   launched since the last tick reads >0 before aging: the limiter sets it
   on every call, the driver-API interposer on every ungated launch);
3. builds a per-GPU census of which priorities are *active*, keyed on the
   ``NVIDIA_VISIBLE_DEVICES`` UUIDs each region was created with;
4. writes each region's ``utilization_switch``: ON iff a higher-priority
   sharer is active on any GPU this region holds — the in-container rate
   limiter then confines low-priority processes to their core grant, and
   lets them borrow idle compute otherwise (reference CheckPriority);
5. runs the :class:`QosController` — the GRADED generalization of the
   binary switch for SLO-tiered co-residency: per GPU, it computes the
   latency-critical class's dispatch-wait p99 from the regions' wait
   histograms, shifts duty weight from best-effort to critical while that
   p99 breaches its target (returning it with hysteresis once it
   recovers), and raises best-effort regions' ``qos_yield`` while a
   co-resident critical slot has queued work;
6. GCs proc slots whose pid is gone (SIGKILLed workloads leak slots — the
   reference recovers these via shared-region status flags).

Imports the standard library and the port's stdlib-only modules; never
torch.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
from typing import Dict, List, Optional, Set

from .reader import Region, RegionReader, scan_container_dirs

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ContainerState:
    key: str  # "<podUID>_<podName>"
    region: Region
    active: bool = False




@dataclasses.dataclass(frozen=True)
class QosConfig:
    """Knobs of the per-class duty re-weighting loop (cmd/monitor.py
    --qos-* flags; chart scheduler.qos.*)."""

    #: Critical-class dispatch-wait p99 target.  Above it, duty shifts
    #: from best-effort to critical every tick.
    target_p99_us: int = 20_000
    #: Duty-weight step per breach/recovery tick (percentage points).
    step_pct: int = 15
    #: Best-effort weight floor — backfill neighbors are squeezed, never
    #: starved outright (their hard-duty grant keeps this fraction).
    min_weight_pct: int = 25
    #: Latency-critical weight ceiling.
    max_weight_pct: int = 175
    #: Hysteresis: consecutive "good" ticks (p99 under target ×
    #: recover_frac, or no critical dispatches at all) before a step of
    #: duty is handed back, and consecutive queue-free ticks before the
    #: best-effort yield flag clears.
    recover_ticks: int = 3
    #: "Good" means p99 below target × this fraction — the dead band
    #: between breach and recovery that stops weight oscillation.
    recover_frac: float = 0.5


def hist_p99_us(delta: List[int]) -> Optional[float]:
    """p99 dispatch wait from a log2-us bucket-count delta (bucket 0 =
    zero-wait; bucket k covers [2^(k-1), 2^k) us — the p99 is the upper
    bound of the bucket holding the 99th percentile).  None when the
    delta holds no dispatches."""
    total = sum(delta)
    if total <= 0:
        return None
    rank = max(1, int(total * 0.99 + 0.999999))
    seen = 0
    for k, n in enumerate(delta):
        seen += n
        if seen >= rank:
            return 0.0 if k == 0 else float(1 << k)
    return float(1 << (len(delta) - 1))


class QosController:
    """Per-chip, per-class duty re-weighting from observed dispatch-wait
    p99 — closes the monitor's feedback loop on the latency signal
    instead of raw utilization.  Pure region-side state machine: all
    inputs are read from and all outputs written to the shared regions,
    so it composes with any data plane (Python shim or PJRT interposer)
    and replays deterministically in the simulator."""

    def __init__(self, cfg: Optional[QosConfig] = None) -> None:
        self.cfg = cfg or QosConfig()
        #: container key → last cumulative wait histogram (delta basis).
        self._last_hist: Dict[str, List[int]] = {}
        #: chip uuid → consecutive good ticks (recovery hysteresis).
        self._good: Dict[str, int] = {}
        #: chip uuid → consecutive ticks without critical queued work.
        self._quiet: Dict[str, int] = {}
        #: chip uuid → critical-class wait p99 (us) of the last tick with
        #: critical dispatches (metrics/debug surface).
        self.critical_p99_us: Dict[str, float] = {}
        #: Lifetime weight-shift actions (observability).
        self.reweights_total = 0

    # -- one tick --------------------------------------------------------------
    def observe(self, containers: Dict[str, ContainerState]) -> None:
        qos: List[tuple] = []  # (key, region, class, wait-hist delta)
        seen_keys = set()
        for c in containers.values():
            # getattr: duck-typed regions (simulator fakes, pre-QoS test
            # stubs) need not carry the QoS plane.
            cls = getattr(c.region, "qos_class", -1)
            if cls < 0:
                continue
            seen_keys.add(c.key)
            hist = c.region.qos_wait_hist()
            prev = self._last_hist.get(c.key)
            if prev is None or len(prev) != len(hist) or any(
                    h < p for h, p in zip(hist, prev)):
                # First sight, or the container restarted in place and
                # its counters began again: the full value is new.
                delta = list(hist)
            else:
                delta = [h - p for h, p in zip(hist, prev)]
            self._last_hist[c.key] = hist
            qos.append((c.key, c.region, cls, delta))
        for key in [k for k in self._last_hist if k not in seen_keys]:
            del self._last_hist[key]
        if not qos:
            # Last QoS container gone: drop every per-chip memory too —
            # a later tenant on the same chip must start from fresh
            # hysteresis state, not the dead pod's counters.
            self._good.clear()
            self._quiet.clear()
            self.critical_p99_us.clear()
            return

        # Phase 1: per-chip signals (breach / ready-to-return / yield),
        # with the hysteresis counters living per chip.
        by_chip: Dict[str, Dict[int, List[tuple]]] = {}
        for key, region, cls, delta in qos:
            for uuid in region.uuids():
                if uuid:
                    by_chip.setdefault(uuid, {}).setdefault(cls, []).append(
                        (key, region, delta))
        signals = {uuid: self._chip_signals(uuid, classes)
                   for uuid, classes in by_chip.items()}
        for uuid in [u for u in list(self._good) if u not in by_chip]:
            self._good.pop(uuid, None)
            self._quiet.pop(uuid, None)
            self.critical_p99_us.pop(uuid, None)

        # Phase 2: ONE write decision per REGION across all its chips —
        # a multi-chip grant must never get conflicting per-chip writes
        # in one tick (last-chip-wins yield, weight stepped once per
        # chip).  Conservative folds: yield/shift-toward-critical on ANY
        # chip's signal, return duty only when EVERY chip is ready.
        cfg = self.cfg
        moved = False
        for key, region, cls, _delta in qos:
            uuids = [u for u in region.uuids() if u in signals]
            if not uuids:
                continue
            breach_any = any(signals[u]["breach"] for u in uuids)
            ready_all = all(signals[u]["ready"] for u in uuids)
            if cls == 0:
                yield_on = any(signals[u]["yield"] for u in uuids)
                if bool(region.qos_yield) != yield_on:
                    log.info("qos: best-effort %s yield -> %s",
                             key, yield_on)
                    region.set_qos_yield(yield_on)
            w = region.qos_weight
            if breach_any:
                nw = (max(cfg.min_weight_pct, w - cfg.step_pct)
                      if cls == 0
                      else min(cfg.max_weight_pct, w + cfg.step_pct))
            elif ready_all:
                nw = (min(100, w + cfg.step_pct) if cls == 0
                      else max(100, w - cfg.step_pct))
            else:
                nw = w
            if nw != w:
                region.set_qos_weight(nw)
                moved = True
                log.info("qos: %s duty weight %d%% -> %d%% (%s)", key,
                         w, nw, "critical p99 breach" if breach_any
                         else "recovered")
        if moved:
            self.reweights_total += 1

    def _chip_signals(self, uuid: str, classes: Dict[int, List[tuple]]
                      ) -> Dict[str, bool]:
        cfg = self.cfg
        critical = classes.get(1, [])
        merged: List[int] = []
        for _key, _region, delta in critical:
            if len(delta) > len(merged):
                merged += [0] * (len(delta) - len(merged))
            for i, n in enumerate(delta):
                merged[i] += n
        p99 = hist_p99_us(merged)
        if p99 is not None:
            self.critical_p99_us[uuid] = p99
        # "Queued work": critical dispatches that actually waited at the
        # gate this tick (nonzero-wait buckets) — the signal best-effort
        # neighbors must stop borrowing idle duty on.
        queued = sum(merged[1:]) > 0
        quiet = self._quiet.get(uuid)
        if queued:
            quiet = 0
        elif quiet is None:
            quiet = cfg.recover_ticks  # no queued work ever seen: no yield
        else:
            quiet += 1
        self._quiet[uuid] = quiet
        breach = p99 is not None and p99 > cfg.target_p99_us
        good = p99 is None or p99 <= cfg.target_p99_us * cfg.recover_frac
        if breach or not good:
            # Breach, or the dead band between recovery and breach:
            # either way the recovery streak restarts.
            self._good[uuid] = 0
        else:
            self._good[uuid] = self._good.get(uuid, 0) + 1
        return {
            "breach": breach,
            "ready": self._good[uuid] >= cfg.recover_ticks,
            "yield": bool(critical) and quiet < cfg.recover_ticks,
        }


def build_nspid_index(proc_root: str = "/proc") -> Dict[int, List[int]]:
    """One walk over /proc: NSpid-tail (the pid as seen inside the innermost
    namespace) → candidate host pids.  Built once per gc pass so resolving N
    region pids costs one scan, not N (each confirmation below then touches
    only the few candidates).

    A status without an NSpid line comes from a kernel that reports no pid
    namespaces (Linux before 4.1, or a user-space kernel such as gVisor's):
    its pid is then the one the monitor sees, and stands for itself.  The
    JAX package's copy skips such a process, so there every live slot
    looks dead and the GC clears it (and zeroes its ``used``)."""
    index: Dict[int, List[int]] = {}
    try:
        entries = os.listdir(proc_root)
    except OSError:
        return index
    for entry in entries:
        if not entry.isdigit():
            continue
        tail = int(entry)
        try:
            with open(os.path.join(proc_root, entry, "status")) as f:
                for line in f:
                    if line.startswith("NSpid:"):
                        tail = int(line.split()[-1])
                        break
        except (OSError, ValueError, IndexError):
            continue
        index.setdefault(tail, []).append(int(entry))
    return index


def _maps_region(region_path: str, host_pid: int,
                 proc_root: str = "/proc") -> bool:
    """Does host process ``host_pid`` actually mmap this region file?
    Confirmed by mapped-file inode (/proc/<pid>/map_files — needs privilege;
    the monitor DaemonSet runs privileged), else path substring in maps."""
    try:
        target = os.stat(region_path)
    except OSError:
        return False
    mf_dir = os.path.join(proc_root, str(host_pid), "map_files")
    try:
        for mf in os.listdir(mf_dir):
            try:
                st = os.stat(os.path.join(mf_dir, mf))
            except OSError:
                continue
            if st.st_ino == target.st_ino and st.st_dev == target.st_dev:
                return True
    except OSError:
        pass
    try:
        with open(os.path.join(proc_root, str(host_pid), "maps")) as f:
            return os.path.basename(region_path) in f.read()
    except OSError:
        return False


def find_host_pid(region_path: str, container_pid: int,
                  proc_root: str = "/proc",
                  index: Optional[Dict[int, List[int]]] = None
                  ) -> Optional[int]:
    """Map a container-namespace pid (as stored in the region by the shim) to
    a host pid: candidate host processes are those whose NSpid chain ends in
    ``container_pid``; the match is confirmed by the process actually mapping
    this region file.

    The reference solves the same problem by walking cgroup tasks files
    (feedback.go:80–159); NSpid + map-inode is the namespace-correct host-side
    equivalent.  When monitor and workload share a PID namespace (tests),
    NSpid has one entry equal to the pid and the check degenerates correctly.
    Pass a prebuilt ``index`` (build_nspid_index) to amortize the /proc walk
    over many lookups.
    """
    if index is None:
        index = build_nspid_index(proc_root)
    for host_pid in index.get(container_pid, []):
        if _maps_region(region_path, host_pid, proc_root):
            return host_pid
    return None


class FeedbackLoop:
    def __init__(self, container_root: str,
                 reader: Optional[RegionReader] = None,
                 qos: Optional[QosConfig] = None) -> None:
        self.container_root = container_root
        self.reader = reader or RegionReader()
        self.qos = QosController(qos)
        self.containers: Dict[str, ContainerState] = {}
        # (container key, container pid) -> confirmed host pid
        self._hostpid_cache: Dict[tuple, int] = {}
        # Serializes the tick against any other thread reading the
        # regions (the usage sampler's readers): rescan munmaps regions a
        # concurrent reader could otherwise be reading.
        self.lock = threading.RLock()

    # -- region lifecycle -----------------------------------------------------
    def rescan(self) -> None:
        found = scan_container_dirs(self.container_root)
        with self.lock:
            for key, path in found.items():
                cur = self.containers.get(key)
                if cur is not None and cur.region.path == path:
                    continue
                region = self.reader.open(path)
                if region is None:
                    continue  # not initialized yet
                if cur is not None:
                    cur.region.close()
                    # New region file under the same key (container restarted
                    # in place): cached host-pid mappings are for the old
                    # region's processes.
                    for ck in [ck for ck in self._hostpid_cache
                               if ck[0] == key]:
                        del self._hostpid_cache[ck]
                self.containers[key] = ContainerState(key=key, region=region)
            for key in list(self.containers):
                if key not in found:
                    self.containers.pop(key).region.close()
                    for ck in [ck for ck in self._hostpid_cache
                               if ck[0] == key]:
                        del self._hostpid_cache[ck]

    # -- one Observe tick -----------------------------------------------------
    def observe(self) -> None:
        with self.lock:
            # Activity census: chip uuid → set of priorities with recent
            # dispatch (lower number = higher priority).
            active_by_chip: Dict[str, Set[int]] = {}
            for c in self.containers.values():
                c.active = c.region.age_kernel() > 0
                if not c.active:
                    continue
                prio = c.region.priority
                for uuid in c.region.uuids():
                    if uuid:
                        active_by_chip.setdefault(uuid, set()).add(prio)

            for c in self.containers.values():
                prio = c.region.priority
                want_on = False
                for uuid in c.region.uuids():
                    others = active_by_chip.get(uuid, set())
                    if any(p < prio for p in others):
                        want_on = True  # a higher-priority sharer is active
                        break
                if bool(c.region.utilization_switch) != want_on:
                    log.info("container %s: utilization_switch -> %s",
                             c.key, want_on)
                    c.region.set_switch(want_on)
            # Graded plane on top of the binary switch: per-class duty
            # re-weighting + best-effort yield from observed critical
            # dispatch-wait p99 (no-op on fleets without QoS regions).
            self.qos.observe(self.containers)

    def gc_dead_procs(self, pid_alive=None) -> int:
        """Clear slots of dead processes and record host pids of live ones.

        Region slots hold container-namespace pids; liveness must be probed
        through the NSpid mapping (see find_host_pid) — a bare
        ``/proc/<pid>`` check on the host would confuse container pids with
        unrelated host processes.  ``pid_alive(pid)->bool`` stays injectable
        for tests."""
        cleared = 0
        with self.lock:
            index = None if pid_alive is not None else build_nspid_index()
            for c in self.containers.values():
                pids = c.region.proc_pids()
                live = []
                for p in pids:
                    if pid_alive is not None:
                        ok = pid_alive(p)
                    else:
                        # Cross-tick cache: re-confirm the cached host pid
                        # directly (one map_files listdir for one process)
                        # instead of walking /proc again.  The NSpid index
                        # alone is NOT sufficient — a recycled host pid in
                        # another container can share the NSpid tail — so
                        # the region mapping is always re-checked.
                        cached = self._hostpid_cache.get((c.key, p))
                        if (cached is not None
                                and cached in index.get(p, [])
                                and _maps_region(c.region.path, cached)):
                            live.append(p)
                            continue
                        host = find_host_pid(c.region.path, p, index=index)
                        ok = host is not None
                        if ok:
                            self._hostpid_cache[(c.key, p)] = host
                            if host != p:
                                c.region.set_hostpid(p, host)
                        else:
                            self._hostpid_cache.pop((c.key, p), None)
                    if ok:
                        live.append(p)
                if len(live) != len(pids):
                    cleared += c.region.gc(live)
        return cleared

    def tick(self) -> None:
        self.rescan()
        self.observe()
        self.gc_dead_procs()

    def close(self) -> None:
        with self.lock:
            for c in self.containers.values():
                c.region.close()
            self.containers.clear()
