"""Co-residency lab of the PyTorch/CUDA port: N REAL native limiters in
one process, virtual time.

The port's own copy of the JAX package's ``shim/simlab.py``, on
``libvgpu_torch.so`` (``csrc/vgpu/``).  The library keeps its attached
region, its token buckets and its deterministic test clock in
process-private globals — one container per process in production.
Simulating co-residency (a latency-critical serving pod next to a
best-effort training neighbor on one GPU) therefore needs N independent
instances of those globals in ONE Python process, driven on a virtual
clock so the run is deterministic and takes microseconds of wall time.

The trick: the dynamic loader dedups shared objects by (device, inode),
so a fresh *copy* of the library gets its own private globals.  Each
simulated container is one copy, attached to its own region file laid
out exactly like the device plugin's container root
(``<root>/<podUID_podName>/cudevshr.cache``), with the limiter switched
into manual-clock test mode (``vgpu_rate_test_mode``).  The region files
are ordinary mmap-shared state, so the port's REAL monitor stack —
RegionReader, FeedbackLoop, QosController, UsageSampler — runs against
the lab unmodified.

Nothing here runs in production containers.  Imports the standard
library and the port's stdlib-only modules; never torch.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from typing import Dict, List, Optional

from ..ops import _kernels

#: The GPU every lab container holds unless told otherwise (the
#: ``NVIDIA_VISIBLE_DEVICES`` UUID its region is created with).
LAB_GPU = "GPU-00000000-1111-2222-3333-444444444444"

#: Env keys a container's region init reads (csrc/vgpu/region.cc apply_env_limits)
#: — saved and restored around every attach so the lab never leaks state
#: into the host process environment.
_ENV_KEYS = (
    "VTPU_DISABLE",
    "CUDA_DEVICE_MEMORY_SHARED_CACHE",
    "CUDA_DEVICE_MEMORY_LIMIT",
    "CUDA_DEVICE_MEMORY_LIMIT_0",
    "CUDA_DEVICE_SM_LIMIT",
    "NVIDIA_VISIBLE_DEVICES",
    "CUDA_TASK_PRIORITY",
    "CUDA_OVERSUBSCRIBE",
    "VTPU_QOS_CLASS",
)


def _declare(lib: ctypes.CDLL) -> None:
    lib.vgpu_init_path.argtypes = [ctypes.c_char_p]
    lib.vgpu_init_path.restype = ctypes.c_int
    lib.vgpu_rate_acquire.argtypes = [ctypes.c_int, ctypes.c_uint64]
    lib.vgpu_rate_feedback.argtypes = [ctypes.c_int, ctypes.c_uint64]
    lib.vgpu_rate_test_mode.argtypes = [ctypes.c_int]
    lib.vgpu_rate_test_advance.argtypes = [ctypes.c_uint64]
    lib.vgpu_rate_test_now.restype = ctypes.c_uint64
    lib.vgpu_region.restype = ctypes.c_void_p
    lib.vgpu_r_qos_class.argtypes = [ctypes.c_void_p]
    lib.vgpu_r_qos_weight.argtypes = [ctypes.c_void_p]
    lib.vgpu_r_qos_yield.argtypes = [ctypes.c_void_p]
    for fn in ("vgpu_r_qos_wait_count", "vgpu_r_qos_wait_us_total",
               "vgpu_r_qos_cost_us_total"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_uint64
    lib.vgpu_r_qos_wait_hist.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
    lib.vgpu_r_qos_wait_hist.restype = ctypes.c_int
    lib.vgpu_r_set_switch.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.vgpu_r_set_qos_weight.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.vgpu_r_set_qos_yield.argtypes = [ctypes.c_void_p, ctypes.c_int]


class SimContainer:
    """One simulated container: a private limiter instance on a manual
    clock plus its region file.  Time unit is MICROSECONDS of virtual
    time; the container's clock is advanced explicitly (``advance``) or
    implicitly by the limiter's own wait loop inside ``acquire``."""

    def __init__(self, key: str, lib: ctypes.CDLL, cache_path: str) -> None:
        self.key = key
        self.lib = lib
        self.cache_path = cache_path
        self._region = lib.vgpu_region()

    # -- virtual clock ---------------------------------------------------------
    @property
    def now_us(self) -> int:
        return int(self.lib.vgpu_rate_test_now()) // 1000

    def advance(self, us: int) -> None:
        """Advance this container's virtual clock (device executing,
        time passing between arrivals)."""
        if us > 0:
            self.lib.vgpu_rate_test_advance(int(us) * 1000)

    def advance_to(self, t_us: int) -> None:
        self.advance(int(t_us) - self.now_us)

    # -- data plane ------------------------------------------------------------
    def acquire(self, cost_us: int, dev: int = 0) -> int:
        """One gated dispatch: blocks (by advancing this container's
        virtual clock) until the limiter admits it; returns the wait in
        virtual microseconds."""
        t0 = self.now_us
        self.lib.vgpu_rate_acquire(dev, int(cost_us))
        return self.now_us - t0

    def feedback(self, busy_us: int, dev: int = 0) -> None:
        self.lib.vgpu_rate_feedback(dev, int(busy_us))

    def set_switch(self, on: bool) -> None:
        """Flip this region's classic priority switch directly (tests;
        the monitor normally owns this)."""
        self.lib.vgpu_r_set_switch(self._region, 1 if on else 0)

    def set_qos_weight(self, pct: int) -> None:
        self.lib.vgpu_r_set_qos_weight(self._region, int(pct))

    def set_qos_yield(self, on: bool) -> None:
        self.lib.vgpu_r_set_qos_yield(self._region, 1 if on else 0)

    # -- observability (reads this container's own region) ---------------------
    def qos_stats(self) -> Dict[str, object]:
        r = self._region
        buf = (ctypes.c_uint64 * 32)()
        n = self.lib.vgpu_r_qos_wait_hist(r, buf, 32)
        return {
            "class": int(self.lib.vgpu_r_qos_class(r)),
            "weight_pct": int(self.lib.vgpu_r_qos_weight(r)),
            "yield": int(self.lib.vgpu_r_qos_yield(r)),
            "wait_count": int(self.lib.vgpu_r_qos_wait_count(r)),
            "wait_us_total": int(self.lib.vgpu_r_qos_wait_us_total(r)),
            "cost_us_total": int(self.lib.vgpu_r_qos_cost_us_total(r)),
            "wait_hist": list(buf[:n]),
        }

    def close(self) -> None:
        try:
            self.lib.vgpu_shutdown()
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass


class CoresidencyLab:
    """Factory for SimContainers sharing one container-root directory.

    ``root`` doubles as the monitor's ``--container-root``: point a real
    FeedbackLoop at it and the lab's containers are scanned, observed and
    QoS-re-weighted exactly like production pods."""

    def __init__(self, root: str, library: Optional[str] = None) -> None:
        self.root = root
        self.library = str(library or _kernels.build_vgpu())
        self._libdir = os.path.join(root, ".libs")
        os.makedirs(self._libdir, exist_ok=True)
        self.containers: List[SimContainer] = []

    def add_container(
        self,
        key: str,
        *,
        core_limit: int,
        qos_class: str = "",
        priority: int = 0,
        mem_mib: int = 1024,
        gpus: str = LAB_GPU,
    ) -> SimContainer:
        """Attach one simulated container holding ``gpus`` (comma-separated
        UUIDs).  ``qos_class`` is the vtpu.dev/qos value ("" = no
        annotation: the flat limiter path, exactly like a no-QoS fleet)."""
        ctr_dir = os.path.join(self.root, key)
        os.makedirs(ctr_dir, exist_ok=True)
        cache = os.path.join(ctr_dir, "cudevshr.cache")
        so_copy = os.path.join(self._libdir, f"{key}.so")
        shutil.copy(self.library, so_copy)

        saved = {k: os.environ.get(k) for k in _ENV_KEYS}
        try:
            # A preloaded copy's constructor attaches at dlopen using the
            # env as it stands — suppress it and attach explicitly instead,
            # so the region init reads exactly THIS container's env.
            os.environ["VTPU_DISABLE"] = "1"
            lib = ctypes.CDLL(so_copy)
            _declare(lib)
            del os.environ["VTPU_DISABLE"]
            for k in _ENV_KEYS:
                os.environ.pop(k, None)
            os.environ["CUDA_DEVICE_MEMORY_LIMIT_0"] = str(mem_mib)
            os.environ["CUDA_DEVICE_SM_LIMIT"] = str(core_limit)
            os.environ["NVIDIA_VISIBLE_DEVICES"] = gpus
            os.environ["CUDA_TASK_PRIORITY"] = str(priority)
            if qos_class:
                os.environ["VTPU_QOS_CLASS"] = qos_class
            rc = lib.vgpu_init_path(cache.encode())
            if rc != 0:
                raise OSError(-rc, f"vgpu_init_path({cache}) failed")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        lib.vgpu_rate_test_mode(1)
        ctr = SimContainer(key, lib, cache)
        self.containers.append(ctr)
        return ctr

    def sync_to(self, t_us: int) -> None:
        """Bring every container's virtual clock up to ``t_us`` (clocks
        are per-container; a segment boundary aligns them)."""
        for c in self.containers:
            if c.now_us < t_us:
                c.advance_to(t_us)

    def max_now_us(self) -> int:
        return max((c.now_us for c in self.containers), default=0)

    def close(self) -> None:
        for c in self.containers:
            c.close()
        self.containers.clear()
        shutil.rmtree(self._libdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# serving co-residency A/B driver
# ---------------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """Nearest-rank percentile over raw values (bench.py convention)."""
    if not values:
        return 0.0
    s = sorted(values)
    rank = max(1, int(len(s) * q + 0.999999))
    return float(s[min(rank, len(s)) - 1])


def _wait_stats(waits: List[int], admitted_us: int) -> dict:
    return {
        "dispatches": len(waits),
        "wait_p50_us": percentile(waits, 0.50),
        "wait_p99_us": percentile(waits, 0.99),
        "wait_mean_us": (sum(waits) / len(waits)) if waits else 0.0,
        "wait_max_us": float(max(waits, default=0)),
        "admitted_device_s": admitted_us / 1e6,
    }


def drive_serving(
    root: str,
    tiered: bool,
    phases: List[dict],
    *,
    qos_cfg=None,
    monitor_interval_s: float = 0.5,
    serve_core: int = 50,
    train_core: int = 50,
    segment_us: int = 100_000,
    library: Optional[str] = None,
) -> dict:
    """One leg of the serving-QoS A/B: a latency-critical serve-decode
    stream next to a best-effort training neighbor on ONE GPU, through
    the REAL native limiters on virtual clocks, with the port's REAL monitor
    feedback loop (FeedbackLoop + QosController) closing per-class duty
    re-weighting — all deterministic (no RNG, manual clocks).

    ``tiered=False`` is the flat baseline: no vtpu.dev/qos classes, and
    ``GPU_CORE_UTILIZATION_POLICY=force`` — the only flat configuration
    that actually ENFORCES both grants (prio-0 serve would run free and
    violate its share; that is the enforcement hole the QoS tier fixes).
    ``tiered=True`` runs the production QoS path: latency-critical serve
    with burst credit, best-effort train with hard duty + idle borrowing,
    monitor re-weighting on observed critical p99.

    ``phases``: [{"duration_s", "serve": {"period_us", "burst",
    "cost_us"} | None, "train": {"cost_us"} | None}, ...] — e.g. a surge
    phase whose serve demand exceeds its share followed by a lull.

    Returns per-class waits/goodput, duty-weight excursions and the
    grant-accounting totals the verdict checks violations against."""
    from ..monitor.feedback import FeedbackLoop
    from ..monitor.reader import RegionReader

    lab = CoresidencyLab(root, library=library)
    saved_policy = os.environ.get("GPU_CORE_UTILIZATION_POLICY")
    if tiered:
        os.environ.pop("GPU_CORE_UTILIZATION_POLICY", None)
    else:
        os.environ["GPU_CORE_UTILIZATION_POLICY"] = "force"
    try:
        serve = lab.add_container(
            "uidS_serve", core_limit=serve_core, priority=0,
            qos_class="latency-critical" if tiered else "")
        train = lab.add_container(
            "uidT_train", core_limit=train_core, priority=1,
            qos_class="best-effort" if tiered else "")
        loop = FeedbackLoop(root, reader=RegionReader(lab.library),
                            qos=qos_cfg)
        loop.rescan()

        per_phase: List[dict] = []
        all_serve: List[int] = []
        all_train: List[int] = []
        admitted_total = {"serve": 0, "train": 0}
        weights = {"serve": [100], "train": [100]}
        tick_us = int(monitor_interval_s * 1e6)
        t = 0
        next_arrival = 0
        next_tick = tick_us
        for phase in phases:
            phase_end = t + int(phase["duration_s"] * 1e6)
            sv = phase.get("serve")
            tr = phase.get("train")
            serve_waits: List[int] = []
            train_waits: List[int] = []
            admitted = {"serve": 0, "train": 0}
            while t < phase_end:
                seg_end = min(t + segment_us, phase_end)
                if sv is not None:
                    while next_arrival < seg_end:
                        if serve.now_us < next_arrival:
                            serve.advance_to(next_arrival)
                        for _ in range(sv["burst"]):
                            w = serve.acquire(sv["cost_us"])
                            serve.advance(sv["cost_us"])
                            serve_waits.append(w)
                            admitted["serve"] += sv["cost_us"]
                        next_arrival += sv["period_us"]
                if tr is not None:
                    while train.now_us < seg_end:
                        w = train.acquire(tr["cost_us"])
                        train.advance(tr["cost_us"])
                        train_waits.append(w)
                        admitted["train"] += tr["cost_us"]
                t = seg_end
                lab.sync_to(t)
                while t >= next_tick:
                    # One monitor tick: activity census + classic switch
                    # + QoS re-weighting, through the real reader stack.
                    loop.observe()
                    weights["serve"].append(
                        serve.qos_stats()["weight_pct"])
                    weights["train"].append(
                        train.qos_stats()["weight_pct"])
                    next_tick += tick_us
            # An idle phase boundary still lets arrivals skip ahead.
            if sv is None:
                next_arrival = max(next_arrival, phase_end)
            per_phase.append({
                "name": phase.get("name", f"phase-{len(per_phase)}"),
                "duration_s": phase["duration_s"],
                "critical": _wait_stats(serve_waits,
                                        admitted["serve"]),
                "best_effort": _wait_stats(train_waits,
                                           admitted["train"]),
            })
            all_serve += serve_waits
            all_train += train_waits
            admitted_total["serve"] += admitted["serve"]
            admitted_total["train"] += admitted["train"]
        elapsed_us = t
        loop.close()
        return {
            "tiered": tiered,
            "elapsed_s": elapsed_us / 1e6,
            "phases": per_phase,
            "critical": _wait_stats(all_serve, admitted_total["serve"]),
            "best_effort": _wait_stats(all_train,
                                       admitted_total["train"]),
            "duty_weights": {
                "critical_max": max(weights["serve"]),
                "best_effort_min": min(weights["train"]),
                "critical_final": weights["serve"][-1],
                "best_effort_final": weights["train"][-1],
            },
            "reweights": loop.qos.reweights_total,
        }
    finally:
        if saved_policy is None:
            os.environ.pop("GPU_CORE_UTILIZATION_POLICY", None)
        else:
            os.environ["GPU_CORE_UTILIZATION_POLICY"] = saved_policy
        lab.close()


#: One serve-decode chunk: 60 TP-sharded int4 decode steps of ~10ms
#: back-to-back (600ms of device time — the models/serve.py serve leg's
#: dispatch shape), arriving every 2s: 30% average duty against a 50%
#: share.  Each chunk NET-drains 300ms of tokens (running at 100% while
#: refilling at 50%), past the flat bucket's 200ms cap — so the flat
#: limiter queues the chunk's tail (~20 steps wait ~10ms each) while the
#: tokens+credit pool (600ms net) admits it whole, and the idle 1.4s
#: repays the debt in full before the next chunk in both modes.
_BURSTY_SERVE = {"period_us": 2_000_000, "burst": 60, "cost_us": 10_000}
#: Sustained overload: 80 ms of decode every 100 ms (80% demand > 50%
#: share) — beyond what credit can absorb, so only the monitor's duty
#: re-weighting can restore critical latency (at the training
#: neighbor's expense, returned on recovery).
_OVERLOAD_SERVE = {"period_us": 100_000, "burst": 8, "cost_us": 10_000}
_TRAIN = {"cost_us": 20_000}

#: bench_coresidency scenario: bursty-within-share serving next to a
#: saturating trainer — the credit win, with the neighbor untouched.
BENCH_PHASES = [
    {"name": "bursty", "duration_s": 60.0,
     "serve": _BURSTY_SERVE, "train": _TRAIN},
]

#: qos-sim scenario: the full story — credit win, overload forcing the
#: re-weighting loop to the ceiling, hysteresis handing duty back in
#: recovery, then steady state again.
SERVING_PHASES = [
    {"name": "bursty", "duration_s": 30.0,
     "serve": _BURSTY_SERVE, "train": _TRAIN},
    {"name": "overload", "duration_s": 10.0,
     "serve": _OVERLOAD_SERVE, "train": _TRAIN},
    {"name": "recovery", "duration_s": 15.0,
     "serve": None, "train": _TRAIN},
    {"name": "bursty-2", "duration_s": 20.0,
     "serve": _BURSTY_SERVE, "train": _TRAIN},
]


def serving_qos_config():
    """Controller tuning for the canonical scenarios: the p99 target
    (1ms) sits BELOW the ceiling-weight steady wait of a 10ms step, so
    under sustained overload the controller drives duty to the ceiling
    and holds it there (the dead band cannot stall the ramp), and duty
    returns only when the critical class actually goes quiet."""
    from ..monitor.feedback import QosConfig

    return QosConfig(target_p99_us=1000, step_pct=40,
                     min_weight_pct=25, max_weight_pct=175,
                     recover_ticks=12)


def serving_violations(leg: dict, serve_core: int = 50,
                       train_core: int = 50,
                       max_weight_pct: int = 175) -> List[str]:
    """Grant-limit violations of one A/B leg (verdict input): no class
    may exceed its ENTITLED duty over the run —

    - the critical class is bounded by its share × the weight ceiling
      plus the constant bucket+credit allowance;
    - flat-leg containers are bounded by their flat share plus the
      bucket allowance;
    - tiered best-effort has no class bound beyond wall time: borrowing
      measured-idle duty when no critical work is queued is sanctioned
      behavior (the whole point of co-residency), and GPU-level
      serialization is the hardware's property, not the limiter's (each
      lab container runs on its own virtual clock).
    """
    out: List[str] = []
    elapsed = leg["elapsed_s"]
    allow = 0.4 + 1e-6  # kMaxBurstUs + kBurstCreditUs, in seconds
    crit = leg["critical"]["admitted_device_s"]
    be = leg["best_effort"]["admitted_device_s"]
    if leg["tiered"]:
        cap = serve_core / 100.0 * max_weight_pct / 100.0
        if crit > cap * elapsed + allow:
            out.append(f"critical over entitled share: {crit:.3f}s > "
                       f"{cap:.3f} x {elapsed:.1f}s")
        if be > elapsed + allow:
            out.append(f"best-effort beyond wall time: {be:.3f}s")
    else:
        if crit > serve_core / 100.0 * elapsed + allow:
            out.append(f"flat serve over share: {crit:.3f}s")
        if be > train_core / 100.0 * elapsed + allow:
            out.append(f"flat train over share: {be:.3f}s")
    return out
