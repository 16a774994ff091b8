"""In-container enforcement shim for the PyTorch/CUDA port (Python half).

The port's counterpart of the JAX package's ``shim/core.py``.  The native
half (``libvgpu_torch.so``, built from ``csrc/vgpu/`` on first use) owns
the shared accounting region, the OOM check and the dispatch rate limiter;
this module is the PyTorch integration:

- attaches the process to the region (ctypes onto the native library);
- publishes the caching allocator's reserved bytes
  (``torch.cuda.memory_reserved``) into the region so the monitor and
  sharers see real consumption;
- hard-caps device memory with
  ``torch.cuda.set_per_process_memory_fraction``: the caching allocator
  then raises ``torch.cuda.OutOfMemoryError`` at the grant.  The grant is
  the pod's, so each process's cap is the grant less what the pod's other
  processes have published into the region, set at install and again by
  the watchdog each interval.  No ballast: processes of several pods
  share one GPU, and a ballast of ``physical - limit`` in each would
  reserve memory that belongs to the others.  Blind spots: the CUDA
  context (driver state, kernel images, library handles) lives outside
  the allocator and is not counted against the grant (cuBLAS's workspace
  comes from the allocator and is); and two processes of one pod that
  grow within one watchdog interval of each other can together pass the
  grant until the next interval.  The driver-API interposer
  (``csrc/vgpu/cuda_interposer.cc``, preloaded) closes both; where it is
  loaded this shim stands down (:func:`install`);
- throttles compute by gating the port's dispatch units through the
  native duty-cycle limiter: the step callables of ``models/train.py``
  and ``models/serve.py`` (each consults :func:`gate`) and
  ``torch.cuda.CUDAGraph.replay``.  Eager ops outside them go ungated;
- virtualizes memory introspection: :meth:`Shim.memory_info` reports the
  grant as the total;
- optional active OOM watchdog (``VTPU_OOM_ACTION=kill|exit``, or the
  reference's ``ACTIVE_OOM_KILLER=true``).

Imports the standard library, ctypes and the port's own stdlib-only
modules (the build helper, ``oversub``); ``torch`` is imported inside the
methods that need it, and this module never imports JAX.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
import signal
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ..ops import _kernels
from . import oversub

log = logging.getLogger("vgpu.shim")

MIB = 1024 * 1024
MAX_DEVICES = 16  # csrc/vgpu/shared_region.h VGPU_MAX_DEVICES
QOS_CLASSES = {0: "best-effort", 1: "latency-critical"}


def interposer_active() -> bool:
    """Whether the CUDA driver-API interposer is loaded into this process
    and enforcing: its ``vgpu_interposer_active`` symbol, looked up in the
    process itself, answers 1."""
    try:
        fn = ctypes.CDLL(None).vgpu_interposer_active
    except AttributeError:
        return False
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn() == 1


class Native:
    """ctypes surface of ``libvgpu_torch.so``; builds it on first use
    unless ``path`` names a built library.  Where the interposer is loaded
    (and no ``path`` is given) it binds to the interposer's copy of the
    ``vgpu_*`` functions instead: a second library would take a second
    proc slot and attach the region twice in one process."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.interposed = path is None and interposer_active()
        self.lib = L = ctypes.CDLL(
            None if self.interposed else str(path or _kernels.build_vgpu()))
        c_int, c_u64, c_p = ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p
        L.vgpu_init_path.argtypes = [ctypes.c_char_p]
        L.vgpu_init_path.restype = c_int
        L.vgpu_shutdown.restype = None
        L.vgpu_initialized.restype = c_int
        for fn in ("vgpu_get_limit", "vgpu_get_sm_limit", "vgpu_get_used"):
            getattr(L, fn).argtypes = [c_int]
            getattr(L, fn).restype = c_u64
        for fn in ("vgpu_try_alloc", "vgpu_set_used", "vgpu_free",
                   "vgpu_rate_acquire", "vgpu_rate_feedback"):
            getattr(L, fn).argtypes = [c_int, c_u64]
            getattr(L, fn).restype = None
        L.vgpu_try_alloc.restype = c_int
        L.vgpu_proc_count.restype = c_int
        L.vgpu_gc_dead.restype = c_int
        L.vgpu_region_path.restype = ctypes.c_char_p
        L.vgpu_region.restype = c_p
        L.vgpu_rate_test_mode.argtypes = [c_int]
        L.vgpu_rate_test_mode.restype = None
        L.vgpu_rate_test_advance.argtypes = [c_u64]
        L.vgpu_rate_test_advance.restype = None
        L.vgpu_rate_test_now.restype = c_u64
        # The reader accessors, for the monitor's view of any region file
        # and for this process's own (vgpu_region()).
        L.vgpu_open_region.argtypes = [ctypes.c_char_p]
        L.vgpu_open_region.restype = c_p
        L.vgpu_close_region.argtypes = [c_p]
        L.vgpu_close_region.restype = None
        for fn, res in (
            ("vgpu_r_num_devices", c_int), ("vgpu_r_priority", c_int),
            ("vgpu_r_oversubscribe", c_int), ("vgpu_r_recent_kernel", c_int),
            ("vgpu_r_age_kernel", c_int), ("vgpu_r_get_switch", c_int),
            ("vgpu_r_qos_class", c_int), ("vgpu_r_qos_weight", c_int),
            ("vgpu_r_qos_yield", c_int), ("vgpu_r_qos_wait_count", c_u64),
            ("vgpu_r_qos_wait_us_total", c_u64),
            ("vgpu_r_qos_cost_us_total", c_u64),
        ):
            getattr(L, fn).argtypes = [c_p]
            getattr(L, fn).restype = res
        for fn in ("vgpu_r_limit", "vgpu_r_sm_limit", "vgpu_r_used"):
            getattr(L, fn).argtypes = [c_p, c_int]
            getattr(L, fn).restype = c_u64
        L.vgpu_r_uuid.argtypes = [c_p, c_int]
        L.vgpu_r_uuid.restype = ctypes.c_char_p
        for fn in ("vgpu_r_set_switch", "vgpu_r_set_qos_weight",
                   "vgpu_r_set_qos_yield"):
            getattr(L, fn).argtypes = [c_p, c_int]
            getattr(L, fn).restype = None
        L.vgpu_r_proc_pids.argtypes = [
            c_p, ctypes.POINTER(ctypes.c_int32), c_int]
        L.vgpu_r_proc_pids.restype = c_int
        L.vgpu_r_gc.argtypes = [c_p, ctypes.POINTER(ctypes.c_int32), c_int]
        L.vgpu_r_gc.restype = c_int
        L.vgpu_r_set_hostpid.argtypes = [c_p, ctypes.c_int32, ctypes.c_int32]
        L.vgpu_r_set_hostpid.restype = None
        L.vgpu_r_qos_wait_hist.argtypes = [
            c_p, ctypes.POINTER(ctypes.c_uint64), c_int]
        L.vgpu_r_qos_wait_hist.restype = c_int

    def init(self, path: Optional[str] = None) -> None:
        rc = self.lib.vgpu_init_path(path.encode() if path else None)
        if rc != 0:
            raise OSError(-rc, f"vgpu_init failed: {os.strerror(-rc)}")

    def shutdown(self) -> None:
        self.lib.vgpu_shutdown()

    def read_region(self, path: Optional[str] = None) -> Dict[str, Any]:
        """What the node monitor reads from the region file at ``path``
        (this process's own region when None)."""
        L = self.lib
        h = L.vgpu_open_region(path.encode()) if path else L.vgpu_region()
        if not h:
            raise OSError(f"no initialized region at {path}")
        try:
            n = L.vgpu_r_num_devices(h)
            pids = (ctypes.c_int32 * 1024)()
            hist = (ctypes.c_uint64 * 32)()
            return {
                "num_devices": n,
                "uuids": [L.vgpu_r_uuid(h, i).decode() for i in range(n)],
                "limit": [L.vgpu_r_limit(h, i) for i in range(n)],
                "sm_limit": [L.vgpu_r_sm_limit(h, i) for i in range(n)],
                "used": [L.vgpu_r_used(h, i) for i in range(n)],
                "priority": L.vgpu_r_priority(h),
                "oversubscribe": L.vgpu_r_oversubscribe(h),
                "pids": list(pids[:L.vgpu_r_proc_pids(h, pids, 1024)]),
                "qos_class": L.vgpu_r_qos_class(h),
                "qos_wait_count": L.vgpu_r_qos_wait_count(h),
                "qos_wait_us_total": L.vgpu_r_qos_wait_us_total(h),
                "qos_cost_us_total": L.vgpu_r_qos_cost_us_total(h),
                "qos_wait_hist": list(
                    hist[:L.vgpu_r_qos_wait_hist(h, hist, 32)]),
            }
        finally:
            if path:
                L.vgpu_close_region(h)


def memory_cap_fractions(limits: Dict[int, int], totals: Dict[int, int],
                         others_used: Optional[Dict[int, int]] = None
                         ) -> Dict[int, float]:
    """The per-process memory fraction for each device with a non-zero
    grant: what the grant leaves after the bytes the pod's other processes
    use (``others_used``), over the card's total, between 0 and 1 — the
    argument ``torch.cuda.set_per_process_memory_fraction`` takes."""
    others = others_used or {}
    return {i: min(1.0, max(0, limit - others.get(i, 0)) / totals[i])
            for i, limit in limits.items() if limit > 0}


def _cuda_ready():
    """torch, when this process has already brought CUDA up; else None.
    Never initializes CUDA (the watchdog thread must not)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch


def _cuda_slots(trees) -> List[int]:
    """Device indices of the CUDA tensors in ``trees`` (tensors, and
    lists, tuples and dicts of them, one level deep)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return []
    slots = []
    for x in trees:
        leaves = x.values() if isinstance(x, dict) else \
            x if isinstance(x, (list, tuple)) else (x,)
        for t in leaves:
            if isinstance(t, torch.Tensor) and t.is_cuda and \
                    t.device.index not in slots:
                slots.append(t.device.index)
    return slots


class Shim:
    # Native bucket burst cap (rate_limiter.cc kMaxBurstUs): larger charges
    # are clamped there anyway; clamp here too so estimates stay sane after
    # a first call (allocator warm-up, cuBLAS init) is measured as one.
    MAX_COST_US = 200_000

    def __init__(self, native: Native, clock=time.monotonic) -> None:
        self.native = native
        self._clock = clock
        self._watchdog: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # The driver-API interposer accounts and gates this process: the
        # shim then publishes nothing, caps nothing and gates nothing.
        self.interposed = interposer_active()
        # Set by the watchdog when VTPU_OOM_ACTION=exit trips; consumed by
        # the next dispatching thread at its gate boundary (_gated_call),
        # which performs the teardown + exit.
        self._oom_exit = threading.Event()
        # When the last dispatch entered the gate — lets the teardown wait
        # for dispatch quiescence instead of a blind fixed grace.
        self._last_dispatch_t: Optional[float] = None
        # Threads currently inside the dispatch region.
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # Only one thread performs the teardown.
        self._teardown_once = threading.Lock()
        # Per device slot: the cost the next dispatch is charged, in us.
        self.last_cost_us: Dict[int, int] = {}
        # Every VTPU_SYNC_EVERY-th gated dispatch on the card waits for its
        # device work, so the measured time is device time, not the
        # (asynchronous) launch.
        self._sync_every = max(1, int(os.environ.get("VTPU_SYNC_EVERY", "16")))
        self.dispatches = 0
        # CUDA events recorded after the previous gated dispatch, one per
        # device it ran on: a synced sample first drains the queue up to
        # them, so it times exactly one dispatch.
        self._prev_events: List[Any] = []
        # Depth of gated calls on each thread: a dispatch unit called
        # inside another (OffloadedTrainStep around a train step) is part
        # of the outer one and is not gated again.
        self._local = threading.local()
        self._spiller: Optional[oversub.PressureSpiller] = None
        # What this process last published into the region, per device.
        self._published: Dict[int, int] = {}
        # The memory fractions set, per device; empty while uncapped.
        self.fractions: Dict[int, float] = {}
        self._totals: Dict[int, int] = {}

    # -- introspection ---------------------------------------------------------
    def memory_info(self, dev: int = 0) -> Dict[str, int]:
        """Virtualized view: 'total' is the grant, not the physical card."""
        return {
            "total": int(self.native.lib.vgpu_get_limit(dev)),
            "used": int(self.native.lib.vgpu_get_used(dev)),
        }

    def qos_info(self) -> Dict[str, Any]:
        """This container's QoS view: the class the grant carried, the
        duty weight the monitor currently applies, and the dispatch-wait
        accounting the limiter has recorded.  ``class`` is None for
        unclassed (flat-limiter) containers."""
        lib = self.native.lib
        r = lib.vgpu_region()
        cls = int(lib.vgpu_r_qos_class(r))
        return {
            "class": QOS_CLASSES.get(cls),
            "duty_weight_pct": (int(lib.vgpu_r_qos_weight(r))
                                if cls >= 0 else None),
            "yield": bool(lib.vgpu_r_qos_yield(r)) if cls >= 0 else False,
            "wait_count": int(lib.vgpu_r_qos_wait_count(r)),
            "wait_us_total": int(lib.vgpu_r_qos_wait_us_total(r)),
            "cost_us_total": int(lib.vgpu_r_qos_cost_us_total(r)),
        }

    # -- compute throttling ----------------------------------------------------
    def throttled(self, fn, dev: int = 0):
        """Gate a plain synchronous callable through the native duty-cycle
        limiter on a fixed device slot, feeding its wall time back as
        cost."""

        @functools.wraps(fn)
        def gated(*args, **kwargs):
            return self._gated_call(fn, args, kwargs, slots=[dev])

        return gated

    def _gated_call(self, fn, args, kwargs, slots=None):
        """One gated dispatch (see _dispatch).  ``slots`` fixes the device
        slots and makes the callable synchronous (its wall time is its
        cost); by default they are the devices of the CUDA tensors among
        the arguments, else the current device."""
        depth = getattr(self._local, "depth", 0)
        if depth:
            return fn(*args, **kwargs)
        # Increment FIRST, then check the flag: checking before entering
        # the region would let a dispatch slip between the check and the
        # increment while the teardown scans _inflight == 0.  The host
        # swap runs here too, under the lock: it spills only while no
        # other dispatch is in flight, and nothing enters while it runs.
        with self._inflight_lock:
            if self._spiller is not None:
                self._spiller.before_dispatch((args, kwargs),
                                              idle=self._inflight == 0)
            self._inflight += 1
        if self._oom_exit.is_set():
            with self._inflight_lock:
                self._inflight -= 1
            self._oom_teardown()
        self._local.depth = 1
        try:
            return self._dispatch(fn, args, kwargs, slots)
        finally:
            self._local.depth = 0
            with self._inflight_lock:
                self._inflight -= 1

    def _dispatch(self, fn, args, kwargs, fixed_slots):
        """Acquire on every slot, run, periodically sync for a
        device-time-accurate cost sample, then feed estimates back.

        Cost model (the JAX shim's): wall time around an asynchronous
        dispatch under-charges (the call returns before the card
        finishes), so every Nth dispatch is timed synced and that sample
        becomes the estimate; unsynced samples only ever raise it.  The
        synced sample must cover exactly ONE dispatch: waiting on its own
        result alone would also wait for every earlier dispatch still
        queued and inflate the charge, so the queue is drained first — a
        sync on the events recorded after the previous dispatch.  Error
        bound: between syncs the estimate lags workload changes by at most
        N dispatches.  Where no CUDA work is involved the call is
        synchronous and its wall time is the cost."""
        self._last_dispatch_t = self._clock()
        torch = _cuda_ready()
        slots = fixed_slots or _cuda_slots(args) or \
            [torch.cuda.current_device() if torch else 0]
        lib = self.native.lib
        for s in slots:
            lib.vgpu_rate_acquire(
                s, min(self.last_cost_us.get(s, 0), self.MAX_COST_US))
        self.dispatches += 1
        on_card = fixed_slots is None and torch is not None
        sync_turn = on_card and self.dispatches % self._sync_every == 0
        if sync_turn:
            for ev in self._prev_events:
                ev.synchronize()
            self._prev_events = []
        t0 = self._clock()
        out = fn(*args, **kwargs)
        torch = _cuda_ready() if fixed_slots is None else None
        events = []
        if torch is not None:  # the callable may have brought CUDA up
            for s in slots:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(s))
                events.append(ev)
            if sync_turn:
                for ev in events:
                    ev.synchronize()
        busy = int((self._clock() - t0) * 1e6)
        if events and sync_turn:
            # The timed window holds the host's launches and the sync's
            # round trip on top of device time; a second sync on the
            # already-complete events costs only the round trip, so
            # subtracting it leaves (about) device time.  Floored, not
            # zero: a 0 charge would let an unthrottled stream starve
            # sharers.
            t1 = self._clock()
            for ev in events:
                ev.synchronize()
            busy = max(busy - int((self._clock() - t1) * 1e6), 100)
        if events:
            self._prev_events = events
        for s in slots:
            if events and not sync_turn:
                # Asynchronous dispatch: unsynced wall time is a lower
                # bound, so it may only raise the last synced estimate.
                prev = self.last_cost_us.get(s, 0)
                est = busy if not prev else max(prev, busy)
            else:
                # Synced, or synchronous: the sample is the cost, and the
                # last one wins so one slow first call can't ratchet the
                # charge up for good.
                est = busy
            self.last_cost_us[s] = min(est, self.MAX_COST_US)
            lib.vgpu_rate_feedback(s, self.last_cost_us[s])
        return out

    def install_torch_hooks(self) -> None:
        """Make this shim the gate of the port's dispatch units: the step
        callables that consult :func:`gate`, and every
        ``torch.cuda.CUDAGraph.replay``."""
        global _GATE
        _GATE = self
        import torch

        graph = torch.cuda.CUDAGraph
        if not getattr(graph.replay, "_vgpu_gated", False):
            orig = graph.replay

            def replay(graph_self):
                return gate(orig, graph_self)

            replay._vgpu_gated = True  # type: ignore[attr-defined]
            graph.replay = replay

    # -- device-memory hard cap ------------------------------------------------
    def others_used(self) -> Dict[int, int]:
        """Per granted device, the bytes the pod's other processes have
        published into the region (its total less this process's own)."""
        lib = self.native.lib
        lib.vgpu_gc_dead()  # a dead sharer's bytes are not in use
        out = {}
        for i in range(MAX_DEVICES):
            if lib.vgpu_get_limit(i) > 0:
                out[i] = max(0, int(lib.vgpu_get_used(i))
                             - self._published.get(i, 0))
        return out

    def cap_fractions(self, totals: Dict[int, int]) -> Dict[int, float]:
        """The fractions the cap sets on cards of ``totals`` bytes: each
        grant less the pod's other processes' use, over the total."""
        limits = {i: int(self.native.lib.vgpu_get_limit(i))
                  for i in range(MAX_DEVICES)}
        return memory_cap_fractions(limits, totals, self.others_used())

    def apply_memory_cap(self) -> Dict[int, float]:
        """Cap the caching allocator of each granted device at what the
        pod's grant leaves this process (``cap_fractions``); returns the
        fractions set.  Counts allocations made after the call only, so
        install before the model loads.  Raises when a device with a
        grant is not visible: a cap that cannot be applied is no cap."""
        import torch

        limits = {i: int(self.native.lib.vgpu_get_limit(i))
                  for i in range(MAX_DEVICES)}
        missing = [i for i, limit in limits.items()
                   if limit > 0 and i >= torch.cuda.device_count()]
        if missing:
            raise RuntimeError(
                f"device memory grants for devices {missing}, but torch "
                f"sees {torch.cuda.device_count()} CUDA devices")
        self._totals = {i: torch.cuda.get_device_properties(i).total_memory
                        for i in limits if limits[i] > 0}
        for i in self._totals:
            if torch.cuda.is_initialized() and \
                    torch.cuda.memory_reserved(i) > limits[i]:
                log.warning("device %d already holds %d MiB, over its grant "
                            "of %d MiB", i,
                            torch.cuda.memory_reserved(i) // MIB,
                            limits[i] // MIB)
        self._set_fractions(torch, self.cap_fractions(self._totals))
        return dict(self.fractions)

    def refresh_memory_cap(self) -> None:
        """Set the cap again from the region (the watchdog, each
        interval): what the pod's other processes hold now."""
        torch = _cuda_ready()
        if torch is None or not self.fractions:
            return
        self._set_fractions(torch, self.cap_fractions(self._totals))

    def _set_fractions(self, torch, fractions: Dict[int, float]) -> None:
        for i, fraction in fractions.items():
            if self.fractions.get(i) == fraction:
                continue
            torch.cuda.set_per_process_memory_fraction(fraction, i)
            self.fractions[i] = fraction
            log.info("memory cap on device %d: %d MiB (%.4f of %d MiB)", i,
                     int(fraction * self._totals[i]) // MIB, fraction,
                     self._totals[i] // MIB)

    # -- accounting + watchdog -------------------------------------------------
    def publish_usage_once(self) -> None:
        """Publish each device's reserved bytes into the region.  Samples
        only if this process has already brought CUDA up: the watchdog
        must never initialize it itself."""
        torch = _cuda_ready()
        if torch is None or self.interposed:
            return  # interposed: the interposer's charges are the use
        for i in range(min(torch.cuda.device_count(), MAX_DEVICES)):
            self._published[i] = torch.cuda.memory_reserved(i)
            self.native.lib.vgpu_set_used(i, self._published[i])

    def start_watchdog(self, interval: float = 1.0) -> None:
        action = os.environ.get("VTPU_OOM_ACTION", "")
        if not action:
            killer = os.environ.get("ACTIVE_OOM_KILLER", "").lower()
            action = "kill" if killer in ("true", "1") else "warn"

        def loop():
            warned = False
            while not self._stop.wait(interval):
                self.publish_usage_once()
                self.refresh_memory_cap()
                for i in range(MAX_DEVICES):
                    limit = int(self.native.lib.vgpu_get_limit(i))
                    if limit <= 0:
                        continue
                    used = int(self.native.lib.vgpu_get_used(i))
                    if used <= limit:
                        continue
                    if action == "kill":
                        log.error("device memory grant exceeded on dev %d "
                                  "(%d > %d MiB); killing process", i,
                                  used // MIB, limit // MIB)
                        os.kill(os.getpid(), signal.SIGKILL)
                    elif action == "exit":
                        # The same outcome as kill (exit code 137), after
                        # in-flight dispatches have drained.
                        log.error("device memory grant exceeded on dev %d "
                                  "(%d > %d MiB); exiting", i, used // MIB,
                                  limit // MIB)
                        self._oom_exit.set()
                        self._oom_teardown()
                    elif not warned:
                        log.warning("device memory grant exceeded on dev %d "
                                    "(%d > %d MiB)", i, used // MIB,
                                    limit // MIB)
                        warned = True

        self._watchdog = threading.Thread(target=loop, daemon=True)
        self._watchdog.start()

    def stop(self) -> None:
        """End the watchdog (within one interval) and detach the host-swap
        spiller; the region stays attached."""
        self._stop.set()
        with self._inflight_lock:
            self._spiller = None

    def _oom_teardown(self) -> None:
        """Terminal stage of ``VTPU_OOM_ACTION=exit``: wait until no
        dispatch is in flight and the last one has had its estimated
        device time (x2) to drain, then die with the OOM-kill exit code.
        An uncosted dispatch is never provably quiescent, so the wait runs
        to the hard deadline (``VTPU_OOM_EXIT_GRACE_S``)."""
        if not self._teardown_once.acquire(blocking=False):
            # Another thread is tearing down; park until it exits.
            while True:
                time.sleep(0.1)
        grace = float(os.environ.get("VTPU_OOM_EXIT_GRACE_S", "60"))
        hard = self._clock() + grace
        while self._clock() < hard:
            if self._inflight == 0 and self._quiescent():
                break
            time.sleep(0.25)
        os._exit(137)

    def _quiescent(self) -> bool:
        last = self._last_dispatch_t
        if last is None:
            return True
        costs = list(self.last_cost_us.values())
        if not costs:
            return False  # in-flight duration unknown — not provable
        return self._clock() - last > max(1.0, 2.0 * max(costs) / 1e6)

    # -- oversubscription (virtual device memory) ------------------------------
    def attach_pressure_spiller(self) -> oversub.PressureSpiller:
        """Bring up device->host swap for oversubscribed grants (reference
        CUDA_OVERSUBSCRIBE): at each gated dispatch, tensors registered in
        ``oversub.global_store()`` are spilled LRU to pinned host memory
        when a card's allocated bytes near its physical size, and the
        dispatch's own are brought back (``_gated_call``)."""
        import torch

        physical = torch.cuda.get_device_properties(0).total_memory
        self._spiller = oversub.PressureSpiller(oversub.global_store(),
                                                physical)
        return self._spiller


# The installed shim every dispatch unit consults (install_torch_hooks).
_GATE: Optional[Shim] = None


def gate(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` as one dispatch of the installed shim's
    duty-cycle gate; with no shim installed, just call it."""
    shim = _GATE
    if shim is None:
        return fn(*args, **kwargs)
    return shim._gated_call(fn, args, kwargs)


def gated(fn):
    """Decorator: every call of ``fn`` is one dispatch through
    :func:`gate`."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return gate(fn, *args, **kwargs)

    return wrapper


_GLOBAL: Optional[Shim] = None


def install(region_path: Optional[str] = None, torch_hooks: bool = True,
            memory_cap: Optional[bool] = None, watchdog: bool = True,
            native: Optional[Native] = None) -> Shim:
    """Full shim bring-up; idempotent.  The memory cap is on unless the
    grant oversubscribes (``CUDA_OVERSUBSCRIBE``), where host swap at the
    gate takes its place.  Where the driver-API interposer is loaded the
    shim stands down, as the JAX shim does under its PJRT interposer: the
    interposer charges every allocation and the context and gates every
    launch, so a memory fraction would cap the allocator a second time and
    gating the step callables would stack a second token bucket on the
    interposer's.  The shim then sets no fraction, gates nothing and
    publishes nothing; it reads the region through the interposer."""
    global _GLOBAL
    if _GLOBAL is not None:
        return _GLOBAL
    native = native or Native()
    native.init(region_path)
    shim = Shim(native)
    oversubscribed = oversub.enabled_from_env() and not shim.interposed
    if shim.interposed:
        torch_hooks = memory_cap = False
    elif memory_cap is None:
        memory_cap = not oversubscribed
    if torch_hooks:
        shim.install_torch_hooks()
    if memory_cap:
        shim.apply_memory_cap()
    if oversubscribed:
        shim.attach_pressure_spiller()
    if watchdog:
        shim.start_watchdog()
    _GLOBAL = shim
    return shim


def autoinstall() -> Optional[Shim]:
    """Entry for a container's startup hook: acts only inside managed
    containers (``CUDA_DEVICE_MEMORY_SHARED_CACHE`` set).  A failed
    install raises: a managed container never runs unenforced."""
    if os.environ.get("VTPU_DISABLE"):
        return None
    if not os.environ.get("CUDA_DEVICE_MEMORY_SHARED_CACHE"):
        return None
    return install()
