"""Host-side region access for the node monitor of the PyTorch/CUDA port.

The port's counterpart of the JAX package's ``monitor/reader.py``: the
reference monitor mmaps each container's cache file
(cmd/vGPUmonitor/cudevshr.go:134–158); here ``libvgpu_torch``'s
opaque-handle reader API (``csrc/vgpu/reader.cc``, ``vgpu.h``) does, so
Python never mirrors the struct layout.  The library comes from an
explicit path or is built from ``csrc/vgpu/`` (``ops/_kernels.build_vgpu``).

Imports the standard library and the port's stdlib-only modules; never
torch (a node monitor is a daemon that never touches the card).
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional

from ..ops import _kernels
from ..shim.core import Native


class Region:
    """One container's live shared region."""

    def __init__(self, lib, handle, path: str) -> None:
        self._lib = lib
        self._h = handle
        self.path = path

    def close(self) -> None:
        if self._h:
            self._lib.vgpu_close_region(self._h)
            self._h = None

    @property
    def num_devices(self) -> int:
        return self._lib.vgpu_r_num_devices(self._h)

    def uuid(self, dev: int) -> str:
        return self._lib.vgpu_r_uuid(self._h, dev).decode()

    def limit(self, dev: int) -> int:
        return self._lib.vgpu_r_limit(self._h, dev)

    def sm_limit(self, dev: int) -> int:
        return self._lib.vgpu_r_sm_limit(self._h, dev)

    def used(self, dev: int) -> int:
        return self._lib.vgpu_r_used(self._h, dev)

    @property
    def oversubscribe(self) -> int:
        return self._lib.vgpu_r_oversubscribe(self._h)

    @property
    def priority(self) -> int:
        return self._lib.vgpu_r_priority(self._h)

    @property
    def recent_kernel(self) -> int:
        """The activity counter as it stands (no aging)."""
        return self._lib.vgpu_r_recent_kernel(self._h)

    def age_kernel(self) -> int:
        """Return activity counter before decrementing it (Observe tick)."""
        return self._lib.vgpu_r_age_kernel(self._h)

    @property
    def utilization_switch(self) -> int:
        return self._lib.vgpu_r_get_switch(self._h)

    def set_switch(self, on: bool) -> None:
        self._lib.vgpu_r_set_switch(self._h, 1 if on else 0)

    def proc_pids(self) -> List[int]:
        buf = (ctypes.c_int32 * 1024)()
        n = self._lib.vgpu_r_proc_pids(self._h, buf, 1024)
        return list(buf[:n])

    def set_hostpid(self, pid: int, hostpid: int) -> None:
        self._lib.vgpu_r_set_hostpid(self._h, pid, hostpid)

    def gc(self, live_pids: List[int]) -> int:
        arr = (ctypes.c_int32 * max(1, len(live_pids)))(*live_pids)
        return self._lib.vgpu_r_gc(self._h, arr, len(live_pids))

    def uuids(self) -> List[str]:
        return [self.uuid(i) for i in range(self.num_devices)]

    # -- QoS plane -------------------------------------------------------------
    @property
    def qos_class(self) -> int:
        """-1 = no QoS class (flat limiter), 0 = best-effort,
        1 = latency-critical."""
        return self._lib.vgpu_r_qos_class(self._h)

    @property
    def qos_weight(self) -> int:
        return self._lib.vgpu_r_qos_weight(self._h)

    def set_qos_weight(self, pct: int) -> None:
        self._lib.vgpu_r_set_qos_weight(self._h, int(pct))

    @property
    def qos_yield(self) -> int:
        return self._lib.vgpu_r_qos_yield(self._h)

    def set_qos_yield(self, on: bool) -> None:
        self._lib.vgpu_r_set_qos_yield(self._h, 1 if on else 0)

    def qos_wait_count(self) -> int:
        return self._lib.vgpu_r_qos_wait_count(self._h)

    def qos_wait_us_total(self) -> int:
        return self._lib.vgpu_r_qos_wait_us_total(self._h)

    def qos_cost_us_total(self) -> int:
        return self._lib.vgpu_r_qos_cost_us_total(self._h)

    def qos_wait_hist(self) -> List[int]:
        """Cumulative dispatch-wait histogram: log2-us buckets (bucket 0
        = zero-wait admissions, bucket k covers [2^(k-1), 2^k) us)."""
        buf = (ctypes.c_uint64 * 32)()
        n = self._lib.vgpu_r_qos_wait_hist(self._h, buf, 32)
        return list(buf[:n])


class RegionReader:
    """Opens region files through ``libvgpu_torch``: the library at
    ``library_path``, else the build of ``csrc/vgpu/`` (compiled with g++
    on first use)."""

    def __init__(self, library_path: Optional[str] = None) -> None:
        # An explicit path: never the interposer's copy, which is this
        # process's own region code where one is preloaded.
        self.lib = Native(str(library_path or _kernels.build_vgpu())).lib

    def open(self, path: str) -> Optional[Region]:
        h = self.lib.vgpu_open_region(path.encode())
        return Region(self.lib, h, path) if h else None


def scan_container_dirs(root: str) -> Dict[str, str]:
    """Map container key ('<podUID>_<podName>') → region file path.

    Reference monitorpath(): readdir /tmp/vgpu/containers/<podUID_ctr>/
    (pathmonitor.go:56–87).
    """
    out: Dict[str, str] = {}
    try:
        entries = os.listdir(root)
    except OSError:
        return out
    for entry in entries:
        d = os.path.join(root, entry)
        try:
            files = os.listdir(d)
        except OSError:
            continue  # dir vanished mid-scan (pod terminated) — next tick
        for f in files:
            if f.endswith(".cache"):
                out[entry] = os.path.join(d, f)
                break
    return out
