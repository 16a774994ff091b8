"""NVML through ``ctypes`` on ``libnvidia-ml.so.1``: the port's device
discovery for the node agent.

The counterpart of the JAX package's ``SysfsBackend`` (a discovery path
that opens no accelerator client) and of the reference's go-nvml
(pkg/device-plugin/nvidia.go:84–171, the XID health loop at 173–244).
NVML reads the driver's view of each card and creates no CUDA context, so
a DaemonSet built on it holds none of the memory its pods are granted.

Every entry point is declared with its C types here.  The ABI it relies on
(nvml.h):

- the ``_v2`` forms of ``nvmlInit``, ``nvmlDeviceGetCount`` and
  ``nvmlDeviceGetHandleByIndex``;
- ``nvmlMemory_t`` is three ``unsigned long long`` (total, free, used);
  ``nvmlMemory_v2_t`` leads with a ``version`` word and adds ``reserved``;
- UUID and name buffers of 96 bytes, the serial's of 30, the PCI bus id's
  of 32 (``nvmlPciInfo_t.busId``);
- ``nvmlDeviceGetP2PStatus`` takes an ``nvmlGpuP2PCapsIndex_t`` and
  writes an ``nvmlGpuP2PStatus_t``, both C enums (``int``), with the values
  below;
- every call returns an ``nvmlReturn_t``: nonzero raises :class:`NvmlError`
  with ``nvmlErrorString``'s text.

Never imports torch.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

LIBRARY = "libnvidia-ml.so.1"

SUCCESS = 0
ERROR_NOT_SUPPORTED = 3
ERROR_TIMEOUT = 10
ERROR_GPU_IS_LOST = 15
ERROR_FUNCTION_NOT_FOUND = 13

UUID_BUFFER = 96
NAME_BUFFER = 96
SERIAL_BUFFER = 30
BUS_ID_BUFFER = 32

# nvmlGpuP2PCapsIndex_t's NVLink index and the nvmlGpuP2PStatus_t values,
# as the nvml.h of CUDA 12.8 defines them.
P2P_CAPS_INDEX_NVLINK = 2
P2P_STATUS = {0: "OK", 1: "CHIPSET_NOT_SUPPORTED", 2: "GPU_NOT_SUPPORTED",
              3: "IOH_TOPOLOGY_NOT_SUPPORTED", 4: "DISABLED_BY_REGKEY",
              5: "NOT_SUPPORTED", 6: "UNKNOWN"}
P2P_STATUS_OK = 0

# nvmlEventTypeXidCriticalError, the one event the reference registers.
EVENT_XID_CRITICAL = 0x8
# Xids an application causes (the skip list of NVIDIA's device plugin,
# which the reference's health loop follows): they say nothing of the
# card's health.
APPLICATION_XIDS = frozenset({13, 31, 43, 45, 68, 109})


class Memory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class MemoryV2(ctypes.Structure):
    _fields_ = [("version", ctypes.c_uint), ("total", ctypes.c_ulonglong),
                ("reserved", ctypes.c_ulonglong),
                ("free", ctypes.c_ulonglong), ("used", ctypes.c_ulonglong)]


# NVML_STRUCT_VERSION(Memory, 2): the struct's size and the version << 24.
MEMORY_V2_VERSION = ctypes.sizeof(MemoryV2) | (2 << 24)


class PciInfo(ctypes.Structure):
    _fields_ = [("busIdLegacy", ctypes.c_char * 16),
                ("domain", ctypes.c_uint), ("bus", ctypes.c_uint),
                ("device", ctypes.c_uint), ("pciDeviceId", ctypes.c_uint),
                ("pciSubSystemId", ctypes.c_uint),
                ("busId", ctypes.c_char * BUS_ID_BUFFER)]


class EventData(ctypes.Structure):
    _fields_ = [("device", ctypes.c_void_p),
                ("eventType", ctypes.c_ulonglong),
                ("eventData", ctypes.c_ulonglong),
                ("gpuInstanceId", ctypes.c_uint),
                ("computeInstanceId", ctypes.c_uint)]


class NvmlError(RuntimeError):
    """A nonzero ``nvmlReturn_t``: ``code`` is the value, ``call`` the
    entry point that returned it."""

    def __init__(self, call: str, code: int, text: str) -> None:
        super().__init__(f"{call}: {text} (NVML error {code})")
        self.call = call
        self.code = code


_h = ctypes.c_void_p
_u = ctypes.c_uint
_pu = ctypes.POINTER(ctypes.c_uint)
# name -> argument types; every one returns nvmlReturn_t.
SIGNATURES = {
    "nvmlInit_v2": (),
    "nvmlShutdown": (),
    "nvmlDeviceGetCount_v2": (_pu,),
    "nvmlDeviceGetHandleByIndex_v2": (_u, ctypes.POINTER(_h)),
    "nvmlDeviceGetIndex": (_h, _pu),
    "nvmlDeviceGetUUID": (_h, ctypes.c_char_p, _u),
    "nvmlDeviceGetName": (_h, ctypes.c_char_p, _u),
    "nvmlDeviceGetSerial": (_h, ctypes.c_char_p, _u),
    "nvmlDeviceGetMinorNumber": (_h, _pu),
    "nvmlDeviceGetPciInfo_v3": (_h, ctypes.POINTER(PciInfo)),
    "nvmlDeviceGetMemoryInfo": (_h, ctypes.POINTER(Memory)),
    "nvmlDeviceGetMemoryInfo_v2": (_h, ctypes.POINTER(MemoryV2)),
    "nvmlDeviceGetP2PStatus": (_h, _h, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int)),
    "nvmlDeviceGetSupportedEventTypes": (_h,
                                         ctypes.POINTER(ctypes.c_ulonglong)),
    "nvmlEventSetCreate": (ctypes.POINTER(_h),),
    "nvmlDeviceRegisterEvents": (_h, ctypes.c_ulonglong, _h),
    "nvmlEventSetWait_v2": (_h, ctypes.POINTER(EventData), _u),
    "nvmlEventSetFree": (_h,),
}


class Nvml:
    """One initialised NVML session (``nvmlInit_v2`` … ``nvmlShutdown``).
    Raises :class:`OSError` when the library cannot be loaded and
    :class:`NvmlError` when a call fails."""

    def __init__(self, library: str = LIBRARY) -> None:
        self.lib = ctypes.CDLL(library)
        self.lib.nvmlErrorString.argtypes = [ctypes.c_int]
        self.lib.nvmlErrorString.restype = ctypes.c_char_p
        self._fns = {}
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name, None)
            if fn is None:
                continue  # an older driver: calling it raises
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            self._fns[name] = fn
        self._call("nvmlInit_v2")
        self._open = True

    def _call(self, name: str, *args) -> None:
        fn = self._fns.get(name)
        if fn is None:
            raise NvmlError(name, ERROR_FUNCTION_NOT_FOUND,
                            "not exported by this driver's NVML")
        rc = fn(*args)
        if rc != SUCCESS:
            raise NvmlError(name, rc,
                            (self.lib.nvmlErrorString(rc) or b"").decode())

    def _text(self, name: str, handle, size: int) -> str:
        buf = ctypes.create_string_buffer(size)
        self._call(name, handle, buf, size)
        return buf.value.decode()

    def shutdown(self) -> None:
        if self._open:
            self._open = False
            self._call("nvmlShutdown")

    def device_count(self) -> int:
        n = ctypes.c_uint()
        self._call("nvmlDeviceGetCount_v2", ctypes.byref(n))
        return n.value

    def handle(self, index: int):
        h = _h()
        self._call("nvmlDeviceGetHandleByIndex_v2", index, ctypes.byref(h))
        return h

    def index(self, handle) -> int:
        v = ctypes.c_uint()
        self._call("nvmlDeviceGetIndex", handle, ctypes.byref(v))
        return v.value

    def uuid(self, handle) -> str:
        return self._text("nvmlDeviceGetUUID", handle, UUID_BUFFER)

    def name(self, handle) -> str:
        return self._text("nvmlDeviceGetName", handle, NAME_BUFFER)

    def serial(self, handle) -> str:
        return self._text("nvmlDeviceGetSerial", handle, SERIAL_BUFFER)

    def minor(self, handle) -> int:
        v = ctypes.c_uint()
        self._call("nvmlDeviceGetMinorNumber", handle, ctypes.byref(v))
        return v.value

    def pci_bus_id(self, handle) -> str:
        info = PciInfo()
        self._call("nvmlDeviceGetPciInfo_v3", handle, ctypes.byref(info))
        return info.busId.decode()

    def memory(self, handle) -> Tuple[int, int, int]:
        """``nvmlDeviceGetMemoryInfo``: (total, free, used) bytes."""
        m = Memory()
        self._call("nvmlDeviceGetMemoryInfo", handle, ctypes.byref(m))
        return m.total, m.free, m.used

    def memory_v2(self, handle) -> Tuple[int, int, int, int]:
        """``nvmlDeviceGetMemoryInfo_v2``: (total, reserved, free, used)
        bytes."""
        m = MemoryV2(version=MEMORY_V2_VERSION)
        self._call("nvmlDeviceGetMemoryInfo_v2", handle, ctypes.byref(m))
        return m.total, m.reserved, m.free, m.used

    def p2p_status(self, a, b, index: int = P2P_CAPS_INDEX_NVLINK) -> int:
        """``nvmlDeviceGetP2PStatus`` of two cards' handles for one
        capability (NVLink by default): an ``nvmlGpuP2PStatus_t`` value,
        ``P2P_STATUS_OK`` where the pair has it."""
        status = ctypes.c_int(-1)
        self._call("nvmlDeviceGetP2PStatus", a, b, index,
                   ctypes.byref(status))
        return status.value


class XidEvents:
    """Critical-Xid events of some cards (the reference's
    ``nvmlEventTypeXidCriticalError`` loop, polled instead of blocked on):
    an event set with every card of ``handles`` that supports them
    registered; raises :class:`NvmlError` when the driver supports no event
    sets at all.  ``registered`` lists the indices registered and
    ``unsupported`` those whose driver refused, with the error."""

    def __init__(self, nvml: Nvml, handles) -> None:
        self.nvml = nvml
        self.set = _h()
        nvml._call("nvmlEventSetCreate", ctypes.byref(self.set))
        self.registered: List[int] = []
        self.unsupported: dict = {}
        self._index_of = {}
        for i, h in enumerate(handles):
            try:
                types = ctypes.c_ulonglong()
                nvml._call("nvmlDeviceGetSupportedEventTypes", h,
                           ctypes.byref(types))
                if not types.value & EVENT_XID_CRITICAL:
                    raise NvmlError("nvmlDeviceGetSupportedEventTypes",
                                    ERROR_NOT_SUPPORTED,
                                    "no critical-Xid events")
                nvml._call("nvmlDeviceRegisterEvents", h,
                           EVENT_XID_CRITICAL, self.set)
            except NvmlError as e:
                self.unsupported[i] = str(e)
                continue
            self.registered.append(i)
            self._index_of[h.value] = i

    def drain(self) -> List[Tuple[int, int]]:
        """Every waiting event as (card index, Xid), without blocking;
        Xids an application causes are left out."""
        out = []
        while True:
            data = EventData()
            try:
                self.nvml._call("nvmlEventSetWait_v2", self.set,
                                ctypes.byref(data), 0)
            except NvmlError as e:
                if e.code == ERROR_TIMEOUT:
                    return out
                raise
            if data.eventData in APPLICATION_XIDS:
                continue
            out.append((self._index_of.get(data.device, -1),
                        int(data.eventData)))

    def close(self) -> None:
        if self.set:
            self.nvml._call("nvmlEventSetFree", self.set)
            self.set = _h()

