"""Watch the first card's used memory through NVML, with nothing else of
this repo running, and report every rise that falls back.

    python3 tools/card_transients.py [SECONDS]

Reads NVML's v2 ``used`` (nvidia-smi's ``memory.used``) and the card's
compute and graphics process lists every 5 ms for SECONDS (default 130)
and prints one JSON object: the least reading, and for each excursion of
more than 64 MiB above it, its start (s), length (s), highest reading
above the least (MiB) and the processes NVML listed during it.  This
process loads NVML alone and never makes a CUDA context.  Torch-free; it
needs the NVIDIA driver's ``libnvidia-ml.so.1``.
"""
import ctypes
import json
import sys
import time

EVERY_S = 0.005
RISE_MIB = 64


class Memory(ctypes.Structure):  # nvmlMemory_v2_t
    _fields_ = [("version", ctypes.c_uint), ("total", ctypes.c_ulonglong),
                ("reserved", ctypes.c_ulonglong),
                ("free", ctypes.c_ulonglong), ("used", ctypes.c_ulonglong)]


class Process(ctypes.Structure):  # nvmlProcessInfo_t
    _fields_ = [("pid", ctypes.c_uint), ("usedGpuMemory", ctypes.c_ulonglong),
                ("gpuInstanceId", ctypes.c_uint),
                ("computeInstanceId", ctypes.c_uint)]


def main(argv) -> int:
    seconds = float(argv[1]) if len(argv) > 1 else 130.0
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError as e:
        print(f"no NVML: {e}", file=sys.stderr)
        return 1
    card = ctypes.c_void_p()
    if nvml.nvmlInit_v2() or nvml.nvmlDeviceGetHandleByIndex_v2(
            0, ctypes.byref(card)):
        print("NVML found no card", file=sys.stderr)
        return 1
    mem = Memory(version=ctypes.sizeof(Memory) | 2 << 24)

    def used() -> int:
        rc = nvml.nvmlDeviceGetMemoryInfo_v2(card, ctypes.byref(mem))
        if rc:
            raise OSError(f"nvmlDeviceGetMemoryInfo_v2 returned {rc}")
        return mem.used >> 20

    def pids(kind: str) -> list:
        count, rows = ctypes.c_uint(16), (Process * 16)()
        call = getattr(nvml, f"nvmlDeviceGet{kind}RunningProcesses_v3", None)
        if call is None or call(card, ctypes.byref(count), rows):
            return []
        return [rows[i].pid for i in range(count.value)]

    samples = []
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        samples.append((time.monotonic() - t0, used(),
                        pids("Compute") + pids("Graphics")))
        time.sleep(EVERY_S)
    least = min(mib for _, mib, _ in samples)
    excursions, open_ = [], None
    for t, mib, procs in samples:
        if mib - least > RISE_MIB:
            if open_ is None:
                open_ = dict(start_s=t, end_s=t, rise_mib=0, processes=[])
            open_["end_s"] = t
            open_["rise_mib"] = max(open_["rise_mib"], mib - least)
            open_["processes"] = sorted(set(open_["processes"]) | set(procs))
        elif open_ is not None:
            excursions.append(open_)
            open_ = None
    if open_ is not None:
        excursions.append(open_)
    print(json.dumps(dict(
        seconds=seconds, samples=len(samples), least_mib=least,
        excursions=[dict(start_s=round(e["start_s"], 3),
                         length_s=round(e["end_s"] - e["start_s"], 3),
                         rise_mib=e["rise_mib"], processes=e["processes"])
                    for e in excursions])))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
