"""Annotation wire codec of the port's node agent.

The port's copy of the JAX package's ``util/codec.py``: it writes the same
bytes.  The scheduler's device decisions travel to the node agent inside
pod annotations.  The wire format is the reference's compact CSV grammar
(reference pkg/util/util.go:76–132) — kept for protocol parity, but with
strict parsing (the reference silently swallows malformed fields):

    pod      := container (";" container)*
    container:= (device ":")*
    device   := uuid "," type "," usedmem "," usedcores

UUIDs therefore must not contain ``,``, ``:`` or ``;`` — enforced at encode
time here, unchecked in the reference.

Canonicalization corner (grammar limitation, same in the reference): a pod
whose ONLY container has no devices encodes as ``""``, which decodes as "no
containers" — ``[[]]`` → ``[]``.  Harmless in practice: a pod with no device
grants never gets the annotation at all; multi-container pods with SOME
empty containers round-trip exactly (``[[], [d]]`` ↔ ``";d..."``).
"""

from __future__ import annotations

from .types import ContainerDevice, ContainerDevices, PodDevices

_FORBIDDEN = (",", ":", ";")


class CodecError(ValueError):
    pass


def encode_container_devices(devices: ContainerDevices) -> str:
    out = []
    for d in devices:
        for ch in _FORBIDDEN:
            if ch in d.uuid or ch in d.type:
                raise CodecError(f"device field contains reserved char {ch!r}: {d}")
        out.append(f"{d.uuid},{d.type},{int(d.usedmem)},{int(d.usedcores)}:")
    return "".join(out)


def encode_pod_devices(pod_devices: PodDevices) -> str:
    return ";".join(encode_container_devices(c) for c in pod_devices)


def decode_container_devices(s: str) -> ContainerDevices:
    devices: ContainerDevices = []
    if not s:
        return devices
    for chunk in s.split(":"):
        if not chunk:
            continue
        parts = chunk.split(",")
        if len(parts) != 4:
            raise CodecError(f"malformed device entry {chunk!r}")
        uuid, dtype, mem_s, cores_s = parts
        try:
            devices.append(
                ContainerDevice(uuid=uuid, type=dtype, usedmem=int(mem_s), usedcores=int(cores_s))
            )
        except ValueError as e:
            raise CodecError(f"malformed device entry {chunk!r}: {e}") from e
    return devices


def decode_pod_devices(s: str) -> PodDevices:
    if not s:
        return []
    return [decode_container_devices(chunk) for chunk in s.split(";")]
