"""File-backed OCI spec with the port's enforcement injected.

The port's counterpart of the JAX package's ``oci/spec.py`` (reference
pkg/oci/spec.go:131–204, fileSpec Load/Modify/Flush).  The spec is a
plain dict (the OCI schema is JSON); :func:`inject_vgpu` grafts onto a raw
runtime bundle the env and mounts the device plugin's Allocate gives a
container (``deviceplugin/plugin.py``'s ``build_container_response`` and
``attach_enforcement``): the bundle a grant produces is Allocate's answer
for that grant, but for the OCI mount format and ``PYTHONPATH``.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

from ..util.enforcement import check_shim_install
from ..util.types import (
    CACHE_CONTAINER_DIR,
    CACHE_FILE,
    ENV_MEMORY_LIMIT_PREFIX,
    ENV_OVERSUBSCRIBE,
    ENV_SHARED_CACHE,
    ENV_SM_LIMIT,
    ENV_VISIBLE_DEVICES,
    PRELOAD_FILE,
    SHIM_CONTAINER_DIR,
)

ENV_PYTHONPATH = "PYTHONPATH"


class FileSpec:
    """Load/Modify/Flush over a bundle's ``config.json``."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.spec: Optional[dict] = None

    def load(self) -> None:
        with open(self.path) as f:
            self.spec = json.load(f)

    def modify(self, fn: Callable[[dict], dict]) -> None:
        if self.spec is None:
            raise ValueError("no spec loaded for modification")
        self.spec = fn(self.spec)

    def flush(self) -> None:
        if self.spec is None:
            raise ValueError("no spec loaded to flush")
        with open(self.path, "w") as f:
            json.dump(self.spec, f)


def _set_env(env: List[str], key: str, value: str) -> List[str]:
    out = [e for e in env if not e.startswith(key + "=")]
    out.append(f"{key}={value}")
    return out


def _env_value(env: List[str], key: str) -> Optional[str]:
    for e in env:
        if e.startswith(key + "="):
            return e[len(key) + 1:]
    return None


def inject_vgpu(
    chip_limits_mib: Dict[int, int],
    core_limit: int = 0,
    visible_devices: str = "",
    oversubscribe: bool = False,
    cache_path: str = f"{CACHE_CONTAINER_DIR}/{CACHE_FILE}",
    shim_host_dir: str = SHIM_CONTAINER_DIR,
    cache_host_dir: Optional[str] = None,
) -> Callable[[dict], dict]:
    """A spec modifier that injects the port's enforcement contract: the
    memory limit of each granted card (``CUDA_DEVICE_MEMORY_LIMIT_<i>``,
    i its place in ``visible_devices``, the cards' UUIDs), the SM limit,
    ``CUDA_OVERSUBSCRIBE``, the region file's path, the interposer's
    mounts (the shim dir and ``/etc/ld.so.preload``, as far as the node's
    install has them: the shim-install policy Allocate uses) and the
    region dir's mount.

    ``PYTHONPATH``: where Allocate sets it to the shim dir (the dir is
    mounted, and the grant oversubscribes or the node has no
    ``ld.so.preload``), the bundle's own ``PYTHONPATH`` keeps its entries
    after the dir, which kubelet's answer cannot do (it replaces the
    image's); the dir is never added twice."""

    def modifier(spec: dict) -> dict:
        proc = spec.setdefault("process", {})
        env = list(proc.get("env", []))
        for idx, mib in sorted(chip_limits_mib.items()):
            env = _set_env(env, f"{ENV_MEMORY_LIMIT_PREFIX}{idx}", str(mib))
        if core_limit:
            env = _set_env(env, ENV_SM_LIMIT, str(core_limit))
        if visible_devices:
            env = _set_env(env, ENV_VISIBLE_DEVICES, visible_devices)
        if oversubscribe:
            env = _set_env(env, ENV_OVERSUBSCRIBE, "true")
        env = _set_env(env, ENV_SHARED_CACHE, cache_path)

        mounts = list(spec.get("mounts", []))

        def add_mount(dest: str, src: str, read_only: bool) -> None:
            mounts[:] = [m for m in mounts if m.get("destination") != dest]
            mounts.append({"destination": dest, "source": src, "type": "bind",
                           "options": ["rbind", "ro" if read_only else "rw"]})

        # Only bind-mount what exists on the host: a mount of a missing
        # source fails every create.  The policy warns loudly where it
        # fails open, and raises under VTPU_STRICT_ENFORCEMENT.
        mount_dir, mount_preload = check_shim_install(
            shim_host_dir, what="container")
        if mount_dir:
            add_mount(SHIM_CONTAINER_DIR, shim_host_dir, read_only=True)
            if oversubscribe or not mount_preload:
                own = _env_value(env, ENV_PYTHONPATH) or ""
                rest = [p for p in own.split(":")
                        if p and p != SHIM_CONTAINER_DIR]
                env = _set_env(env, ENV_PYTHONPATH,
                               ":".join([SHIM_CONTAINER_DIR, *rest]))
        if mount_preload:
            add_mount(f"/etc/{PRELOAD_FILE}",
                      os.path.join(shim_host_dir, PRELOAD_FILE),
                      read_only=True)
        if cache_host_dir:
            add_mount(os.path.dirname(cache_path), cache_host_dir,
                      read_only=False)
        proc["env"] = env
        spec["mounts"] = mounts
        return spec

    return modifier
