"""The port's OCI runtime wrapper entry point, ``vgpu-oci-runtime``.

    VTPU_OCI_RUNTIME=/usr/bin/runc VTPU_OCI_CONFIG=/etc/vgpu/oci.json \
        vgpu-oci-runtime [runc's global flags] create --bundle <dir> <id>
    python -m k8s_vgpu_scheduler_tpu_torch.cmd.oci_runtime ...

The counterpart of the JAX package's ``vtpu-oci-runtime``: a drop-in runc
wrapper for container launches without kubelet (plain containerd,
nerdctl).  Configure containerd with it as the runtime binary, and every
``create`` gets the port's enforcement env and mounts injected into its
bundle (``oci.inject_vgpu``) before the real runtime runs; every other
command goes to the runtime unchanged.  Its own settings come from the
environment, since argv is the OCI runtime's: ``VTPU_OCI_RUNTIME`` (the
wrapped runtime, default /usr/bin/runc) and ``VTPU_OCI_CONFIG`` (the
grant, default /etc/vgpu/oci.json: the port's directory names, where the
JAX package's default names its own):

    {"chip_limits_mib": {"0": 3000}, "core_limit": 30,
     "visible_devices": "GPU-<uuid>", "oversubscribe": false,
     "cache_path": "/tmp/vgpu/cudevshr.cache",
     "shim_host_dir": "/usr/local/vgpu",
     "cache_host_dir": "/tmp/vgpu/containers/<name>"}

The grant is read only on ``create``, so ``delete``, ``state`` and
``kill`` of existing containers work with a missing or broken config.
"""

from __future__ import annotations

import json
import logging
import os
import sys

from ..oci import ModifyingRuntimeWrapper, SyscallExecRuntime, inject_vgpu
from ..util.types import CACHE_CONTAINER_DIR, CACHE_FILE, SHIM_CONTAINER_DIR

log = logging.getLogger(__name__)

DEFAULT_RUNTIME = "/usr/bin/runc"
DEFAULT_CONFIG = "/etc/vgpu/oci.json"


def load_modifier(config_path: str):
    with open(config_path) as f:
        cfg = json.load(f)
    return inject_vgpu(
        chip_limits_mib={int(k): int(v)
                         for k, v in cfg.get("chip_limits_mib", {}).items()},
        core_limit=int(cfg.get("core_limit", 0)),
        visible_devices=cfg.get("visible_devices", ""),
        oversubscribe=bool(cfg.get("oversubscribe", False)),
        cache_path=cfg.get("cache_path",
                           f"{CACHE_CONTAINER_DIR}/{CACHE_FILE}"),
        shim_host_dir=cfg.get("shim_host_dir", SHIM_CONTAINER_DIR),
        cache_host_dir=cfg.get("cache_host_dir"),
    )


def main(argv=None) -> None:
    argv = list(sys.argv if argv is None else argv)
    runtime_path = os.environ.get("VTPU_OCI_RUNTIME", DEFAULT_RUNTIME)
    config_path = os.environ.get("VTPU_OCI_CONFIG", DEFAULT_CONFIG)
    logging.basicConfig(level=logging.INFO)

    def lazy_modifier(spec: dict) -> dict:
        # Loaded on the create path alone: delete/state/kill of existing
        # containers must keep working with a missing or broken grant
        # config, or a stuck container could never be cleaned up.
        return load_modifier(config_path)(spec)

    wrapper = ModifyingRuntimeWrapper(SyscallExecRuntime(runtime_path),
                                      lazy_modifier)
    wrapper.exec(argv)


if __name__ == "__main__":
    main()
