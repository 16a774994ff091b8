"""A gang member's process group from the gang contract (the port's copy of
the JAX package's ``parallel/multihost.py``, on ``torch.distributed``).

The control plane places a gang atomically and gives each member a stable
process rank (``scheduler/gang.py`` ``Gang.ranks`` -> the
``vtpu.dev/pod-group-rank`` annotation -> ``VTPU_GANG_RANK`` in the node
agent's Allocate answer, beside ``VTPU_GANG_SIZE`` and the user's
``VTPU_GANG_COORDINATOR``).  This module is the last hop, the launcher's
part inside the container::

    # pod spec: vtpu.dev/pod-group: llama7b, vtpu.dev/pod-group-total: "4",
    #           vtpu.dev/pod-group-coordinator: llama7b-0.llama7b-svc:8476
    from k8s_vgpu_scheduler_tpu_torch.parallel import multihost
    multihost.initialize_from_env("nccl")  # before the first collective

The caller names the backend (``"nccl"`` across cards, ``"gloo"`` over
CPU tensors); nothing here guesses it from the host.  A replacement
member inherits its dead peer's rank, so a restarted process rejoins the
same slot.  torch is imported inside :func:`initialize_from_env` alone.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

log = logging.getLogger(__name__)

ENV_RANK = "VTPU_GANG_RANK"
ENV_SIZE = "VTPU_GANG_SIZE"
ENV_COORDINATOR = "VTPU_GANG_COORDINATOR"
DEFAULT_PORT = 8476


class GangEnvError(RuntimeError):
    pass


def gang_env() -> Optional[dict]:
    """The gang contract from the container's env, or None outside a
    gang: ``process_id``, ``num_processes`` and ``coordinator_address``
    (``host:port``; DEFAULT_PORT where the address names no port)."""
    rank = os.environ.get(ENV_RANK, "")
    if rank == "":
        return None
    size = os.environ.get(ENV_SIZE, "")
    coord = os.environ.get(ENV_COORDINATOR, "")
    if not size:
        raise GangEnvError(f"{ENV_RANK} set but {ENV_SIZE} missing")
    if not coord:
        raise GangEnvError(
            f"{ENV_RANK} set but {ENV_COORDINATOR} missing — set the "
            "vtpu.dev/pod-group-coordinator annotation to the rank-0 "
            "member's stable address (headless-service DNS)")
    if ":" not in coord:
        coord = f"{coord}:{DEFAULT_PORT}"
    return {
        "process_id": int(rank),
        "num_processes": int(size),
        "coordinator_address": coord,
    }


def initialize_from_env(backend: str,
                        timeout_s: Optional[float] = None) -> bool:
    """``torch.distributed.init_process_group`` from the gang env, rank 0
    serving the rendezvous at the coordinator's address.  True when a
    group was formed, False outside a gang (callers may call it
    unconditionally).  ``timeout_s`` bounds the rendezvous and every
    collective, so a missing peer fails instead of hanging."""
    cfg = gang_env()
    if cfg is None:
        return False
    import torch.distributed as dist

    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    log.info("joining gang process group: rank %d/%d via %s (%s)",
             cfg["process_id"], cfg["num_processes"],
             cfg["coordinator_address"], backend)
    dist.init_process_group(
        backend, init_method=f"tcp://{cfg['coordinator_address']}",
        rank=cfg["process_id"], world_size=cfg["num_processes"], **kwargs)
    return True
