"""Fleet health of the port's scheduler: the node leases its Filter gates
on (the JAX package's ``health/lease.py``).  Chip quarantine, the rescue
sweep and the fault injector wait for their own slices."""

from .lease import LeaseConfig, LeaseState, LeaseTracker

__all__ = ["LeaseConfig", "LeaseState", "LeaseTracker"]
