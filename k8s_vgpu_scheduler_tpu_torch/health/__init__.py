"""Fleet health of the port's scheduler (the JAX package's ``health/``):
heartbeat leases, card quarantine, the rescue of stranded grants and a
seeded fault injector.

- :mod:`.lease` — a deadline failure detector over the heartbeats the
  node agents piggyback on the register stream (Healthy → Suspect →
  Dead);
- :mod:`.quarantine` — per-card flap damping with a sustained healthy
  probation;
- :mod:`.rescuer` — the sweep that rescinds grants stranded on dead nodes
  and quarantined cards, asking a victim on a live node to checkpoint
  first;
- :mod:`.faults` — a seeded fault harness that drives all of the above
  on a simulated clock.
"""

from .faults import FaultEvent, FaultInjector, SimClock
from .lease import LeaseConfig, LeaseState, LeaseTracker
from .quarantine import ChipQuarantine, QuarantineConfig
from .rescuer import RESCUE_VALUE_PREFIX, RescueConfig, RescueItem, Rescuer

__all__ = [
    "ChipQuarantine",
    "FaultEvent",
    "FaultInjector",
    "LeaseConfig",
    "LeaseState",
    "LeaseTracker",
    "QuarantineConfig",
    "RESCUE_VALUE_PREFIX",
    "RescueConfig",
    "RescueItem",
    "Rescuer",
    "SimClock",
]
