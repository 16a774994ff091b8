"""Multicore control plane: the shared-memory columnar fleet and its solve
workers (the port's copy of the JAX package's ``parallelcp/``).

- :mod:`.shmem`: the ``ColumnarFleet`` numpy columns live in
  ``multiprocessing.shared_memory`` segments behind a versioned header (a
  generation counter and the column layout's manifest), so worker
  processes map the fleet read-only and fence every request on its
  generation.
- :mod:`.workers`: solve worker processes that run the vectorized class
  evaluation (``scheduler/batch.eval_class_full``) over disjoint row
  ranges of the mapped columns, in parallel (no GIL).

The commit stays single-writer in the scheduler's process; workers never
write the segments.  Opt-in through ``Config.solve_workers``
(``vgpu-scheduler --solve-workers``; 0, the default, evaluates in the
scheduler's process with the same bits), and any worker failure falls back
to the in-process evaluation: the pool can slow a cycle, never change a
decision.  Nothing here imports torch: a spawned worker re-imports the
parent's ``__main__`` and this package, and ``import torch`` would cost it
seconds.
"""

from .shmem import SharedColumnStore, SharedColumnView, StaleGeneration
from .workers import SolveWorkerPool

__all__ = [
    "SharedColumnStore",
    "SharedColumnView",
    "StaleGeneration",
    "SolveWorkerPool",
]
