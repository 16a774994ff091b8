"""Usage accounting of the PyTorch/CUDA port (the JAX package's
``accounting/``): the monitor's per-container counters (``sampler``), the
scheduler's per-pod ledger built from the counters the register stream
carries (``ledger``), the granted-vs-actual join behind ``/usagez`` and
``--score-by-actual`` (``efficiency``), the demand forecasters the node
exporter and the capacity planner read (``forecast``), and capacity
planning on the forecasts (``planner``: the ``/capacityz`` assessment, the
named arrival patterns the simulator's what-if replays use, and live-trace
capture into replayable scenarios).  Standard library only."""

from .efficiency import EfficiencyConfig, FleetEfficiency, PodEfficiency
from .forecast import (
    DemandForecaster,
    ForecastConfig,
    ForecastPoint,
    SeriesForecaster,
)
from .ledger import PodAccount, UsageLedger
from .planner import CapacityTracker
from .sampler import USAGE_FIELDS, UsageSampler

__all__ = [
    "CapacityTracker",
    "DemandForecaster",
    "EfficiencyConfig",
    "ForecastConfig",
    "ForecastPoint",
    "PodAccount",
    "PodEfficiency",
    "SeriesForecaster",
    "USAGE_FIELDS",
    "UsageLedger",
    "UsageSampler",
]
