"""Usage accounting of the PyTorch/CUDA port (the JAX package's
``accounting/``): the monitor's per-container counters (``sampler``), the
scheduler's per-pod ledger built from the counters the register stream
carries (``ledger``), the granted-vs-actual join behind ``/usagez`` and
``--score-by-actual`` (``efficiency``), and the series forecaster the node
exporter reads (``forecast``).  Standard library only."""

from .efficiency import EfficiencyConfig, FleetEfficiency, PodEfficiency
from .forecast import ForecastConfig, ForecastPoint, SeriesForecaster
from .ledger import PodAccount, UsageLedger
from .sampler import USAGE_FIELDS, UsageSampler

__all__ = [
    "EfficiencyConfig",
    "FleetEfficiency",
    "ForecastConfig",
    "ForecastPoint",
    "PodAccount",
    "PodEfficiency",
    "SeriesForecaster",
    "USAGE_FIELDS",
    "UsageLedger",
    "UsageSampler",
]
