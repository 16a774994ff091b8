"""Demand forecasting over bucketed series (the port's copy of the JAX
package's ``accounting/forecast.py``).

A windowed EWMA level with additive seasonality (Holt-Winters additive,
damped trend) over bucketed demand samples, emitting horizon-bucketed
forecasts with confidence bands and tracking its own one-bucket-ahead
error, so the observability surface can report forecast-vs-actual drift
(``vtpu_capacity_forecast_error_ratio``) instead of asking operators to
trust the model blindly.  The node exporter forecasts its busy-GPU count
with it (``monitor/metrics.py``); the capacity planner (``planner.py``)
forecasts each queue's demand through :class:`DemandForecaster`.

- **Deterministic.**  Pure float arithmetic over the observations fed in;
  no wall clock, no RNG.  The simulator's capacity section replays its
  scenarios bit-identically.
- **Bounded.**  State per series is O(season buckets) floats plus a small
  ring of recent bucket totals, kept so a live window can be snapshotted
  into a replayable scenario (``planner.scenario_from_capacityz``).
- **Non-negative.**  Demand is a count of cards; a forecast below zero is
  noise, clamped at emission (never inside the state update, which would
  bias the level upward).
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class ForecastConfig:
    #: Observations are aggregated into buckets of this many seconds;
    #: forecasts are emitted per bucket.
    bucket_s: float = 60.0
    #: Buckets per seasonal cycle (additive seasonality).  1 disables
    #: seasonality (plain EWMA level + damped trend).
    season_buckets: int = 24
    #: EWMA weight of the newest bucket on the level.  Low by default:
    #: with real seasonality the seasonal terms should absorb the
    #: periodic signal, not the level chasing it.
    alpha: float = 0.1
    #: EWMA weight on the trend (damped by ``phi`` per bucket ahead).
    beta: float = 0.05
    #: EWMA weight on the seasonal component of the bucket just closed.
    gamma: float = 0.5
    #: Trend damping per bucket of horizon (1.0 = undamped Holt).
    phi: float = 0.9
    #: EWMA weight for the residual scale the confidence bands use.
    band_alpha: float = 0.2
    #: Band half-width in residual-scale units (~"sigmas" of the EWMA
    #: absolute one-step error).
    band_k: float = 2.0
    #: How many recent (bucket_start_s, demand) samples to retain for
    #: snapshot/replay (planner.scenario_from_capacityz).
    history_len: int = 96


@dataclasses.dataclass
class ForecastPoint:
    #: Bucket start, seconds from the forecast's ``now``.
    at_s: float
    mean: float
    lower: float
    upper: float

    def as_dict(self) -> dict:
        return {"at_s": round(self.at_s, 3), "mean": round(self.mean, 4),
                "lower": round(self.lower, 4),
                "upper": round(self.upper, 4)}


class SeriesForecaster:
    """Holt-Winters additive forecaster over one demand series.

    Feed ``observe(t, value)`` with instantaneous demand samples; the
    forecaster aggregates them into ``bucket_s`` buckets (mean of the
    samples that fell in the bucket) and updates level/trend/season when
    a bucket closes.  ``forecast(n)`` projects ``n`` buckets ahead.
    """

    def __init__(self, cfg: Optional[ForecastConfig] = None) -> None:
        self.cfg = cfg or ForecastConfig()
        s = max(1, int(self.cfg.season_buckets))
        self._season = [0.0] * s
        self._season_seen = [False] * s
        self.level: Optional[float] = None
        self.trend = 0.0
        #: EWMA of |one-bucket-ahead prediction error| and of |actual|,
        #: the drift ratio's numerator/denominator.
        self._err_ewma: Optional[float] = None
        self._abs_ewma: Optional[float] = None
        #: Open bucket accumulation.
        self._bucket_idx: Optional[int] = None
        self._bucket_sum = 0.0
        self._bucket_n = 0
        #: Closed buckets absorbed (age of the model, in buckets).
        self.buckets_observed = 0
        #: Ring of (bucket_start_s, mean demand) for snapshot/replay.
        self.history: deque = deque(maxlen=self.cfg.history_len)

    # -- state update ----------------------------------------------------------
    def _season_slot(self, bucket_idx: int) -> int:
        return bucket_idx % len(self._season)

    def _close_bucket(self, bucket_idx: int, value: float) -> None:
        cfg = self.cfg
        slot = self._season_slot(bucket_idx)
        # Drift bookkeeping BEFORE absorbing: compare what the model
        # would have predicted for this bucket against what arrived.
        if self.level is not None:
            predicted = self.level + cfg.phi * self.trend \
                + (self._season[slot] if self._season_seen[slot] else 0.0)
            err = abs(value - max(0.0, predicted))
            self._err_ewma = err if self._err_ewma is None else (
                cfg.band_alpha * err
                + (1 - cfg.band_alpha) * self._err_ewma)
        self._abs_ewma = abs(value) if self._abs_ewma is None else (
            cfg.band_alpha * abs(value)
            + (1 - cfg.band_alpha) * self._abs_ewma)

        # Standard additive Holt-Winters: the seasonal update reads the
        # PRE-update level/trend (value − (l + b)), not the post-update
        # level — folding the level's own move into the deviation biases
        # every seasonal component toward zero and the forecast low.
        seasonal = self._season[slot] if self._season_seen[slot] else 0.0
        if self.level is None:
            self.level = value - seasonal
            deviation = value - self.level
        else:
            prev = self.level + cfg.phi * self.trend
            deviation = value - prev
            prev_level = self.level
            self.level = (cfg.alpha * (value - seasonal)
                          + (1 - cfg.alpha) * prev)
            self.trend = (cfg.beta * (self.level - prev_level)
                          + (1 - cfg.beta) * cfg.phi * self.trend)
        if len(self._season) > 1:
            if not self._season_seen[slot]:
                self._season[slot] = deviation
                self._season_seen[slot] = True
            else:
                self._season[slot] = (cfg.gamma * deviation
                                      + (1 - cfg.gamma)
                                      * self._season[slot])
        self.buckets_observed += 1
        self.history.append((bucket_idx * cfg.bucket_s, value))

    def observe(self, t: float, value: float) -> None:
        """Absorb one demand sample at time ``t`` (seconds on any
        monotonic clock; buckets are ``floor(t / bucket_s)``).  Samples
        must arrive in non-decreasing time order; a gap of empty buckets
        closes them with zero demand (no demand observed IS the
        observation)."""
        idx = int(math.floor(t / self.cfg.bucket_s))
        if self._bucket_idx is None:
            self._bucket_idx = idx
        while idx > self._bucket_idx:
            mean = (self._bucket_sum / self._bucket_n
                    if self._bucket_n else 0.0)
            self._close_bucket(self._bucket_idx, mean)
            self._bucket_idx += 1
            self._bucket_sum = 0.0
            self._bucket_n = 0
        self._bucket_sum += value
        self._bucket_n += 1

    # -- queries ---------------------------------------------------------------
    def forecast(self, horizon_buckets: int) -> List[ForecastPoint]:
        """Project ``horizon_buckets`` ahead of the last CLOSED bucket.
        Empty (all-zero, unbounded bands collapsed to zero) before any
        bucket has closed — unknown must not read as "no demand"
        upstream, so callers check :attr:`buckets_observed`."""
        cfg = self.cfg
        out: List[ForecastPoint] = []
        if self.level is None or self._bucket_idx is None:
            for h in range(1, horizon_buckets + 1):
                out.append(ForecastPoint(at_s=h * cfg.bucket_s, mean=0.0,
                                         lower=0.0, upper=0.0))
            return out
        band = cfg.band_k * (self._err_ewma or 0.0)
        damp = cfg.phi
        for h in range(1, horizon_buckets + 1):
            slot = self._season_slot(self._bucket_idx + h - 1)
            seasonal = (self._season[slot]
                        if self._season_seen[slot] else 0.0)
            # Damped-trend projection: sum of phi^1..phi^h.
            if cfg.phi >= 1.0:
                trend_sum = h * self.trend
            else:
                trend_sum = self.trend * damp * (1 - cfg.phi ** h) \
                    / (1 - cfg.phi)
            mean = self.level + trend_sum + seasonal
            # Bands widen with horizon (sqrt(h): independent-ish bucket
            # errors accumulate) — the planner's conservative answers
            # read the upper band.
            half = band * math.sqrt(h)
            out.append(ForecastPoint(
                at_s=h * cfg.bucket_s,
                mean=max(0.0, mean),
                lower=max(0.0, mean - half),
                upper=max(0.0, mean + half)))
        return out

    def error_ratio(self) -> Optional[float]:
        """Forecast-vs-actual drift: EWMA |one-bucket-ahead error| over
        EWMA |actual|.  None until one prediction has been scored.
        ~0 = the model tracks the series; > ~0.5 = forecasts are mostly
        noise (the VtpuCapacityForecastDrift alert's signal)."""
        if self._err_ewma is None or self._abs_ewma is None:
            return None
        if self._abs_ewma <= 1e-9:
            return 0.0 if self._err_ewma <= 1e-9 else 1.0
        return self._err_ewma / self._abs_ewma

    def history_rows(self) -> List[List[float]]:
        """Closed-bucket history as ``[bucket_start_s, demand]`` rows —
        the replayable trace ``planner.scenario_from_capacityz`` captures."""
        return [[round(t, 3), round(v, 4)] for t, v in self.history]


class DemandForecaster:
    """Per-key (tenant / queue) demand forecasting — a keyed family of
    :class:`SeriesForecaster` sharing one config."""

    def __init__(self, cfg: Optional[ForecastConfig] = None) -> None:
        self.cfg = cfg or ForecastConfig()
        self.series: Dict[str, SeriesForecaster] = {}

    def observe(self, key: str, t: float, value: float) -> None:
        f = self.series.get(key)
        if f is None:
            f = self.series[key] = SeriesForecaster(self.cfg)
        f.observe(t, value)

    def forecast(self, key: str,
                 horizon_buckets: int) -> List[ForecastPoint]:
        f = self.series.get(key)
        if f is None:
            f = SeriesForecaster(self.cfg)
        return f.forecast(horizon_buckets)

    def keys(self) -> List[str]:
        return sorted(self.series)
