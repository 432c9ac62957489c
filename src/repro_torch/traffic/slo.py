"""SLO plane: streaming windowed percentile sketches + goodput accounting.

A load episode produces one ``Completion`` per request (the driver books
virtual queue-wait / service / end-to-end times from the modeled backend
costs).  ``WindowedSLO`` folds completions into per-window log-bucket
sketches the moment they are recorded — O(1) memory per window regardless
of traffic volume — and reports, per window and overall:

  * p50/p95/p99 end-to-end latency, split into queue wait and service;
  * goodput under per-tenant deadlines (completions within deadline / s);
  * joules per request (backend + gateway energy, mWh -> J via
    ``core.energy.mwh_to_joules``).

``LatencySketch`` is a DDSketch-style relative-accuracy histogram:
geometric buckets with ratio gamma = (1+a)/(1-a), so any quantile is
within relative error ``a`` of the exact value — deterministic,
mergeable, and insertion-order independent (the properties a percentile
in a benchmark trajectory needs; a sampled reservoir has none of them).

A copy of ``repro.traffic.slo`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.core.energy import mwh_to_joules


class LatencySketch:
    """Log-bucket quantile sketch with bounded RELATIVE error.

    Values at or below ``min_value`` land in a dedicated zero bucket and
    report as 0.0 (a queue wait of exactly zero is common and meaningful).
    ``merge`` sums bucket counts — combining per-window sketches into an
    episode-wide one loses nothing."""

    def __init__(self, *, rel_err: float = 0.01, min_value: float = 1e-3):
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err={rel_err}: need 0 < a < 1")
        self.rel_err = rel_err
        self.min_value = min_value
        self._log_gamma = math.log((1.0 + rel_err) / (1.0 - rel_err))
        self._buckets: Dict[int, int] = {}
        self._zero = 0
        self.count = 0
        self.total = 0.0

    def add(self, value: float) -> None:
        if value < 0 or not math.isfinite(value):
            raise ValueError(f"sketch values must be finite >= 0: {value}")
        self.count += 1
        self.total += value
        if value <= self.min_value:
            self._zero += 1
            return
        key = math.ceil(math.log(value / self.min_value) / self._log_gamma)
        self._buckets[key] = self._buckets.get(key, 0) + 1

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1], within ``rel_err`` relative
        error (bucket midpoint in log space); 0.0 on an empty sketch."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q={q}: need 0 <= q <= 1")
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        seen = self._zero
        if rank < seen:
            return 0.0
        for key in sorted(self._buckets):
            seen += self._buckets[key]
            if rank < seen:
                return self.min_value * math.exp((key - 0.5)
                                                 * self._log_gamma)
        return self.min_value * math.exp((max(self._buckets) - 0.5)
                                         * self._log_gamma)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def merge(self, other: "LatencySketch") -> "LatencySketch":
        if (other.rel_err != self.rel_err
                or other.min_value != self.min_value):
            raise ValueError("cannot merge sketches with different layouts")
        out = LatencySketch(rel_err=self.rel_err, min_value=self.min_value)
        out._zero = self._zero + other._zero
        out.count = self.count + other.count
        out.total = self.total + other.total
        for src in (self._buckets, other._buckets):
            for k, n in src.items():
                out._buckets[k] = out._buckets.get(k, 0) + n
        return out


@dataclasses.dataclass(frozen=True)
class Completion:
    """One request's fate in VIRTUAL time (seconds on the manual clock):
    arrival -> service start (queue wait) -> done (service), with the
    energy actually charged and the tenant's deadline verdict."""
    uid: int
    tenant: str
    t_arrival: float
    t_start: float
    t_done: float
    service_ms: float
    energy_mwh: float
    deadline_ms: Optional[float]
    ok: bool                      # served without a backend error
    pod: int = 0
    pair: Optional[tuple] = None

    @property
    def queue_wait_ms(self) -> float:
        return (self.t_start - self.t_arrival) * 1e3

    @property
    def e2e_ms(self) -> float:
        return (self.t_done - self.t_arrival) * 1e3

    @property
    def within_deadline(self) -> bool:
        """Goodput verdict: served AND under the tenant's deadline (no
        deadline means any successful completion counts)."""
        return self.ok and (self.deadline_ms is None
                            or self.e2e_ms <= self.deadline_ms)


class _Window:
    def __init__(self, rel_err: float):
        self.e2e = LatencySketch(rel_err=rel_err)
        self.queue_wait = LatencySketch(rel_err=rel_err)
        self.service = LatencySketch(rel_err=rel_err)
        self.n = 0
        self.good = 0
        self.failed = 0
        self.energy_mwh = 0.0
        self.tenants: Dict[str, Dict[str, int]] = {}


class WindowedSLO:
    """Streaming SLO tracker: completions fold into the sketch of the
    virtual-time window they COMPLETE in (an overloaded minute shows up in
    that minute's percentiles, not smeared across the episode)."""

    def __init__(self, *, window_s: float = 1.0, rel_err: float = 0.01):
        if window_s <= 0:
            raise ValueError(f"window_s={window_s}: need > 0")
        self.window_s = window_s
        self.rel_err = rel_err
        self._windows: Dict[int, _Window] = {}

    def record(self, c: Completion) -> None:
        idx = int(c.t_done // self.window_s)
        w = self._windows.get(idx)
        if w is None:
            w = self._windows[idx] = _Window(self.rel_err)
        w.n += 1
        w.energy_mwh += c.energy_mwh
        per = w.tenants.setdefault(c.tenant, {"n": 0, "good": 0})
        per["n"] += 1
        if not c.ok:
            w.failed += 1
        if c.within_deadline:
            w.good += 1
            per["good"] += 1
        w.e2e.add(c.e2e_ms)
        w.queue_wait.add(c.queue_wait_ms)
        w.service.add(c.service_ms)

    @staticmethod
    def _percentiles(w: "_Window") -> Dict[str, float]:
        return {
            "p50_ms": w.e2e.quantile(0.50),
            "p95_ms": w.e2e.quantile(0.95),
            "p99_ms": w.e2e.quantile(0.99),
            "queue_wait_p50_ms": w.queue_wait.quantile(0.50),
            "queue_wait_p99_ms": w.queue_wait.quantile(0.99),
            "service_p50_ms": w.service.quantile(0.50),
        }

    def window_records(self) -> List[Dict]:
        """One record per non-empty window, in time order — what the load
        bench appends to the trajectory."""
        out = []
        for idx in sorted(self._windows):
            w = self._windows[idx]
            out.append({
                "t_start_s": idx * self.window_s,
                "n": w.n,
                "failed": w.failed,
                "goodput_rps": w.good / self.window_s,
                "joules_per_request": (mwh_to_joules(w.energy_mwh) / w.n
                                       if w.n else 0.0),
                "tenants": {t: dict(v) for t, v in w.tenants.items()},
                **self._percentiles(w),
            })
        return out

    def summary(self) -> Dict:
        """Episode-wide aggregate: merged sketches + total goodput."""
        windows = [self._windows[i] for i in sorted(self._windows)]
        agg = _Window(self.rel_err)
        for w in windows:
            agg.e2e = agg.e2e.merge(w.e2e)
            agg.queue_wait = agg.queue_wait.merge(w.queue_wait)
            agg.service = agg.service.merge(w.service)
            agg.n += w.n
            agg.good += w.good
            agg.failed += w.failed
            agg.energy_mwh += w.energy_mwh
        span_s = len(windows) * self.window_s
        return {
            "completions": agg.n,
            "failed": agg.failed,
            "windows": len(windows),
            "goodput_fraction": agg.good / agg.n if agg.n else 0.0,
            "goodput_rps": agg.good / span_s if span_s else 0.0,
            "joules_per_request": (mwh_to_joules(agg.energy_mwh) / agg.n
                                   if agg.n else 0.0),
            **self._percentiles(agg),
        }
