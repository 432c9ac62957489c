"""Deterministic open-loop arrival processes on the injectable clock.

Every generator is a pure function of ``(rate, duration, seed)`` returning
ABSOLUTE arrival times (float seconds, sorted ascending) — the same seed
always yields the same stream, so a load episode is replayable
bit-for-bit.  Inhomogeneous processes (diurnal sinusoid, flash crowd) are
built by Lewis-Shedler thinning of a homogeneous Poisson process at the
peak rate: candidates are kept with probability ``rate(t) / peak``, which
preserves both determinism and the exact Poisson counting statistics.

``ManualClock`` is the virtual clock the whole traffic plane rides: the
``LoadDriver`` advances it to each arrival/deadline event, services see it
through their injectable ``clock`` parameter, and nothing ever sleeps on
the wall clock.

A copy of ``repro.traffic.arrivals`` (the port imports nothing of
``repro``): the same seed gives the same stream, bit for bit.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

RateFn = Callable[[np.ndarray], np.ndarray]


class ManualClock:
    """A settable monotonic clock (seconds).  Drop-in for ``time.monotonic``
    wherever a ``clock`` parameter is injectable; the driver owns time."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance a monotonic clock by {dt}")
        self._t += dt
        return self._t

    def advance_to(self, t: float) -> float:
        """Move to absolute time ``t``; earlier-than-now is clamped (events
        may be processed slightly late, never in the past)."""
        self._t = max(self._t, float(t))
        return self._t


def _homogeneous(rng: np.random.Generator, rate_hz: float,
                 duration_s: float) -> np.ndarray:
    """Cumulative-sum-of-exponential-gaps Poisson process on [0, duration).
    Gaps are drawn in chunks until the horizon is passed (the loop is
    bounded: every chunk advances time by a positive amount a.s.)."""
    chunks: List[np.ndarray] = []
    t = 0.0
    size = max(int(rate_hz * duration_s * 1.25) + 16, 16)
    while t < duration_s:
        ts = t + np.cumsum(rng.exponential(1.0 / rate_hz, size=size))
        chunks.append(ts)
        t = float(ts[-1])
    ts = np.concatenate(chunks)
    return ts[ts < duration_s]


def poisson_arrivals(rate_hz: float, duration_s: float, *, seed: int = 0,
                     t0: float = 0.0) -> np.ndarray:
    """Homogeneous Poisson arrivals at ``rate_hz`` on [t0, t0+duration)."""
    if rate_hz <= 0 or duration_s <= 0:
        return np.empty(0, np.float64)
    rng = np.random.default_rng(seed)
    return t0 + _homogeneous(rng, rate_hz, duration_s)


def thinned_arrivals(rate_fn: RateFn, peak_rate_hz: float,
                     duration_s: float, *, seed: int = 0,
                     t0: float = 0.0) -> np.ndarray:
    """Inhomogeneous Poisson arrivals with intensity ``rate_fn(t)`` (which
    must never exceed ``peak_rate_hz``), by thinning a homogeneous process
    at the peak rate.  One rng drives both the candidates and the keep
    draws, so the stream is a pure function of the seed."""
    if peak_rate_hz <= 0 or duration_s <= 0:
        return np.empty(0, np.float64)
    rng = np.random.default_rng(seed)
    cand = _homogeneous(rng, peak_rate_hz, duration_s)
    keep = rng.uniform(size=len(cand)) * peak_rate_hz < rate_fn(cand)
    return t0 + cand[keep]


def diurnal_rate(base_hz: float, *, amplitude: float = 0.5,
                 period_s: float = 60.0, phase: float = 0.0) -> RateFn:
    """Sinusoidal day/night intensity: mean ``base_hz``, swinging by
    ``amplitude`` (fraction of base, <= 1 so the rate stays nonnegative)."""
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError(f"amplitude={amplitude}: need 0 <= a <= 1")

    def rate(t: np.ndarray) -> np.ndarray:
        return base_hz * (1.0 + amplitude
                          * np.sin(2.0 * np.pi * t / period_s + phase))
    return rate


def diurnal_arrivals(base_hz: float, duration_s: float, *,
                     amplitude: float = 0.5, period_s: float = 60.0,
                     phase: float = 0.0, seed: int = 0,
                     t0: float = 0.0) -> np.ndarray:
    """Diurnal-cycle arrivals (the smart-city day/night swing, compressed
    to ``period_s``).  Over whole periods the mean rate is ``base_hz``."""
    fn = diurnal_rate(base_hz, amplitude=amplitude, period_s=period_s,
                      phase=phase)
    return thinned_arrivals(fn, base_hz * (1.0 + amplitude), duration_s,
                            seed=seed, t0=t0)


def flash_crowd_rate(base_hz: float, spike_hz: float, spike_start_s: float,
                     spike_len_s: float) -> RateFn:
    """Step intensity: ``base_hz`` everywhere except a ``spike_hz`` plateau
    on [spike_start, spike_start + spike_len) — the stadium-exit burst."""

    def rate(t: np.ndarray) -> np.ndarray:
        in_spike = (t >= spike_start_s) & (t < spike_start_s + spike_len_s)
        return np.where(in_spike, spike_hz, base_hz)
    return rate


def flash_crowd_arrivals(base_hz: float, duration_s: float, *,
                         spike_hz: float = None, spike_start_s: float = None,
                         spike_len_s: float = None, seed: int = 0,
                         t0: float = 0.0) -> np.ndarray:
    """Flash-crowd arrivals: steady ``base_hz`` with one rate spike
    (default: 4x base for the middle fifth of the episode)."""
    spike_hz = 4.0 * base_hz if spike_hz is None else spike_hz
    if spike_hz < base_hz:
        raise ValueError(f"spike_hz={spike_hz} below base_hz={base_hz}")
    spike_start_s = (0.4 * duration_s if spike_start_s is None
                     else spike_start_s)
    spike_len_s = 0.2 * duration_s if spike_len_s is None else spike_len_s
    fn = flash_crowd_rate(base_hz, spike_hz, spike_start_s, spike_len_s)
    return thinned_arrivals(fn, spike_hz, duration_s, seed=seed, t0=t0)


#: name -> generator(rate_hz, duration_s, *, seed, t0)
ARRIVAL_PATTERNS: Dict[str, Callable[..., np.ndarray]] = {
    "poisson": poisson_arrivals,
    "diurnal": diurnal_arrivals,
    "flash": flash_crowd_arrivals,
}


def make_arrivals(pattern: str, rate_hz: float, duration_s: float, *,
                  seed: int = 0, t0: float = 0.0) -> np.ndarray:
    """Build an arrival stream by registry name (each pattern's optional
    shape knobs stay at their defaults; call the generator directly for
    custom spikes/periods)."""
    try:
        fn = ARRIVAL_PATTERNS[pattern]
    except KeyError:
        raise ValueError(f"unknown arrival pattern {pattern!r}; one of "
                         f"{sorted(ARRIVAL_PATTERNS)}") from None
    return fn(rate_hz, duration_s, seed=seed, t0=t0)
