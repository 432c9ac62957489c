"""Edge-device energy/latency models + the paper's testbed construction.

Each device is parameterized by (effective GFLOP/s for small convnets,
active power W, fixed per-request overhead ms).  The constants are chosen to
reproduce the ORDERING in the paper's Table 1 / Fig. 5 (Jetson Orin Nano =
lowest energy; Pi5+Coral TPU = lowest latency; accelerators fast but
power-hungry relative to their speed on small models; plain Pis slow).
Absolute numbers are representative; the paper's claims are ratios,
which are insensitive to the absolute scale.  A copy of
``repro.detection.devices`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class EdgeDevice:
    name: str
    gflops: float       # sustained for small conv nets
    watts: float        # active power above idle
    overhead_ms: float  # request handling / runtime dispatch

    def time_ms(self, flops: float) -> float:
        return flops / (self.gflops * 1e9) * 1e3 + self.overhead_ms

    def energy_mwh(self, flops: float) -> float:
        hours = self.time_ms(flops) / 1e3 / 3600.0
        return self.watts * hours * 1e3  # W * h * 1000 = mWh


DEVICES: Dict[str, EdgeDevice] = {
    "pi3":        EdgeDevice("pi3", 1.2, 3.2, 9.0),
    "pi3_tpu":    EdgeDevice("pi3_tpu", 16.0, 5.4, 6.0),
    "pi4":        EdgeDevice("pi4", 2.8, 4.2, 6.0),
    "pi4_tpu":    EdgeDevice("pi4_tpu", 22.0, 6.4, 4.0),
    "pi5":        EdgeDevice("pi5", 6.5, 5.6, 3.5),
    "pi5_tpu":    EdgeDevice("pi5_tpu", 32.0, 7.8, 1.2),  # lowest latency
    "pi5_aihat":  EdgeDevice("pi5_aihat", 26.0, 7.2, 2.0),
    "orin_nano":  EdgeDevice("orin_nano", 40.0, 6.8, 2.6),  # lowest energy
}

# The paper's finalized testbed (Table 1) pairs — each strong in >=1 metric.
# We profile ALL (8 models x 8 devices) = 64 pairs for the Fig. 5 Pareto
# analog, then select this subset for routing experiments.
TESTBED_PAIRS: Tuple[Tuple[str, str], ...] = (
    ("ssd_v1", "orin_nano"),     # lowest energy        (Table 1 row 1)
    ("ssd_v1", "pi5_tpu"),       # lowest latency       (row 2)
    ("ssd_lite", "pi5"),         # mAP group 2          (row 4)
    ("yolov8_s", "orin_nano"),   # mAP group 3          (row 5)
    ("yolov8_s", "pi5_aihat"),   # mAP groups 4/5       (rows 6-7)
    ("yolov8_n", "pi5_tpu"),     # extra pareto point
)


# ------------------------------------------------------- nominal profiling
# Routing-dynamics fixtures (benches, examples, tests) need a profile with
# the testbed's SHAPE but no trained detectors: nominal per-model mAPs that
# degrade mildly with the group, device costs from the real energy models.

NOMINAL_MAP: Dict[str, float] = {"ssd_v1": 52.0, "ssd_lite": 55.0,
                                 "yolov8_n": 57.0, "yolov8_s": 60.0}


def nominal_profile_table(pairs: Sequence[Tuple[str, str]] = TESTBED_PAIRS,
                          groups: int = 5, *, device="cuda"):
    """Fresh ProfileTable over ``pairs`` with nominal mAPs and modeled
    device costs — isolates WHERE requests go from how well boxes are
    drawn.  Callers that EWMA-adapt get their own instance per call.  The
    table's state lives on ``device``."""
    from repro_torch.core.profiles import ProfileEntry, ProfileTable
    from repro_torch.detection.detectors import DETECTOR_CONFIGS
    entries = []
    for m, d in pairs:
        flops = DETECTOR_CONFIGS[m].flops
        for g in range(groups):
            entries.append(ProfileEntry(
                m, d, g, NOMINAL_MAP[m] - 1.5 * g,
                DEVICES[d].time_ms(flops), DEVICES[d].energy_mwh(flops)))
    return ProfileTable(entries, device=device)


# --------------------------------------------------------------- drift model
# BEYOND-PAPER (paper §6 / AyE-Edge 2408.05363): the offline profile goes
# stale at runtime — devices throttle, share CPU with other tenants, or drop
# off the network.  A DriftingFleet is a time-varying view of DEVICES that
# the gateway can charge ACTUAL costs against while the routers still consult
# the (possibly EWMA-adapted) profile table.

class DeviceDropout(RuntimeError):
    """A hard-dropout device was asked to serve while unreachable
    (``DriftEvent(kind="dropout", hard=True)`` active at this step).  The
    dispatch plane turns this into a failed batch the resilience layer
    retries elsewhere — unlike the soft penalty, the request does NOT
    complete on this device."""

    def __init__(self, device: str, step: int):
        super().__init__(f"device {device!r} is unreachable at step {step} "
                         "(hard dropout window)")
        self.device = device
        self.step = step


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    """One runtime condition change on one device.

    kind:
      * ``thermal``    — sustained throttling: the latency multiplier ramps
                         linearly from 1 to ``severity`` over ``ramp`` steps
                         after ``start`` and stays there
      * ``background`` — co-tenant load: square wave alternating between
                         ``severity`` and 1 with ``period`` steps per cycle
      * ``dropout``    — device unreachable in [start, end): requests pay a
                         flat ``severity``x retry/timeout penalty — or, with
                         ``hard=True``, FAIL outright: the scalar ``cost``
                         raises ``DeviceDropout`` (the serving path's batch
                         error) and the vectorized faces report ``inf``
                         (the scanned closed loop's failure sentinel that
                         drives the quarantine breaker)
    Energy scales with the same multiplier (active power x longer busy time).
    """
    device: str
    kind: str
    start: int = 0
    end: Optional[int] = None   # exclusive; None = never ends
    severity: float = 2.0
    ramp: int = 40              # thermal ramp-up length, steps
    period: int = 60            # background-load cycle length, steps
    hard: bool = False          # dropout only: raise instead of penalizing

    def active(self, step: int) -> bool:
        return step >= self.start and (self.end is None or step < self.end)

    def failing(self, step: int) -> bool:
        """True when a HARD dropout makes the device unreachable at
        ``step`` (soft events never fail — they only cost more)."""
        return self.hard and self.kind == "dropout" and self.active(step)

    def multiplier(self, step: int) -> float:
        if not self.active(step):
            return 1.0
        if self.kind == "thermal":
            frac = min((step - self.start) / max(self.ramp, 1), 1.0)
            return 1.0 + (self.severity - 1.0) * frac
        if self.kind == "background":
            phase = ((step - self.start) % self.period) / self.period
            return self.severity if phase < 0.5 else 1.0
        if self.kind == "dropout":
            return float("inf") if self.hard else self.severity
        raise ValueError(f"unknown drift kind {self.kind!r}")

    def multipliers(self, steps: int):
        """``multiplier(t)`` for every t in [0, steps) in one shot — the
        vectorized face the scanned closed loop's measurement precompute
        uses (exact-parity with the scalar method, tested)."""
        import numpy as np
        t = np.arange(steps)
        if self.kind == "thermal":
            frac = np.minimum((t - self.start) / max(self.ramp, 1), 1.0)
            m = 1.0 + (self.severity - 1.0) * frac
        elif self.kind == "background":
            phase = ((t - self.start) % self.period) / self.period
            m = np.where(phase < 0.5, self.severity, 1.0)
        elif self.kind == "dropout":
            m = np.full(steps, np.inf if self.hard else self.severity)
        else:
            raise ValueError(f"unknown drift kind {self.kind!r}")
        active = t >= self.start
        if self.end is not None:
            active &= t < self.end
        return np.where(active, m, 1.0)


class DriftingFleet:
    """Time-varying device fleet: actual per-request cost at step t is the
    profiled cost times the product of every active drift event's multiplier."""

    def __init__(self, events: Sequence[DriftEvent] = (),
                 devices: Dict[str, EdgeDevice] = DEVICES):
        self.events = tuple(events)
        self.devices = devices

    def multiplier(self, device: str, step: int) -> float:
        m = 1.0
        for ev in self.events:
            if ev.device == device:
                m *= ev.multiplier(step)
        return m

    def failing(self, device: str, step: int) -> bool:
        """True when a hard-dropout event makes ``device`` unreachable at
        ``step`` — ``cost`` raises instead of quoting a price."""
        return any(ev.device == device and ev.failing(step)
                   for ev in self.events)

    def cost(self, device: str, flops: float, step: int
             ) -> Tuple[float, float]:
        """(time_ms, energy_mwh) actually paid at ``step``; energy is linear
        in busy time, so both scale by the same multiplier.  Raises
        ``DeviceDropout`` when a hard-dropout window covers ``step`` — the
        request did not complete, so there IS no cost to report."""
        if self.failing(device, step):
            raise DeviceDropout(device, step)
        dev = self.devices[device]
        m = self.multiplier(device, step)
        return dev.time_ms(flops) * m, dev.energy_mwh(flops) * m

    def cost_profile(self, device: str, flops: float, steps: int):
        """``cost(device, flops, t)`` for every t in [0, steps) as two [T]
        arrays — the vectorized precompute for the scanned closed loop
        (one numpy pass instead of T Python calls per pair)."""
        import numpy as np
        m = np.ones(steps)
        for ev in self.events:
            if ev.device == device:
                m = m * ev.multipliers(steps)
        dev = self.devices[device]
        return dev.time_ms(flops) * m, dev.energy_mwh(flops) * m


def drift_scenario(name: str, device: str = "orin_nano",
                   start: int = 0) -> DriftingFleet:
    """Named single-event scenarios used by tests and the adaptive bench."""
    if name == "thermal":
        events = (DriftEvent(device, "thermal", start=start, severity=4.0),)
    elif name == "background":
        events = (DriftEvent(device, "background", start=start, severity=3.0,
                             period=80),)
    elif name == "dropout":
        events = (DriftEvent(device, "dropout", start=start, end=start + 120,
                             severity=30.0),)
    else:
        raise ValueError(f"unknown drift scenario {name!r}")
    return DriftingFleet(events)
