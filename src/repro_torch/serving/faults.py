"""Fault injection plane: deterministic failures for any ExecutionBackend.

Every fault is a pure function of the request ``uid``: a ``FaultSpec``
hashes (uid, seed, kind) through a splitmix32 avalanche and fires when the
hash lands under ``rate``.  Two runs over the same uid stream inject the
same faults however dispatch batches or reorders, and on the same uids as
``repro.serving.faults`` for the same specs.

Four fault kinds:

  * ``error``        — the device throws: ``serve_batch`` raises
                       ``InjectedFault`` (the whole batch dies with it)
  * ``stall``        — the device answers LATE: the result's modeled
                       ``time_ms`` grows by ``stall_ms``
  * ``corrupt``      — the device answers GARBAGE: payload zeroed and
                       ``time_ms`` = NaN, the marker the resilience layer
                       rejects
  * ``crash_window`` — the device is down for every uid in
                       [``start``, ``end``)

``make_backend("faulty:<inner>", ..., faults=[...])`` wraps a registered
backend in ``FaultyBackend``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.backend import ExecutionBackend, ensure_backend
from repro_torch.serving.engine import Request, Result

FAULT_KINDS = ("error", "stall", "corrupt", "crash_window")

#: per-kind hash salt so one seed drives independent streams per fault kind
_KIND_SALT = {"error": 0x9E3779B9, "stall": 0x85EBCA6B,
              "corrupt": 0xC2B2AE35, "crash_window": 0x27D4EB2F}

_MUL1, _MUL2 = np.uint32(0x7FEB352D), np.uint32(0x846CA68B)


def _mix32(x):
    """splitmix32-style avalanche on a uint32 numpy array (wraps silently);
    the integer ops of ``repro.serving.cluster._mix32``."""
    x = x ^ (x >> 16)
    x = x * _MUL1
    x = x ^ (x >> 15)
    x = x * _MUL2
    x = x ^ (x >> 16)
    return x


def uniform_u32(uid: int, salt) -> int:
    """The uint32 hash of ``uid`` under ``salt``."""
    return int(_mix32(np.asarray([uid], np.uint32) ^ np.uint32(salt))[0])


class InjectedFault(RuntimeError):
    """A deterministically injected backend failure."""

    def __init__(self, kind: str, uid: int, backend: str):
        super().__init__(f"injected {kind} fault on {backend!r} "
                         f"(fired by uid {uid})")
        self.kind = kind
        self.uid = uid
        self.backend = backend


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault mode, seeded per request uid.  ``rate`` is the per-uid
    firing probability for ``error``/``stall``/``corrupt`` (by hashing, so
    reproducible, not sampled); ``crash_window`` ignores it and fires for
    every uid in [``start``, ``end``)."""
    kind: str
    rate: float = 1.0
    seed: int = 0
    stall_ms: float = 250.0     # modeled extra latency for a stall
    start: int = 0              # crash window [start, end) in uid space
    end: Optional[int] = None   # exclusive; None = never recovers

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate={self.rate}: probability in [0, 1]")

    def fires(self, uid: int) -> bool:
        """Does this fault hit request ``uid``?  Pure and stateless."""
        if self.kind == "crash_window":
            return uid >= self.start and (self.end is None
                                          or uid < self.end)
        if self.rate <= 0.0:
            return False
        if self.rate >= 1.0:
            return True
        salt = _mix32(np.asarray([self.seed], np.uint32)
                      ^ np.uint32(_KIND_SALT[self.kind]))[0]
        return uniform_u32(uid, salt) < int(self.rate * 4294967296.0)


class FaultyBackend:
    """Wrap any ``ExecutionBackend`` with deterministic fault injection.

    ``error``/``crash_window`` faults fire BEFORE the inner backend runs —
    no result exists and the whole batch fails.  ``stall``/``corrupt``
    rewrite the inner backend's results.  ``injected`` counts fired faults
    per kind."""

    def __init__(self, inner: ExecutionBackend,
                 faults: Sequence[FaultSpec] = ()):
        self.inner = ensure_backend(inner)
        self.faults = tuple(faults)
        self.name = self.inner.name
        self.max_batch = self.inner.max_batch
        self.injected: Dict[str, int] = {k: 0 for k in FAULT_KINDS}

    def serve_batch(self, requests: List[Request]) -> List[Result]:
        for r in requests:
            for spec in self.faults:
                if (spec.kind in ("error", "crash_window")
                        and spec.fires(r.uid)):
                    self.injected[spec.kind] += 1
                    raise InjectedFault(spec.kind, r.uid, self.name)
        out = []
        for res in self.inner.serve_batch(requests):
            for spec in self.faults:
                if spec.kind == "stall" and spec.fires(res.uid):
                    self.injected["stall"] += 1
                    res = dataclasses.replace(
                        res, time_ms=(res.time_ms or 0.0) + spec.stall_ms)
                elif spec.kind == "corrupt" and spec.fires(res.uid):
                    self.injected["corrupt"] += 1
                    res = dataclasses.replace(
                        res, tokens=np.zeros_like(res.tokens),
                        detections=None, time_ms=float("nan"))
            out.append(res)
        return out

    def profile_row(self) -> Dict[str, object]:
        row = dict(self.inner.profile_row())
        row["faults"] = [f.kind for f in self.faults]
        return row
