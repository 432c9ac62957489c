"""repro_torch.traffic: open-loop load harness + SLO plane.

Production gateways see OPEN-LOOP traffic — requests arrive whether or
not the fleet keeps up — while everything the paper measures is
closed-loop (fixed-size streams, next request waits for the last).  This
package closes that gap deterministically:

  * ``arrivals``  — arrival processes (Poisson, diurnal sinusoid, flash
                    crowd) as pure functions of a seed, plus the
                    ``ManualClock`` every component rides;
  * ``workload``  — multi-tenant request mixes (detector tenants seeded
                    from the drift scenarios in ``detection/scenes.py``,
                    LLM tenants over the serving pool's prompt-length
                    distribution) and the ``LoadDriver`` that pushes them
                    into an ``EcoreService``/``EcoreCluster`` at their
                    arrival times — no backpressure, late service means
                    queue growth;
  * ``slo``       — streaming windowed percentile sketches (p50/p95/p99
                    end-to-end latency split into queue wait and service
                    time), goodput under per-tenant deadlines, and
                    joules-per-request.

Everything is virtual-time: no wall-clock sleeps anywhere, so a
10-minute diurnal episode replays in milliseconds, bit-identically, in CI.
The same plane as ``repro.traffic``, host code on numpy; the pods it
drives run on the card.
"""
from repro_torch.traffic.arrivals import (ARRIVAL_PATTERNS, ManualClock,
                                          diurnal_arrivals,
                                          flash_crowd_arrivals,
                                          make_arrivals, poisson_arrivals)
from repro_torch.traffic.slo import Completion, LatencySketch, WindowedSLO
from repro_torch.traffic.workload import (LoadDriver, Tenant, TimedRequest,
                                          detector_tenant, llm_tenant,
                                          merge_tenants)

__all__ = [
    "ARRIVAL_PATTERNS", "ManualClock", "diurnal_arrivals",
    "flash_crowd_arrivals", "make_arrivals", "poisson_arrivals",
    "Completion", "LatencySketch", "WindowedSLO",
    "LoadDriver", "Tenant", "TimedRequest", "detector_tenant",
    "llm_tenant", "merge_tenants",
]
