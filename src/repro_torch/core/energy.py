"""Energy accounting: the edge devices of the paper's testbed and the
roofline backends of the LLM pool.

Edge energy comes from the device models in repro_torch.detection.devices;
the gateway host is modeled as a Pi5-class device.  Pool backends derive
latency/energy from the dry-run roofline rows (repro_torch.launch.dryrun).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.detection.devices import DEVICES

GATEWAY_DEVICE = DEVICES["pi5"]

#: 1 mWh = 3.6 J
MWH_TO_J = 3.6


def mwh_to_joules(mwh: float) -> float:
    """Convert milliwatt-hours (the profile/bench unit) to joules (the
    paper's reporting unit, and what the SLO plane charges per request)."""
    return mwh * MWH_TO_J


def gateway_cost(flops: float) -> Dict[str, float]:
    """Latency/energy of an estimator invocation at the gateway.

    In-process estimation: pure compute time on the gateway host (no
    per-request dispatch overhead — that applies to backend requests)."""
    if flops <= 0:
        return {"time_ms": 0.02, "energy_mwh": 1e-6}  # table lookup only
    t_ms = flops / (GATEWAY_DEVICE.gflops * 1e9) * 1e3 + 0.05
    return {"time_ms": t_ms,
            "energy_mwh": GATEWAY_DEVICE.watts * t_ms / 1e3 / 3600.0 * 1e3}


def roofline_backend_profile(row: Dict, *,
                             requests_per_step: int = 1) -> Dict[str, float]:
    """Convert a dry-run roofline row (launch.roofline.Roofline.row()) into
    per-request latency/energy for the serving pool."""
    t = row["t_step_s"]
    e = row["energy_j"]
    per = max(requests_per_step, 1)
    return {"time_ms": t * 1e3 / per,
            "energy_mwh": e / 3.6 / per}  # J -> mWh
