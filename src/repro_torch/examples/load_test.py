"""Open-loop load test: flash crowd vs an autoscaled detector fleet.

  PYTHONPATH=src python -m repro_torch.examples.load_test
  PYTHONPATH=src python -m repro_torch.examples.load_test --device cpu

Everything runs on a ManualClock — the whole episode (a 6-second flash
crowd at hundreds of requests/second) replays in seconds of wall time,
deterministically, so its output is the same on any device.  The
LoadDriver fires batch deadlines at their exact virtual times (services
are built with ``flusher=False``), books per-pod occupancy from the device
latency model, and feeds the resulting backlog to an Autoscaler that grows
the fleet through the spike and retires pods once it passes.  The profile
state and the shard selection live on ``--device``.
"""
import argparse

from repro_torch.core.policy import DetectionPolicy
from repro_torch.core.router import OracleRouter
from repro_torch.detection.devices import nominal_profile_table
from repro_torch.serving.backend import make_backend, null_run
from repro_torch.serving.cluster import Autoscaler, EcoreCluster
from repro_torch.traffic import (LoadDriver, ManualClock, detector_tenant,
                                 flash_crowd_arrivals, merge_tenants)


def policy_for(_pod: int, device) -> DetectionPolicy:
    table = nominal_profile_table(device=device)
    return DetectionPolicy(OracleRouter(table, 5.0), table)


def episode(autoscale: bool, device):
    def factory(decision):
        return make_backend("detector", decision.pair[0], decision.pair[1],
                            None, max_batch=4, run_fn=null_run,
                            device=device)

    clock = ManualClock()
    cluster = EcoreCluster(lambda pod: policy_for(pod, device), factory,
                           pods=2, max_pods=6, max_wait_ms=20.0, clock=clock,
                           retain_results=False, flusher=False, device=device)
    auto = Autoscaler(cluster, clock, min_pods=2, max_pods=6,
                      high_backlog_per_pod=10.0, low_backlog_per_pod=1.0,
                      cooldown_s=0.5) if autoscale else None
    arrivals = flash_crowd_arrivals(300.0, 6.0, spike_hz=1200.0, seed=7)
    work = merge_tenants([
        detector_tenant("cam", arrivals, seed=1, deadline_ms=100.0)])
    driver = LoadDriver(cluster, clock, autoscaler=auto, window_s=1.0)
    try:
        driver.run(work)
    finally:
        cluster.close()
    return driver, auto


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    for name, autoscale in (("fixed 2-pod", False), ("autoscaled", True)):
        driver, auto = episode(autoscale, dev)
        print(f"=== {name} ===")
        for rec in driver.slo.window_records():
            print(f"  t={rec['t_start_s']:4.1f}s  n={rec['n']:4d}  "
                  f"p99={rec['p99_ms']:8.1f}ms  "
                  f"goodput={rec['goodput_rps']:7.1f}/s")
        s = driver.slo.summary()
        print(f"  summary: p99={s['p99_ms']:.1f}ms  "
              f"goodput={s['goodput_fraction']:.3f}  "
              f"J/req={s['joules_per_request']:.4f}")
        if auto is not None:
            acts = ", ".join(f"{e['action']}@{e['t_s']:.1f}s"
                             for e in auto.events)
            print(f"  autoscaler: {acts or '(no events)'}")


if __name__ == "__main__":
    main()
