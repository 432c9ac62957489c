"""One execution plane, three drivers: sync service, asyncio facade,
sharded cluster — all over the same policy + ExecutionBackend pair.

  PYTHONPATH=src python -m repro_torch.examples.async_cluster
  PYTHONPATH=src python -m repro_torch.examples.async_cluster --device cpu

Uses DetectorBackends over the edge-device models (no training needed: a
stub detector stands in, the device energy/latency models are real); the
profile state and the cluster's shard selection live on ``--device``.
"""
import argparse
import asyncio

import numpy as np

from repro_torch.core.policy import DetectionPolicy, Observation, RouteRequest
from repro_torch.core.router import OracleRouter
from repro_torch.detection.devices import nominal_profile_table
from repro_torch.serving.aio import AsyncEcoreService
from repro_torch.serving.backend import make_backend, null_run
from repro_torch.serving.cluster import EcoreCluster
from repro_torch.serving.service import EcoreService


def policy_for(_pod: int, device) -> DetectionPolicy:
    table = nominal_profile_table(device=device)
    return DetectionPolicy(OracleRouter(table, 5.0), table)


def factory_on(device):
    def factory(decision):
        return make_backend("detector", decision.pair[0], decision.pair[1],
                            None, max_batch=4, run_fn=null_run,
                            device=device)
    return factory


def requests(n: int):
    rng = np.random.default_rng(0)
    frame = np.zeros((8, 8), np.float32)
    return [RouteRequest(uid=i, payload=frame,
                         true_complexity=int(rng.integers(0, 9)))
            for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    factory = factory_on(dev)

    # 1) sync service: futures + drain
    with EcoreService(policy_for(0, dev), factory) as service:
        futs = [service.submit(r) for r in requests(8)]
        service.drain()
        hist = {}
        for f in futs:
            hist[f.result().decision.pair_name] = \
                hist.get(f.result().decision.pair_name, 0) + 1
        print("sync service pairs:", hist)

    # 2) asyncio facade: the same plane, awaitable
    async def drive():
        async with AsyncEcoreService(policy_for(0, dev), factory) as svc:
            futs = [svc.submit_nowait(r) for r in requests(8)]
            await svc.drain()
            served = await asyncio.gather(*futs)
            # the single observation plane works here too
            svc.observe(Observation(pair=served[0].decision.pair,
                                    uid=served[0].request.uid,
                                    time_ms=99.0))
            return [s.decision.pair_name for s in served]

    print("async served:", sorted(set(asyncio.run(drive()))))

    # 3) cluster: shard one stream over 4 pods, aggregate stats
    with EcoreCluster(lambda pod: policy_for(pod, dev), factory, pods=4,
                      device=dev) as cluster:
        futs = cluster.submit_batch(requests(32))
        cluster.drain()
        if not all(f.done() for f in futs):
            raise RuntimeError("the cluster's drain left requests pending")
        stats = cluster.stats()
        print(f"cluster: {stats['served']} served over {stats['pods']} pods, "
              f"shard_counts={stats['shard_counts']}")


if __name__ == "__main__":
    main()
