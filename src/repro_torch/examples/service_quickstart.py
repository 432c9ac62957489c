"""EcoreService in ~30 lines: the request-centric serving API.

  PYTHONPATH=src python -m repro_torch.examples.service_quickstart
  PYTHONPATH=src python -m repro_torch.examples.service_quickstart \
      --device cpu --reduced

Build a routing policy (here: Algorithm 1 over prompt-length buckets),
hand it to an ``EcoreService`` with a backend factory, and stream typed
``RouteRequest``s at it — batching, per-backend queues, the deadline-
bounded background flusher and the ``Observation`` feedback plane are all
inside the service.  The backends run at full published width on
``--device`` (``--reduced``: their reduced variants).
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.policy import Observation, PoolPolicy, RouteRequest
from repro_torch.launch.serve import synthetic_pool_table
from repro_torch.serving.engine import Backend
from repro_torch.serving.pool import ServingPool
from repro_torch.serving.service import EcoreService


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    pool = ServingPool(synthetic_pool_table(["qwen2.5-3b", "mamba2-370m"],
                                            device=args.device), delta=5.0)

    def backend_factory(decision):
        cfg = get_config(decision.backend)
        if args.reduced:
            cfg = cfg.reduced()
        return Backend(decision.backend, cfg, max_batch=4, max_seq=96,
                       device=args.device)

    rng = np.random.default_rng(0)
    with EcoreService(PoolPolicy(pool), backend_factory,
                      max_wait_ms=25.0) as service:
        futures = [service.submit(RouteRequest(
            uid=uid, complexity=plen, max_new_tokens=4,
            payload=rng.integers(0, 1000, size=min(plen, 48))))
            for uid, plen in enumerate((32, 64, 2048, 50_000, 128, 96))]
        for fut in futures:
            s = fut.result(timeout=600)
            print(f"req {s.request.uid} (len {s.request.complexity:6d}) -> "
                  f"{s.decision.pair_name:22s} bucket={s.decision.group} "
                  f"batch={s.result.batch_size} tokens={s.result.tokens}")
            # close the loop: measured latency feeds the next decision
            service.observe(Observation(
                pair=s.decision.pair,
                time_ms=(s.result.prefill_s + s.result.decode_s) * 1e3
                / s.result.batch_size))
        print("flushes:", service.stats()["serve_calls"],
              "| deadline flushes:", service.deadline_flushes)


if __name__ == "__main__":
    main()
