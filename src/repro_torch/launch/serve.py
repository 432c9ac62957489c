"""Serving driver: one request plane streams ECORE-routed requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 24 --delta 5
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 24 --pods 4
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 24 --async
  PYTHONPATH=src python -m repro_torch.launch.serve --rate 20 --duration 5 \\
      --pattern flash --pods 2 --max-wait-ms 25   # open-loop SLO replay

The port of ``repro.launch.serve``, with the same flags and printed lines.
Backends run on ``--device`` (default ``cuda``; without a GPU pass
``--device cpu``) at the assigned archs' full published widths, or at
their ``reduced()`` variants with ``--reduced``.  Prompts are capped at
``PROMPT_CAP`` tokens (routing still sees the full requested length).  The
routing profile comes from the dry-run roofline (``--dryrun-artifact``)
when that file exists, else from the analytic ``synthetic_pool_table``.
The artifact is the JAX package's (its TPU mesh's rows, ``--dryrun-mesh``
16x16 by default) or the port's own (``python -m
repro_torch.launch.dryrun``: the card's rows, ``--dryrun-mesh 1x1``,
routed on their measured steps).

The driver is a thin loop over ``EcoreService``: it builds a ``PoolPolicy``
(Algorithm 1 over prompt-length buckets), submits ``RouteRequest``s, and
handles ``Served`` completions; dispatch batching, per-backend queues and
the ``--max-wait-ms`` deadline all live inside the service.  With a static
profile the whole workload is routed in one tensorized ``decide_batch``
call (``submit_batch``); ``--adapt`` submits per request, since each
observation changes the table the next decision reads.

``--adapt`` closes the loop: each backend's measured per-request latency,
relative to its own fastest batch of the same shape, rescales its profiled
time and energy through the ``Observation`` plane, so the greedy
argmin-energy routing reacts when a backend runs slower than its profile
claims.

``--pods N`` shards the stream over an ``EcoreCluster`` of N service pods,
each with its own ``PoolPolicy`` over a copy of the profile; every pod's
backend of one arch shares one seeded parameter set, so N pods hold the
weights once.  ``--async`` drives a single pod through the
``AsyncEcoreService`` asyncio facade.  ``--profile-out PATH`` writes the
(possibly adapted) routing profile as json after the run.

``--rate`` replays an open-loop arrival stream through the ``LoadDriver``
on a ``ManualClock``: service times are the profiled costs routing decided
on, so the window records and summary are the same on any device.  What
the device's clock measured (the replay's wall time, each backend's
prefill and decode per batch, generated tokens per second) is printed on
lines of its own, labelled ``measured on``.
"""
from __future__ import annotations

import argparse
import asyncio
import os
import threading
import time

import numpy as np
import torch

from repro_torch import traffic as tr
from repro_torch.configs import get_config
from repro_torch.core.policy import Observation, PoolPolicy, RouteRequest
from repro_torch.core.profiles import ProfileTable
from repro_torch.device import resolve_device
from repro_torch.serving.aio import AsyncEcoreService
from repro_torch.serving.cluster import EcoreCluster
from repro_torch.serving.engine import Backend
from repro_torch.serving.pool import (DEFAULT_POOL, ServingPool,
                                      pool_table_from_dryrun,
                                      synthetic_pool_table)
from repro_torch.serving.service import EcoreService

# the materialized prompt is capped (routing still sees the full requested
# length), so every backend's cache fits max_seq=96
PROMPT_CAP = 48


def _device_label(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)


def _logged(backend_factory, log):
    """``backend_factory`` whose backends append (backend, batch size,
    prefill s, decode s, generated tokens) to ``log`` for every batch."""
    def build(decision):
        backend = backend_factory(decision)
        serve = backend.serve_batch

        def serve_logged(requests):
            results = serve(requests)
            r = results[0]
            log.append((r.backend, r.batch_size, r.prefill_s, r.decode_s,
                        sum(len(x.tokens) for x in results)))
            return results
        backend.serve_batch = serve_logged
        return backend
    return build


def _print_measured(label: str, wall_s: float, log) -> None:
    """The lines a run's device clock measured, beside the modeled SLOs."""
    print(f"measured on {label}: replay wall time {wall_s:.3f} s")
    for arch in sorted({b for b, *_ in log}):
        rows = [r for r in log if r[0] == arch]
        print(f"measured on {label}: {arch}: {len(rows)} batches of "
              f"{sum(r[1] for r in rows)} requests, mean prefill "
              f"{np.mean([r[2] for r in rows]) * 1e3:.2f} ms, mean decode "
              f"{np.mean([r[3] for r in rows]) * 1e3:.2f} ms per batch")
    busy_s = sum(r[2] + r[3] for r in log)
    tokens = sum(r[4] for r in log)
    print(f"measured on {label}: {tokens} generated tokens in "
          f"{busy_s:.3f} s of serve_batch = "
          f"{tokens / max(busy_s, 1e-9):.1f} tokens/s")


def _run_open_loop(args, table: ProfileTable, backend_factory) -> int:
    """--rate mode: replay a generated open-loop arrival stream through the
    virtual-time LoadDriver and report windowed SLOs.  Arrival times are
    virtual (the episode replays as fast as the backends serve); the
    modeled service times come from the routing profile, so queue growth
    reflects the PROFILED fleet capacity at this rate."""
    clock = tr.ManualClock()
    arrivals = tr.make_arrivals(args.pattern, args.rate, args.duration,
                                seed=args.seed)
    work = tr.merge_tenants([tr.llm_tenant(
        "pool", arrivals, seed=args.seed, deadline_ms=args.deadline_ms,
        prompt_cap=PROMPT_CAP, max_new_tokens=args.max_new)])
    log = []
    backend_factory = _logged(backend_factory, log)
    if args.pods > 1:
        service = EcoreCluster(
            lambda i: PoolPolicy(ServingPool(table.copy(),
                                             delta=args.delta)),
            backend_factory, pods=args.pods, shard=args.shard,
            max_wait_ms=args.max_wait_ms, clock=clock,
            retain_results=False, flusher=False, device=args.device)
        plane = f"{args.pods}-pod cluster ({args.shard})"
    else:
        service = EcoreService(
            PoolPolicy(ServingPool(table, delta=args.delta)),
            backend_factory, max_wait_ms=args.max_wait_ms, clock=clock,
            retain_results=False, buffer_errors=False, flusher=False)
        plane = "service"

    driver = tr.LoadDriver(service, clock,
                           window_s=max(args.duration / 10.0, 1.0))
    t0 = time.time()
    try:
        done = driver.run(work)
    finally:
        service.close()
    wall_s = time.time() - t0

    print(f"\nopen-loop replay [{plane}]: {len(done)} requests, "
          f"pattern={args.pattern}, rate={args.rate:.1f}/s, "
          f"duration={args.duration:.0f}s virtual ({wall_s:.1f}s wall)")
    print("window_t_s,n,goodput_rps,p50_ms,p99_ms,queue_wait_p99_ms,"
          "joules_per_request")
    for w in driver.slo.window_records():
        print(f"{w['t_start_s']:.0f},{w['n']},{w['goodput_rps']:.1f},"
              f"{w['p50_ms']:.1f},{w['p99_ms']:.1f},"
              f"{w['queue_wait_p99_ms']:.1f},"
              f"{w['joules_per_request']:.4f}")
    s = driver.slo.summary()
    print(f"summary: p50={s['p50_ms']:.1f}ms p95={s['p95_ms']:.1f}ms "
          f"p99={s['p99_ms']:.1f}ms goodput={s['goodput_fraction']:.3f} "
          f"({s['goodput_rps']:.1f}/s) "
          f"J/req={s['joules_per_request']:.4f} "
          f"failed={s['failed']}")
    _print_measured(_device_label(resolve_device(args.device)), wall_s, log)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="ECORE serving driver: closed-loop request stream by "
                    "default, open-loop load replay with --rate")

    serving = ap.add_argument_group(
        "serving", "workload shape, routing profile, dispatch batching")
    serving.add_argument("--requests", type=int, default=24)
    serving.add_argument("--delta", type=float, default=5.0)
    serving.add_argument("--archs", nargs="*", default=list(DEFAULT_POOL))
    serving.add_argument("--dryrun-artifact",
                         default="artifacts/dryrun.jsonl")
    serving.add_argument("--dryrun-mesh", default="16x16",
                         help="the artifact's rows to route on (default "
                              "16x16, the reference's mesh; 1x1 for the "
                              "port's dry run on one card)")
    serving.add_argument("--max-new", type=int, default=8)
    serving.add_argument("--max-batch", type=int, default=8)
    serving.add_argument("--max-wait-ms", type=float, default=None,
                         help="serve a partial batch once its oldest "
                              "request has waited this long (default: wait "
                              "for a full batch); honored by the service's "
                              "background flusher thread")
    serving.add_argument("--seed", type=int, default=0)
    serving.add_argument("--adapt", action="store_true",
                         help="EWMA-update the routing profile from "
                              "measured per-request latency (closed loop)")
    serving.add_argument("--profile-out", default=None,
                         help="write the routing profile (with any --adapt "
                              "updates folded in) to this json path after "
                              "the run, to warm-start a later session; "
                              "under --pods each pod adapts a PRIVATE copy, "
                              "so the shared source profile is written "
                              "unadapted")
    serving.add_argument("--device", default="cuda",
                         help="where the backends and the profile state "
                              "live (default cuda; without a GPU pass cpu)")
    serving.add_argument("--reduced", action="store_true",
                         help="serve each arch's reduced() variant instead "
                              "of its full published widths")

    scale = ap.add_argument_group(
        "resilience / scale-out", "how many pods serve, and through which "
        "request plane")
    scale.add_argument("--pods", type=int, default=1,
                       help="shard the stream over an EcoreCluster of N "
                            "service pods (each pod: own policy over a "
                            "copy of the profile, own queues and backends)")
    scale.add_argument("--shard", default="least_loaded",
                       choices=["least_loaded", "rendezvous"],
                       help="cluster shard-selection policy (with "
                            "--pods > 1)")
    scale.add_argument("--async", dest="use_async", action="store_true",
                       help="drive one pod through the AsyncEcoreService "
                            "asyncio facade (incompatible with --pods > 1)")

    traffic = ap.add_argument_group(
        "traffic", "open-loop load replay (repro_torch.traffic) — requests "
        "arrive at generated times on a virtual clock instead of the "
        "closed --requests loop")
    traffic.add_argument("--rate", type=float, default=None,
                         help="mean arrival rate in requests/s; turns the "
                              "driver into an open-loop LoadDriver replay")
    traffic.add_argument("--duration", type=float, default=None,
                         help="episode length in virtual seconds "
                              "(default 10; needs --rate)")
    traffic.add_argument("--pattern", default=None,
                         choices=["poisson", "diurnal", "flash"],
                         help="arrival process (default poisson; needs "
                              "--rate)")
    traffic.add_argument("--deadline-ms", type=float, default=None,
                         help="per-request SLO deadline for goodput "
                              "accounting (needs --rate)")

    args = ap.parse_args(argv)
    if args.pods < 1:
        ap.error(f"--pods {args.pods}: need at least one pod")
    if args.use_async and args.pods != 1:
        ap.error("--async drives a single pod; use --pods 1 with it")
    if args.rate is None:
        for flag, v in (("--duration", args.duration),
                        ("--pattern", args.pattern),
                        ("--deadline-ms", args.deadline_ms)):
            if v is not None:
                ap.error(f"{flag} is open-loop traffic shape; it needs "
                         f"--rate")
    else:
        if args.rate <= 0:
            ap.error(f"--rate {args.rate}: need > 0")
        if args.use_async:
            ap.error("--rate replays through the sync LoadDriver; "
                     "drop --async")
        if args.adapt:
            ap.error("--rate is an open-loop replay; --adapt's "
                     "per-request closed loop is not supported with it")
        args.duration = 10.0 if args.duration is None else args.duration
        args.pattern = args.pattern or "poisson"
    dev = resolve_device(args.device)

    if os.path.exists(args.dryrun_artifact):
        table = pool_table_from_dryrun(args.dryrun_artifact,
                                       mesh=args.dryrun_mesh, device=dev)
        table = ProfileTable([e for e in table.entries
                              if e.model in args.archs], device=dev)
        src = args.dryrun_artifact
    else:
        table = synthetic_pool_table(args.archs, device=dev)
        src = "analytic fallback"
    pool = ServingPool(table, delta=args.delta)
    print(f"pool profile from {src}: {len(table.pairs())} backends")

    # (arch, batch_size, prompt_len) -> fastest local_ms: keyed per batch
    # shape, so the first batch of a shape (warm-up) never masquerades as
    # backend drift
    baselines = {}
    # observations rescale the PRISTINE profile (time/energy are
    # bucket-independent per arch), never the already-adapted one — basing
    # them on live decisions would compound drift and stop the profile from
    # recovering once a backend returns to its healthy speed
    pristine = {}
    for entry in table.entries:
        pristine.setdefault(entry.model, (entry.time_ms, entry.energy_mwh))
    totals = {"energy_mwh": 0.0, "time_ms": 0.0}
    t_start = time.time()

    # one seeded parameter set per arch for the whole run: every pod's
    # backend of an arch shares it (read-only), so N pods hold it once
    shared_params = {}
    build_lock = threading.Lock()

    def backend_factory(decision):
        arch = decision.backend
        cfg = get_config(arch)
        if args.reduced:
            cfg = cfg.reduced()
        with build_lock:
            backend = Backend(arch, cfg, shared_params.get(arch),
                              max_batch=args.max_batch, max_seq=96,
                              seed=args.seed, device=dev)
            shared_params.setdefault(arch, backend.params)
        return backend

    if args.rate is not None:
        return _run_open_loop(args, table, backend_factory)

    def handle(served):
        observed = set()  # one observation per serve_batch call, not result
        for s in served:
            d, res, plen = s.decision, s.result, s.request.complexity
            totals["energy_mwh"] += d.energy_mwh
            totals["time_ms"] += d.time_ms
            local_ms = (res.prefill_s + res.decode_s) * 1e3 / res.batch_size
            print(f"req {res.uid:3d} len={plen:6d} bucket={d.group} -> "
                  f"{d.backend:22s} score={d.score:5.1f} "
                  f"prof[t={d.time_ms:8.2f}ms e={d.energy_mwh:7.4f}mWh] "
                  f"local[{local_ms:6.1f}ms/req batch={res.batch_size}] "
                  f"tokens={res.tokens[:4]}")
            key = (d.backend, res.batch_size, min(plen, PROMPT_CAP))
            if args.adapt and key + (res.prefill_s,) not in observed:
                observed.add(key + (res.prefill_s,))
                base_ms = min(baselines.get(key, local_ms), local_ms)
                baselines[key] = base_ms
                slowdown = local_ms / max(base_ms, 1e-9)
                prof_t, prof_e = pristine[d.backend]
                # uid lets a cluster fold the observation into the pod
                # that actually made (and will remake) this decision
                service.observe(Observation(
                    pair=d.pair, uid=res.uid, time_ms=prof_t * slowdown,
                    energy_mwh=prof_e * slowdown))

    rng = np.random.default_rng(args.seed)
    plens = [int(rng.choice([32, 128, 1024, 4096, 40_000],
                            p=[.3, .3, .2, .1, .1]))
             for _ in range(args.requests)]
    reqs = [RouteRequest(uid=uid, complexity=plen,
                         payload=rng.integers(0, 1000,
                                              size=min(plen, PROMPT_CAP)),
                         max_new_tokens=args.max_new)
            for uid, plen in enumerate(plens)]

    if args.use_async:
        # asyncio facade: awaitable futures are the consumption plane
        async def drive_async():
            nonlocal service
            service = AsyncEcoreService(PoolPolicy(pool), backend_factory,
                                        max_wait_ms=args.max_wait_ms)
            try:
                if args.adapt:
                    # closed loop, same cadence as the sync driver: fold
                    # each batch's observations in as soon as it completes,
                    # BEFORE later requests are routed
                    pending = []
                    for req in reqs:
                        pending.append(service.submit_nowait(req))
                        await asyncio.sleep(0)  # let inline flushes land
                        done = [f for f in pending if f.done()]
                        pending = [f for f in pending if not f.done()]
                        handle([f.result() for f in done])
                    await service.drain()
                    handle(await asyncio.gather(*pending))
                else:
                    futs = service.submit_batch_nowait(reqs)
                    await service.drain()   # flush partials -> all resolve
                    handle(await asyncio.gather(*futs))
                return service.stats()
            finally:
                await service.close()

        service = None
        stats = asyncio.run(drive_async())
        plane = "async service"
    elif args.pods > 1:
        # sharded: each pod adapts its OWN copy of the profile
        service = EcoreCluster(
            lambda i: PoolPolicy(ServingPool(table.copy(), delta=args.delta)),
            backend_factory, pods=args.pods, shard=args.shard,
            max_wait_ms=args.max_wait_ms, device=dev)
        plane = f"{args.pods}-pod cluster ({args.shard})"
    else:
        service = EcoreService(PoolPolicy(pool), backend_factory,
                               max_wait_ms=args.max_wait_ms)
        plane = "service"

    if not args.use_async:
        try:
            if args.adapt:
                # closed loop: route per request — each observation mutates
                # the table the next decision must read
                for req in reqs:
                    service.submit(req)
                    handle(service.results())
            else:
                # static profile: route the whole workload in one tensorized
                # call (per pod, under a cluster)
                service.submit_batch(reqs)
                handle(service.results())
            handle(service.drain())
            stats = service.stats()
        finally:
            service.close()

    if args.profile_out:
        pool.table.to_json(args.profile_out)
        print(f"wrote adapted routing profile to {args.profile_out}")
    print(f"\n{args.requests} requests in {time.time()-t_start:.1f}s via "
          f"{stats['serve_calls']} serve_batch calls over "
          f"{stats['backends']} backends [{plane}] "
          f"(max_batch={args.max_batch}, "
          f"deadline_flushes={stats['deadline_flushes']}); "
          f"profiled totals: {totals['time_ms']:.1f}ms, "
          f"{totals['energy_mwh']:.3f}mWh "
          f"(delta={args.delta}, adapt={args.adapt})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
