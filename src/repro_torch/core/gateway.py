"""The ECORE gateway: estimate -> route -> dispatch -> account.

Mirrors Figure 3: cameras send frames to the gateway, which runs a
lightweight estimator, feeds the count to the routing algorithm, forwards
the frame to the selected (model, device) backend, and returns detections.
Energy/latency for backends come from the profiled device models; gateway
overhead (estimator cost) is accounted separately, exactly like the paper's
"Gateway Overhead" metric.

Decision-making lives in ``core.policy.DetectionPolicy`` (estimate+route+
explore/adapt behind the shared ``RoutingPolicy`` API); EXECUTION lives in
``serving.backend.DetectorBackend`` behind the shared ``ExecutionBackend``
protocol.  This class is the thin stream driver over ``EcoreService``: it
submits the stream as ``RouteRequest``s, lets the service's per-pair
``DispatchQueue``s batch the dispatch, accumulates ``EpisodeStats`` from the
``Served`` completions, and feeds measurements back through the single
``Observation`` plane — there is no detection-private serving loop.

The detectors run on the gateway's ``device``; the profile state lives on
the table's, and the ED estimator's edge maps on the estimator's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.closed_loop import measurements_from_fleet
from repro_torch.core.estimators import Estimator
from repro_torch.core.metrics import MAPAccumulator
from repro_torch.core.policy import DetectionPolicy, Observation, RouteRequest
from repro_torch.core.profiles import ProfileTable
from repro_torch.core.router import Router
from repro_torch.detection.scenes import NUM_CLASSES, Scene
from repro_torch.device import resolve_device


@dataclasses.dataclass
class EpisodeStats:
    router: str
    estimator: Optional[str]
    map_pct: float
    backend_energy_mwh: float
    backend_time_ms: float       # sum over requests (piggybacked => total)
    gateway_energy_mwh: float
    gateway_time_ms: float
    pair_histogram: Dict[str, int]

    @property
    def total_energy_mwh(self) -> float:
        return self.backend_energy_mwh + self.gateway_energy_mwh

    @property
    def total_time_ms(self) -> float:
        return self.backend_time_ms + self.gateway_time_ms


class Gateway:
    """Routes a stream of scenes through detector backends via EcoreService.

    Closed loop (BEYOND-PAPER, §6 future work): with ``adapt=True`` every
    request's MEASURED backend latency/energy is EWMA-folded back into the
    profile table (``ProfileTable.observe_pair``), so the router tracks
    runtime drift.  Pass a ``fleet`` (``detection.devices.DriftingFleet``) to
    make the measured costs diverge from the offline profile — without one,
    measurements equal the profile and adaptation is a fixed point.

    Pure exploitation cannot recover from TRANSIENT drift: once a pair's
    observed cost spikes, routing abandons it and its rows are never
    re-measured, so it stays poisoned after the device recovers.
    ``explore_every=N`` serves every Nth request on a round-robin pair
    instead of the router's pick (a small accuracy/energy tax), keeping
    every pair's profile fresh.

    Batched hot path: when the policy is ``batchable`` (ED estimator,
    greedy/oracle router, loop open), ``process_stream`` decides the WHOLE
    stream in one ``EcoreService.submit_batch`` call (one estimator launch +
    one tensorized routing call) and the per-pair dispatch queues batch detector
    execution up to ``max_batch`` frames per launch — decisions and stats
    are identical to the scalar path (tested).  Set ``batch_routing=False``
    to force the scalar path.

    Scanned closed loop: when the policy is ``scannable`` (adapt on, greedy
    routing, batchable/oracle estimator, no ``adapt_map``), the per-frame
    estimate->route->observe dependency chain runs as ONE device-side loop
    over the profile's ``ProfileState``
    (``DetectionPolicy.decide_scan``): the fleet's drifted costs are
    decision-independent, so the gateway precomputes every pair's would-be
    measurement per step and the scan gathers + EWMA-folds the routed
    pair's column between decisions.  Decisions, adapted profile and
    EpisodeStats are identical to the scalar closed loop (tested), and
    dispatch batches detector execution up to ``max_batch`` — the closed
    loop does not force frame-at-a-time serving.  Feedback estimators and
    ``adapt_map`` serve one request at a time, since their inputs depend
    on each frame's served result.

    mAP closed loop: ``adapt_map=True`` (requires ``adapt=True``) folds each
    request's MEASURED per-frame detection quality back into the served
    pair's row for the scene's TRUE group via the observation plane — the
    third profile column (after latency/energy) the runtime keeps fresh."""

    def __init__(self, router: Router, table: ProfileTable,
                 detector_params: Dict[str, "torch.nn.Module"],
                 estimator: Optional[Estimator] = None, *,
                 fleet=None, adapt: bool = False, alpha: float = 0.1,
                 explore_every: int = 0, adapt_map: bool = False,
                 batch_routing: bool = True, max_batch: int = 1,
                 device="cuda"):
        # lazy: the serving plane imports the core
        from repro_torch.serving.backend import DetectorBackend
        from repro_torch.serving.service import EcoreService
        self.device = resolve_device(device)
        self._DetectorBackend = DetectorBackend
        self._EcoreService = EcoreService
        self.policy = DetectionPolicy(router, table, estimator, adapt=adapt,
                                      alpha=alpha, explore_every=explore_every,
                                      adapt_map=adapt_map,
                                      batch_routing=batch_routing)
        self.params = detector_params
        self.fleet = fleet
        #: frames per detector launch on the batched paths (open-loop
        #: decide_batch and the scanned closed loop); 1 = bit-exact with
        #: per-frame execution
        self.max_batch = max_batch

    # single source of truth for routing state is the policy — read-only
    # mirrors here, so a post-construction toggle can't drift the two apart
    @property
    def router(self) -> Router:
        return self.policy.router

    @property
    def table(self) -> ProfileTable:
        return self.policy.table

    @property
    def estimator(self) -> Optional[Estimator]:
        return self.policy.estimator

    @property
    def adapt(self) -> bool:
        return self.policy.adapt

    @property
    def adapt_map(self) -> bool:
        return self.policy.adapt_map

    def process_stream(self, stream: Sequence[Scene]) -> EpisodeStats:
        scenes = list(stream)
        acc = MAPAccumulator(NUM_CLASSES)
        totals = {"be_e": 0.0, "be_t": 0.0, "gw_e": 0.0, "gw_t": 0.0}
        hist: Dict[str, int] = {}
        self.policy.reset()
        # request uid = stream position: DetectorBackend uses it as the
        # fleet timestep, so drifted costs are identical however dispatch
        # batches the frames
        reqs = [RouteRequest(uid=i, payload=s.image, true_complexity=s.count)
                for i, s in enumerate(scenes)]
        batchable = self.policy.batchable
        scannable = not batchable and self.policy.scannable
        # the remaining scalar closed loops (estimator feedback, adapt_map)
        # serve frame-at-a-time: each observation mutates the table the
        # next decision must read
        max_batch = self.max_batch if (batchable or scannable) else 1

        def factory(decision):
            model, device = decision.pair
            return self._DetectorBackend(model, device, self.params[model],
                                         max_batch=max_batch,
                                         fleet=self.fleet, table=self.table,
                                         device=self.device)

        # does the estimator CONSUME backend feedback?  The scannable
        # estimators (ED/oracle/None) all inherit the no-op observe, so
        # the scanned path skips computing per-frame detected counts
        wants_feedback = (self.estimator is not None
                          and type(self.estimator).observe
                          is not Estimator.observe)

        def handle(service, served_batch, folded=False):
            # uid order = stream order: accumulation is identical to the
            # longhand per-frame loop however the dispatch queues batched
            detected = []
            for served in sorted(served_batch, key=lambda s: s.request.uid):
                d, res = served.decision, served.result
                scene = scenes[served.request.uid]
                totals["gw_e"] += d.gateway_energy_mwh
                totals["gw_t"] += d.gateway_time_ms
                hist[d.pair_name] = hist.get(d.pair_name, 0) + 1
                boxes, scores, classes = res.detections
                acc.add_image(boxes, scores, classes, scene.boxes,
                              scene.classes)
                totals["be_e"] += res.energy_mwh
                totals["be_t"] += res.time_ms
                if folded:
                    # the scan already EWMA-folded every cost observation;
                    # backend-detected counts only matter to an estimator
                    # that actually consumes feedback
                    if wants_feedback:
                        detected.append(int(np.count_nonzero(scores >= 0.5)))
                    continue
                obs = Observation(pair=d.pair, uid=served.request.uid)
                if self.adapt:
                    if self.adapt_map:
                        one = MAPAccumulator(NUM_CLASSES)
                        one.add_image(boxes, scores, classes, scene.boxes,
                                      scene.classes)
                        obs.map_pct = one.map()
                    obs.group = self.policy.group_for(scene.count)
                    obs.time_ms, obs.energy_mwh = res.time_ms, res.energy_mwh
                if self.estimator is not None:
                    # estimator feedback: the count the BACKEND detected
                    obs.detected_count = int(np.count_nonzero(scores >= 0.5))
                if not obs.empty:
                    service.observe(obs)
            if folded and detected and self.estimator is not None:
                self.estimator.observe_batch(detected)

        service = self._EcoreService(self.policy, factory)
        try:
            if batchable and reqs:
                # one decide_batch for the whole stream, batched dispatch;
                # open loop, so deferring the (estimator-feedback-only)
                # observations to completion order is semantics-preserving
                service.submit_batch(reqs)
                handle(service, service.results() + service.drain())
            elif scannable and reqs:
                # closed loop as ONE device-side scan: decisions and EWMA
                # folds happen inside decide_scan, so dispatch receives
                # pre-routed requests and batches execution freely; the
                # fleet's per-step costs are decision-independent, which is
                # what lets them be precomputed
                measurements = measurements_from_fleet(
                    self.table.as_arrays().pairs, len(reqs), self.fleet)
                decisions = self.policy.decide_scan(reqs, measurements)
                service.submit_batch(reqs, decisions=decisions)
                handle(service, service.results() + service.drain(),
                       folded=True)
            else:
                for req in reqs:
                    # max_batch=1: the request is served inline, so the
                    # observation lands before the next decision
                    service.submit(req)
                    handle(service, service.results())
                handle(service, service.drain())
        finally:
            service.close()
        return EpisodeStats(
            router=self.router.name,
            estimator=self.estimator.name if self.estimator else None,
            map_pct=acc.map(),
            backend_energy_mwh=totals["be_e"],
            backend_time_ms=totals["be_t"],
            gateway_energy_mwh=totals["gw_e"],
            gateway_time_ms=totals["gw_t"],
            pair_histogram=hist,
        )
