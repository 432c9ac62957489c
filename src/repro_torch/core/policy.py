"""Request-centric routing policies: ONE decision/observation plane.

The paper's pipeline (Fig. 3) is estimate -> route -> dispatch -> observe.
This module gives every face of the repo the same typed vocabulary for the
first, second and fourth stages:

  * ``RouteRequest``   — what arrives at the gateway (a camera frame or an
                         LLM prompt, plus whatever complexity signal exists)
  * ``RouteDecision``  — where it goes: the (model, device) pair, the group
                         it was routed under, profiled costs, and the
                         gateway-side estimation cost
  * ``Observation``    — what came back: measured latency/energy/quality and
                         the backend-detected count (OB estimator feedback)

A policy turns requests into decisions (``decide`` / ``decide_batch`` /
``decide_scan``) and folds observations back into its profile
(``observe``).  Two implementations cover both faces:

  * ``DetectionPolicy`` — estimator + router + explore/adapt closed loop
  * ``PoolPolicy``      — ``ServingPool`` over profiled LLM backends

``EcoreService`` (repro_torch.serving.service) dispatches over either.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from .closed_loop import StreamMeasurements, scan_stream
from .energy import gateway_cost
from .estimators import Estimator, OracleEstimator
from .groups import DEFAULT_GROUP_RULES, group_of
from .profiles import ProfileTable
from .router import Router

Pair = Tuple[str, str]


@dataclasses.dataclass
class RouteRequest:
    """One unit of work arriving at the gateway.

    ``payload`` is whatever the backend consumes (a [H, W] frame for the
    detection face, an int32 token prompt for the serving face).
    ``complexity`` is the known complexity signal the router consumes
    directly (the serving face's prompt length); the detection face instead
    ESTIMATES complexity from the payload.  ``true_complexity`` is ground
    truth (oracle routers, per-group quality observation)."""
    uid: int
    payload: Any = None
    complexity: Optional[int] = None
    true_complexity: Optional[int] = None
    max_new_tokens: int = 8


@dataclasses.dataclass
class RouteDecision:
    """Where one request goes, plus the costs known at decision time."""
    uid: int
    pair: Pair                               # (model/arch, device/mesh)
    group: Optional[int] = None              # group/bucket routed under
    est_complexity: Optional[int] = None     # estimator output (detection)
    time_ms: Optional[float] = None          # profiled backend latency
    energy_mwh: Optional[float] = None       # profiled backend energy
    score: Optional[float] = None            # profiled mAP / capability
    gateway_time_ms: float = 0.0             # estimation cost at the gateway
    gateway_energy_mwh: float = 0.0
    explored: bool = False                   # round-robin exploration pick

    @property
    def backend(self) -> str:
        return self.pair[0]

    @property
    def pair_name(self) -> str:
        return f"{self.pair[0]}@{self.pair[1]}"


@dataclasses.dataclass
class Observation:
    """Measured runtime signals for one served request (the single observe
    plane): latency/energy are pair-wide, quality is per-group.  ``group``
    may be omitted when ``true_complexity`` is given — the policy derives
    the group under its own rules.  ``uid`` (optional) names the request
    that produced the measurement — ``EcoreCluster.observe`` uses it to
    fold the observation into the OWNING pod's policy."""
    pair: Pair
    uid: Optional[int] = None
    group: Optional[int] = None
    true_complexity: Optional[int] = None
    time_ms: Optional[float] = None
    energy_mwh: Optional[float] = None
    map_pct: Optional[float] = None
    detected_count: Optional[int] = None     # backend count (OB feedback)

    @property
    def empty(self) -> bool:
        return (self.time_ms is None and self.energy_mwh is None
                and self.map_pct is None and self.detected_count is None)


class DetectionPolicy:
    """Estimator + router + explore/adapt closed loop behind the policy API.

    The per-request estimate->route scalar path (with the round-robin
    exploration override under ``adapt``), the batched estimate->route
    path (one estimator launch + one tensorized routing call for a whole
    stream), the scanned closed loop (``decide_scan``), and the EWMA
    observation plumbing for latency, energy and measured mAP."""

    def __init__(self, router: Router, table: ProfileTable,
                 estimator: Optional[Estimator] = None, *,
                 adapt: bool = False, alpha: float = 0.1,
                 explore_every: int = 0, adapt_map: bool = False,
                 batch_routing: bool = True,
                 quarantine_after: Optional[int] = None):
        self.router = router
        self.table = table
        self.estimator = estimator
        self.adapt = adapt
        self.alpha = alpha
        self.explore_every = explore_every
        self.adapt_map = adapt_map
        self.batch_routing = batch_routing
        #: circuit-breaker threshold for the scanned closed loop: after this
        #: many consecutive failed steps on a (group, pair) cell the scan
        #: quarantines it (None = off); half-open probes ride explore_every
        self.quarantine_after = quarantine_after
        self._step = 0
        if adapt and getattr(router, "table", None) is not table:
            raise ValueError(
                "adapt=True requires router.table to BE the policy's table "
                "(same object): observe_pair updates would otherwise never "
                "reach the router's decisions")
        if adapt_map and not adapt:
            raise ValueError("adapt_map=True requires adapt=True")

    @property
    def batchable(self) -> bool:
        """True when a whole stream can be decided in one shot: open loop
        (per-request observations never change later decisions) and both
        estimator and router expose real batched implementations."""
        return (self.batch_routing and not self.adapt
                and self.estimator is not None and self.estimator.batchable
                and self.router.batchable)

    @property
    def scannable(self) -> bool:
        """True when the CLOSED loop can run as one device-side loop
        (``decide_scan``): adapt on, the router's decision rule is the
        tensorized Algorithm-1 argmin (``batchable`` routers), the counts
        are computable up front (batchable/oracle/no estimator — OB's
        feedback counts depend on each frame's served result), and no
        quality feedback (measured mAP depends on which detector served the
        frame, so ``adapt_map`` is decision-dependent and stays scalar)."""
        return (self.batch_routing and self.adapt and not self.adapt_map
                and self.router.batchable
                and (self.estimator is None or self.estimator.batchable
                     or isinstance(self.estimator, OracleEstimator)))

    def _scan_inputs(self, reqs: Sequence[RouteRequest]):
        """(est_counts, routing_counts, gateway_flops) for ``decide_scan``
        — the estimate stage, hoisted out of the loop: one batched device
        launch (or a ground-truth passthrough) for the whole stream."""
        if self.estimator is None:
            est = None
            flops = np.zeros(len(reqs))
        elif isinstance(self.estimator, OracleEstimator):
            est = np.asarray([int(r.true_complexity) for r in reqs])
            flops = np.zeros(len(reqs))
        else:
            images = np.stack([r.payload for r in reqs])
            est, flops = self.estimator.estimate_batch(images)
        if self.router.uses_ground_truth:
            routing = np.asarray([int(r.true_complexity) for r in reqs])
        elif est is None:
            # no estimator: the scalar route sees estimated_count=None -> 0
            routing = np.zeros(len(reqs), np.int32)
        else:
            routing = np.asarray([int(c or 0) for c in est])
        return est, routing, flops

    def decide_scan(self, reqs: Sequence[RouteRequest],
                    measurements: StreamMeasurements
                    ) -> List[RouteDecision]:
        """The closed-loop fast path: decide AND observe a whole stream in
        one ``scan_stream`` over the profile's ``ProfileState``.

        ``measurements`` carries the decision-independent per-step, per-pair
        runtime signals (``closed_loop.StreamMeasurements``, columns in
        ``table.pairs()`` order); each step's routed column is gathered and
        EWMA-folded before the next step decides — the exact scalar
        ``decide``/``observe`` interleaving, on the device.  The final state is
        folded back into the table (``load_state``), so subsequent scalar
        decisions and ``profile_row`` reads see the adapted values.  The
        round-robin exploration schedule (``explore_every``) is precomputed
        — it depends only on the step counter — and honored inside the scan.
        """
        reqs = list(reqs)
        if not self.scannable:
            raise ValueError("decide_scan requires a scannable policy "
                             "(adapt=True, batchable router/estimator, "
                             "no adapt_map)")
        if not reqs:
            return []
        est, routing, flops = self._scan_inputs(reqs)
        arrays = self.table.as_arrays()
        T, E = len(reqs), self.explore_every
        explore = np.full(T, -1, np.int32)
        if E:
            steps = self._step + np.arange(T)
            fire = steps % E == E - 1
            explore[fire] = (steps[fire] // E) % len(arrays.pairs)
        self._step += T
        state, trace = scan_stream(
            arrays.state, routing, measurements, arrays=arrays,
            delta=self.router.delta, alpha=self.alpha,
            group_rules=self.rules, explore_pairs=explore,
            quarantine_after=self.quarantine_after)
        self.table.load_state(state)
        out = []
        for t, req in enumerate(reqs):
            gc = gateway_cost(float(flops[t]))
            out.append(RouteDecision(
                uid=req.uid, pair=arrays.pairs[trace.pair_idx[t]],
                est_complexity=None if est is None else int(est[t]),
                gateway_time_ms=gc["time_ms"],
                gateway_energy_mwh=gc["energy_mwh"],
                explored=bool(trace.explored[t])))
        return out

    @property
    def rules(self):
        return getattr(self.router, "rules", None) or DEFAULT_GROUP_RULES

    def group_for(self, true_count: int) -> int:
        """The group an observation lands in — derived from the TRUE count
        under the ROUTER's rules (custom labels must hit the right row)."""
        return group_of(int(true_count), self.rules)

    def decide(self, req: RouteRequest) -> RouteDecision:
        step, self._step = self._step, self._step + 1
        if self.estimator is not None:
            if isinstance(self.estimator, OracleEstimator):
                self.estimator.true_count = req.true_complexity
            est_count, est_flops = self.estimator.estimate(req.payload)
            gc = gateway_cost(est_flops)
        else:
            est_count = None
            gc = gateway_cost(0.0)  # routing-table lookup only
        pair = self.router.route(estimated_count=est_count,
                                 true_count=req.true_complexity)
        explored = False
        if (self.adapt and self.explore_every
                and step % self.explore_every == self.explore_every - 1):
            pairs = self.table.pairs()
            pair = pairs[(step // self.explore_every) % len(pairs)]
            explored = True
        return RouteDecision(
            uid=req.uid, pair=pair,
            est_complexity=None if est_count is None else int(est_count),
            gateway_time_ms=gc["time_ms"],
            gateway_energy_mwh=gc["energy_mwh"], explored=explored)

    def decide_batch(self, reqs: Sequence[RouteRequest]
                     ) -> List[RouteDecision]:
        """One estimator launch (``estimate_batch``) + one tensorized call
        (``route_batch``) for the whole batch when ``batchable``; the
        generic fallback loops ``decide`` so non-batchable faces (closed
        loop, feedback estimators, stateful routers) expose the same API."""
        reqs = list(reqs)
        if not reqs:
            return []
        if not self.batchable:
            return [self.decide(r) for r in reqs]
        self._step += len(reqs)
        images = np.stack([r.payload for r in reqs])
        counts, flops = self.estimator.estimate_batch(images)
        pairs = self.router.route_batch(
            estimated_counts=counts,
            true_counts=[r.true_complexity for r in reqs])
        out = []
        for req, count, fl, pair in zip(reqs, counts, flops, pairs):
            gc = gateway_cost(float(fl))
            out.append(RouteDecision(
                uid=req.uid, pair=pair, est_complexity=int(count),
                gateway_time_ms=gc["time_ms"],
                gateway_energy_mwh=gc["energy_mwh"]))
        return out

    def observe(self, obs: Observation) -> None:
        """Fold runtime measurements into the profile: latency/energy are
        group-independent (every row of the pair moves), detection quality
        is per-group; a backend-detected count feeds the estimator (OB).

        Non-finite latency/energy (the fault plane's did-not-answer
        sentinel) is NOT evidence about the pair's cost and is dropped here
        — one inf folded into the EWMA would poison the profile forever;
        failures reroute traffic through the resilience/quarantine planes
        instead."""
        if obs.detected_count is not None and self.estimator is not None:
            self.estimator.observe(int(obs.detected_count))
        t_ms = obs.time_ms if (obs.time_ms is None
                               or np.isfinite(obs.time_ms)) else None
        e_mwh = obs.energy_mwh if (obs.energy_mwh is None
                                   or np.isfinite(obs.energy_mwh)) else None
        if t_ms is not None or e_mwh is not None:
            self.table.observe_pair(obs.pair, time_ms=t_ms,
                                    energy_mwh=e_mwh, alpha=self.alpha)
        if obs.map_pct is not None:
            group = obs.group
            if group is None:
                if obs.true_complexity is None:
                    raise ValueError(
                        "map_pct is per-group: pass group= or "
                        "true_complexity= with the measurement")
                group = self.group_for(obs.true_complexity)
            self.table.observe(obs.pair, group, map_pct=obs.map_pct,
                               alpha=self.alpha)

    def reset(self) -> None:
        self._step = 0
        if self.estimator is not None:
            self.estimator.reset()
        self.router.reset()


class PoolPolicy:
    """The LLM serving face behind the policy API: wraps a ``ServingPool``
    (Algorithm 1 over prompt-length buckets).  ``decide_batch`` is the
    tensorized one-call path; ``observe`` EWMA-folds measured serving
    signals through ``ServingPool.observe``."""

    batchable = True  # decisions depend only on prompt length

    def __init__(self, pool, alpha: float = 0.1):
        self.pool = pool
        self.alpha = alpha

    def _decision(self, req: RouteRequest, d) -> RouteDecision:
        return RouteDecision(uid=req.uid, pair=(d.arch, d.device),
                             group=d.bucket, time_ms=d.time_ms,
                             energy_mwh=d.energy_mwh, score=d.score)

    def decide(self, req: RouteRequest) -> RouteDecision:
        return self._decision(req, self.pool.route(int(req.complexity)))

    def decide_batch(self, reqs: Sequence[RouteRequest]
                     ) -> List[RouteDecision]:
        reqs = list(reqs)
        if not reqs:
            return []
        pool_decisions = self.pool.route_batch(
            [int(r.complexity) for r in reqs])
        return [self._decision(r, d) for r, d in zip(reqs, pool_decisions)]

    def observe(self, obs: Observation) -> None:
        bucket = obs.group
        if bucket is None and obs.true_complexity is not None:
            # lazy: serving.pool imports the core package
            from repro_torch.serving.pool import bucket_of
            bucket = bucket_of(int(obs.true_complexity))
        self.pool.observe(obs.pair[0], time_ms=obs.time_ms,
                          energy_mwh=obs.energy_mwh, map_pct=obs.map_pct,
                          bucket=bucket, alpha=self.alpha)

    def reset(self) -> None:
        pass
