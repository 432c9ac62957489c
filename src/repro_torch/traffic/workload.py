"""Multi-tenant open-loop workloads + the LoadDriver that replays them.

A ``Tenant`` is an arrival stream (from ``traffic.arrivals``) plus a
request factory and an SLO deadline: detector tenants draw object counts
from the drifting scene mix (``detection/scenes.py`` — the sparse
COCO-like distribution flipping to its crowded mirror mid-stream), LLM
tenants draw prompt lengths from the serving pool's distribution.
``merge_tenants`` interleaves any number of them into one time-ordered
stream with globally unique uids.

``LoadDriver`` replays that stream OPEN-LOOP against an ``EcoreService``
or ``EcoreCluster`` on a shared ``ManualClock``: it advances virtual time
to each arrival, submits the request, and fires every ``max_wait_ms``
dispatch deadline at its exact virtual expiry (``service.flush_due``) —
no background flusher thread, no wall-clock sleeps, bit-reproducible.

There is deliberately NO backpressure.  Service capacity is modeled in
virtual time: each (pod, routed pair) is one sequential server — an edge
device serves its batch one frame at a time — so a flushed request starts
when its server frees up (``busy_until``) and occupies it for the modeled
backend latency.  When arrivals outpace capacity, ``busy_until`` runs
ahead of the clock and queue waits grow without bound — which is exactly
the signal the SLO plane and the cluster ``Autoscaler`` exist to see.

A copy of ``repro.traffic.workload`` over the port's scenes and policy
types (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.policy import RouteRequest
from repro_torch.detection import scenes as sc
from repro_torch.traffic.arrivals import ManualClock
from repro_torch.traffic.slo import Completion, WindowedSLO


@dataclasses.dataclass(frozen=True)
class TimedRequest:
    """One arrival: WHEN it lands, WHO sent it, WHAT it asks."""
    t: float
    tenant: str
    request: RouteRequest
    deadline_ms: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Tenant:
    """An arrival stream + request factory + per-tenant deadline.

    ``make_request(uid, i)`` builds the i-th arrival's request with the
    globally-assigned ``uid``; factories index PRE-GENERATED per-tenant
    draws by ``i``, so the stream is independent of merge order."""
    name: str
    arrivals: np.ndarray
    make_request: Callable[[int, int], RouteRequest]
    deadline_ms: Optional[float] = None


def detector_tenant(name: str, arrivals: np.ndarray, *, seed: int = 0,
                    deadline_ms: Optional[float] = None,
                    shift_frac: float = 0.5,
                    scene_images: bool = False,
                    frame_hw: Tuple[int, int] = (8, 8)) -> Tenant:
    """Detection-face tenant seeded from the drift scenario: object counts
    follow the sparse COCO-like mix until ``shift_frac`` of the stream,
    then flip to its crowded mirror (``scenes.drifting_dataset``'s rush
    hour), so the dominant routed group changes mid-episode.

    ``scene_images=True`` renders a real synthetic scene per request
    (needed when the backend actually detects); the default ships a shared
    zero frame of ``frame_hw`` — the routing/dispatch dynamics are
    identical and the stream is cheap enough for big episodes."""
    rng = np.random.default_rng(seed)
    n = len(arrivals)
    shift_at = int(n * shift_frac)
    sparse, crowded = sc.COUNT_PROBS, sc.COUNT_PROBS[::-1]
    counts = np.concatenate([
        rng.choice(len(sparse), p=sparse, size=shift_at),
        rng.choice(len(crowded), p=crowded, size=n - shift_at),
    ]).astype(np.int64)
    if scene_images:
        frames = [sc.make_scene(rng, count=int(c)).image for c in counts]
    else:
        shared = np.zeros(frame_hw, np.float32)
        frames = [shared] * n

    def make_request(uid: int, i: int) -> RouteRequest:
        return RouteRequest(uid=uid, payload=frames[i],
                            true_complexity=int(counts[i]))
    return Tenant(name=name, arrivals=np.asarray(arrivals, np.float64),
                  make_request=make_request, deadline_ms=deadline_ms)


def llm_tenant(name: str, arrivals: np.ndarray, *, seed: int = 0,
               deadline_ms: Optional[float] = None,
               prompt_lens: Sequence[int] = (32, 128, 1024, 4096, 40_000),
               probs: Sequence[float] = (.3, .3, .2, .1, .1),
               prompt_cap: int = 48, max_new_tokens: int = 4) -> Tenant:
    """Serving-face tenant: prompt lengths from the pool drivers'
    long-tailed mix (the router buckets on the full length; the
    materialized prompt is capped like ``launch/serve.py``)."""
    rng = np.random.default_rng(seed)
    n = len(arrivals)
    plens = rng.choice(np.asarray(prompt_lens), p=np.asarray(probs), size=n)
    payloads = [rng.integers(0, 1000, size=min(int(p), prompt_cap))
                for p in plens]

    def make_request(uid: int, i: int) -> RouteRequest:
        return RouteRequest(uid=uid, complexity=int(plens[i]),
                            payload=payloads[i],
                            max_new_tokens=max_new_tokens)
    return Tenant(name=name, arrivals=np.asarray(arrivals, np.float64),
                  make_request=make_request, deadline_ms=deadline_ms)


def merge_tenants(tenants: Sequence[Tenant]) -> List[TimedRequest]:
    """Interleave tenant streams into one time-ordered workload with
    globally unique uids (assigned in arrival order; ties break by tenant
    position then arrival index, so the merge is deterministic)."""
    events = [(float(t), ti, i) for ti, tenant in enumerate(tenants)
              for i, t in enumerate(tenant.arrivals)]
    events.sort()
    out = []
    for uid, (t, ti, i) in enumerate(events):
        tenant = tenants[ti]
        out.append(TimedRequest(t=t, tenant=tenant.name,
                                request=tenant.make_request(uid, i),
                                deadline_ms=tenant.deadline_ms))
    return out


class LoadDriver:
    """Replay a merged workload open-loop against a service/cluster.

    The target must share this driver's ``clock`` and run WITHOUT the
    background flusher (``EcoreService(..., clock=clock, flusher=False)``)
    — the driver fires dispatch deadlines itself at their exact virtual
    expiry, so batch composition is a pure function of the workload.

    Completion accounting rides the futures: every submit's done-callback
    books the request onto its (pod, pair) virtual server — requests in
    one flushed batch start when the server frees and run back-to-back for
    their modeled per-request latency (an edge device serves its batch
    sequentially, exactly the ``DetectorBackend.realtime_scale`` model,
    minus the wall-clock sleep).  ``backlog()`` is the number of requests
    submitted but not yet virtually completed — the queue-depth signal an
    ``Autoscaler`` ticks on.
    """

    def __init__(self, service, clock: ManualClock, *,
                 slo: Optional[WindowedSLO] = None, window_s: float = 1.0,
                 autoscaler=None):
        self.service = service
        self.clock = clock
        self.slo = slo if slo is not None else WindowedSLO(window_s=window_s)
        self.autoscaler = autoscaler
        self.completions: List[Completion] = []
        self._lock = threading.Lock()
        #: (pod, pair) -> virtual time its sequential server frees up
        self._busy: Dict[Tuple[int, Tuple[str, str]], float] = {}
        self._ends: List[float] = []      # heap of virtual completion times
        self._submitted = 0
        self._done_virtual = 0

    # ------------------------------------------------------------- driving

    def run(self, timed: Sequence[TimedRequest]) -> List[Completion]:
        """Replay the whole workload; returns completions sorted by
        virtual completion time.  Anything still batched when the last
        deadline fired is flushed by a final ``drain`` at end time."""
        timed = sorted(timed, key=lambda tr: (tr.t, tr.request.uid))
        for tr in timed:
            self._fire_deadlines(until=tr.t)
            self.clock.advance_to(tr.t)
            self._submit(tr)
            self._tick()
        self._fire_deadlines(until=None)
        self.service.drain()
        with self._lock:
            if self._ends:                 # run the clock out: the episode
                last = max(self._ends)     # ends when the last booked
            else:                          # request virtually completes
                last = self.clock()
        self.clock.advance_to(last)
        self._tick()
        with self._lock:
            self.completions.sort(key=lambda c: (c.t_done, c.uid))
            return list(self.completions)

    def backlog(self) -> int:
        """Requests submitted but not yet virtually complete (queued for
        dispatch, or booked on a server whose work extends past now)."""
        now = self.clock()
        with self._lock:
            while self._ends and self._ends[0] <= now:
                heapq.heappop(self._ends)
                self._done_virtual += 1
            return self._submitted - self._done_virtual

    # ----------------------------------------------------------- internals

    def _tick(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.tick(self.backlog())

    def _fire_deadlines(self, until: Optional[float]) -> None:
        while True:
            nd = self.service.next_deadline()
            if nd is None or (until is not None and nd > until):
                break
            self.clock.advance_to(nd)
            self.service.flush_due(nd)
            self._tick()

    def _submit(self, tr: TimedRequest) -> None:
        self._submitted += 1
        fut = self.service.submit(tr.request)
        fut.add_done_callback(lambda f, tr=tr: self._on_done(tr, f))

    def _modeled(self, served) -> Tuple[float, float]:
        """(service_ms, energy_mwh) for one served request: the backend's
        modeled per-request cost when it reports one (detector results),
        else the profiled cost routing decided on (LLM pool), else the
        measured wall time — first finite value wins."""
        res, dec = served.result, served.decision
        t_ms = res.time_ms
        if t_ms is None or not math.isfinite(t_ms):
            t_ms = dec.time_ms
        if t_ms is None or not math.isfinite(t_ms):
            t_ms = ((res.prefill_s + res.decode_s) * 1e3
                    / max(res.batch_size, 1))
        e_mwh = res.energy_mwh
        if e_mwh is None or not math.isfinite(e_mwh):
            e_mwh = dec.energy_mwh if dec.energy_mwh is not None else 0.0
        return float(t_ms), float(e_mwh) + dec.gateway_energy_mwh

    def _on_done(self, tr: TimedRequest, fut) -> None:
        trigger = self.clock()
        if fut.exception() is not None:
            c = Completion(uid=tr.request.uid, tenant=tr.tenant,
                           t_arrival=tr.t, t_start=trigger, t_done=trigger,
                           service_ms=0.0, energy_mwh=0.0,
                           deadline_ms=tr.deadline_ms, ok=False)
            with self._lock:
                self.completions.append(c)
                self.slo.record(c)
            return
        s = fut.result()
        owner_of = getattr(self.service, "owner_of", None)
        pod = owner_of(tr.request.uid) if owner_of is not None else 0
        pod = 0 if pod is None else pod
        t_ms, e_mwh = self._modeled(s)
        key = (pod, s.decision.pair)
        with self._lock:
            start = max(self._busy.get(key, 0.0), trigger)
            end = start + t_ms / 1e3
            self._busy[key] = end
            heapq.heappush(self._ends, end)
            c = Completion(uid=tr.request.uid, tenant=tr.tenant,
                           t_arrival=tr.t, t_start=start, t_done=end,
                           service_ms=t_ms, energy_mwh=e_mwh,
                           deadline_ms=tr.deadline_ms, ok=True, pod=pod,
                           pair=s.decision.pair)
            self.completions.append(c)
            self.slo.record(c)
