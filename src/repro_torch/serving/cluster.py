"""EcoreCluster: N EcoreService pods behind ONE request plane.

Scaling ECORE out means standing up many (policy + dispatch queues +
backends) pods and sharding the request stream across them, the serving
analog of the paper's multi-gateway deployment.  The cluster owns:

  * shard selection: ``select_pods`` assigns a whole batch in a few
    PyTorch operations on the cluster's device (one host read per batch),
    with an exact-parity scalar reference (``select_pods_reference``) used
    on the per-request path and in tests.  Two policies:

      - ``least_loaded``: the sequential greedy argmin over live depths
        (each assignment sees the depths the previous ones produced), in
        closed form: pod ``p`` offers slots at levels ``depth[p] + j``, and
        the i-th pick is the pod of the i-th smallest (level, pod) pair, so
        one sort over batch x live pods gives every pick;
      - ``rendezvous``: highest-random-weight hashing of (uid, pod) via a
        splitmix-style 32-bit avalanche, stable request->pod affinity that
        survives pod count changes with minimal reshuffling.

  * observe() fan-in: an ``Observation`` carrying the request ``uid`` is
    folded into the OWNING pod's policy; without a uid it is a pair-wide
    signal and broadcasts to every pod.

  * per-pod ``stats()`` aggregation and concurrent ``drain``/``close``.

Pods are fully independent (own policy, own queues, own backends, own
lock), so ``submit_batch`` fans each pod's shard out on a small thread
pool.  Pods on one GPU issue to the same stream: their device work
serializes and they overlap only in host work.

The same planes as ``repro.serving.cluster``; the shard picks equal its
bit for bit.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.policy import (Observation, RouteDecision,
                                     RouteRequest)
from repro_torch.device import resolve_device
from repro_torch.serving.faults import _mix32
from repro_torch.serving.service import EcoreService, Served

SHARD_MODES = ("least_loaded", "rendezvous")

#: bound on the uid -> owning-pod map (a long-lived cluster must not grow
#: per-request state; observations normally arrive right after completion)
OWNER_LIMIT = 8192


# ------------------------------------------------------- shard selection

#: a dead pod's masked queue depth in the scalar reference: larger than
#: any real depth, far from int32 overflow after a whole batch of +1s
_DEAD_DEPTH = 2 ** 30

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x * m`` modulo 2^32 for int64 tensors holding uint32 values,
    in 16-bit halves so no product leaves int64."""
    lo = (x & 0xFFFF) * m
    hi = (((x >> 16) * m) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32_i64(x: torch.Tensor) -> torch.Tensor:
    """``faults._mix32`` on int64 tensors holding uint32 values (torch has
    no uint32 arithmetic to speak of); every value stays in [0, 2^32), so
    each right shift is a logical one."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _masked_scores(scores: np.ndarray, alive: np.ndarray) -> np.ndarray:
    """Rendezvous scores (uint32) with dead pods forced to lose: live
    scores map monotonically into [2^31, 2^32) (>> 1 then set the top
    bit), dead pods score 0.  ``select_pods`` does the same on int64."""
    live = (scores >> np.uint32(1)) | np.uint32(0x80000000)
    return np.where(alive, live, np.uint32(0))


def select_pods(uids: Sequence[int], depths: Sequence[int],
                mode: str = "least_loaded",
                alive: Optional[Sequence[bool]] = None, *,
                device="cuda") -> np.ndarray:
    """Assign a batch of request uids to pods on ``device``; returns the
    picks as numpy int64 (one host read).

    ``depths`` is the live per-pod queue depth (least-loaded consumes it;
    rendezvous ignores it).  ``alive`` (optional bool mask) excludes dead
    pods.  Equals ``select_pods_reference`` exactly."""
    if mode not in SHARD_MODES:
        raise ValueError(f"unknown shard mode {mode!r}; one of {SHARD_MODES}")
    dev = resolve_device(device)
    u = np.asarray(uids, np.uint32).astype(np.int64)
    n_pods = len(depths)
    if u.size == 0:
        return np.zeros(0, np.int64)
    live = torch.from_numpy(np.ones(n_pods, bool) if alive is None
                            else np.asarray(alive, bool)).to(dev)
    if mode == "rendezvous":
        pods = _mix32_i64(torch.arange(n_pods, dtype=torch.int64,
                                       device=dev))
        scores = _mix32_i64(torch.from_numpy(u).to(dev)[:, None]
                            ^ pods[None, :])
        if alive is not None:   # _masked_scores on the uint32 values
            scores = torch.where(live[None, :], (scores >> 1) | 0x80000000,
                                 0)
        # the first maximum, as np.argmax and jnp.argmax take it
        return torch.argmax(scores, dim=1).cpu().numpy()
    if alive is not None and not np.any(alive):
        # every pod masked: all levels tie at the dead depth, and the
        # reference's argmin takes the first pod each time
        return np.zeros(len(u), np.int64)
    # least loaded: every live pod's slots at levels depth + j; the batch
    # takes the len(uids) smallest (level, pod) pairs in order
    b = len(u)
    depth = torch.from_numpy(np.asarray(depths, np.int64)).to(dev)
    levels = depth[:, None] + torch.arange(b, dtype=torch.int64,
                                           device=dev)[None, :]
    pod = torch.arange(n_pods, dtype=torch.int64, device=dev)[:, None]
    keys = torch.where(live[:, None], levels * n_pods + pod,
                       torch.iinfo(torch.int64).max)
    first = torch.topk(keys.flatten(), b, largest=False, sorted=True).values
    return (first % n_pods).cpu().numpy()


def select_pods_reference(uids: Sequence[int], depths: Sequence[int],
                          mode: str = "least_loaded",
                          alive: Optional[Sequence[bool]] = None
                          ) -> np.ndarray:
    """Scalar reference: one request at a time, plain numpy.  ``select_pods``
    must match this exactly (masked or not)."""
    if mode not in SHARD_MODES:
        raise ValueError(f"unknown shard mode {mode!r}; one of {SHARD_MODES}")
    uids = list(uids)   # materialize ONCE: a generator must not be exhausted
    depths = np.asarray(depths, np.int32).copy()
    pod_ids = np.arange(len(depths), dtype=np.uint32)
    alive_mask = None if alive is None else np.asarray(alive, bool)
    picks = np.zeros(len(uids), np.int64)
    for i, uid in enumerate(uids):
        if mode == "least_loaded":
            visible = (depths if alive_mask is None
                       else np.where(alive_mask, depths,
                                     np.int32(_DEAD_DEPTH)))
            p = int(np.argmin(visible))
            depths[p] += 1
        else:
            u = np.asarray([uid], np.uint32)  # arrays: silent uint32 wrap
            scores = _mix32(u ^ _mix32(pod_ids))
            if alive_mask is not None:
                scores = _masked_scores(scores, alive_mask)
            p = int(np.argmax(scores))
        picks[i] = p
    return picks


# --------------------------------------------------------------- cluster

class NoLivePods(RuntimeError):
    """Every pod has been marked failed: the cluster cannot place work."""


class EcoreCluster:
    """Shard one request stream over N independent ``EcoreService`` pods.

    ``policy_factory(pod_index)`` builds each pod's OWN policy (adaptive
    state must not be shared: observations fold into the owning pod);
    ``backend_factory`` is per-decision, as in ``EcoreService``.  Requests
    need cluster-unique uids (the owner map and each pod's inflight check
    key on them).  ``device`` is where ``submit_batch``'s shard selection
    runs.

    ``pod_fail_after`` (optional) arms graceful degradation: after that
    many CONSECUTIVE failed completions a pod is marked dead
    (``mark_pod_failed``), masked out of shard selection, and every
    request that failed on it is RESUBMITTED to a surviving pod (the
    cluster then owns the returned future and resolves it from whichever
    pod finally answers; the owner map follows the move, so uid-keyed
    observations fold into the pod that actually served).  Off (None),
    pod futures are returned directly and errors propagate untouched."""

    def __init__(self, policy_factory: Callable[[int], object],
                 backend_factory: Callable[[RouteDecision], object], *,
                 pods: int = 2, shard: str = "least_loaded",
                 max_wait_ms: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 retain_results: bool = True,
                 pod_fail_after: Optional[int] = None,
                 max_pods: Optional[int] = None,
                 flusher: bool = True, device="cuda"):
        if pods < 1:
            raise ValueError(f"pods={pods}: need at least one pod")
        if shard not in SHARD_MODES:
            raise ValueError(
                f"unknown shard mode {shard!r}; one of {SHARD_MODES}")
        self.max_pods = pods if max_pods is None else max_pods
        if self.max_pods < pods:
            raise ValueError(
                f"max_pods={max_pods} below initial pods={pods}")
        self.shard = shard
        self.device = resolve_device(device)
        # kept so add_pod() can stand up new pods with identical wiring
        self._policy_factory = policy_factory
        self._backend_factory = backend_factory
        self._max_wait_ms = max_wait_ms
        self._clock = clock
        self._retain = retain_results
        self._pod_flusher = flusher
        self.pods: List[EcoreService] = [
            self._make_pod(i) for i in range(pods)]
        self._lock = threading.Condition()
        #: live queue depth per pod (in-flight requests; shard input)
        self._depth = np.zeros(pods, np.int64)
        #: total requests ever assigned per pod (stats)
        self.shard_counts = np.zeros(pods, np.int64)
        self._owner: Dict[int, int] = {}
        self._owner_order: collections.deque = collections.deque()
        #: uid-keyed observations dropped because the owner was unknown
        self.stale_observations = 0
        self.pod_fail_after = pod_fail_after
        self._alive = np.ones(pods, bool)
        self._consec_errors = np.zeros(pods, np.int64)
        self.resubmitted = 0          # requests moved off a failed pod
        self._moving = 0              # resubmissions not yet re-enqueued
        #: pods drained by the autoscaler (alive=False but healthy: the
        #: first to revive on scale-up, unlike FAILED pods which stay dead)
        self._retired: set = set()
        # sized for the elastic ceiling: ThreadPoolExecutor cannot grow
        self._exec = ThreadPoolExecutor(max_workers=self.max_pods,
                                        thread_name_prefix="ecore-pod")
        self._closed = False

    def _make_pod(self, index: int) -> EcoreService:
        return EcoreService(self._policy_factory(index),
                            self._backend_factory,
                            max_wait_ms=self._max_wait_ms,
                            clock=self._clock,
                            retain_results=self._retain,
                            flusher=self._pod_flusher)

    # ------------------------------------------------------------ submit

    def _assign(self, uids: Sequence[int], batched: bool) -> np.ndarray:
        with self._lock:
            if not self._alive.any():
                raise NoLivePods(
                    f"all {len(self.pods)} pods are marked failed")
            # the mask only enters selection once a pod is down
            alive = None if self._alive.all() else self._alive
            if batched:
                picks = select_pods(uids, self._depth, self.shard,
                                    alive=alive, device=self.device)
            else:
                picks = select_pods_reference(uids, self._depth, self.shard,
                                              alive=alive)
            np.add.at(self._depth, picks, 1)
            np.add.at(self.shard_counts, picks, 1)
            for uid, p in zip(uids, picks):
                if uid not in self._owner:
                    self._owner_order.append(uid)
                self._owner[uid] = int(p)
            while len(self._owner_order) > OWNER_LIMIT:
                self._owner.pop(self._owner_order.popleft(), None)
        return picks

    def _release(self, pod: int, n: int = 1) -> None:
        with self._lock:
            self._depth[pod] -= n

    def _watch(self, fut: "Future[Served]", pod: int) -> "Future[Served]":
        fut.add_done_callback(lambda _f: self._release(pod))
        return fut

    # ------------------------------------------------------- degradation

    def mark_pod_failed(self, pod: int) -> None:
        """Mask ``pod`` out of shard selection (manual override or called
        by the consecutive-error detector).  Its queued work is not
        recalled wholesale (each failed completion resubmits itself), but
        nothing NEW lands on it."""
        with self._lock:
            self._alive[pod] = False
            self._lock.notify_all()

    def _record_outcome(self, pod: int, failed: bool) -> None:
        """Consecutive-failure pod detector (degradation armed only)."""
        with self._lock:
            if failed:
                self._consec_errors[pod] += 1
                if (self.pod_fail_after is not None and self._alive[pod]
                        and self._consec_errors[pod] >= self.pod_fail_after):
                    self._alive[pod] = False
            else:
                self._consec_errors[pod] = 0
            self._lock.notify_all()

    def _guard(self, fut: "Future[Served]", pod: int, req: RouteRequest,
               outer: "Future[Served]", hops: int) -> None:
        """Bridge a pod future to the cluster-owned ``outer`` future,
        recording outcomes and resubmitting failures to survivors.  The
        pod resolves its futures while holding its OWN condition, so the
        resubmission (which must take another pod's condition) hops
        through the executor: pod-to-pod lock cycles are impossible."""
        def _done(f: "Future[Served]") -> None:
            self._release(pod)
            exc = f.exception()
            if exc is None:
                self._record_outcome(pod, failed=False)
                outer.set_result(f.result())
                return
            self._recover(pod, req, outer, exc, hops)
        fut.add_done_callback(_done)

    def _recover(self, pod: int, req: RouteRequest, outer: "Future[Served]",
                 exc: BaseException, hops: int) -> None:
        """One failed attempt on ``pod``: feed the detector, then either
        move the request to a survivor (pod is dead, hop budget left) or
        surface the error on the outer future."""
        self._record_outcome(pod, failed=True)
        with self._lock:
            can_move = (not self._alive[pod] and not self._closed
                        and hops + 1 < len(self.pods)
                        and self._alive.any())
            if can_move:
                self.resubmitted += 1
                self._moving += 1
        if can_move:
            self._exec.submit(self._resubmit, req, outer, hops + 1)
        else:
            outer.set_exception(exc)

    def _submit_guarded(self, pod: int, shard_reqs: List[RouteRequest],
                        outers: List["Future[Served]"]) -> None:
        """Armed-mode shard submission: one ``pod.submit`` per request, so
        an inline-flush backend error surfaces HERE for exactly the
        request that triggered it (co-batched failures come back through
        the futures ``_guard`` already watches)."""
        for req, outer in zip(shard_reqs, outers):
            self._enter(pod, req, outer, hops=0)

    def _enter(self, pod: int, req: RouteRequest, outer: "Future[Served]",
               hops: int) -> None:
        """Submit ``req`` to ``pod`` under the guard; a raising submit is
        un-counted and recovered like a failed completion."""
        try:
            fut = self.pods[pod].submit(req)
        except Exception as exc:
            self._release(pod)
            self._recover(pod, req, outer, exc, hops)
        else:
            self._guard(fut, pod, req, outer, hops)

    def _resubmit(self, req: RouteRequest, outer: "Future[Served]",
                  hops: int) -> None:
        """Re-place one request that failed on a dead pod (executor
        thread: holds no lock while entering the survivor pod)."""
        try:
            try:
                pod = int(self._assign([req.uid], batched=False)[0])
            except Exception as exc:
                outer.set_exception(exc)
                return
            try:
                fut = self.pods[pod].submit(req)
            except Exception as exc:
                self._release(pod)
                outer.set_exception(exc)
                return
            self._guard(fut, pod, req, outer, hops)
        finally:
            with self._lock:
                self._moving -= 1
                self._lock.notify_all()

    def submit(self, req: RouteRequest) -> "Future[Served]":
        """Shard one request (scalar reference path) and submit it to its
        pod.  If the pod's submit raises (inline-flush backend error,
        routing error), the request is un-counted from the depth
        accounting before the error propagates."""
        pod = int(self._assign([req.uid], batched=False)[0])
        if self.pod_fail_after is None:
            try:
                fut = self.pods[pod].submit(req)
            except Exception:
                self._release(pod)
                raise
            return self._watch(fut, pod)
        outer: "Future[Served]" = Future()
        self._enter(pod, req, outer, hops=0)
        return outer

    def submit_batch(self, reqs: Sequence[RouteRequest]
                     ) -> List["Future[Served]"]:
        """One shard-selection call for the whole batch, then each pod's
        shard is submitted CONCURRENTLY (thread pool).  Futures return in
        request order.

        If a pod's inline flush raises, the error re-raises here AFTER
        every healthy pod's futures have their depth watchers attached and
        the failing pod's shard is released from the depth accounting."""
        reqs = list(reqs)
        if not reqs:
            return []
        picks = self._assign([r.uid for r in reqs], batched=True)
        shards: Dict[int, List[int]] = {}
        for i, p in enumerate(picks):
            shards.setdefault(int(p), []).append(i)
        if self.pod_fail_after is not None:
            # degradation armed: per-request pod submission (still batched
            # at the dispatch queues) so inline backend errors recover
            # per request instead of losing a whole shard's futures
            outers: List["Future[Served]"] = [Future() for _ in reqs]
            tasks = [self._exec.submit(self._submit_guarded, pod,
                                       [reqs[i] for i in idxs],
                                       [outers[i] for i in idxs])
                     for pod, idxs in shards.items()]
            for t in tasks:
                t.result()
            return outers
        pending = {
            pod: self._exec.submit(self.pods[pod].submit_batch,
                                   [reqs[i] for i in idxs])
            for pod, idxs in shards.items()}
        out: List[Optional[Future]] = [None] * len(reqs)
        first_exc = None
        for pod, idxs in shards.items():
            try:
                futs = pending[pod].result()
            except Exception as exc:
                first_exc = first_exc or exc
                # nothing watchable came back: un-count the whole shard
                # (requests already enqueued resolve at drain unwatched)
                self._release(pod, len(idxs))
                continue
            for i, fut in zip(idxs, futs):
                out[i] = self._watch(fut, pod)
        if first_exc is not None:
            raise first_exc
        return out  # type: ignore[return-value]

    # -------------------------------------------------------- elasticity

    def can_add_pod(self) -> bool:
        """True when scale-up is possible: a retired pod can revive, or the
        fleet is still below ``max_pods``."""
        with self._lock:
            return bool(self._retired) or len(self.pods) < self.max_pods

    def add_pod(self) -> int:
        """Grow the fleet by one pod and return its index.  A RETIRED pod
        revives in place (lowest index first, so grow/shrink cycles reuse
        warm pods and their adapted policies); otherwise a fresh pod is
        appended, up to ``max_pods``."""
        with self._lock:
            if self._closed:
                raise RuntimeError("cluster is closed")
            if self._retired:
                pod = min(self._retired)
                self._retired.discard(pod)
                self._alive[pod] = True
                self._consec_errors[pod] = 0
                self._lock.notify_all()
                return pod
            pod = len(self.pods)
            if pod >= self.max_pods:
                raise RuntimeError(
                    f"cluster is at max_pods={self.max_pods}")
            self.pods.append(self._make_pod(pod))
            self._depth = np.append(self._depth, 0)
            self.shard_counts = np.append(self.shard_counts, 0)
            self._alive = np.append(self._alive, True)
            self._consec_errors = np.append(self._consec_errors, 0)
            self._lock.notify_all()
            return pod

    def retire_pod(self, pod: Optional[int] = None) -> int:
        """Shrink the fleet by one pod: mask it out of shard selection,
        remember it as retired (revivable), then DRAIN it so every queued
        request completes.  Default victim is the highest-index live pod;
        the last live pod is never retired."""
        with self._lock:
            live = [i for i, a in enumerate(self._alive) if a]
            if pod is None:
                if not live:
                    raise NoLivePods("no live pod to retire")
                pod = live[-1]
            if not (0 <= pod < len(self.pods)) or not self._alive[pod]:
                raise ValueError(f"pod {pod} is not live")
            if len(live) <= 1:
                raise ValueError("refusing to retire the last live pod")
            self._alive[pod] = False
            self._retired.add(pod)
            self._lock.notify_all()
        # outside the cluster lock: drain takes the pod's own condition and
        # resolves futures (whose callbacks may re-enter cluster state)
        self.pods[pod].drain()
        return pod

    def live_pods(self) -> List[int]:
        with self._lock:
            return [i for i, a in enumerate(self._alive) if a]

    def queue_depths(self) -> List[int]:
        """Live in-flight depth per pod (the shard-selection input)."""
        with self._lock:
            return self._depth.tolist()

    def owner_of(self, uid: int) -> Optional[int]:
        """Pod that owns ``uid``'s decision (None if unknown/evicted)."""
        with self._lock:
            return self._owner.get(uid)

    def next_deadline(self) -> Optional[float]:
        """Earliest ``max_wait_ms`` expiry across every pod's queues (the
        virtual-time driver's next flush event), or None."""
        deadlines = [d for p in list(self.pods)
                     if (d := p.next_deadline()) is not None]
        return min(deadlines) if deadlines else None

    def flush_due(self, now: Optional[float] = None) -> int:
        """Synchronously flush every pod queue whose deadline expired."""
        return sum(p.flush_due(now) for p in list(self.pods))

    # ----------------------------------------------------------- observe

    def observe(self, obs: Observation) -> None:
        """Fold a measurement into the OWNING pod's policy (by ``obs.uid``);
        an observation without a uid is pair-wide evidence and broadcasts
        to every pod.  A uid-keyed observation whose owner is UNKNOWN is
        DROPPED and counted in ``stats()["stale_observations"]``."""
        if obs.uid is not None:
            with self._lock:
                pod = self._owner.get(obs.uid)
                if pod is None:
                    self.stale_observations += 1
                    return
            self.pods[pod].observe(obs)
        else:
            for p in self.pods:
                p.observe(obs)

    # ----------------------------------------------------------- results

    def results(self) -> List[Served]:
        out: List[Served] = []
        for p in self.pods:
            out += p.results()
        return out

    def drain(self) -> List[Served]:
        """Drain every pod CONCURRENTLY; completions are merged.  The first
        pod error re-raises after all pods finished draining.  Under
        degradation a drained failure may RESUBMIT to a survivor, so the
        drain loops until no resubmission is still moving between pods."""
        out: List[Served] = []
        first_exc = None
        while True:
            futs = [self._exec.submit(p.drain) for p in self.pods]
            for f in futs:
                try:
                    out += f.result()
                except Exception as exc:
                    first_exc = first_exc or exc
            with self._lock:
                while self._moving:
                    self._lock.wait(timeout=1.0)
            if not any(p.pending_requests for p in self.pods):
                break
        if first_exc is not None:
            raise first_exc
        return out

    def close(self) -> None:
        if self._closed:
            return
        first_exc = None
        for f in [self._exec.submit(p.close) for p in self.pods]:
            try:
                f.result()
            except Exception as exc:
                first_exc = first_exc or exc
        self._closed = True
        self._exec.shutdown(wait=True)
        if first_exc is not None:
            raise first_exc

    def __enter__(self) -> "EcoreCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def wake(self) -> None:
        for p in self.pods:
            p.wake()

    # ------------------------------------------------------------- stats

    def stats(self) -> Dict:
        per_pod = [p.stats() for p in self.pods]
        with self._lock:
            alive = self._alive.tolist()
            resubmitted = self.resubmitted
            retired = sorted(self._retired)
        return {
            "pods": len(self.pods),
            "max_pods": self.max_pods,
            "retired": retired,
            "shard_mode": self.shard,
            "shard_counts": self.shard_counts.tolist(),
            "backends": sum(s["backends"] for s in per_pod),
            "serve_calls": sum(s["serve_calls"] for s in per_pod),
            "served": sum(s["served"] for s in per_pod),
            "deadline_flushes": sum(s["deadline_flushes"] for s in per_pod),
            "stale_observations": self.stale_observations,
            "alive": alive,
            "availability": sum(alive) / len(alive),
            "resubmitted": resubmitted,
            "per_pod": per_pod,
        }


# ------------------------------------------------------------ autoscaler

class Autoscaler:
    """Queue-depth-driven fleet elasticity with hysteresis, entirely on the
    injectable clock: no background thread, no wall-clock sleeps.

    The owner of time (``repro_torch.traffic.LoadDriver``, or any event
    loop) calls ``tick(backlog)`` whenever the backlog signal changes.
    Backlog is normalized per LIVE pod and compared against two
    watermarks:

      * backlog/pod >= ``high_backlog_per_pod``  -> ``add_pod`` (revive a
        retired pod, else append, up to ``max_pods``);
      * backlog/pod <= ``low_backlog_per_pod``   -> ``retire_pod`` (drain
        the highest-index live pod, down to ``min_pods``).

    The gap between the watermarks plus ``cooldown_s`` between actions is
    the hysteresis.  Every action is appended to ``events`` (virtual
    timestamp, action, pod, backlog, resulting live count)."""

    def __init__(self, cluster: EcoreCluster,
                 clock: Callable[[], float] = time.monotonic, *,
                 min_pods: int = 1, max_pods: Optional[int] = None,
                 high_backlog_per_pod: float = 8.0,
                 low_backlog_per_pod: float = 1.0,
                 cooldown_s: float = 2.0):
        if min_pods < 1:
            raise ValueError(f"min_pods={min_pods}: need >= 1")
        self.max_pods = (cluster.max_pods if max_pods is None
                         else min(max_pods, cluster.max_pods))
        if self.max_pods < min_pods:
            raise ValueError(
                f"max_pods={self.max_pods} below min_pods={min_pods}")
        if low_backlog_per_pod >= high_backlog_per_pod:
            raise ValueError(
                f"watermarks must leave a hysteresis band: "
                f"low={low_backlog_per_pod} >= high={high_backlog_per_pod}")
        self.cluster = cluster
        self.clock = clock
        self.min_pods = min_pods
        self.high = high_backlog_per_pod
        self.low = low_backlog_per_pod
        self.cooldown_s = cooldown_s
        self._last_action_t = -float("inf")
        self.events: List[Dict] = []

    def tick(self, backlog: int) -> Optional[str]:
        """Evaluate the watermarks against ``backlog``; returns "add",
        "retire", or None (in cooldown / inside the hysteresis band)."""
        now = self.clock()
        if now - self._last_action_t < self.cooldown_s:
            return None
        n = len(self.cluster.live_pods())
        per_pod = backlog / max(n, 1)
        if (per_pod >= self.high and n < self.max_pods
                and self.cluster.can_add_pod()):
            pod = self.cluster.add_pod()
            action = "add"
        elif per_pod <= self.low and n > self.min_pods:
            pod = self.cluster.retire_pod()
            action = "retire"
        else:
            return None
        self._last_action_t = now
        self.events.append({
            "t_s": now, "action": action, "pod": pod, "backlog": backlog,
            "live_pods": len(self.cluster.live_pods()),
        })
        return action
