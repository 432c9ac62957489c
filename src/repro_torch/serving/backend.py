"""ExecutionBackend: ONE execution protocol for every workload.

ECORE's premise is a single router in front of *heterogeneous*
(model, device) pairs, so the execution layer must expose exactly one
dispatch surface no matter what the backend computes.  A backend is
anything with:

  * ``name``        — identifies the (model, device/mesh) pair it serves
  * ``max_batch``   — dispatch capacity per ``serve_batch`` call (the
                      ``DispatchQueue`` batches up to this)
  * ``serve_batch`` — consumes the queued form of ``RouteRequest``s
                      (``engine.Request``: uid + payload in ``prompt`` +
                      routed ``group``) and returns one ``engine.Result``
                      per request
  * ``profile_row`` — the offline-profile facts routing consumed to pick
                      this backend (model, device, nominal cost columns)

``EcoreService`` dispatches over any of them through its per-pair
``DispatchQueue``s; a new workload implements this protocol (and registers
a factory) instead of forking another serving loop.  Two faces ship here:

  * the LLM ``engine.Backend`` (prefill + decode over a dense model
    config) — registered as ``"llm"``
  * ``DetectorBackend`` — the detection fleet face: runs a detector over a
    batch of frames on the GPU and charges the profiled edge-device cost
    (optionally through a ``DriftingFleet``, using each request's ``uid``
    as the fleet timestep) — registered as ``"detector"``

``make_backend("faulty:<inner>", ..., faults=[...])`` wraps any of them in
the fault-injection plane's ``FaultyBackend`` (``serving/faults.py``).
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Dict, List, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.serving.engine import Backend, Request, Result


@runtime_checkable
class ExecutionBackend(Protocol):
    """The one execution surface every workload implements."""
    name: str
    #: dispatch capacity: DispatchQueue flushes at this batch size
    max_batch: int

    def serve_batch(self, requests: List[Request]) -> List[Result]: ...

    def profile_row(self) -> Dict[str, object]: ...


#: kind -> factory.  ``make_backend`` validates what the factory builds, so
#: a registered workload cannot silently miss part of the protocol.
_REGISTRY: Dict[str, Callable[..., ExecutionBackend]] = {}


def register_backend(kind: str, factory: Optional[Callable] = None):
    """Register a backend factory under ``kind`` (usable as a decorator)."""
    def _register(f):
        if kind in _REGISTRY and _REGISTRY[kind] is not f:
            raise ValueError(f"backend kind {kind!r} is already registered")
        _REGISTRY[kind] = f
        return f
    return _register(factory) if factory is not None else _register


def backend_kinds() -> List[str]:
    return sorted(_REGISTRY)


def ensure_backend(obj) -> ExecutionBackend:
    """Raise a TypeError naming every missing protocol member."""
    missing = [m for m in ("name", "max_batch", "serve_batch", "profile_row")
               if not hasattr(obj, m)]
    if missing:
        raise TypeError(
            f"{type(obj).__name__} does not implement ExecutionBackend: "
            f"missing {', '.join(missing)}")
    return obj


def make_backend(kind: str, *args, **kwargs) -> ExecutionBackend:
    """Build a registered backend and validate it against the protocol.

    ``"faulty:<inner>"`` builds ``<inner>`` through its registered factory
    and wraps it in ``FaultyBackend``; the ``faults`` kwarg (a sequence of
    ``FaultSpec``) belongs to the wrapper, the rest to the inner factory."""
    if kind.startswith("faulty:"):
        # lazy: faults.py imports this module
        from repro_torch.serving.faults import FaultyBackend
        faults = kwargs.pop("faults", ())
        inner = make_backend(kind[len("faulty:"):], *args, **kwargs)
        return ensure_backend(FaultyBackend(inner, faults))
    try:
        factory = _REGISTRY[kind]
    except KeyError:
        raise KeyError(f"unknown backend kind {kind!r}; registered: "
                       f"{backend_kinds()}") from None
    return ensure_backend(factory(*args, **kwargs))


register_backend("llm", Backend)


def null_run(params, images) -> List[tuple]:
    """Detector stub (real shapes, zero detections) for load benches and
    examples that exercise routing/dispatch dynamics without trained
    detectors — pass as ``DetectorBackend(run_fn=null_run)``."""
    none = np.zeros((0, 4), np.float32)
    return [(none, np.zeros(0, np.float32), np.zeros(0, np.int32))
            for _ in range(len(images))]


class DetectorBackend:
    """One (detector model, edge device) pair behind the execution protocol.

    Adapts the detection fleet (``detection/devices.py``) to
    ``ExecutionBackend`` so the Gateway's per-frame traffic flows through
    ``EcoreService``'s dispatch queues instead of a workload-private loop:
    ``serve_batch`` stacks the queued frames, runs the detector ONCE for the
    whole batch on ``device``, and charges each request the profiled device
    cost — through a ``DriftingFleet`` when one is given, with the request
    ``uid`` as the fleet timestep (the Gateway numbers requests by stream position, so
    fleet costs are identical no matter how dispatch batches or reorders).

    Frames in one dispatch batch need not share a shape: ``serve_batch``
    groups ragged frames into pad-and-mask buckets
    (``kernels.canny_fused.bucket_shape``) and runs the detector once per
    bucket — a uniform batch is a single exact-shape bucket and takes the
    old one-``np.stack``-one-launch path unchanged.  ``edge_stage=True``
    additionally runs the fused Canny gateway stage over the whole dispatch
    batch first (ONE kernel launch per size bucket via
    ``canny_edge_batch``) and records each frame's edge density in
    ``self.edge_density`` keyed by request uid — the EdgeNet-style
    pre-detector complexity signal the router can consult.

    ``run_fn(params, frames)`` defaults to ``detection.train.run_detector``
    on ``device``; tests and benches inject stubs.  ``realtime_scale`` > 0
    makes ``serve_batch`` occupy wall-clock time for the modeled device
    latency (``scale`` seconds per modeled second), so a cluster's pods
    contend and overlap as real edge devices would.  ``table`` (optional)
    is the routing profile this backend was
    picked from: ``profile_row`` then reports the LIVE adapted cost columns
    (what routing actually consults — kept fresh by ``observe``/the scanned
    closed loop's ``ProfileState`` folds) instead of the static device
    model."""

    def __init__(self, model: str, edge_device: str, params=None, *,
                 max_batch: int = 1, fleet=None,
                 run_fn: Optional[Callable] = None,
                 realtime_scale: float = 0.0, table=None,
                 edge_stage: bool = False, device="cuda"):
        from repro_torch.detection.detectors import DETECTOR_CONFIGS
        from repro_torch.detection.devices import DEVICES
        self.name = f"{model}@{edge_device}"
        self.model = model
        #: the modeled edge device this pair charges (``DEVICES`` key)
        self.edge_device = edge_device
        #: where the detector and the Canny stage run
        self.device = resolve_device(device)
        self.params = params
        self.max_batch = max_batch
        self.fleet = fleet
        self.realtime_scale = realtime_scale
        self.table = table
        self.edge_stage = edge_stage
        #: uid -> fraction of edge pixels, filled when edge_stage is on
        self.edge_density: Dict[int, float] = {}
        self._edge = DEVICES[edge_device]
        self._flops = DETECTOR_CONFIGS[model].flops
        if run_fn is None:
            from repro_torch.detection.train import run_detector
            run_fn = functools.partial(run_detector, device=self.device)
        self._run = run_fn

    def cost(self, step: int):
        """(time_ms, energy_mwh) one request pays at fleet timestep ``step``
        (the offline profile when no fleet is attached)."""
        if self.fleet is not None:
            return self.fleet.cost(self.edge_device, self._flops, step)
        return (self._edge.time_ms(self._flops),
                self._edge.energy_mwh(self._flops))

    def _run_buckets(self, frames: List[np.ndarray]) -> List[tuple]:
        """Run the detector over ragged frames: group by pad-and-mask
        bucket shape, ONE ``self._run`` per bucket, results in input
        order.  A uniform batch is a single bucket with zero padding, so
        it degenerates to the old one-stack-one-launch path."""
        if len({f.shape for f in frames}) == 1:
            # uniform batch (any payload rank): the old exact-shape path
            return self._run(self.params, np.stack(frames))
        from repro_torch.kernels.canny_fused import bucket_shape
        buckets: Dict[tuple, List[int]] = {}
        for i, f in enumerate(frames):
            if f.ndim < 2:
                raise ValueError(
                    "ragged serve_batch needs [H, W(, C)] frame payloads; "
                    f"got a {f.ndim}-d payload of shape {f.shape}")
            buckets.setdefault(bucket_shape(*f.shape[:2]) + f.shape[2:],
                               []).append(i)
        out: List[tuple] = [None] * len(frames)  # type: ignore[list-item]
        for shape, idxs in buckets.items():
            batch = np.zeros((len(idxs),) + shape, np.float32)
            for j, i in enumerate(idxs):
                h, w = frames[i].shape[:2]
                batch[j, :h, :w] = frames[i]
            for i, dets in zip(idxs, self._run(self.params, batch)):
                out[i] = dets
        return out

    def serve_batch(self, requests: List[Request]) -> List[Result]:
        if not requests:
            raise ValueError("serve_batch needs at least one request")
        frames = [np.asarray(r.prompt) for r in requests]
        t0 = time.perf_counter()
        if self.edge_stage:
            from repro_torch.kernels.canny_fused import canny_edge_batch
            for r, edge in zip(requests,
                               canny_edge_batch([f if f.ndim == 2 else
                                                 f.mean(axis=-1)
                                                 for f in frames],
                                                device=self.device)):
                # the maps are host-side numpy already: np.mean is an
                # explicit host reduction, not a per-item device sync
                self.edge_density[r.uid] = float(np.mean(edge))
        detections = self._run_buckets(frames)
        wall_s = time.perf_counter() - t0
        results = []
        total_modeled_ms = 0.0
        for r, dets in zip(requests, detections):
            t_ms, e_mwh = self.cost(r.uid)
            total_modeled_ms += t_ms
            results.append(Result(
                uid=r.uid, tokens=np.zeros(0, np.int32),
                prefill_s=wall_s, decode_s=0.0, backend=self.name,
                batch_size=len(requests), detections=dets,
                time_ms=t_ms, energy_mwh=e_mwh))
        if self.realtime_scale > 0.0:
            # an edge device serves its batch sequentially: occupy the wall
            # clock for the modeled busy time (scaled), so pods genuinely
            # contend and overlap in cluster measurements
            time.sleep(total_modeled_ms / 1e3 * self.realtime_scale)
        return results

    def profile_row(self) -> Dict[str, object]:
        # prefer the LIVE adapted row (latency/energy are group-replicated,
        # so any group row of the pair carries the pair-wide EWMA value)
        entry = None if self.table is None else next(
            (e for e in self.table.entries
             if e.pair == (self.model, self.edge_device)), None)
        if entry is not None:
            t_ms, e_mwh = entry.time_ms, entry.energy_mwh
        else:
            t_ms, e_mwh = self.cost(0)
        return {"kind": "detector", "model": self.model,
                "device": self.edge_device, "flops": self._flops,
                "time_ms": t_ms, "energy_mwh": e_mwh,
                "max_batch": self.max_batch}


register_backend("detector", DetectorBackend)
