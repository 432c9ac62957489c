"""Object-count estimators (paper §3.3): ED, SF, OB, and the
ground-truth oracle.

Each estimator returns (count, gateway_flops) — the FLOPs drive the
gateway-overhead energy/latency accounting the paper reports separately.
ED and SF run on the estimator's device (CUDA unless the caller asks for
the CPU); OB and the oracle compute nothing.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.detection.canny import canny_count, canny_count_batch
from repro_torch.detection.detectors import DETECTOR_CONFIGS
from repro_torch.detection.train import run_detector
from repro_torch.device import resolve_device


class Estimator:
    name = "base"
    #: True if estimate_batch is a real batched launch with no per-frame
    #: feedback dependency (lets the gateway estimate+route whole batches)
    batchable = False

    def estimate(self, image: np.ndarray) -> Tuple[int, float]:
        raise NotImplementedError

    def estimate_batch(self, images: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """images [B,H,W] -> (counts [B], gateway_flops [B]).  The generic
        fallback loops ``estimate``; batchable estimators override with one
        device launch for the whole batch."""
        pairs = [self.estimate(im) for im in images]
        return (np.asarray([c for c, _ in pairs]),
                np.asarray([f for _, f in pairs], np.float64))

    def observe(self, detected_count: int) -> None:
        """Feedback from the backend's detection result (used by OB)."""

    def observe_batch(self, detected_counts) -> None:
        """Fold a whole stream's backend feedback in completion order.  The
        generic fallback loops ``observe``; estimators whose fold telescopes
        (OB keeps only the LAST count) override with one assignment."""
        for c in detected_counts:
            self.observe(int(c))

    def reset(self) -> None:
        pass


class EdgeDetectionEstimator(Estimator):
    """ED: Canny edges -> connected-component count.  Cheapest, coarse.
    The edge maps are computed on ``device``."""
    name = "ED"
    batchable = True
    # gaussian+sobel+nms+hysteresis: ~60 flops/pixel
    FLOPS_PER_PIXEL = 60.0

    def __init__(self, *, device="cuda"):
        self.device = resolve_device(device)

    def estimate(self, image):
        return (canny_count(image, device=self.device),
                image.size * self.FLOPS_PER_PIXEL)

    def estimate_batch(self, images):
        flops = np.full(len(images), images[0].size * self.FLOPS_PER_PIXEL)
        return canny_count_batch(images, device=self.device), flops


class SSDFrontEndEstimator(Estimator):
    """SF: a lightweight detector AT THE GATEWAY counts the objects it
    finds at ``score_thr``.  More accurate than ED, at a higher gateway
    cost (``DETECTOR_CONFIGS[model].flops`` a frame).  The ``Detector``
    is moved to ``device`` and runs there, one forward per batch."""
    name = "SF"
    batchable = True

    def __init__(self, detector, model: str = "ssd_v1",
                 score_thr: float = 0.5, *, device="cuda"):
        self.device = resolve_device(device)
        self.detector = detector.to(self.device)
        self._flops = DETECTOR_CONFIGS[model].flops
        self._thr = score_thr

    def _detect(self, images):
        return run_detector(self.detector, images, device=self.device)

    def estimate(self, image):
        _, scores, _ = self._detect(np.asarray(image)[None])[0]
        return int(np.count_nonzero(scores >= self._thr)), self._flops

    def estimate_batch(self, images):
        counts = np.asarray([np.count_nonzero(s >= self._thr)
                             for _, s, _ in self._detect(np.asarray(images))])
        return counts, np.full(len(images), self._flops, np.float64)


class OutputBasedEstimator(Estimator):
    """OB: reuse the object count the backend detected for the previous
    frame (temporal continuity); no gateway cost."""
    name = "OB"

    def __init__(self, default: int = 0):
        self._default = default
        self._last: Optional[int] = None

    def estimate(self, image):
        return (self._last if self._last is not None else self._default), 0.0

    def observe(self, detected_count: int) -> None:
        self._last = int(detected_count)

    def observe_batch(self, detected_counts) -> None:
        # the fold telescopes: only the last count survives
        if len(detected_counts):
            self._last = int(detected_counts[-1])

    def reset(self) -> None:
        self._last = None


class OracleEstimator(Estimator):
    """Ground-truth count passthrough (for the Orc router wiring)."""
    name = "GT"

    def __init__(self):
        self.true_count: Optional[int] = None

    def estimate(self, image):
        return int(self.true_count), 0.0
