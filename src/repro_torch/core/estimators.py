"""Object-count estimators (paper §3.3): ED and the ground-truth oracle.

Each estimator returns (count, gateway_flops) — the FLOPs drive the
gateway-overhead energy/latency accounting the paper reports separately.
The SF and OB estimators of ``repro.core.estimators`` wait for a later
slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.detection.canny import canny_count, canny_count_batch
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


class OracleEstimator(Estimator):
    """Ground-truth count passthrough (for the Orc router wiring)."""
    name = "GT"

    def __init__(self):
        self.true_count: Optional[int] = None

    def estimate(self, image):
        return int(self.true_count), 0.0
