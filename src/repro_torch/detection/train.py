"""Running the detector family: the backends' forward and the SF
estimator's.  The port has no training or offline profiling of
detectors; its detectors carry seeded or JAX-trained weights
(``init_detector``, ``params_from_jax``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.detection.detectors import Detector, decode_detections
from repro_torch.device import resolve_device


def run_detector(model: Detector, images: np.ndarray, *, device="cuda"):
    """images [B,H,W] -> list of (boxes, scores, classes).

    Convolutions run in full float32 (cuDNN's TF32 is off inside), so the
    GPU agrees with the CPU and with the JAX package to f32 rounding."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(images, np.float32), device=dev)[..., None]
    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=False):
        raw = model.to(dev)(x).cpu().numpy()
    return [decode_detections(r) for r in raw]
