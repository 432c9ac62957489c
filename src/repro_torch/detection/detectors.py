"""The 8-model detector family (YOLO/SSD/EfficientDet capacity analogs).

Single-scale grid detectors: a conv backbone (stride-2 stages) to an 8x8
grid over the 64x64 scene, and a head predicting per cell
[objectness, dx, dy, log w, log h, class logits].  ``Detector`` is the
``nn.Module``; its public input and output stay NHWC, as in
``repro.detection.detectors``, so the two packages compare like with like.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.detection.scenes import IMG, NUM_CLASSES

GRID = 8
CELL = IMG // GRID


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    name: str
    channels: Tuple[int, ...]     # per stage (each stage: conv3x3 s1 + s2)
    head_channels: int

    @property
    def flops(self) -> float:
        """Analytic MACs*2 per image (for the device energy model)."""
        total, res, cin = 0.0, IMG, 1
        for c in self.channels:
            total += 2 * res * res * 9 * cin * c          # 3x3 s1
            total += 2 * (res // 2) ** 2 * 9 * c * c      # 3x3 s2
            res //= 2
            cin = c
        total += 2 * GRID * GRID * 9 * cin * self.head_channels
        total += 2 * GRID * GRID * self.head_channels * (5 + NUM_CLASSES)
        return total


# capacity ladder ~ paper's 8 models (SSDv1 ... YOLOv8m)
DETECTOR_CONFIGS: Dict[str, DetectorConfig] = {
    "ssd_v1":       DetectorConfig("ssd_v1", (4, 8, 8), 16),
    "ssd_lite":     DetectorConfig("ssd_lite", (6, 12, 12), 24),
    "effdet_lite0": DetectorConfig("effdet_lite0", (8, 16, 16), 32),
    "effdet_lite1": DetectorConfig("effdet_lite1", (12, 24, 24), 48),
    "effdet_lite2": DetectorConfig("effdet_lite2", (16, 32, 32), 64),
    "yolov8_n":     DetectorConfig("yolov8_n", (16, 32, 64), 96),
    "yolov8_s":     DetectorConfig("yolov8_s", (24, 48, 96), 128),
    "yolov8_m":     DetectorConfig("yolov8_m", (32, 64, 128), 192),
}

OUT_PER_CELL = 5 + NUM_CLASSES


def _same(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding (before, after): the odd pixel goes after, so a
    stride-2 3x3 conv on an even size pads (0, 1), not (1, 1)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    k, s = conv.kernel_size[0], conv.stride[0]
    top, bottom = _same(x.shape[2], k, s)
    left, right = _same(x.shape[3], k, s)
    return conv(F.pad(x, (left, right, top, bottom)))


class Detector(nn.Module):
    """x [B, IMG, IMG, 1] -> raw head [B, GRID, GRID, 5+C].  Weights are a
    seeded truncated-normal init (std 1/sqrt(fan_in), cut at 2 std) with
    zero biases, as ``init_detector`` of the JAX package draws them."""

    def __init__(self, cfg: DetectorConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.stages = nn.ModuleList()
        cin = 1
        for c in cfg.channels:
            self.stages.append(nn.ModuleList([
                nn.Conv2d(cin, c, 3, stride=1), nn.Conv2d(c, c, 3, stride=2)]))
            cin = c
        self.head1 = nn.Conv2d(cin, cfg.head_channels, 3)
        self.head2 = nn.Conv2d(cfg.head_channels, OUT_PER_CELL, 1)
        with torch.no_grad():
            for conv in self.convs():
                _, i, kh, kw = conv.weight.shape
                nn.init.trunc_normal_(conv.weight, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                conv.weight.mul_(1.0 / math.sqrt(kh * kw * i))
                conv.bias.zero_()

    def convs(self):
        for c1, c2 in self.stages:
            yield c1
            yield c2
        yield self.head1
        yield self.head2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for c1, c2 in self.stages:
            h = F.relu(_conv(h, c1))
            h = F.relu(_conv(h, c2))
        h = F.relu(_conv(h, self.head1))
        return _conv(h, self.head2).permute(0, 2, 3, 1)


def init_detector(cfg: DetectorConfig, seed: int = 0) -> Detector:
    """A detector with weights drawn from ``torch.Generator`` ``seed``."""
    return Detector(cfg, torch.Generator().manual_seed(seed))


def detector_forward(model: Detector, x: torch.Tensor) -> torch.Tensor:
    """x [B, IMG, IMG, 1] -> raw head [B, GRID, GRID, 5+C]."""
    return model(x)


def _jax_slots(np_params: Dict):
    """The pytree's (w, b) key pairs in ``Detector.convs()`` order."""
    slots = [(("convs", i, w), ("convs", i, b))
             for i in range(len(np_params["convs"]))
             for w, b in (("w1", "b1"), ("w2", "b2"))]
    return slots + [(("head", "w1"), ("head", "b1")),
                    (("head", "w2"), ("head", "b2"))]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def params_from_jax(np_params: Dict, name: str = "from_jax") -> Detector:
    """A ``Detector`` holding the JAX package's parameter pytree (as numpy:
    ``{"convs": [{"w1","b1","w2","b2"}, ...], "head": {...}}``), the
    kernels moved from HWIO to OIHW.  Its config is named ``name``; a name
    of ``DETECTOR_CONFIGS`` must fit the weights' widths."""
    cfg = DetectorConfig(
        name, tuple(int(st["w1"].shape[3]) for st in np_params["convs"]),
        int(np_params["head"]["w1"].shape[3]))
    if name in DETECTOR_CONFIGS and DETECTOR_CONFIGS[name] != cfg:
        raise ValueError(f"weights of widths {cfg.channels}, "
                         f"{cfg.head_channels} are not {name}'s")
    model = Detector(cfg)
    with torch.no_grad():
        for conv, (w, b) in zip(model.convs(), _jax_slots(np_params)):
            conv.weight.copy_(torch.tensor(np.asarray(
                _at(np_params, w), np.float32).transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.tensor(np.asarray(_at(np_params, b),
                                                    np.float32)))
    return model


def params_to_jax(model: Detector) -> Dict:
    """The inverse of ``params_from_jax``: the weights as the JAX package's
    pytree of numpy arrays, the kernels moved from OIHW to HWIO."""
    tree = {"convs": [{} for _ in model.cfg.channels], "head": {}}
    for conv, (w, b) in zip(model.convs(), _jax_slots(tree)):
        _at(tree, w[:-1])[w[-1]] = (conv.weight.detach().cpu().numpy()
                                    .transpose(2, 3, 1, 0).copy())
        _at(tree, b[:-1])[b[-1]] = conv.bias.detach().cpu().numpy().copy()
    return tree


# ------------------------------------------------------------- target/loss


def encode_targets(boxes: np.ndarray, classes: np.ndarray):
    """GT -> grid targets: obj [G,G], box [G,G,4] (dx,dy,logw,logh), cls [G,G]."""
    obj = np.zeros((GRID, GRID), np.float32)
    box = np.zeros((GRID, GRID, 4), np.float32)
    cls = np.zeros((GRID, GRID), np.int32)
    for b, c in zip(boxes.reshape(-1, 4), classes.reshape(-1)):
        cx, cy = (b[0] + b[2]) / 2, (b[1] + b[3]) / 2
        gx, gy = min(int(cx // CELL), GRID - 1), min(int(cy // CELL), GRID - 1)
        obj[gy, gx] = 1.0
        box[gy, gx] = [cx / CELL - gx, cy / CELL - gy,
                       math.log(max(b[2] - b[0], 1) / CELL),
                       math.log(max(b[3] - b[1], 1) / CELL)]
        cls[gy, gx] = c
    return obj, box, cls


def detection_loss(model: Detector, batch: Dict) -> torch.Tensor:
    """batch: image [B,H,W,1], obj [B,G,G], box [B,G,G,4], cls [B,G,G] int
    (tensors on the model's device).  The JAX package's formula: balanced
    objectness BCE, box L2 and class CE on the positive cells."""
    raw = model(batch["image"])
    obj_logit, box_pred, cls_logit = raw[..., 0], raw[..., 1:5], raw[..., 5:]
    obj = batch["obj"]
    # torch.maximum splits a tie's gradient as jnp.maximum does
    bce = (torch.maximum(obj_logit, torch.zeros_like(obj_logit))
           - obj_logit * obj
           + torch.log1p(torch.exp(-obj_logit.abs())))
    w = obj * 4.0 + (1 - obj)
    loss_obj = (bce * w).sum() / w.sum()
    pos = obj[..., None]
    loss_box = ((box_pred - batch["box"]).square() * pos).sum() / (
        pos.sum() * 4 + 1e-6)
    logp = torch.log_softmax(cls_logit, dim=-1)
    gold = torch.gather(logp, -1, batch["cls"].long()[..., None])[..., 0]
    loss_cls = -(gold * obj).sum() / (obj.sum() + 1e-6)
    return loss_obj + 2.0 * loss_box + loss_cls


# ------------------------------------------------------------------ decode


def decode_detections(raw: np.ndarray, score_thr: float = 0.5,
                      nms_iou: float = 0.45):
    """raw [G,G,5+C] -> (boxes [N,4], scores [N], classes [N])."""
    from repro_torch.core.metrics import iou as _iou
    raw = np.asarray(raw)
    obj = 1 / (1 + np.exp(-raw[..., 0]))
    boxes, scores, classes = [], [], []
    for gy in range(GRID):
        for gx in range(GRID):
            if obj[gy, gx] < score_thr:
                continue
            dx, dy, lw, lh = raw[gy, gx, 1:5]
            cx, cy = (gx + float(dx)) * CELL, (gy + float(dy)) * CELL
            w = math.exp(min(float(lw), 3.0)) * CELL
            h = math.exp(min(float(lh), 3.0)) * CELL
            boxes.append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
            scores.append(float(obj[gy, gx]))
            classes.append(int(np.argmax(raw[gy, gx, 5:])))
    if not boxes:
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32),
                np.zeros((0,), np.int32))
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    classes = np.asarray(classes, np.int32)
    # simple class-agnostic NMS
    keep = []
    order = np.argsort(-scores)
    for i in order:
        if all(_iou(boxes[i], boxes[j]) < nms_iou for j in keep):
            keep.append(i)
    keep = np.asarray(keep, int)
    return boxes[keep], scores[keep], classes[keep]
