"""Synthetic scene corpus (the COCO-val / pedestrian-video stand-in).

Images are [H, W] grayscale in [0, 1] with K objects from 3 shape classes
(rectangle, ellipse, triangle), plus background noise and small clutter dots
that are NOT objects (so counting is non-trivial).  Four dataset variants:

  * full            — natural object-count mix (COCO-like distribution)
  * balanced_sorted — 5 groups x n images, ordered by group (paper §4.1)
  * video           — temporally-correlated sequence: counts random-walk and
                      objects move smoothly between frames
  * drifting        — the count mix flips mid-stream

A copy of ``repro.detection.scenes`` (the port imports nothing of
``repro``), drawing from the generator in the same order, so both packages
draw the same scenes from the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

IMG = 64
CLASSES = ("rect", "ellipse", "triangle")
NUM_CLASSES = len(CLASSES)

# COCO-val-like count distribution (paper Fig. 4: long tail, mode at 1-3)
COUNT_PROBS = np.array([0.08, 0.22, 0.20, 0.15, 0.12, 0.09, 0.06, 0.05, 0.03])


@dataclasses.dataclass
class Scene:
    image: np.ndarray          # [IMG, IMG] float32
    boxes: np.ndarray          # [K, 4] x0,y0,x1,y1
    classes: np.ndarray        # [K] int
    count: int


def _draw_object(img, rng, cls: int, x0, y0, w, h, intensity):
    x1, y1 = x0 + w, y0 + h
    yy, xx = np.mgrid[y0:y1, x0:x1]
    if cls == 0:  # rectangle
        img[y0:y1, x0:x1] = intensity
    elif cls == 1:  # ellipse
        cy, cx = (y0 + y1) / 2, (x0 + x1) / 2
        mask = (((yy - cy) / (h / 2)) ** 2 + ((xx - cx) / (w / 2)) ** 2) <= 1
        img[y0:y1, x0:x1][mask] = intensity
    else:  # triangle
        mask = (yy - y0) >= np.abs(xx - (x0 + x1) / 2) * 2 * h / max(w, 1)
        img[y0:y1, x0:x1][mask] = intensity
    return np.array([x0, y0, x1, y1], np.float32)


def make_scene(rng: np.random.Generator, count: Optional[int] = None,
               positions: Optional[List[Tuple]] = None) -> Scene:
    img = rng.normal(0.12, 0.04, (IMG, IMG)).astype(np.float32)
    # clutter: tiny dots that must not be counted as objects
    for _ in range(rng.integers(3, 9)):
        cy, cx = rng.integers(2, IMG - 2, 2)
        img[cy - 1:cy + 1, cx - 1:cx + 1] += rng.uniform(0.15, 0.3)
    if count is None:
        count = int(rng.choice(len(COUNT_PROBS), p=COUNT_PROBS))
    boxes, classes = [], []
    specs = positions if positions is not None else [None] * count
    for k in range(count):
        if specs[k] is None:
            w, h = rng.integers(10, 22, 2)
            x0 = int(rng.integers(1, IMG - w - 1))
            y0 = int(rng.integers(1, IMG - h - 1))
            cls = int(rng.integers(0, NUM_CLASSES))
        else:
            x0, y0, w, h, cls = specs[k]
        inten = float(rng.uniform(0.55, 0.95))
        boxes.append(_draw_object(img, rng, cls, x0, y0, int(w), int(h), inten))
        classes.append(cls)
    img = np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1).astype(np.float32)
    return Scene(image=img,
                 boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                 classes=np.asarray(classes, np.int32).reshape(-1),
                 count=count)


def full_dataset(n: int, seed: int = 0) -> List[Scene]:
    rng = np.random.default_rng(seed)
    return [make_scene(rng) for _ in range(n)]


def balanced_sorted_dataset(per_group: int = 40, seed: int = 1) -> List[Scene]:
    """paper §4.1: equal-size groups 0,1,2,3,4+, ordered by group."""
    rng = np.random.default_rng(seed)
    out = []
    for g in range(5):
        for _ in range(per_group):
            count = g if g < 4 else int(rng.integers(4, 8))
            out.append(make_scene(rng, count=count))
    return out


def drifting_dataset(n: int = 200, seed: int = 4,
                     shift_at: Optional[int] = None) -> List[Scene]:
    """Workload drift: the count distribution flips mid-stream from the
    sparse COCO-like mix to its crowded mirror image (rush hour at the
    pedestrian crossing), so the dominant object-count group changes and
    adaptive routing has something to chase."""
    rng = np.random.default_rng(seed)
    shift_at = n // 2 if shift_at is None else shift_at
    crowded = COUNT_PROBS[::-1]
    out = []
    for i in range(n):
        probs = COUNT_PROBS if i < shift_at else crowded
        out.append(make_scene(rng, count=int(rng.choice(len(probs), p=probs))))
    return out


def video_dataset(n_frames: int = 200, seed: int = 2) -> List[Scene]:
    """Pedestrian-crossing analog: counts random-walk; objects drift."""
    rng = np.random.default_rng(seed)
    count = 2
    objs: List[list] = []  # [x0, y0, w, h, cls, vx, vy]
    out = []
    for _ in range(n_frames):
        # random-walk the target count occasionally
        if rng.random() < 0.15:
            count = int(np.clip(count + rng.choice([-1, 1]), 0, 8))
        while len(objs) < count:
            w, h = rng.integers(10, 22, 2)
            objs.append([int(rng.integers(1, IMG - w - 1)),
                         int(rng.integers(1, IMG - h - 1)),
                         int(w), int(h), int(rng.integers(0, NUM_CLASSES)),
                         float(rng.uniform(-2, 2)), float(rng.uniform(-2, 2))])
        while len(objs) > count:
            objs.pop(rng.integers(0, len(objs)))
        positions = []
        for o in objs:  # drift; int() truncates the clipped float
            o[0] = int(np.clip(o[0] + o[5], 1, IMG - o[2] - 1))
            o[1] = int(np.clip(o[1] + o[6], 1, IMG - o[3] - 1))
            positions.append((o[0], o[1], o[2], o[3], o[4]))
        out.append(make_scene(rng, count=count, positions=positions))
    return out
