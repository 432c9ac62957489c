"""Canny edge detection + connected-component object counting (ED estimator).

Pipeline (paper §3.3 approach 1): gaussian blur -> Sobel gradients ->
direction-quantized non-maximum suppression -> double-threshold hysteresis
-> connected components of the edge map, filtered by size, as the
object-count estimate.

The edge-map stage is the gateway's per-frame hot path and lives in
``repro_torch.kernels.canny_fused``: one CUDA kernel launch on the GPU
(only the bool edge map is written to device memory), the bit-identical
plain version on the CPU.  This module adds the host-side component
counting on top.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.canny_fused.ops import canny_edge, canny_edge_batch


def _label_count(edge: np.ndarray, min_size: int = 20,
                 dilate: int = 0) -> int:
    """Connected components (8-conn) of the dilated edge map, size-filtered."""
    e = edge.copy()
    for _ in range(dilate):
        p = np.pad(e, 1)
        e = (p[:-2, 1:-1] | p[2:, 1:-1] | p[1:-1, :-2] | p[1:-1, 2:]
             | p[:-2, :-2] | p[:-2, 2:] | p[2:, :-2] | p[2:, 2:] | e)
    h, w = e.shape
    seen = np.zeros_like(e, bool)
    count = 0
    for y in range(h):
        for x in range(w):
            if not e[y, x] or seen[y, x]:
                continue
            # BFS
            stack = [(y, x)]
            seen[y, x] = True
            size = 0
            while stack:
                cy, cx = stack.pop()
                size += 1
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        ny, nx = cy + dy, cx + dx
                        if 0 <= ny < h and 0 <= nx < w and e[ny, nx] \
                                and not seen[ny, nx]:
                            seen[ny, nx] = True
                            stack.append((ny, nx))
            if size >= min_size:
                count += 1
    return count


def canny_count(img: np.ndarray, *, device="cuda") -> int:
    """Estimate the number of objects in one [H, W] image."""
    edge = canny_edge(np.asarray(img)[None], device=device)[0]
    return _label_count(edge.cpu().numpy())


def canny_count_batch(imgs, *, device="cuda") -> np.ndarray:
    """Estimate object counts for a whole batch: edge maps first (as few
    kernel launches as the frame shapes allow), then per-image component
    counting.

    Accepts a uniform [B, H, W] array (ONE launch) or a sequence of [H, W]
    frames of mixed sizes, which goes through the ragged pad-and-mask
    bucket path (one launch per size bucket)."""
    if getattr(imgs, "ndim", None) == 3:
        edges = canny_edge(imgs, device=device).cpu().numpy()
    else:
        edges = canny_edge_batch(imgs, device=device)
    return np.asarray([_label_count(e) for e in edges])
