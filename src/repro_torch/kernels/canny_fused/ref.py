"""Plain PyTorch Canny edge stage: the definition the CUDA kernel matches.

``canny_edge`` is gaussian blur -> Sobel gradients -> direction-quantized
non-maximum suppression -> double threshold -> fixed-iteration
hysteresis, stage for stage and in the same arithmetic order as
``repro.kernels.canny_fused.ref``, so the edge maps are bit-identical to
the JAX oracle's on the CPU and to the kernel's on the GPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.sobel import ref as sobel_ref
from repro_torch.kernels.sobel.ref import pad_edge

HYSTERESIS_ITERS = 8


def gauss_kernel(sigma: float = 1.0, radius: int = 2) -> torch.Tensor:
    """The blur weights, f32 on the CPU."""
    xs = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (xs / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Separable 5-tap gaussian, batch [B,H,W] (horizontal then vertical),
    the input replicated at the frame edge; taps summed in order."""
    r = 2
    k = gauss_kernel(sigma, r).tolist()
    h, w = img.shape[1], img.shape[2]
    pad = pad_edge(img, 2, r)
    acc = pad[:, :, 0:w] * k[0]
    for i in range(1, 2 * r + 1):
        acc = acc + pad[:, :, i:i + w] * k[i]
    padv = pad_edge(acc, 1, r)
    out = padv[:, 0:h, :] * k[0]
    for i in range(1, 2 * r + 1):
        out = out + padv[:, i:i + h, :] * k[i]
    return out


def nms(mag: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Thin edges: keep pixels that are maxima along their quantized
    gradient direction (zero-padded neighbours at the frame border)."""
    h, w = mag.shape[1], mag.shape[2]
    p = F.pad(mag, (1, 1, 1, 1))
    c = p[:, 1:h + 1, 1:w + 1]
    neigh = [
        (p[:, 1:h + 1, 2:], p[:, 1:h + 1, :w]),        # 0: E/W
        (p[:, 2:, 2:], p[:, :h, :w]),                  # 1: SE/NW
        (p[:, 2:, 1:w + 1], p[:, :h, 1:w + 1]),        # 2: S/N
        (p[:, 2:, :w], p[:, :h, 2:]),                  # 3: SW/NE
    ]
    keep = torch.zeros_like(c, dtype=torch.bool)
    for d, (a, b2) in enumerate(neigh):
        keep = keep | ((q == d) & (c >= a) & (c >= b2))
    return mag * keep


def hysteresis(thin: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Double threshold, then grow strong edges into weak ones for a fixed
    number of 3x3 dilation rounds (zero-padded at the frame border)."""
    strong = thin > hi
    weak = thin > lo
    for _ in range(HYSTERESIS_ITERS):
        dil = F.max_pool2d(strong[:, None].to(torch.float32), 3, 1, 1)[:, 0]
        strong = (dil > 0) & weak
    return strong


def canny_edge(img: torch.Tensor, lo: float = 0.6,
               hi: float = 1.0) -> torch.Tensor:
    """img [B,H,W] f32 -> edge map [B,H,W] bool."""
    sm = gaussian_blur(img)
    mag, q = sobel_ref.sobel_grad(sm)
    thin = nms(mag, q)
    return hysteresis(thin, lo, hi)
