"""Plain PyTorch Sobel gradient: the stage of Canny edge detection."""
from __future__ import annotations

import math

import torch

#: f32(pi / 4); dividing by a tensor on the input's device keeps the
#: division a true division on the GPU (PyTorch turns a division by a
#: Python scalar into a multiply by its reciprocal there)
QUARTER_PI = math.pi / 4


def pad_edge(x: torch.Tensor, dim: int, r: int) -> torch.Tensor:
    """``x`` padded by ``r`` along ``dim``, replicating the edge values
    (``jnp.pad(mode="edge")``)."""
    n = x.shape[dim]
    idx = torch.arange(-r, n + r, device=x.device).clamp_(0, n - 1)
    return x.index_select(dim, idx)


def sobel_grad(img: torch.Tensor):
    """img [B, H, W] f32 -> (magnitude [B,H,W] f32, direction [B,H,W] i32).

    Direction is the gradient angle quantized to 4 bins (0=E/W, 1=NE/SW,
    2=N/S, 3=NW/SE) for the non-maximum-suppression stage.
    """
    x = pad_edge(pad_edge(img, 1, 1), 2, 1)
    tl = x[:, :-2, :-2]; tc = x[:, :-2, 1:-1]; tr = x[:, :-2, 2:]  # noqa: E702
    ml = x[:, 1:-1, :-2];                       mr = x[:, 1:-1, 2:]  # noqa: E702
    bl = x[:, 2:, :-2];  bc = x[:, 2:, 1:-1];  br = x[:, 2:, 2:]  # noqa: E702
    gx = (tr + 2 * mr + br) - (tl + 2 * ml + bl)
    gy = (bl + 2 * bc + br) - (tl + 2 * tc + tr)
    mag = torch.sqrt(gx * gx + gy * gy)
    quarter = torch.tensor(QUARTER_PI, dtype=torch.float32, device=img.device)
    q = torch.round(torch.atan2(gy, gx) / quarter).to(torch.int32) % 4
    return mag, q
