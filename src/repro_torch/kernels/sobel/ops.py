"""Wrapper of the Sobel gradient kernel (``csrc/sobel.cu``).

A CUDA tensor goes to the kernel; a CPU tensor to the plain version in
``ref.py``.  ``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build

from . import ref

#: kernel launches since the count was last set to 0
launches = 0

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def _launch(img: torch.Tensor):
    if img.dtype != torch.float32 or img.dim() != 3 \
            or not img.is_contiguous():
        raise ValueError("sobel kernel takes a contiguous [B, H, W] float32 "
                         f"tensor; got {img.dtype} {tuple(img.shape)}")
    b, h, w = img.shape
    mag = torch.empty_like(img)
    direction = torch.empty(img.shape, dtype=torch.int32, device=img.device)
    if img.numel() == 0:
        return mag, direction
    fn = _build.function("sobel", "sobel_grad", _ARGTYPES)
    with torch.cuda.device(img.device):
        rc = fn(img.data_ptr(), mag.data_ptr(), direction.data_ptr(), b, h, w,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sobel kernel launch failed: CUDA error {rc}")
    _build.count_launch(__name__)
    return mag, direction


def sobel_grad(img, *, device="cuda"):
    """img [B, H, W] -> (mag [B,H,W] f32, dir [B,H,W] int32) on ``device``."""
    x = torch.as_tensor(img, dtype=torch.float32,
                        device=resolve_device(device)).contiguous()
    if x.device.type == "cpu":
        return ref.sobel_grad(x)
    return _launch(x)
