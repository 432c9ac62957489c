"""Wrapper of the fused Canny kernel (``csrc/canny_fused.cu``).

A CUDA tensor goes to the kernel; a CPU tensor to the plain version in
``ref.py``.  ``launches`` counts the kernel's launches.

``canny_edge_batch`` is the ragged entry point the serving plane uses:
frames of mixed sizes are grouped into pad-and-mask buckets, one launch
per bucket with each frame's true size in ``dims``, instead of one launch
per frame.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build

from . import ref

#: kernel launches since the count was last set to 0
launches = 0

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p, ctypes.c_void_p)


@functools.lru_cache(maxsize=1)
def _gauss_weights() -> Tuple[float, ...]:
    """The blur weights of the plain version, f32 values."""
    return tuple(ref.gauss_kernel().tolist())


def _launch(img: torch.Tensor, dims: Optional[torch.Tensor], lo: float,
            hi: float) -> torch.Tensor:
    if img.dtype != torch.float32 or img.dim() != 3 \
            or not img.is_contiguous():
        raise ValueError("canny kernel takes a contiguous [B, H, W] float32 "
                         f"tensor; got {img.dtype} {tuple(img.shape)}")
    b, h, w = img.shape
    if dims is not None and (dims.dtype != torch.int32
                             or tuple(dims.shape) != (b, 2)
                             or dims.device != img.device
                             or not dims.is_contiguous()):
        raise ValueError("dims must be a contiguous [B, 2] int32 tensor on "
                         "the image's device")
    out = torch.empty(img.shape, dtype=torch.bool, device=img.device)
    if img.numel() == 0:
        return out
    fn = _build.function("canny_fused", "canny_edge", _ARGTYPES)
    k = (ctypes.c_float * 5)(*_gauss_weights())
    with torch.cuda.device(img.device):
        rc = fn(img.data_ptr(), None if dims is None else dims.data_ptr(),
                out.data_ptr(), b, h, w, lo, hi, k,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"canny kernel launch failed: CUDA error {rc}")
    _build.count_launch(__name__)
    return out


def canny_edge(img, lo: float = 0.6, hi: float = 1.0, *,
               device="cuda") -> torch.Tensor:
    """img [B,H,W] -> edge map [B,H,W] bool on ``device``."""
    x = torch.as_tensor(img, dtype=torch.float32,
                        device=resolve_device(device)).contiguous()
    if x.device.type == "cpu":
        return ref.canny_edge(x, lo, hi)
    return _launch(x, None, lo, hi)


def bucket_shape(h: int, w: int) -> Tuple[int, int]:
    """Padded bucket shape for a ragged frame: rounds h up to 64 and w up
    to 128 so nearby frame sizes share one launch."""
    return (-(-h // 64) * 64, -(-w // 128) * 128)


def canny_edge_batch(frames, lo: float = 0.6, hi: float = 1.0, *,
                     device="cuda") -> List[np.ndarray]:
    """Ragged batch entry point: ``frames`` is a sequence of [H,W] arrays
    of possibly different sizes; returns per-frame [H,W] bool edge maps
    (host numpy) in input order.

    On the GPU, frames are grouped by ``bucket_shape``, zero-padded into
    one [Nb,Hb,Wb] tensor per bucket and served by ONE launch per bucket
    with the true sizes in ``dims`` (output beyond a frame is False; the
    host crop drops it).  On the CPU, one plain-version call per
    exact-shape group.
    """
    dev = resolve_device(device)
    frames = [np.asarray(f, np.float32) for f in frames]
    for f in frames:
        if f.ndim != 2 or f.size == 0:
            raise ValueError(f"frames must be non-empty [H, W] arrays; "
                             f"got shape {f.shape}")
    out: List[Optional[np.ndarray]] = [None] * len(frames)
    groups: Dict[Tuple[int, int], List[int]] = {}
    if dev.type == "cpu":
        for i, f in enumerate(frames):
            groups.setdefault(f.shape, []).append(i)
        for idxs in groups.values():
            batch = torch.from_numpy(np.stack([frames[i] for i in idxs]))
            maps = ref.canny_edge(batch, lo, hi).numpy()
            for j, i in enumerate(idxs):
                out[i] = maps[j]
        return out  # type: ignore[return-value]

    for i, f in enumerate(frames):
        groups.setdefault(bucket_shape(*f.shape), []).append(i)
    for (bh, bw), idxs in groups.items():
        batch = np.zeros((len(idxs), bh, bw), np.float32)
        dims = np.empty((len(idxs), 2), np.int32)
        for j, i in enumerate(idxs):
            h, w = frames[i].shape
            batch[j, :h, :w] = frames[i]
            dims[j] = (h, w)
        maps = _launch(torch.from_numpy(batch).to(dev),
                       torch.from_numpy(dims).to(dev), lo, hi).cpu().numpy()
        for j, i in enumerate(idxs):
            h, w = frames[i].shape
            out[i] = maps[j, :h, :w]
    return out  # type: ignore[return-value]
