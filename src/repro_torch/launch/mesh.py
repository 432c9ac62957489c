"""Mesh construction over ``torch.distributed``: the reference's
``launch/mesh.py``.

Single pod = 256 cards (16 x 16, axes data x model); multi-pod = 2 pods
= 512 cards (2 x 16 x 16, axes pod x data x model).  Each function builds
a ``DeviceMesh`` over the current process group, which the caller
initialises (``torch.distributed.init_process_group``: NCCL across
cards, ``gloo`` on the CPU, the ``fake`` backend for one rank's program
of a large mesh); a group whose world size differs from the mesh's
raises, and so does a mesh on ``cuda`` without a GPU.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over ranks
    0 .. prod(shape) - 1 of the current process group, on ``device``'s
    type."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks; the process group has "
                         f"{dist.get_world_size()}")
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(dev.type, torch.arange(n).view(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device="cuda"):
    """The degenerate 1x1 mesh on one device."""
    return make_mesh((1, 1), ("data", "model"), device)


def mesh_name(mesh) -> str:
    """``"16x16"``, ``"2x16x16"``, ``"1x1"``: the dry run's name of it."""
    return "x".join(str(mesh.size(i)) for i in range(mesh.ndim))
