"""The port's collectives over the mesh axes of the sharding context, and
the bytes each rank moves through them: the counterpart of the collective
count of ``repro.launch.hlo_cost``.

Every collective of the model code goes through here.  Each takes a mesh
axis name; over an axis of size 1 (or outside a mesh) it is the identity
and moves nothing, so the 1x1 mesh runs the one-device path's ops.  The
differentiable ones are ``torch.autograd.Function``s whose backward is
their dual:

- ``all_gather(x, axis, dim)``: the shards concatenated along ``dim``;
  backward a reduce-scatter (FSDP's gather of a weight at use);
- ``all_reduce(x, axis)``: the sum over the axis; backward the identity
  (a row-parallel product's partial outputs, whose consumers run alike
  on every rank);
- ``reduce_grad(x, axis)``: the identity; backward the sum of the
  gradients over the axis (a tensor every rank of the axis reads, its
  gradient summed: a column-parallel product's input, a weight replicated
  over the batch axes).

``moved`` holds the bytes by kind, each collective's output bytes times
the reference's weight (``launch/hlo_cost.py``: an all-reduce 2, an
all-gather and a reduce-scatter 1), added under one lock as
``kernels/_build.py::count_launch`` adds launches; ``reset`` sets it to 0.
"""
from __future__ import annotations

import functools
import threading
import warnings
from collections import Counter

import torch
import torch.distributed as dist

from . import ctx

#: the reference's link-traffic weight of each kind
FACTORS = {"all-gather": 1.0, "reduce-scatter": 1.0, "all-reduce": 2.0}
#: weighted bytes this rank moved, by kind, since ``reset``
moved: Counter = Counter()
_lock = threading.Lock()


def reset() -> None:
    with _lock:
        moved.clear()


def by_kind() -> dict:
    with _lock:
        return {k: float(moved[k]) for k in FACTORS if moved[k]}


def _count(kind: str, out: torch.Tensor) -> None:
    with _lock:
        moved[kind] += FACTORS[kind] * out.numel() * out.element_size()


@functools.lru_cache(maxsize=None)
def _quiet() -> None:
    """Torch 2.13 renames ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor`` and warns at each call; 2.11 has only
    them."""
    warnings.filterwarnings("ignore", message=r".*(all_gather_into_"
                            r"tensor|reduce_scatter_tensor).*deprecated")


def group(axis: str):
    """The process group of ``axis`` of the current mesh; None when it has
    one rank (or there is no mesh, or no such axis)."""
    mesh = ctx.current_mesh()
    if mesh is None or axis not in mesh.mesh_dim_names:
        return None
    if mesh.size(mesh.mesh_dim_names.index(axis)) == 1:
        return None
    _quiet()
    return mesh.get_group(axis)


def size(axis: str) -> int:
    g = group(axis)
    return 1 if g is None else g.size()


def _gather(x, g, dim):
    n = g.size()
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((n * x0.shape[0],) + tuple(x0.shape[1:]))
    dist.all_gather_into_tensor(out, x0, group=g)
    _count("all-gather", out)
    return out.movedim(0, dim)


def _scatter(x, g, dim):
    n = g.size()
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((x0.shape[0] // n,) + tuple(x0.shape[1:]))
    dist.reduce_scatter_tensor(out, x0, group=g)
    _count("reduce-scatter", out)
    return out.movedim(0, dim)


def _sum(x, g, op=dist.ReduceOp.SUM):
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op, group=g)
    _count("all-reduce", x)
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, g, dim):
        ctx_.g, ctx_.dim = g, dim
        return _gather(x, g, dim)

    @staticmethod
    def backward(ctx_, grad):
        return _scatter(grad, ctx_.g, ctx_.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, g):
        return _sum(x, g)

    @staticmethod
    def backward(ctx_, grad):
        return grad, None


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, g):
        ctx_.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx_, grad):
        return _sum(grad, ctx_.g), None


def all_gather(x, axis: str, dim: int = 0):
    g = group(axis)
    return x if g is None else _AllGather.apply(x, g, dim)


def all_reduce(x, axis: str):
    g = group(axis)
    return x if g is None else _AllReduce.apply(x, g)


def reduce_grad(x, axis: str):
    g = group(axis)
    if g is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _ReduceGrad.apply(x, g)


def all_reduce_max(x, axis: str):
    """The elementwise max over the axis (no gradient)."""
    g = group(axis)
    return x if g is None else _sum(x.detach(), g, dist.ReduceOp.MAX)


def sum_all(x):
    """``x`` summed over every rank of the mesh in one all-reduce (no
    gradient)."""
    mesh = ctx.current_mesh()
    if mesh is None or mesh.size() == 1:
        return x
    x = x.detach().contiguous().clone()
    dist.all_reduce(x)
    _count("all-reduce", x)
    return x


def sum_over(x, axes):
    """``x`` summed over each of ``axes`` in turn (no gradient)."""
    for a in axes:
        g = group(a)
        if g is not None:
            x = _sum(x.detach(), g)
    return x
