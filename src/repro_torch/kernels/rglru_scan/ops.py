"""Wrapper of the RG-LRU scan kernel (``csrc/rglru_scan.cu``) and of its
backward (``rglru_scan_backward`` in the same source).

A CUDA tensor goes to the kernel; a CPU tensor to the plain version in
``ref.py``, which autograd differentiates; a meta tensor takes the card's
path up to the launch (outputs allocated, nothing launched or counted).
``launches`` counts the
forward kernel's launches, ``backward_launches`` the backward's.  The
kernels run the recurrence h_t = a_t h_{t-1} + b_t and its reverse in f32,
one thread per (batch, width) lane, rounding the product and the sum apart
as the plain versions do.  On the card, a call that autograd records goes
through ``_LinearScan``, which keeps h for the backward kernel.  ``rglru``
is the whole RG-LRU layer of the JAX package's ``rglru_pallas``: the gates
in plain PyTorch, the recurrence in the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from . import ref

#: kernel launches since the count was last set to 0
launches = 0
#: backward kernel launches since set to 0
backward_launches = 0

_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 + (
    ctypes.c_void_p,)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 3 + (
    ctypes.c_void_p,)


def _launch(a, b, h0):
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError("the RG-LRU scan takes a and b [B,S,W] of one "
                         f"shape; got {tuple(a.shape)}, {tuple(b.shape)}")
    bsz, s, w = a.shape
    if h0 is not None and tuple(h0.shape) != (bsz, w):
        raise ValueError(f"h0 must be [{bsz}, {w}]; got {tuple(h0.shape)}")
    tensors = (a, b) if h0 is None else (a, b, h0)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("a, b and h0 must be on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("the RG-LRU scan takes f32 a, b and h0; got "
                         f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the RG-LRU scan needs contiguous a, b and h0")
    h = torch.empty_like(a)
    if h.numel() == 0 or a.is_meta:
        return h
    fn = _build.function("rglru_scan", "rglru_scan", _ARGTYPES)
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(),
                None if h0 is None else h0.data_ptr(), h.data_ptr(), bsz, s,
                w, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"RG-LRU scan launch failed: CUDA error {rc}")
    _build.count_launch(__name__)
    return h


def _launch_backward(a, h, dh, h0):
    """(da, db, dh0) of ``_launch(a, b, h0)``, whose output was ``h``, at
    the cotangent ``dh``; dh0 is None without h0."""
    if dh.shape != h.shape or dh.device != h.device:
        raise ValueError(f"RG-LRU backward: the gradient {tuple(dh.shape)} "
                         f"does not match h {tuple(h.shape)}")
    dh = dh.float().contiguous()
    bsz, s, w = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    if a.numel() == 0 or a.is_meta:
        return da, db, None if dh0 is None else dh0.zero_()
    fn = _build.function("rglru_scan", "rglru_scan_backward", _BWD_ARGTYPES)
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), h.data_ptr(), dh.data_ptr(),
                None if h0 is None else h0.data_ptr(), da.data_ptr(),
                db.data_ptr(), None if dh0 is None else dh0.data_ptr(), bsz,
                s, w, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"RG-LRU scan backward launch failed: CUDA error "
                           f"{rc}")
    _build.count_launch(__name__, "backward_launches")
    return da, db, dh0


class _LinearScan(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient.  It
    keeps a, h0 and its own output h."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _launch(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        return _launch_backward(a, h, dh, h0)


def cost(a, b, h0=None):
    """(operations, bytes) of a forward call: a multiply and an add an
    element; a and b read and h written in f32 (and h0 read)."""
    extra = 0 if h0 is None else 4 * h0.numel()
    return 2 * a.numel(), 12 * a.numel() + extra


def backward_cost(a, b, h0=None):
    """(operations, bytes) of its backward: an add and two multiplies an
    element; a, h and dh read and da and db written in f32."""
    return 3 * a.numel(), 20 * a.numel()


@_build.counted(cost, backward_cost)
def linear_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t over axis 1 from h0 (zeros when None).  a,
    b [B,S,W] f32; h0 [B,W] f32 -> h [B,S,W] f32, on a's device: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.
    Differentiable: on the card through the backward kernel, on the CPU
    through the plain version."""
    if a.device.type == "cpu":
        return ref.linear_scan(a, b, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, h0)):
        return _LinearScan.apply(a, b, h0)
    return _launch(a, b, h0)


def rglru(x, w_a, b_a, w_x, b_x, log_lambda, h0=None, *,
          return_final_state: bool = False):
    """x [B,S,W] -> h [B,S,W] in x's dtype (and the final state [B,W] f32
    with ``return_final_state``): ``ref.rglru`` with the recurrence in
    ``linear_scan``."""
    a, b = ref.rglru_gates(x, w_a, b_a, w_x, b_x, log_lambda)
    h = linear_scan(a, b, h0)
    if return_final_state:
        return h.to(x.dtype), h[:, -1].clone()
    return h.to(x.dtype)
