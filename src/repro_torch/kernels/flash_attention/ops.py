"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``) and
of its backward (``csrc/flash_attention_bwd.cu``).

A CUDA tensor goes to the kernel; a CPU tensor to the plain version in
``ref.py``, which autograd differentiates.  ``launches`` counts the
forward kernel's launches, ``backward_launches`` the backward's (one a
call, which runs its two kernels: dQ with the row statistics, then dK and
dV).  The kernels read strided views (each of q, k, v may be a transpose
or a slice of a larger cache, as long as the last dim is contiguous), and
each output keeps its input's strides, so the model passes [B, S, H, D]
activations without copies.  A meta tensor takes the card's path up to
the launch: the outputs and workspaces are allocated, nothing is
launched or counted (the dry run measures a step's memory there).  On the card, a call that autograd records
(an input that requires a gradient, with gradients enabled) goes through
``_Attention``, whose backward is the backward kernel.  ``cost`` and
``backward_cost`` are what a step cost counter adds for a call
(``_build.counted``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from . import ref

#: kernel launches since the count was last set to 0
launches = 0
#: backward kernel launches (one a backward call) since set to 0
backward_launches = 0

#: head dims the kernel is compiled for
HEAD_DIMS = (32, 64, 128, 256)

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, ctypes.c_void_p)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 6 + (
    ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def rows_aligned(x: torch.Tensor) -> bool:
    """True if ``x``'s last dim is contiguous and every row starts on a
    16-byte boundary (the kernels load rows in 16-byte pieces)."""
    size = x.element_size()
    return x.stride(-1) == 1 and not x.data_ptr() % 16 and not any(
        st * size % 16 for st in x.stride()[:-1])


def check_rows(name: str, x: torch.Tensor) -> None:
    """Raise unless ``x``'s last dim is contiguous and every row starts on
    a 16-byte boundary (the kernels load rows in 16-byte pieces)."""
    if not rows_aligned(x):
        raise ValueError(f"{name} needs a contiguous last dim and 16-byte "
                         f"aligned rows; got strides {x.stride()}")


def attended_pairs(b, h, s, t, causal=True, window=None) -> int:
    """The (query row, key column) pairs a call attends: row i sees the
    columns j <= i (by index) within the window when causal, else all T."""
    if not causal:
        return b * h * s * t
    w = min(window or s, s, t)
    return b * h * (w * (w + 1) // 2 + (s - w) * w)


def cost(q, k, v, *, causal=True, window=None, softcap=None):
    """(operations, bytes) of a forward call, from the shapes: 4 a (row,
    column, d) over the attended pairs; q, k, v read and the output
    written once."""
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    return (4 * d * attended_pairs(b, h, s, t, causal, window),
            q.element_size() * (2 * b * h * s * d + 2 * b * kv * t * d))


def backward_cost(q, k, v, *, causal=True, window=None, softcap=None):
    """(operations, bytes) of its backward: 2.5 times the forward's
    operations; q, k, v and dO read and dq, dk, dv written."""
    ops, nbytes = cost(q, k, v, causal=causal, window=window)
    return 2.5 * ops, 2 * nbytes


def _launch(q, k, v, causal, window, softcap):
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError("flash attention takes f32 or bf16 q, k, v of one "
                         f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash attention takes q [B,H,S,D] and k, v "
                         f"[B,KV,T,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kv or d not in HEAD_DIMS:
        raise ValueError(f"flash attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree, H is not a multiple "
                         f"of KV, or D is not one of {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_rows(name, x)
    o = torch.empty_like(q)
    if o.numel() == 0 or q.is_meta:
        return o
    strides = (ctypes.c_longlong * 12)(
        *(x.stride(i) for x in (q, k, v, o) for i in range(3)))
    fn = _build.function("flash_attention", "flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
                kv, s, t, d, strides, d ** -0.5, int(causal),
                window if window is not None else 0,
                softcap if softcap is not None else 0.0,
                int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention launch failed: CUDA error {rc}")
    _build.count_launch(__name__)
    return o


def _launch_backward(q, k, v, do, causal, window, softcap):
    """dq, dk, dv of ``_launch(q, k, v, ...)`` at the cotangent ``do``, in
    the inputs' dtype and strides (q, k and v were checked by the
    forward)."""
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"flash attention backward: the gradient "
                         f"{tuple(do.shape)} {do.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if not rows_aligned(do):
        do = do.contiguous()
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    # each row's max, its sum of exponentials and Delta, from the dQ
    # kernel for the dK/dV kernel; a head's rows padded to a multiple of
    # 64, which the bf16 kernels copy a 64-row tile at a time
    stats = torch.empty(3 * b * h * (-(-s // 64) * 64), dtype=torch.float32,
                        device=q.device)
    if q.is_meta:
        return dq, dk, dv
    strides = (ctypes.c_longlong * 21)(
        *(x.stride(i) for x in (q, k, v, do, dq, dk, dv) for i in range(3)))
    fn = _build.function("flash_attention_bwd", "flash_attention_bwd",
                         _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                stats.data_ptr(), b, h, kv, s, t, d, strides, d ** -0.5,
                int(causal), window if window is not None else 0,
                softcap if softcap is not None else 0.0,
                int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention backward launch failed: CUDA "
                           f"error {rc}")
    _build.count_launch(__name__, "backward_launches")
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient.  It
    keeps q, k and v (not the output): the backward recomputes the row
    statistics."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.options = (causal, window, softcap)
        return _launch(q, k, v, causal, window, softcap)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*_launch_backward(q, k, v, do, *ctx.options), None, None,
                None)


class _GradsInLayout(torch.autograd.Function):
    """Identity on q, k and v of the CPU path when autograd records it:
    its backward hands each gradient on in its input's strides, as the
    backward kernel writes them (``torch.empty_like``), so that the ops
    autograd runs after it are the same on either device."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.save_for_backward(*xs)
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return tuple(None if g is None else torch.empty_like(x).copy_(g)
                     for x, g in zip(ctx.saved_tensors, grads))


@_build.counted(cost, backward_cost)
def attention(q, k, v, *, causal=True, window=None, softcap=None):
    """Attention at scale D ** -0.5.  q [B,H,S,D]; k, v [B,KV,T,D] ->
    [B,H,S,D] in q's dtype, on q's device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  ``causal``: query row i
    sees the key columns j <= i (by index, also when S != T); else every
    column.  ``window``: only the columns j > i - window.  Differentiable:
    on the card through the backward kernel, on the CPU through the plain
    version."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None; got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0 or None; got {softcap}")
    recorded = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if q.device.type == "cpu":
        # in the kernel's layout: the output keeps q's strides, and the
        # gradients those of q, k and v, so what follows runs the same ops
        # on either device
        if recorded:
            q, k, v = _GradsInLayout.apply(q, k, v)
        return torch.empty_like(q).copy_(ref.mha_reference(
            q, k, v, causal=causal, window=window, softcap=softcap))
    if recorded:
        return _Attention.apply(q, k, v, causal, window, softcap)
    return _launch(q, k, v, causal, window, softcap)
