"""Wrapper of the SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

A CUDA tensor goes to the kernel; a CPU tensor to the plain version in
``ref.py``.  ``launches`` counts the wrapper's launches: one a call, which
in bf16 runs the kernel's three passes (chunk states, carry, outputs).
The kernel reads strided views (x, B and C may be column slices of the
Mamba-2 block's conv output, as long as their last dim is contiguous, at
any element offset), works through the caller's chunk with chunk-wide
cumulative decays, pads a ragged S with dt = 0 as the plain version does,
and always writes the final state.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from . import ref

#: kernel launches since the count was last set to 0
launches = 0

#: the largest head dim P and state dim N the kernel takes
MAX_HEADDIM, MAX_STATE = 64, 128

_ARGTYPES = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 6 + (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)


def _launch(x, dt, A, B, C, D, q):
    if len({t.device for t in (x, dt, A, B, C, D)}) != 1:
        raise ValueError("x, dt, A, B, C and D must be on one device")
    if x.dtype not in (torch.float32, torch.bfloat16) or not (
            x.dtype == B.dtype == C.dtype):
        raise ValueError("the SSD kernel takes f32 or bf16 x, B, C of one "
                         f"dtype; got {x.dtype}, {B.dtype}, {C.dtype}")
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 3 or B.shape != C.shape:
        raise ValueError("the SSD kernel takes x [b,s,h,p], dt [b,s,h] and "
                         f"B, C [b,s,n]; got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, s, h, p = x.shape
    n = B.shape[2]
    if (tuple(dt.shape) != (b, s, h) or tuple(B.shape[:2]) != (b, s)
            or tuple(A.shape) != (h,) or tuple(D.shape) != (h,)):
        raise ValueError(f"the SSD kernel: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, B {tuple(B.shape)}, A "
                         f"{tuple(A.shape)} and D {tuple(D.shape)} disagree")
    if not (1 <= p <= MAX_HEADDIM and 1 <= n <= MAX_STATE and s >= 1):
        raise ValueError(f"the SSD kernel takes 1 <= p <= {MAX_HEADDIM}, "
                         f"1 <= n <= {MAX_STATE} and s >= 1; got p={p}, "
                         f"n={n}, s={s}")
    if any(t.stride(-1) != 1 for t in (x, B, C)):
        raise ValueError("the SSD kernel needs x, B and C with a contiguous "
                         "last dim")
    dt = dt.float()
    A = A.float().contiguous()
    D = D.float().contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    # bf16 runs three kernels that pass a_cum and the chunk states through
    # this f32 workspace; the f32 kernel needs none
    bf16 = x.dtype == torch.bfloat16
    work = torch.empty(b * h * -(-s // q) * (q + 3 * p * n) + 24 if bf16
                       else 0, dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 10)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2])
    fn = _build.function("ssd_scan", "ssd_scan", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), D.data_ptr(), y.data_ptr(), state.data_ptr(),
                work.data_ptr(), b, s, h, p, n, q, strides, int(bf16),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"SSD scan launch failed: CUDA error {rc}")
    _build.count_launch(__name__)
    return y, state


def ssd(x, dt, A, B, C, D, *, chunk: int, return_final_state: bool = False):
    """The SSD scan from a zero state.  x [b,s,h,p]; dt [b,s,h] (softplus
    applied); A, D [h]; B, C [b,s,n] -> y [b,s,h,p] in x's dtype (and the
    final state [b,h,p,n] f32 with ``return_final_state``), on x's device:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    The chunk is ``min(chunk, s)``, as in the plain version.  The kernel
    has no backward: on the card, a call that autograd would record
    raises."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1; got {chunk}")
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk,
                               return_final_state=return_final_state)
    _build.refuse_gradient("SSD scan", x, dt, A, B, C, D)
    y, state = _launch(x, dt, A, B, C, D, min(chunk, x.shape[1]))
    return (y, state) if return_final_state else y
