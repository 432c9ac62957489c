"""Wrapper of the SSD chunked-scan kernel (``csrc/ssd_scan.cu``) and of
its backward (``csrc/ssd_scan_bwd.cu``).

A CUDA tensor goes to the kernel; a CPU tensor to the plain version in
``ref.py``, which autograd differentiates; a meta tensor takes the card's
path up to the launch (outputs and workspaces allocated, nothing launched
or counted: the dry run measures a step's memory there).  ``launches``
counts the forward's launches: one a call, which in bf16 runs the kernel's three
passes (chunk states, carry, outputs); ``backward_launches`` the
backward's (one a call, which runs its six kernels).  The kernels read
strided views (x, B and C may be column slices of the Mamba-2 block's conv
output, as long as their last dim is contiguous, at any element offset),
work through the caller's chunk with chunk-wide cumulative decays, pad a
ragged S with dt = 0 as the plain version does, and the forward always
writes the final state.  On the card, a call that autograd records (an
input that requires a gradient, with gradients enabled) goes through
``_SSD``, whose backward is the backward kernel.  ``cost`` and
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

#: the largest head dim P and state dim N the kernel takes
MAX_HEADDIM, MAX_STATE = 64, 128

_ARGTYPES = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 6 + (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 15 + (ctypes.c_int,) * 6 + (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)


def _strides(x, dt, B, C):
    """The element strides of x's, dt's (batch, seq, head) dims and B's
    and C's (batch, seq) dims, as the kernels take them."""
    return (ctypes.c_longlong * 10)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2])


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
    if x.is_meta:
        return y, state
    fn = _build.function("ssd_scan", "ssd_scan", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), D.data_ptr(), y.data_ptr(), state.data_ptr(),
                work.data_ptr(), b, s, h, p, n, q, _strides(x, dt, B, C),
                int(bf16), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"SSD scan launch failed: CUDA error {rc}")
    _build.count_launch(__name__)
    return y, state


def _backward_work(b, s, h, p, n, q, bf16):
    """Floats of the backward's workspace, region by region as
    ``csrc/ssd_scan_bwd.cu`` carves it.  f32: the f64 row and column sums
    of T, a_cum, the states and their gradients, <G, S> in 8 parts, four
    per-row sums, dB and dC of each head, dA and dD of each chunk.  bf16
    (``tc::carve``, each of its 17 regions 32-byte aligned): the f64 row
    sums of T per 64-row column tile and column sums, a_cum, the chunks'
    own states and state gradients, both carried in three bf16 parts,
    <G, S> in parts of 1024 elements, four per-row sums, the sum of M^T
    over each group of hg heads per 64-row tile pair, dB and dC of each
    group of hc heads, dA and dD of each chunk.  hg and hc as ``tc::
    shape_of`` picks them: 2 and 8 (4, 2) where the grids of 64-row tiles
    then still fill the card (264 blocks), else 1 and the fewest heads."""
    nc = -(-s // q)
    bh, sp, pn = b * h, nc * q, p * n
    if not bf16:
        return bh * (nc * (2 * pn + 10) + 8 * nc * q) + 2 * h * b * nc * q * n
    tiles = -(-q // 64)
    pairs = tiles * (tiles + 1) // 2
    blocks = tiles * nc * b
    hg = 2 if blocks * -(-h // 2) >= 264 else 1
    hc = next((c for c in (8, 4, 2)
               if c > hg and 2 * blocks * -(-h // c) >= 264), hg)
    return (2 * bh * nc * tiles * q + 2 * bh * sp + bh * sp
            + 2 * bh * nc * pn + 2 * (bh * nc * 3 * pn // 2 + 1)
            + bh * nc * -(-pn // 1024) + 4 * bh * sp
            + b * nc * -(-h // hg) * pairs * 64 * 64
            + 2 * -(-h // hc) * b * sp * n + 2 * bh * nc + 8 * 17)


def _launch_backward(x, dt, A, B, C, D, dy, d_state, q):
    """(dx, ddt, dA, dB, dC, dD) of ``_launch(x, dt, A, B, C, D, q)`` at the
    cotangents ``dy`` of y and ``d_state`` of the final state (None: zero),
    each in its input's dtype (the inputs were checked by the forward)."""
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"SSD backward: the gradient {tuple(dy.shape)} on "
                         f"{dy.device} does not match x {tuple(x.shape)} on "
                         f"{x.device}")
    b, s, h, p = x.shape
    n = B.shape[2]
    dy = dy.to(x.dtype).contiguous()
    if d_state is not None:
        d_state = d_state.float().contiguous()
    dtf = dt.float()
    A32 = A.float().contiguous()
    D32 = D.float().contiguous()
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    dB, dC = (torch.empty((b, s, n), dtype=x.dtype, device=x.device)
              for _ in range(2))
    ddt = torch.empty((b, s, h), dtype=torch.float32, device=x.device)
    dA, dD = (torch.empty(h, dtype=torch.float32, device=x.device)
              for _ in range(2))
    bf16 = x.dtype == torch.bfloat16
    work = torch.empty(_backward_work(b, s, h, p, n, q, bf16),
                       dtype=torch.float32, device=x.device)
    if not x.is_meta:
        fn = _build.function("ssd_scan_bwd", "ssd_scan_bwd", _BWD_ARGTYPES)
        with torch.cuda.device(x.device):
            rc = fn(x.data_ptr(), dtf.data_ptr(), A32.data_ptr(),
                    B.data_ptr(), C.data_ptr(), D32.data_ptr(), dy.data_ptr(),
                    None if d_state is None else d_state.data_ptr(),
                    dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
                    dB.data_ptr(), dC.data_ptr(), dD.data_ptr(),
                    work.data_ptr(), b, s, h, p, n, q,
                    _strides(x, dtf, B, C), int(bf16),
                    torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"SSD scan backward launch failed: CUDA "
                               f"error {rc}")
        _build.count_launch(__name__, "backward_launches")
    return (dx, ddt.to(dt.dtype), dA.to(A.dtype), dB.to(B.dtype),
            dC.to(C.dtype), dD.to(D.dtype))


class _SSD(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient.  It
    keeps the inputs (not the states): the backward recomputes them."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, q):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.q = q
        return _launch(x, dt, A, B, C, D, q)

    @staticmethod
    def backward(ctx, dy, d_state):
        x, dt, A, B, C, D = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return (*_launch_backward(x, dt, A, B, C, D, dy, d_state, ctx.q),
                None)


def _pairs(s, chunk):
    """(causal pairs within the chunks, rows of the first chunk, of the
    last)."""
    q = min(chunk, s)
    rows = [min(q, s - c0) for c0 in range(0, s, q)]
    return sum(r * (r + 1) // 2 for r in rows), rows[0], rows[-1]


def cost(x, dt, A, B, C, D, *, chunk, return_final_state=False):
    """(operations, bytes) of a forward call, from the shapes: per (batch,
    chunk) the C B^T scores on and below the diagonal; per head the decayed
    scores times x dt, the carried state's term after the first chunk, the
    state update over every row.  x, B, C read and y written in x's type,
    dt read and the final state written in f32, A and D read."""
    b, s, h, p = x.shape
    n = B.shape[2]
    tri, first, _ = _pairs(s, chunk)
    return (2 * b * (tri * n + h * tri * p + h * (s - first) * p * n
                     + h * s * p * n),
            x.element_size() * (2 * b * s * h * p + 2 * b * s * n)
            + 4 * b * s * h + 4 * b * h * p * n + 8 * h)


def backward_cost(x, dt, A, B, C, D, *, chunk, return_final_state=False):
    """(operations, bytes) of its backward: per (batch, chunk) C_i . B_j
    over the causal pairs, per head dy_i . xd_j, dC, dB and dxd over them;
    per row and head the chunk's own state and state gradient, the
    entering state's term after the first chunk, the state terms before
    the last chunk (every chunk with the final state's gradient).  x and
    dy read and dx written, B and C read and dB, dC written, in x's type;
    dt read and ddt written, A and D read and dA, dD written in f32 (and
    the final state's gradient read)."""
    b, s, h, p = x.shape
    n = B.shape[2]
    tri, first, last = _pairs(s, chunk)
    earlier = s if return_final_state else s - last
    return (2 * b * (tri * (n + h * (2 * p + 2 * n))
                     + h * p * n * (2 * s + (s - first) + 2 * earlier)),
            x.element_size() * (3 * b * s * h * p + 4 * b * s * n)
            + 4 * 2 * b * s * h + 4 * 4 * h
            + (4 * b * h * p * n if return_final_state else 0))


@_build.counted(cost, backward_cost)
def ssd(x, dt, A, B, C, D, *, chunk: int, return_final_state: bool = False):
    """The SSD scan from a zero state.  x [b,s,h,p]; dt [b,s,h] (softplus
    applied); A, D [h]; B, C [b,s,n] -> y [b,s,h,p] in x's dtype (and the
    final state [b,h,p,n] f32 with ``return_final_state``), on x's device:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    The chunk is ``min(chunk, s)``, as in the plain version.
    Differentiable: on the card through the backward kernel, on the CPU
    through the plain version."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1; got {chunk}")
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk,
                               return_final_state=return_final_state)
    q = min(chunk, x.shape[1])
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C, D)):
        y, state = _SSD.apply(x, dt, A, B, C, D, q)
    else:
        y, state = _launch(x, dt, A, B, C, D, q)
    return (y, state) if return_final_state else y
