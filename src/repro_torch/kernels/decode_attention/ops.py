"""Wrapper of the flash-decode kernel (``csrc/decode_attention.cu``).

A CUDA tensor goes to the kernel; a CPU tensor to the plain version in
``ref.py``.  ``launches`` counts the kernel's launches.  k and v may be
strided views of a cache (last dim contiguous); the model passes the
cache's first ``pos + 1`` rows, so that T is the longest length.  The
wrapper cuts those T rows into as many splits as fit in one wave of
blocks, at the blocks per SM that the kernel's shared memory and registers
allow at this (D, G) and dtype (the CUDA occupancy query).

A decode step calls this once per attention layer with the same shapes
and strides and a T one longer than the step before, so everything but T
and the pointers is worked out once per (device, dtype, shapes, strides,
window, softcap) and kept in a launch plan: the checks that depend only on
those, the ctypes function, the blocks per SM and the SM count, the splits
of each T, and a C struct (``_Static``) with the shapes, strides, scale,
window, softcap, stream and the splits' workspace (allocated once per plan
and stream: the kernel leaves its tickets at zero).  A call then checks
what the plan cannot fix (devices, lengths, pointer alignment) and makes
one ctypes call of nine arguments.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import check_rows

from . import ref

#: kernel launches since the count was last set to 0
launches = 0

#: cache rows per tile of the f32 kernel, and the rows its splits come in
BLOCK_K = 64
#: the rows the bf16 kernel's splits come in, by head dim: half a block
#: tile (4 warps of 16 rows) at D <= 128, two tiles (2 warps of 16 rows)
#: at D = 256, where a split's partials (G * D floats) cost the merge more
BLOCK_K_BF16 = {32: 32, 64: 32, 128: 32, 256: 64}
#: the (head dim, GQA group H / KV) pairs the kernel is compiled for: those
#: of the repository's configs, full size and reduced
PAIRS = ((32, 1), (32, 2), (32, 4), (64, 1), (64, 2), (128, 1), (128, 4),
         (128, 7), (128, 8), (256, 2), (256, 10))
#: blocks per SM the splits may fill: None asks the kernel (its occupancy
#: at the launch's (D, G) and dtype); 0 keeps the cache in one piece per
#: (batch, KV head)
BLOCKS_PER_SM = None

#: launch plans by (device, dtypes, shapes but T, strides, window, softcap)
_PLANS = {}

#: q, k, v, lengths, o, t, nsplit, chunk, the plan's _Static and the
#: statistics (null when not asked for)
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3
             + (ctypes.c_void_p,) * 2)


class _Static(ctypes.Structure):
    """The C side's ``DecodePlan`` (csrc/decode_attention.cu), field for
    field."""

    _fields_ = [("b", ctypes.c_int), ("h", ctypes.c_int),
                ("kv", ctypes.c_int), ("d", ctypes.c_int),
                ("st", ctypes.c_longlong * 10), ("scale", ctypes.c_float),
                ("window", ctypes.c_int), ("cap", ctypes.c_float),
                ("bf16", ctypes.c_int), ("part", ctypes.c_void_p),
                ("tickets", ctypes.c_void_p), ("stream", ctypes.c_void_p)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def blocks_per_sm(index: int, d: int, g: int, bf16: bool) -> int:
    """Blocks of the kernel at (d, g) that fit on one SM of device
    ``index`` at once."""
    fn = _build.function("decode_attention", "decode_attention_blocks_per_sm",
                         (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p))
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = fn(d, g, int(bf16), ctypes.addressof(n))
    if rc != 0 or n.value < 1:
        raise RuntimeError(f"decode attention at D={d}, G={g} fits no block "
                           f"on an SM (CUDA error {rc})")
    return n.value


def splits(b: int, kv: int, t: int, n_sm: int, per_sm: int,
           rows: int = BLOCK_K):
    """(nsplit, chunk): the cache of T rows cut into nsplit pieces of
    ``chunk`` rows (a multiple of ``rows``), as many as fit B * KV * nsplit
    blocks into one wave of ``per_sm`` blocks per SM."""
    want = max(1, per_sm * n_sm // (b * kv))
    chunk = rows * math.ceil(t / min(want, math.ceil(t / rows)) / rows)
    return math.ceil(t / chunk), chunk


class _Plan:
    """What a launch needs that depends only on the plan's key."""

    __slots__ = ("index", "b", "kv", "per_sm", "n_sm", "rows", "fn",
                 "splits", "static", "address", "stream", "workspace",
                 "device", "get_device", "get_stream")

    def __init__(self, q, k, v, window, softcap):
        # the checks that the key fixes, in the order and with the words
        # they have always had
        if not (q.device == k.device == v.device):
            raise ValueError("q, k, v and lengths must be on one device")
        if q.dtype not in (torch.float32, torch.bfloat16) or not (
                q.dtype == k.dtype == v.dtype):
            raise ValueError("decode attention takes f32 or bf16 q, k, v of "
                             f"one dtype; got {q.dtype}, {k.dtype}, "
                             f"{v.dtype}")
        if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
            raise ValueError("decode attention takes q [B,H,D] and k, v "
                             f"[B,KV,T,D]; got {tuple(q.shape)}, "
                             f"{tuple(k.shape)}, {tuple(v.shape)}")
        b, h, d = q.shape
        kv = k.shape[1]
        if k.shape[0] != b or k.shape[3] != d or h % kv \
                or (d, h // kv) not in PAIRS:
            raise ValueError(f"decode attention: q {tuple(q.shape)} and k "
                             f"{tuple(k.shape)} disagree, or (D, H / KV) is "
                             f"not one of {PAIRS}")
        for name, x in (("q", q), ("k", k), ("v", v)):
            check_rows(name, x)
        self.device, self.index = q.device, q.device.index
        self.b, self.kv = b, kv
        bf16 = q.dtype == torch.bfloat16
        self.rows = BLOCK_K_BF16[d] if bf16 else BLOCK_K
        # the output is torch.empty_like(q), whose strides follow q's
        o = torch.empty_like(q)
        self.static = _Static(
            b, h, kv, d, (ctypes.c_longlong * 10)(
                q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
                o.stride(0), o.stride(1)), d ** -0.5,
            window if window is not None else 0,
            softcap if softcap is not None else 0.0, bf16)
        self.address = ctypes.addressof(self.static)
        self.fn = None
        self.splits = {}
        self.stream = self.workspace = None

    def resolve(self):
        """The CUDA side of the plan, on the first launch."""
        self.fn = _build.function("decode_attention", "decode_attention",
                                  _ARGTYPES)
        st = self.static
        self.per_sm = BLOCKS_PER_SM
        if self.per_sm is None:
            self.per_sm = blocks_per_sm(self.index, st.d, st.h // st.kv,
                                        bool(st.bf16))
        self.n_sm = _sm_count(self.index)
        # the current device and the current stream's handle as plain ints,
        # without the Python objects torch.cuda.current_stream builds (the
        # getters of CUDA builds of PyTorch, which its compiled kernels use)
        self.get_device = torch._C._cuda_getDevice
        self.get_stream = torch._C._cuda_getCurrentRawStream

    def split(self, t: int):
        """(nsplit, chunk) of a cache of t rows, worked out once per t."""
        got = self.splits.get(t)
        if got is None:
            got = self.splits[t] = splits(self.b, self.kv, t, self.n_sm,
                                          self.per_sm, self.rows)
        return got

    def set_stream(self, stream: int):
        """Launch on ``stream``, with a workspace of its own (partials and
        tickets) sized for the most splits the plan can ask for."""
        st = self.static
        most = max(1, self.per_sm * self.n_sm // (st.b * st.kv))
        part = torch.empty(st.b * st.h * most * (st.d + 2),
                           dtype=torch.float32, device=self.device)
        tickets = torch.zeros(st.b * st.kv, dtype=torch.int32,
                              device=self.device)
        self.workspace = part, tickets
        st.part, st.tickets = part.data_ptr(), tickets.data_ptr()
        st.stream = self.stream = stream


def _plan(q, k, v, window, softcap) -> _Plan:
    key = (q.device, q.dtype, k.dtype, v.dtype, q.shape, k.shape[:2],
           k.shape[3:], q.stride(), k.stride(), v.stride(), window, softcap,
           BLOCKS_PER_SM)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _Plan(q, k, v, window, softcap)
    return plan


def _launch(q, k, v, lengths, window, softcap, stats=False):
    plan = _plan(q, k, v, window, softcap)
    # what the plan does not fix: devices, the shapes of v and lengths,
    # the pointers' alignment
    dev = plan.device
    if not (k.device == dev and v.device == dev and lengths.device == dev):
        raise ValueError("q, k, v and lengths must be on one device")
    if k.shape != v.shape:
        raise ValueError("decode attention takes q [B,H,D] and k, v "
                         f"[B,KV,T,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (plan.b,) \
            or not lengths.is_contiguous():
        raise ValueError(f"lengths must be a contiguous int32 [{plan.b}] "
                         f"tensor; got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (qp | kp | vp) % 16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            check_rows(name, x)
    o = torch.empty_like(q)
    st = (torch.empty((2,) + tuple(q.shape[:2]), dtype=torch.float32,
                      device=dev) if stats else None)
    t = k.shape[2]
    if o.numel() == 0 or t == 0:
        if stats:
            st[0].fill_(ref.NEG_INF)
            st[1].zero_()
            return o.zero_(), st[0], st[1]
        return o.zero_()
    if plan.fn is None:
        plan.resolve()
    nsplit, chunk = plan.split(t)
    index = plan.index
    stream = plan.get_stream(index)
    if stream != plan.stream:
        plan.set_stream(stream)
    sp = None if st is None else st.data_ptr()
    if plan.get_device() == index:
        rc = plan.fn(qp, kp, vp, lengths.data_ptr(), o.data_ptr(), t, nsplit,
                     chunk, plan.address, sp)
    else:
        with torch.cuda.device(index):
            rc = plan.fn(qp, kp, vp, lengths.data_ptr(), o.data_ptr(), t,
                         nsplit, chunk, plan.address, sp)
    if rc != 0:
        raise RuntimeError(f"decode attention launch failed: CUDA error {rc}")
    _build.count_launch(__name__)
    return o if st is None else (o, st[0], st[1])


def cost(q, k, v, lengths, *, window=None, softcap=None, stats=False):
    """(operations, bytes) of a call, from the shapes: every row attends
    the cache's T rows (or the window), never read from ``lengths``; 4 a
    (head, key, d); those K/V rows and q read, the output (and the
    statistics, 8 bytes a (row, head)) written, the lengths read."""
    b, h, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    keys = b * min(t, window or t)
    return (4 * h * d * keys, q.element_size() * (
        2 * kv * d * keys + 2 * b * h * d) + lengths.element_size() * b
        + 8 * b * h * stats)


@_build.counted(cost)
def decode(q, k, v, lengths, *, window=None, softcap=None, stats=False):
    """Scale D ** -0.5.  q [B,H,D]; k, v [B,KV,T,D]; lengths [B] int32 ->
    [B,H,D] in q's dtype, on q's device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  Row b attends to the cache
    positions < lengths[b] (and >= lengths[b] - window when windowed).
    With ``stats``, (out, m, l): each (row, head)'s largest scaled (and
    softcapped) score over its keys and the sum of exp(score - m), f32
    [B,H] (-1e30 and 0 for a row with no key), which merge the outputs of
    calls over disjoint key sets (a sequence-sharded cache)."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None; got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0 or None; got {softcap}")
    if q.device.type == "cpu":
        return ref.decode_reference(q, k, v, lengths, window=window,
                                    softcap=softcap, stats=stats)
    return _launch(q, k, v, lengths, window, softcap, stats)
