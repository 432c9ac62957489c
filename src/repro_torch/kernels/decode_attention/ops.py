"""Wrapper of the flash-decode kernel (``csrc/decode_attention.cu``).

A CUDA tensor goes to the kernel; a CPU tensor to the plain version in
``ref.py``.  ``launches`` counts the kernel's launches.  k and v may be
strided views of a cache (last dim contiguous); the model passes the
cache's first ``pos + 1`` rows, so that T is the longest length.  The
wrapper cuts those T rows into as many splits as fit in one wave of
blocks, at the blocks per SM that the kernel's shared memory and registers
allow at this (D, G) (the CUDA occupancy query: 3 at D = 128, 1 at
recurrentgemma-2b's D = 256, G = 10).  The splits' workspace is allocated
once per (device, stream) and reused: the kernel leaves its tickets at
zero.
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

#: cache rows per tile
BLOCK_K = 64
#: the (head dim, GQA group H / KV) pairs the kernel is compiled for: those
#: of the repository's configs, full size and reduced
PAIRS = ((32, 1), (32, 2), (32, 4), (64, 1), (64, 2), (128, 1), (128, 4),
         (128, 7), (128, 8), (256, 2), (256, 10))
#: blocks per SM the splits may fill: None asks the kernel (its occupancy
#: at the launch's (D, G) and dtype); 0 keeps the cache in one piece per
#: (batch, KV head)
BLOCKS_PER_SM = None

#: (device index, stream) -> (partials, tickets) of the splits' merge
_WORKSPACE = {}

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p)


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


def splits(b: int, kv: int, t: int, n_sm: int, per_sm: int):
    """(nsplit, chunk): the cache of T rows cut into nsplit pieces of
    ``chunk`` rows (a multiple of BLOCK_K), as many as fit B * KV * nsplit
    blocks into one wave of ``per_sm`` blocks per SM."""
    want = max(1, per_sm * n_sm // (b * kv))
    chunk = BLOCK_K * math.ceil(t / min(want, math.ceil(t / BLOCK_K))
                                / BLOCK_K)
    return math.ceil(t / chunk), chunk


def _workspace(device, stream, n_part: int, n_tickets: int):
    """The (partials, tickets) buffers of launches on ``stream``, grown to
    at least ``n_part`` floats and ``n_tickets`` zeroed counters."""
    key = (device.index, stream)
    part, tickets = _WORKSPACE.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    _WORKSPACE[key] = part, tickets
    return part, tickets


def _launch(q, k, v, lengths, window, softcap):
    global launches
    if not (q.device == k.device == v.device == lengths.device):
        raise ValueError("q, k, v and lengths must be on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError("decode attention takes f32 or bf16 q, k, v of one "
                         f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("decode attention takes q [B,H,D] and k, v "
                         f"[B,KV,T,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kv \
            or (d, h // kv) not in PAIRS:
        raise ValueError(f"decode attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree, or (D, H / KV) is not "
                         f"one of {PAIRS}")
    if lengths.dtype != torch.int32 or lengths.shape != (b,) \
            or not lengths.is_contiguous():
        raise ValueError(f"lengths must be a contiguous int32 [{b}] tensor; "
                         f"got {lengths.dtype} {tuple(lengths.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_rows(name, x)
    o = torch.empty_like(q)
    if o.numel() == 0 or t == 0:
        return o.zero_()
    bf16 = q.dtype == torch.bfloat16
    per_sm = BLOCKS_PER_SM
    if per_sm is None:
        per_sm = blocks_per_sm(q.device.index, d, h // kv, bf16)
    nsplit, chunk = splits(b, kv, t, _sm_count(q.device.index), per_sm)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part = tickets = None
    if nsplit > 1:
        part, tickets = _workspace(q.device, stream,
                                   b * h * nsplit * (d + 2), b * kv)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
        o.stride(0), o.stride(1))
    fn = _build.function("decode_attention", "decode_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                o.data_ptr(), b, h, kv, t, d, strides, d ** -0.5,
                window if window is not None else 0,
                softcap if softcap is not None else 0.0, nsplit, chunk,
                None if part is None else part.data_ptr(),
                None if tickets is None else tickets.data_ptr(),
                int(bf16), stream)
    if rc != 0:
        raise RuntimeError(f"decode attention launch failed: CUDA error {rc}")
    launches += 1
    return o


def decode(q, k, v, lengths, *, window=None, softcap=None):
    """Scale D ** -0.5.  q [B,H,D]; k, v [B,KV,T,D]; lengths [B] int32 ->
    [B,H,D] in q's dtype, on q's device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  Row b attends to the cache
    positions < lengths[b] (and >= lengths[b] - window when windowed)."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None; got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0 or None; got {softcap}")
    if q.device.type == "cpu":
        return ref.decode_reference(q, k, v, lengths, window=window,
                                    softcap=softcap)
    return _launch(q, k, v, lengths, window, softcap)
