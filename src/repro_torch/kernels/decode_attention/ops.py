"""Wrapper of the flash-decode kernel (``csrc/decode_attention.cu``).

A CUDA tensor goes to the kernel; a CPU tensor to the plain version in
``ref.py``.  ``launches`` counts the kernel's launches.  k and v may be
strided views of a cache (last dim contiguous); the model passes the
cache's first ``pos + 1`` rows, so that T is the longest length.  The
wrapper cuts those T rows into as many splits as fit in one wave of
blocks.  The splits' workspace is allocated once per (device, stream) and
reused: the kernel leaves its tickets at zero.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS, check_rows

from . import ref

#: kernel launches since the count was last set to 0
launches = 0

#: cache rows per tile, and the GQA group sizes (H / KV) it is compiled for
BLOCK_K = 64
GROUPS = (1, 2, 4, 8)
#: blocks of the kernel that fit on an SM at D = 128 (about 70 KB of
#: shared memory each, of 228 KB): the splits fill one such wave at most
BLOCKS_PER_SM = 3

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


def splits(b: int, kv: int, t: int, n_sm: int):
    """(nsplit, chunk): the cache of T rows cut into nsplit pieces of
    ``chunk`` rows (a multiple of BLOCK_K), as many as fit B * KV * nsplit
    blocks into one wave of BLOCKS_PER_SM blocks per SM."""
    want = max(1, BLOCKS_PER_SM * n_sm // (b * kv))
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
    if (k.shape[0] != b or k.shape[3] != d or h % kv
            or h // kv not in GROUPS or d not in HEAD_DIMS):
        raise ValueError(f"decode attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree, H / KV is not one of "
                         f"{GROUPS}, or D is not one of {HEAD_DIMS}")
    if lengths.dtype != torch.int32 or lengths.shape != (b,) \
            or not lengths.is_contiguous():
        raise ValueError(f"lengths must be a contiguous int32 [{b}] tensor; "
                         f"got {lengths.dtype} {tuple(lengths.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_rows(name, x)
    o = torch.empty_like(q)
    if o.numel() == 0 or t == 0:
        return o.zero_()
    nsplit, chunk = splits(b, kv, t, _sm_count(q.device.index))
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
                int(q.dtype == torch.bfloat16), stream)
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
