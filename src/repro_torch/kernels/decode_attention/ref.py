"""Plain PyTorch single-token GQA decode attention over a KV cache: the
JAX package's ``decode_reference`` at its default scale, D ** -0.5.

q [B, H, D]; k, v [B, KV, T, D]; lengths [B] int32: row b attends to the
cache positions < lengths[b] (and >= lengths[b] - window when windowed).
With ``stats``, also each (row, head)'s largest score over its keys and
the sum of exp(score - that max), f32 [B, H] (-1e30 and 0 for a row with
no key).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_reference(q, k, v, lengths, *, window: Optional[int] = None,
                     softcap: Optional[float] = None, stats: bool = False):
    b, h, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    if t == 0:   # no key: a zero output, as the kernel gives
        out = torch.zeros_like(q)
        if not stats:
            return out
        return (out, torch.full((b, h), NEG_INF, device=q.device),
                torch.zeros((b, h), device=q.device))
    qg = q.reshape(b, kv, h // kv, d)
    s = torch.einsum("bkgd,bktd->bkgt", qg.float(), k.float()) * d ** -0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    cols = torch.arange(t, device=q.device)[None, :]
    lengths = lengths.to(q.device)[:, None]
    ok = cols < lengths
    if window is not None:
        ok &= cols >= lengths - window
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", p, v.float())
    out = out.reshape(b, h, d).to(q.dtype)
    if not stats:
        return out
    m = s.amax(dim=-1)
    ll = torch.where(ok[:, None, None, :], torch.exp(s - m[..., None]),
                     0.0).sum(dim=-1)
    return out, m.reshape(b, h), ll.reshape(b, h)
