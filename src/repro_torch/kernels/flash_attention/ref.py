"""Plain PyTorch GQA attention, causal or not, optionally sliding-window
and softcapped: the JAX package's ``mha_reference`` at its default scale,
D ** -0.5, which is the one the model uses; and its plain backward.

Layout: q [B, H, S, D]; k, v [B, KV, T, D]; head h reads kv head
h // (H / KV).  Scores, softmax and the value sum run in f32 (in f64 for
f64 inputs); the output has q's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _acc(x: torch.Tensor) -> torch.dtype:
    """The type the plain versions compute in: f64 for f64 inputs, else
    f32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _visible(s: int, t: int, causal: bool, window: Optional[int], device):
    """[S, T] mask: query row i sees key column j."""
    rows = torch.arange(s, device=device)[:, None]
    cols = torch.arange(t, device=device)[None, :]
    ok = cols <= rows if causal else cols < t
    if window is not None:
        ok = ok & (cols > rows - window)
    return ok


def _scores(qg, k, d, softcap):
    """(scaled and softcapped scores [B,KV,G,S,T], tanh(x / cap) or
    None)."""
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k) * d ** -0.5
    if softcap is None:
        return scores, None
    t = torch.tanh(scores / softcap)
    return t * softcap, t


def mha_reference(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None):
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    acc = _acc(q)
    qg = q.reshape(b, kv, h // kv, s, d)
    scores, _ = _scores(qg.to(acc), k.to(acc), d, softcap)
    ok = _visible(s, t, causal, window, q.device)
    scores = torch.where(ok, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.to(acc))
    return out.reshape(b, h, s, d).to(q.dtype)


def mha_backward_reference(q, k, v, do, *, causal: bool = True,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None):
    """(dq, dk, dv): the vjp of ``mha_reference`` at the cotangent ``do``
    [B,H,S,D], written out: P the softmax, dV = P^T dO, dP = dO V^T, dS =
    P (dP - rowsum(P dP)) times 1 - tanh^2 under a softcap, dQ = scale dS
    K and dK = scale dS^T Q, summed over each KV head's group of heads.
    Computed as ``mha_reference`` computes (f32, or f64 for f64 inputs),
    returned in the inputs' dtypes."""
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    acc = _acc(q)
    qg = q.reshape(b, kv, h // kv, s, d).to(acc)
    dog = do.reshape(b, kv, h // kv, s, d).to(acc)
    k32, v32 = k.to(acc), v.to(acc)
    scores, tanh = _scores(qg, k32, d, softcap)
    ok = _visible(s, t, causal, window, q.device)
    p = torch.softmax(torch.where(ok, scores, NEG_INF), dim=-1)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dog)
    dp = torch.einsum("bkgsd,bktd->bkgst", dog, v32)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    if tanh is not None:
        ds = ds * (1 - tanh * tanh)
    ds = ds * d ** -0.5
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, k32).reshape(b, h, s, d)
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
