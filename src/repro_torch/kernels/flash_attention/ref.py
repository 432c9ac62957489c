"""Plain PyTorch GQA attention, causal or not, optionally sliding-window
and softcapped: the JAX package's ``mha_reference`` at its default scale,
D ** -0.5, which is the one the model uses.

Layout: q [B, H, S, D]; k, v [B, KV, T, D]; head h reads kv head
h // (H / KV).  Scores, softmax and the value sum run in f32; the output
has q's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def mha_reference(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None):
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, s, d)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg.float(),
                          k.float()) * d ** -0.5
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(t, device=q.device)[None, :]
    ok = cols <= rows if causal else cols < t
    if window is not None:
        ok = ok & (cols > rows - window)
    scores = torch.where(ok, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return out.reshape(b, h, s, d).to(q.dtype)
