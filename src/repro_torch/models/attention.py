"""GQA attention (global, and sliding-window for ``"local"`` layers),
through the port's two kernels.

Prefill runs the flash-attention kernel where the JAX package runs
``chunked_causal_attention``; decode runs the flash-decode kernel over the
cache where it runs ``attention_decode_v2`` (the old cache merged with the
new token: the same key set as the cache with the new token written
first).  On CPU tensors both kernels' wrappers take their plain versions.
Both kinds of layer take one path: a cache of T rows holds position p at
slot p % T (``kvcache.py``).  Prefill runs flash over the prompt's own
K/V, windowed for a ``"local"`` layer, then keeps the last min(S, T) of
them; decode writes the new token at slot pos % T and attends the first
min(pos + 1, T) rows with no window, each of them in the key set.  A
global layer's T is max_seq, which its config never passes
(``bounded_by_max_seq``), so its slot is its position and it never wraps;
a ``"local"`` layer's T is its ring's R rows.  MLA, cross-attention and
the sharded paths are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops

from .base import ModelConfig
from .layers import apply_rope, dense_init


def init_attention(gen, cfg: ModelConfig, dtype, device=None):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": dense_init(gen, (d, h * hd), dtype, device=device),
         "wk": dense_init(gen, (d, kv * hd), dtype, device=device),
         "wv": dense_init(gen, (d, kv * hd), dtype, device=device),
         "wo": dense_init(gen, (h * hd, d), dtype, device=device)}
    if cfg.qkv_bias:
        for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros(n * hd, dtype=dtype, device=device)
    return p


def _project(p, cfg: ModelConfig, x, positions):
    """q [B,S,H,hd] and k [B,S,KV,hd] after RoPE, v [B,S,KV,hd]."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q.view(b, s, h, hd), positions, cfg.rope_theta)
    k = apply_rope(k.view(b, s, kv, hd), positions, cfg.rope_theta)
    return q, k, v.view(b, s, kv, hd)


def _fill_ring(cache, k, v) -> None:
    """Write the last min(S, T) rows of the prompt's k, v [B,KV,S,hd] into
    ``cache`` of T rows, position p at slot p % T (the JAX package's
    ``_prefill_fill_attn``)."""
    s, r = k.shape[2], cache.k.shape[2]
    n = min(s, r)
    start = (s - n) % r
    head = min(n, r - start)
    for ring, new in zip(cache, (k, v)):
        ring[:, :, start:start + head].copy_(new[:, :, s - n:s - n + head])
        ring[:, :, :n - head].copy_(new[:, :, s - n + head:])


def attention_forward(p, cfg: ModelConfig, x, positions, *, window=None,
                      cache=None):
    """Full-sequence causal attention (forward / prefill), over the last
    ``window`` positions when windowed.  x [B,S,d]; ``cache`` (optional)
    is this layer's (k, v) [B,KV,T,hd], which keeps the last min(S, T) of
    the prompt's K/V."""
    b, s, _ = x.shape
    q, k, v = _project(p, cfg, x, positions)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    out = flash_ops.attention(q.transpose(1, 2), k, v, window=window,
                              softcap=cfg.attn_softcap)
    if cache is not None:
        _fill_ring(cache, k, v)
    return out.transpose(1, 2).reshape(b, s, -1) @ p["wo"]


def attention_decode(p, cfg: ModelConfig, x, cache, pos: int, positions,
                     lengths):
    """One-token decode.  x [B,1,d]; ``positions`` [B,1] holds pos (for
    RoPE); ``cache`` is this layer's (k, v) [B,KV,T,hd], written in place
    at slot pos % T.  ``lengths`` [B] int32 holds the rows every batch row
    attends, min(pos + 1, T)."""
    b = x.shape[0]
    q, k, v = _project(p, cfg, x, positions)
    ck, cv = cache
    t = ck.shape[2]
    ck[:, :, pos % t].copy_(k[:, 0])
    cv[:, :, pos % t].copy_(v[:, 0])
    rows = min(pos + 1, t)
    # only the filled rows: the kernel sizes its splits from T
    out = decode_ops.decode(q[:, 0], ck[:, :, :rows], cv[:, :, :rows],
                            lengths, softcap=cfg.attn_softcap)
    return out.reshape(b, 1, -1) @ p["wo"]
