"""GQA attention (global, and sliding-window for ``"local"`` layers),
through the port's two kernels.

Prefill runs the flash-attention kernel where the JAX package runs
``chunked_causal_attention``; decode runs the flash-decode kernel over the
cache where it runs ``attention_decode_v2`` (the old cache merged with the
new token: the same key set as the cache with the new token written at
``pos`` and ``lengths = pos + 1``).  On CPU tensors both kernels' wrappers
take their plain versions.  A ``"local"`` layer passes its window to both
kernels, which mask the position-ordered cache rows to the last ``window``
positions.  MLA, cross-attention and the sharded paths are not ported.
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


def attention_forward(p, cfg: ModelConfig, x, positions, *, window=None,
                      cache=None):
    """Full-sequence causal attention (forward / prefill), over the last
    ``window`` positions when windowed.  x [B,S,d];
    ``cache`` (optional) is this layer's (k, v) [B,KV,T,hd]: the prompt's
    K/V are written into its rows [0, S) (the JAX package's
    ``_prefill_fill_attn`` for a ring that does not wrap) and attended
    from there."""
    b, s, _ = x.shape
    q, k, v = _project(p, cfg, x, positions)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    if cache is not None:
        ck, cv = cache
        ck[:, :, :s].copy_(k)
        cv[:, :, :s].copy_(v)
        k, v = ck[:, :, :s], cv[:, :, :s]
    out = flash_ops.attention(q.transpose(1, 2), k, v, window=window,
                              softcap=cfg.attn_softcap)
    return out.transpose(1, 2).reshape(b, s, -1) @ p["wo"]


def attention_decode(p, cfg: ModelConfig, x, cache, pos: int, lengths, *,
                     window=None):
    """One-token decode.  x [B,1,d]; ``cache`` is this layer's (k, v)
    [B,KV,T,hd], written in place at row ``pos``; ``lengths`` [B] int32
    holds pos + 1, so every row attends to cache rows [0, pos] (the last
    ``window`` of them when windowed)."""
    b = x.shape[0]
    q, k, v = _project(p, cfg, x, (lengths - 1)[:, None])
    ck, cv = cache
    ck[:, :, pos].copy_(k[:, 0])
    cv[:, :, pos].copy_(v[:, 0])
    # only the rows [0, pos]: the kernel sizes its splits from T
    out = decode_ops.decode(q[:, 0], ck[:, :, :pos + 1], cv[:, :, :pos + 1],
                            lengths, window=window,
                            softcap=cfg.attn_softcap)
    return out.reshape(b, 1, -1) @ p["wo"]
