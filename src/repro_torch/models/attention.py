"""GQA attention (global, and sliding-window for ``"local"`` layers; the
encoder's unmasked self-attention and the decoder's cross-attention of
the encdec family), through the port's two kernels.

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
a ``"local"`` layer's T is its ring's R rows.  A config without RoPE
(``use_rope`` False: whisper, whose decoder positions are all zero in the
JAX package, where RoPE at angle 0 is the identity) projects without it.

Whisper's encoder runs flash with ``causal=False`` over its frames (the
JAX package's ``gqa_scores_softmax`` with a zero bias).  Cross-attention
reads K/V projected once from the encoder's output (``encode_cross_kv``)
and kept in the cache as [B, KV, T, hd]: every query attends all T rows,
through flash with ``causal=False`` over the prompt and through the decode
kernel over all T rows in a decode step.

MLA (DeepSeek-V2's multi-head latent attention) runs in plain PyTorch, as
the JAX package runs it in XLA einsums: its q·k width of 192 and v width
of 128 suit neither kernel.  Prefill expands the keys and values
(``mla_forward``, the reference's ``chunked_causal_attention``: f32
scores, probabilities cast to the values' dtype); decode attends in the
latent space with the up-projections absorbed (``mla_decode_v2``, the
reference's one-device carry path: the old latent rows merged with the
new token's).  The sharded paths are not ported.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops

from .base import ModelConfig
from .layers import apply_rope, dense_init, softcap


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


def init_mla(gen, cfg: ModelConfig, dtype, device=None):
    d, h = cfg.d_model, cfg.num_heads
    r, dr, dn, dv = (cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim,
                     cfg.v_head_dim)
    return {name: dense_init(gen, shape, dtype, device=device)
            for name, shape in (("wq", (d, h * (dn + dr))), ("w_dkv", (d, r)),
                                ("w_kr", (d, dr)), ("w_uk", (r, h * dn)),
                                ("w_uv", (r, h * dv)), ("wo", (h * dv, d)))}


def _project(p, cfg: ModelConfig, x, positions):
    """q [B,S,H,hd] and k [B,S,KV,hd] after RoPE (none without
    ``cfg.use_rope``: ``positions`` unused), v [B,S,KV,hd]."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k = q.view(b, s, h, hd), k.view(b, s, kv, hd)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
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


def attention_forward(p, cfg: ModelConfig, x, positions, *, causal=True,
                      window=None, cache=None):
    """Full-sequence self-attention (forward / prefill), causal unless
    ``causal`` is False (whisper's encoder), over the last ``window``
    positions when windowed.  x [B,S,d]; ``cache`` (optional) is this
    layer's (k, v) [B,KV,T,hd], which keeps the last min(S, T) of the
    prompt's K/V."""
    b, s, _ = x.shape
    q, k, v = _project(p, cfg, x, positions)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    out = flash_ops.attention(q.transpose(1, 2), k, v, causal=causal,
                              window=window, softcap=cfg.attn_softcap)
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


def encode_cross_kv(p, cfg: ModelConfig, enc, cache=None):
    """The cross-attention K/V [B,KV,T,hd] of the encoder's output enc
    [B,T,d] (``wk``, ``wv``; no bias, as in the JAX package), written into
    ``cache`` (this layer's (k, v) [B,KV,T,hd]) when given."""
    b, t, _ = enc.shape
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    k, v = ((enc @ p[w]).view(b, t, kv, hd).transpose(1, 2)
            for w in ("wk", "wv"))
    if cache is None:
        return k, v
    cache.k.copy_(k)
    cache.v.copy_(v)
    return cache


def _cross_queries(p, cfg: ModelConfig, x):
    b, s, _ = x.shape
    return (x @ p["wq"]).view(b, s, cfg.num_heads, cfg.head_dim)


def cross_attention_forward(p, cfg: ModelConfig, x, enc_kv):
    """Cross-attention over the prompt: x [B,S,d], every query row over
    every row of ``enc_kv``'s k, v [B,KV,T,hd] (flash, not causal) ->
    [B,S,d]."""
    b, s, _ = x.shape
    k, v = enc_kv
    out = flash_ops.attention(_cross_queries(p, cfg, x).transpose(1, 2), k,
                              v, causal=False)
    return out.transpose(1, 2).reshape(b, s, -1) @ p["wo"]


def cross_attention_decode(p, cfg: ModelConfig, x, enc_kv, lengths):
    """A decode step's cross-attention: x [B,1,d] over all T rows of
    ``enc_kv``'s k, v [B,KV,T,hd] (the decode kernel; ``lengths`` [B]
    int32 holds T) -> [B,1,d]."""
    k, v = enc_kv
    out = decode_ops.decode(_cross_queries(p, cfg, x)[:, 0], k, v, lengths)
    return out.reshape(x.shape[0], 1, -1) @ p["wo"]


#: the reference's additive mask value
NEG_INF = -1e30
#: query rows per chunk of ``chunked_causal_attention``
CHUNK = 1024


def chunked_causal_attention(q, k, v, scale: float, cap=None):
    """Causal attention over query chunks: q, k [B,S,H,D], v [B,S,H,Dv] ->
    [B,S,H,Dv] in v's dtype.  Chunks of ``CHUNK`` rows (one chunk when S
    is not a multiple of it); scores in f32 (the products of the inputs'
    values, summed in f32), scaled, softcapped by ``cap``, masked, a
    softmax in f32, the probabilities cast to v's dtype before the product
    with v."""
    s = q.shape[1]
    chunk = min(CHUNK, s)
    if s % chunk:
        chunk = s
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))    # [B,H,S,D]
    k32 = kt.float().transpose(2, 3)
    cols = torch.arange(s, device=q.device)
    outs = []
    for c0 in range(0, s, chunk):
        scores = softcap((qt[:, :, c0:c0 + chunk].float() @ k32) * scale,
                         cap)
        rows = torch.arange(c0, c0 + chunk, device=q.device)[:, None]
        scores = scores.masked_fill(cols[None, :] > rows, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(probs @ vt)
    return torch.cat(outs, 2).transpose(1, 2)


def _mla_queries(p, cfg: ModelConfig, x, positions):
    """q_nope [B,S,H,dn] and q_rope [B,S,H,dr] after RoPE; the latent c
    [B,S,r] and the shared rope key k_rope [B,S,dr] after RoPE."""
    b, s, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = (x @ p["wq"]).view(b, s, cfg.num_heads, dn + dr)
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    k_rope = apply_rope(x @ p["w_kr"], positions, cfg.rope_theta)
    return q[..., :dn], q_rope, x @ p["w_dkv"], k_rope


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)


def mla_forward(p, cfg: ModelConfig, x, positions, *, return_cache=False):
    """MLA over the full sequence (forward / prefill), keys and values
    expanded from the latent.  x [B,S,d] -> [B,S,d]; with
    ``return_cache``, also (c [B,S,r], k_rope [B,S,dr]), the rows the
    latent cache keeps."""
    b, s, _ = x.shape
    h, dn, dr = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q_nope, q_rope, c_kv, k_rope = _mla_queries(p, cfg, x, positions)
    k_nope = (c_kv @ p["w_uk"]).view(b, s, h, dn)
    v = (c_kv @ p["w_uv"]).view(b, s, h, cfg.v_head_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, dr)],
                       dim=-1)
    out = chunked_causal_attention(q_full, k_full, v, _mla_scale(cfg),
                                   cfg.attn_softcap)
    out = out.reshape(b, s, -1) @ p["wo"]
    return (out, (c_kv, k_rope)) if return_cache else out


def mla_decode_v2(p, cfg: ModelConfig, x, c_old, kr_old, pos: int):
    """One-token MLA decode in the latent space over the old cache rows
    merged with the new token.  x [B,1,d]; c_old [B,T,r] and kr_old
    [B,T,dr] are the latent rows of positions [0, T), every one attended
    (the caller passes the first ``pos`` rows).  Returns (out [B,1,d],
    c_col [B,1,r], kr_col [B,1,dr]): the new token's rows, which the
    caller writes at row ``pos``.  The reference's casts, op by op: the
    absorbed query in x's dtype, both score products in f32, the merge of
    the old rows' context with the new row's in x's dtype."""
    b = x.shape[0]
    h, r, dn = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_nope_dim
    adt = x.dtype
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q_nope, q_rope, c_col, kr_col = _mla_queries(p, cfg, x, positions)
    scale = _mla_scale(cfg)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0],
                         p["w_uk"].view(r, h, dn))              # [B,H,r]
    q_abs32, q_rope32 = q_abs.float(), q_rope[:, 0].float()
    s_old = (q_abs32 @ c_old.float().transpose(1, 2)
             + q_rope32 @ kr_old.float().transpose(1, 2)) * scale
    s_new = (q_abs32 @ c_col.float().transpose(1, 2)
             + q_rope32 @ kr_col.float().transpose(1, 2)) * scale  # [B,H,1]
    m = torch.maximum(s_old.amax(dim=-1, keepdim=True), s_new)
    p_old, p_new = torch.exp(s_old - m), torch.exp(s_new - m)
    denom = p_old.sum(dim=-1, keepdim=True) + p_new
    ctx = (p_old.to(adt) @ c_old + p_new.to(adt) * c_col) / denom.to(adt)
    out = torch.einsum("bhr,rhd->bhd", ctx,
                       p["w_uv"].view(r, h, cfg.v_head_dim))
    return out.reshape(b, 1, -1) @ p["wo"], c_col, kr_col
