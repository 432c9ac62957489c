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
new token's).

On a mesh (``sharding.ctx``) the GQA layers are tensor-parallel over its
'model' axis of m ranks, the reference's specs: ``wq`` (and ``bq``) a
column shard of the rank's H / m query heads, ``wo`` a row shard whose
output is all-reduced, the input's gradient all-reduced
(``comm.reduce_grad``).  Where the KV heads divide m, ``wk`` and ``wv``
are column shards of the rank's KV heads; where they do not, each rank
gathers them whole over 'model' and computes the KV heads its query
heads read (every head where it fills a sequence-split cache), the
function GSPMD gives the reference.  Both kernels run on the rank's
heads.  A decode step's cache follows ``decode_cache_layout``: ``kv``
runs as one device does on the rank's heads; ``seq`` gathers every query
head of the new token, runs the decode kernel over the rank's rows with
its softmax statistics and merges the ranks' outputs by the reference's
formula (max over the ranks, then the sums of l e^(m - max) and of the
scaled outputs), then keeps the rank's heads; ``none`` (a replicated
cache) the same without the merge.  The sharded MLA paths are not
ported.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.sharding import comm, ctx
from repro_torch.sharding import specs as sp

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


class _Heads:
    """A rank's share of a GQA layer's heads on the 'model' axis (one
    rank: all of them): m ranks, this one r, its ``hl`` query heads, and
    the KV heads [k0, k1) they read, which it computes from its column
    shard (``split``) or from ``wk``, ``wv`` gathered whole."""

    def __init__(self, cfg: ModelConfig):
        h, kv = cfg.num_heads, cfg.num_kv_heads
        self.m = comm.size("model")
        self.r = (sp.axis_coords(ctx.current_mesh())["model"]
                  if self.m > 1 else 0)
        self.hl = h // self.m
        self.split = kv % self.m == 0
        g = h // kv
        self.k0 = self.r * self.hl // g
        self.k1 = ((self.r + 1) * self.hl - 1) // g + 1


def _whole(w, n: int, dim: int = -1):
    """``w`` gathered over 'model' along ``dim`` unless it has ``n`` there
    already (a leaf the spec keeps whole)."""
    if w.shape[dim] == n:
        return w
    return comm.all_gather(w, "model", dim % w.dim())


def _project(p, cfg: ModelConfig, x, positions, kv_all: bool = False):
    """q [B,S,Hr,hd] and k [B,S,KVr,hd] after RoPE (none without
    ``cfg.use_rope``: ``positions`` unused), v [B,S,KVr,hd]: every head
    on one device; on a mesh the rank's query heads and the KV heads
    they read (all of them with ``kv_all``, where they do not divide the
    axis; ``_Heads``)."""
    b, s, _ = x.shape
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    tp = _Heads(cfg)
    wk, wv = p["wk"], p["wv"]
    bk, bv = (p["bk"], p["bv"]) if cfg.qkv_bias else (None, None)
    if tp.m > 1:
        x = comm.reduce_grad(x, "model")
        if not tp.split:
            lo, hi = (0, kv) if kv_all else (tp.k0, tp.k1)
            wk, wv = (_whole(w, kv * hd)[:, lo * hd:hi * hd]
                      for w in (wk, wv))
            if cfg.qkv_bias:
                bk, bv = (_whole(w, kv * hd)[lo * hd:hi * hd]
                          for w in (bk, bv))
    q, k, v = x @ p["wq"], x @ wk, x @ wv
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + bk, v + bv
    q, k = q.view(b, s, -1, hd), k.view(b, s, -1, hd)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.view(b, s, -1, hd)


def _out(p, o):
    """The layer's output o [B,S,Hr*hd] @ ``wo``, summed over 'model' (a
    row shard on a mesh)."""
    return comm.all_reduce(o @ p["wo"], "model")


def _fill_ring(cache, k, v, r=None, lo=0) -> None:
    """Write the last min(S, T) rows of the prompt's k, v [B,KV,S,hd] into
    a cache of T rows (``r``; the cache's own unless given), position p at
    slot p % T (the JAX package's ``_prefill_fill_attn``); ``cache`` holds
    the slots [lo, lo + its rows) of them (a sequence shard)."""
    s, rows = k.shape[2], cache.k.shape[2]
    r = r or rows
    n = min(s, r)
    start = (s - n) % r
    head = min(n, r - start)
    for dst, src, count in ((start, s - n, head), (0, s - n + head,
                                                    n - head)):
        a, b = max(dst, lo), min(dst + count, lo + rows)
        if a < b:
            for ring, new in zip(cache, (k, v)):
                ring[:, :, a - lo:b - lo].copy_(
                    new[:, :, src + a - dst:src + b - dst])


def _layout(cfg: ModelConfig, rows) -> str:
    """This layer's ``decode_cache_layout`` on the current mesh (``kv``:
    the rank's KV heads, as one device holds them all)."""
    if comm.size("model") == 1:
        return "kv"
    return sp.decode_cache_layout(cfg.num_kv_heads, rows, ctx.current_mesh())


def attention_forward(p, cfg: ModelConfig, x, positions, *, causal=True,
                      window=None, cache=None, rows=None):
    """Full-sequence self-attention (forward / prefill), causal unless
    ``causal`` is False (whisper's encoder), over the last ``window``
    positions when windowed.  x [B,S,d]; ``cache`` (optional) is this
    layer's (k, v) [B,KV,T,hd] of ``rows`` rows (on a mesh the rank's
    shard), which keeps the last min(S, T) of the prompt's K/V."""
    b, s, _ = x.shape
    layout = "kv" if cache is None else _layout(cfg, rows)
    q, k, v = _project(p, cfg, x, positions, kv_all=layout != "kv")
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    if cache is not None:
        tp = _Heads(cfg)
        lo = tp.r * cache.k.shape[2] if layout == "seq" else 0
        _fill_ring(cache, k, v, rows, lo)
        if layout != "kv":   # the KV heads this rank's query heads read
            k, v = k[:, tp.k0:tp.k1], v[:, tp.k0:tp.k1]
    out = flash_ops.attention(q.transpose(1, 2), k, v, causal=causal,
                              window=window, softcap=cfg.attn_softcap)
    return _out(p, out.transpose(1, 2).reshape(b, s, -1))


def attention_decode(p, cfg: ModelConfig, x, cache, pos: int, positions,
                     lengths, rows=None):
    """One-token decode.  x [B,1,d]; ``positions`` [B,1] holds pos (for
    RoPE); ``cache`` is this layer's (k, v) [B,KV,T,hd] of ``rows`` rows
    (on a mesh the rank's shard, the module docstring), written in place
    at slot pos % T.  ``lengths`` [B] int32 holds the rows every batch row
    attends, min(pos + 1, T)."""
    b = x.shape[0]
    layout = _layout(cfg, rows)
    q, k, v = _project(p, cfg, x, positions, kv_all=layout != "kv")
    ck, cv = cache
    t = ck.shape[2]
    if layout == "kv":
        ck[:, :, pos % t].copy_(k[:, 0])
        cv[:, :, pos % t].copy_(v[:, 0])
        n = min(pos + 1, t)
        # only the filled rows: the kernel sizes its splits from T
        out = decode_ops.decode(q[:, 0], ck[:, :, :n], cv[:, :, :n],
                                lengths, softcap=cfg.attn_softcap)
        return _out(p, out.reshape(b, 1, -1))
    tp = _Heads(cfg)
    lo = tp.r * t if layout == "seq" else 0
    slot = pos % rows - lo
    if 0 <= slot < t:
        ck[:, :, slot].copy_(k[:, 0])
        cv[:, :, slot].copy_(v[:, 0])
    n = min(max(min(pos + 1, rows) - lo, 0), t)
    q_all = comm.all_gather(q[:, 0], "model", dim=1)         # [B, H, hd]
    mine = torch.full((b,), n, dtype=torch.int32, device=x.device)
    out, mx, ll = decode_ops.decode(q_all, ck[:, :, :n], cv[:, :, :n], mine,
                                    softcap=cfg.attn_softcap, stats=True)
    if layout == "seq":   # the reference's merge over the rows' shards
        top = comm.all_reduce_max(mx, "model")
        w = ll * torch.exp(mx - top)
        acc = comm.all_reduce(out.float() * w[..., None], "model")
        den = comm.all_reduce(w, "model")
        out = (acc / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)
    out = out[:, tp.r * tp.hl:(tp.r + 1) * tp.hl]
    return _out(p, out.reshape(b, 1, -1))


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
