"""Model assembly of the dense and ssm families: init / forward / prefill /
decode.

A dense model is embed -> N x [pre-norm attention][pre-norm SwiGLU MLP] ->
final norm -> tied unembedding; an ssm model (Mamba-2) is embed -> N x
[pre-norm Mamba-2 block] -> final norm -> tied unembedding, with no MLP.
Where the JAX package scans over layer parameters stacked on a leading
n_blocks dim, the port loops over a list: ``params["blocks"]["s0"]`` holds
one dict per layer with the JAX names (``norm1``,
``attn.{wq,wk,wv,wo[,bq,bk,bv]}``, ``norm2``, ``mlp.{w_gate,w_up,w_down}``;
or ``norm1``, ``ssm.{in_proj,conv_w,conv_b,dt_bias,A_log,D,norm_w,
out_proj}``); ``params_from_jax`` unstacks a JAX parameter tree into that
form.  Matrices, biases and the conv are kept in the activation dtype
(cast once at load), norm weights and the Mamba-2 per-head scalars in f32.

The other families (moe, hybrid, encdec, vlm) and the dense variants with
local layers, MLA, post-norms or scaled embeddings raise ``ValueError``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

from .attention import attention_decode, attention_forward, init_attention
from .base import ModelConfig
from .kvcache import init_cache
from .layers import (apply_mlp, embed, init_embedding, init_mlp, rms_norm,
                     unembed)
from .ssm import init_ssm, ssm_decode_step, ssm_forward

#: the family -> block layout pairs the port runs
_PORTED = {"dense": ("attn",), "ssm": ("ssm",)}
#: the Mamba-2 parameters kept in f32 (the rest take the activation dtype)
_SSM_F32 = ("dt_bias", "A_log", "D", "norm_w")


def check_config(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` naming what of ``cfg`` the port does not run."""
    unported = [what for what, bad in (
        (f"family {cfg.family!r}", cfg.family not in _PORTED),
        (f"layout {cfg.block_layout}+{cfg.trailing_layout}",
         cfg.block_layout != _PORTED.get(cfg.family)
         or bool(cfg.trailing_layout)),
        (f"mlp {cfg.mlp_variant!r}", cfg.mlp_variant != "swiglu"),
        ("MLA", cfg.use_mla), ("experts", bool(cfg.num_experts)),
        ("post-norms", cfg.post_norm), ("scaled embeddings", cfg.embed_scale),
        ("positions without RoPE", not cfg.use_rope),
        ("prefix embeddings", bool(cfg.num_prefix_embeds))) if bad]
    if unported:
        raise ValueError(f"{cfg.name}: not ported yet: {', '.join(unported)}")


def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Seeded random parameters, drawn on ``device`` from one generator."""
    check_config(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    adt, d = cfg.adtype, cfg.d_model

    def norm():
        return torch.zeros(d, dtype=torch.float32, device=dev)

    def layer():
        if cfg.family == "ssm":
            return {"norm1": norm(), "ssm": init_ssm(gen, cfg, adt, dev)}
        return {"norm1": norm(), "attn": init_attention(gen, cfg, adt, dev),
                "norm2": norm(),
                "mlp": init_mlp(gen, d, cfg.d_ff, cfg.mlp_variant, adt, dev)}

    return {
        "embed": init_embedding(gen, cfg.vocab_size, d, adt, dev),
        "final_norm": norm(),
        "blocks": {"s0": [layer() for _ in range(cfg.n_blocks)]},
    }


def params_from_jax(cfg: ModelConfig, tree, device="cuda") -> Dict[str, Any]:
    """The JAX package's parameter tree (``repro.models.init_params``, as
    numpy arrays or anything ``np.asarray`` reads) in the port's form."""
    check_config(cfg)
    dev = resolve_device(device)

    def mat(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=cfg.adtype)

    def vec(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    s0 = tree["blocks"]["s0"]

    def layer(i):
        if cfg.family == "ssm":
            return {"norm1": vec(s0["norm1"][i]),
                    "ssm": {n: (vec if n in _SSM_F32 else mat)(a[i])
                            for n, a in s0["ssm"].items()}}
        return {"norm1": vec(s0["norm1"][i]),
                "attn": {n: mat(a[i]) for n, a in s0["attn"].items()},
                "norm2": vec(s0["norm2"][i]),
                "mlp": {n: mat(a[i]) for n, a in s0["mlp"].items()}}

    return {
        "embed": {"table": mat(tree["embed"]["table"])},
        "final_norm": vec(tree["final_norm"]),
        "blocks": {"s0": [layer(i) for i in range(cfg.n_blocks)]},
    }


def _mlp_residual(p, cfg: ModelConfig, x):
    return x + apply_mlp(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps),
                         cfg.mlp_variant)


def _prompt_layers(params, cfg: ModelConfig, tokens, cache=None):
    """The hidden states [B,S,d] after every layer; with ``cache``, each
    attention layer's K/V land in its rows [0, S) and each Mamba-2 layer's
    state after the prompt replaces its slot."""
    check_config(cfg)
    x = embed(params["embed"], tokens, adtype=cfg.adtype)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    for i, p in enumerate(params["blocks"]["s0"]):
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        if cfg.family == "ssm":
            if cache is None:
                x = x + ssm_forward(p["ssm"], cfg, h)
            else:
                o, cache[i] = ssm_forward(p["ssm"], cfg, h,
                                          return_state=True)
                x = x + o
            continue
        kv = None if cache is None else (cache.k[i], cache.v[i])
        x = x + attention_forward(p["attn"], cfg, h, positions, cache=kv)
        x = _mlp_residual(p, cfg, x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(params, cfg: ModelConfig, tokens):
    """Full-sequence logits [B, S, V] (f32).  tokens [B, S] int."""
    return unembed(params["embed"], _prompt_layers(params, cfg, tokens),
                   cap=cfg.final_softcap)


def prefill(params, cfg: ModelConfig, tokens, *, max_seq=None):
    """Run the prompt: (last-position logits [B, 1, V], cache holding the
    prompt's K/V, or the Mamba-2 states, for ``decode_step``).  ``max_seq``
    sizes the attention cache; an ssm config has none and takes any
    prompt."""
    b, s = tokens.shape
    max_seq = max_seq or s
    if "attn" in cfg.block_layout and s > max_seq:
        raise ValueError(f"prompt of {s} tokens does not fit max_seq="
                         f"{max_seq} (the wrapping ring is not ported)")
    cache = init_cache(cfg, b, max_seq, cfg.adtype,
                       params["embed"]["table"].device)
    x = _prompt_layers(params, cfg, tokens, cache["blocks"]["s0"])
    cache["pos"] = s
    return unembed(params["embed"], x[:, -1:], cap=cfg.final_softcap), cache


def decode_step(params, cfg: ModelConfig, token, cache):
    """One decode step.  token [B, 1] int -> (logits [B, 1, V], cache).
    The cache is updated in place (the new K/V row at ``pos``, or each
    layer's new Mamba-2 state, then ``pos + 1``) and returned."""
    check_config(cfg)
    pos, c = cache["pos"], cache["blocks"]["s0"]
    x = embed(params["embed"], token, adtype=cfg.adtype)
    if cfg.family == "ssm":
        for i, p in enumerate(params["blocks"]["s0"]):
            o, c[i] = ssm_decode_step(p["ssm"], cfg,
                                      rms_norm(x, p["norm1"], cfg.norm_eps),
                                      c[i])
            x = x + o
        return _decoded(params, cfg, x, cache)
    if pos >= c.k.shape[3]:
        raise ValueError(f"the cache holds {c.k.shape[3]} positions and is "
                         "full (the wrapping ring is not ported)")
    lengths = torch.full((x.shape[0],), pos + 1, dtype=torch.int32,
                         device=x.device)
    for i, p in enumerate(params["blocks"]["s0"]):
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + attention_decode(p["attn"], cfg, h, (c.k[i], c.v[i]), pos,
                                 lengths)
        x = _mlp_residual(p, cfg, x)
    return _decoded(params, cfg, x, cache)


def _decoded(params, cfg: ModelConfig, x, cache):
    """The step's logits from the last layer's output; ``pos`` + 1."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache["pos"] += 1
    return unembed(params["embed"], x, cap=cfg.final_softcap), cache
