"""Shared layer primitives: norms, SiLU, the SwiGLU MLP, embeddings and
RoPE.

``init_*`` builds a parameter sub-tree (a dict of tensors), the apply
functions take (params, x).  Matrices are stored in the activation dtype:
the JAX package keeps them in f32 and casts them at every use
(``x @ w.astype(adt)``), which gives the same values.  Norms, logits and
RoPE run in f32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init, drawn in f32 on ``device`` from
    ``gen`` (a generator on that device) and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(std).to(dtype)


def rms_norm(x, weight, eps: float = 1e-6, *, plus_one: bool = True):
    """RMS norm in f32.  ``plus_one``: the weight is stored as (w - 1), the
    convention of the JAX models' residual norms; the Mamba-2 block's gated
    norm takes the weight as it is (``plus_one=False``)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = w + 1.0
    return (x * w).to(dtype)


def silu(x):
    """x / (1 + exp(-x)) with each op rounded to x's dtype: the JAX
    package's ``jax.nn.silu`` in bf16 rounds there too, where ``F.silu``
    would round once."""
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------- MLP


def init_mlp(gen, d_model: int, d_ff: int, variant: str, dtype, device=None):
    if variant != "swiglu":
        raise ValueError(f"mlp variant {variant!r} is not ported yet")
    return {"w_gate": dense_init(gen, (d_model, d_ff), dtype, device=device),
            "w_up": dense_init(gen, (d_model, d_ff), dtype, device=device),
            "w_down": dense_init(gen, (d_ff, d_model), dtype, device=device)}


def apply_mlp(params, x, variant: str):
    if variant != "swiglu":
        raise ValueError(f"mlp variant {variant!r} is not ported yet")
    act = silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return act @ params["w_down"]


# ---------------------------------------------------------------- embeddings


def init_embedding(gen, vocab: int, d_model: int, dtype, device=None):
    # std 1/sqrt(d): keeps tied-unembedding logits O(1) at init
    return {"table": dense_init(gen, (vocab, d_model), dtype,
                                scale=d_model ** -0.5, device=device)}


def embed(params, tokens, *, adtype=torch.bfloat16):
    return params["table"][tokens].to(adtype)


def unembed(params, x, *, cap: Optional[float] = None):
    """Logits in f32 through the tied embedding table."""
    return softcap((x @ params["table"].to(x.dtype).T).float(), cap)


# ---------------------------------------------------------------- RoPE


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D] (or [..., S, D]); positions: [..., S].  Half-split
    rotation (not interleaved), in f32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # [D/2]
    angles = positions[..., None].float() * freqs              # [..., S, D/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    if x.dim() == angles.dim() + 1:  # head axis present
        sin, cos = sin[..., None, :], cos[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
