"""Shared layer primitives: norms, SiLU, tanh GeLU, the SwiGLU, GeGLU and
ungated GELU MLPs, the causal depthwise conv, embeddings, the
cross-entropy, sinusoidal positions and RoPE.

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

from repro_torch.sharding import comm


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


def gelu_tanh(x):
    """``jax.nn.gelu(approximate=True)`` with each op rounded to x's dtype,
    as XLA rounds it in bf16 (``F.gelu(approximate="tanh")`` rounds once):
    the constants are cast to x's dtype first (filled on x's device: no
    copy from the host)."""
    c, k = (torch.full((), v, dtype=x.dtype, device=x.device)
            for v in (math.sqrt(2 / math.pi), 0.044715))
    return x * (0.5 * (1 + torch.tanh(c * (x + k * x ** 3))))


def causal_conv(x, w, b):
    """x [bsz, s, ch], depthwise causal conv of width K (w [K, ch], bias b
    [ch]): the K products summed in x's dtype in order, then the bias, as
    the JAX package's prefill convs round."""
    k, s = w.shape[0], x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = pad[:, :s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return out + b


def conv_history(x, k: int):
    """The last K - 1 rows of x [bsz, s, ch] (zero rows first when s <
    K - 1): the conv's history for the next decode step."""
    tail = x[:, -(k - 1):]
    return torch.nn.functional.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------- MLP


_GATES = {"swiglu": silu, "geglu": gelu_tanh}
#: every MLP variant: the two gated ones, and whisper's ungated GELU
MLP_VARIANTS = tuple(_GATES) + ("gelu",)


def init_mlp(gen, d_model: int, d_ff: int, variant: str, dtype, device=None):
    """A gated MLP's ``w_gate``, ``w_up`` [d, d_ff] and ``w_down`` [d_ff,
    d]; the ungated ``"gelu"`` one has no ``w_gate``."""
    if variant not in MLP_VARIANTS:
        raise ValueError(f"mlp variant {variant!r} is unknown")
    names = ("w_up",) if variant == "gelu" else ("w_gate", "w_up")
    p = {n: dense_init(gen, (d_model, d_ff), dtype, device=device)
         for n in names}
    p["w_down"] = dense_init(gen, (d_ff, d_model), dtype, device=device)
    return p


def apply_mlp(params, x, variant: str):
    if variant not in MLP_VARIANTS:
        raise ValueError(f"mlp variant {variant!r} is unknown")
    if variant == "gelu":
        return gelu_tanh(x @ params["w_up"]) @ params["w_down"]
    act = _GATES[variant](x @ params["w_gate"]) * (x @ params["w_up"])
    return act @ params["w_down"]


# ---------------------------------------------------------------- embeddings


def init_embedding(gen, vocab: int, d_model: int, dtype, device=None):
    # std 1/sqrt(d): keeps tied-unembedding logits O(1) at init
    return {"table": dense_init(gen, (vocab, d_model), dtype,
                                scale=d_model ** -0.5, device=device)}


def embed(params, tokens, *, scale_by_sqrt_dim: bool = False,
          adtype=torch.bfloat16, vocab_lo=None):
    """The table's rows in the activation dtype; with ``scale_by_sqrt_dim``
    (the gemma family) times sqrt(d) rounded to that dtype first, as the
    JAX package multiplies.  With ``vocab_lo`` the table holds the rows
    [vocab_lo, vocab_lo + rows) of a vocabulary split over the mesh's
    'model' axis: each rank gives its tokens' rows, zero for the others,
    and the ranks' rows are summed over the axis."""
    table = params["table"]
    if vocab_lo is None:
        out = table[tokens].to(adtype)
    else:
        local = tokens - vocab_lo
        hit = (local >= 0) & (local < table.shape[0])
        out = (table[torch.where(hit, local, 0)].to(adtype)
               * hit[..., None].to(adtype))
        out = comm.all_reduce(out, "model")
    if scale_by_sqrt_dim:
        out = out * torch.full((), math.sqrt(params["table"].shape[1]),
                               dtype=adtype, device=out.device)
    return out


def unembed(params, x, *, cap: Optional[float] = None):
    """Logits in f32 through the tied embedding table."""
    return softcap((x @ params["table"].to(x.dtype).T).float(), cap)


def _nll(logits, labels, mask, vocab_lo=None):
    """Each row's negative log-likelihood of its label under f32 logits
    [..., V], zero where ``mask`` is False.  With ``vocab_lo`` the logits
    are the columns [vocab_lo, vocab_lo + V) of a vocabulary split over
    the mesh's 'model' axis: the softmax's max and sum and the label's
    logit are all-reduced over it."""
    if vocab_lo is None:
        gold = torch.gather(logits, -1,
                            torch.where(mask, labels, 0)[..., None])
        return (torch.logsumexp(logits, dim=-1) - gold[..., 0]) * mask
    top = comm.all_reduce_max(logits.detach().amax(dim=-1), "model")
    total = comm.all_reduce(torch.exp(logits - top[..., None]).sum(dim=-1),
                            "model")
    local = labels - vocab_lo
    hit = mask & (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(hit, local, 0)[..., None])
    gold = comm.all_reduce(gold[..., 0] * hit, "model")
    return (top + torch.log(total) - gold) * mask


def nll_sum(logits, labels, *, ignore_id: int = -1, vocab_lo=None):
    """The summed next-token negative log-likelihood of f32 logits [..., V]
    over the labels [...] that are not ``ignore_id`` (``vocab_lo``:
    ``_nll``'s)."""
    return _nll(logits, labels, labels != ignore_id, vocab_lo).sum()


def cross_entropy(logits, labels, *, ignore_id: int = -1):
    """Mean next-token cross-entropy of f32 logits [..., V] over the labels
    [...] that are not ``ignore_id``; a batch without one divides by 1."""
    mask = labels != ignore_id
    return _nll(logits, labels, mask).sum() / torch.clamp(mask.sum(), min=1)


def sinusoidal_positions(num_pos: int, dim: int, dtype=torch.float32,
                         device=None):
    """[num_pos, dim] absolute position embeddings: angle pos / 10000 **
    (2 i / dim) in f32, then [sin, cos] concatenated (not interleaved) and
    cast to ``dtype``."""
    pos = torch.arange(num_pos, dtype=torch.float32, device=device)[:, None]
    return _sin_cos(pos, dim).to(dtype)


def _sin_cos(pos, dim: int):
    """[..., dim]: [sin, cos] of pos [..., 1] (f32) over the dim // 2
    frequencies 10000 ** -(2 i / dim)."""
    i = torch.arange(dim // 2, dtype=torch.float32, device=pos.device)
    angle = pos / torch.pow(10_000.0, 2 * i / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def position_embedding(pos: int, dim: int, dtype, device=None):
    """[dim]: row ``pos`` of ``sinusoidal_positions``, computed for that
    position alone (the JAX decode step's formula), the position filled on
    the device."""
    p = torch.full((1,), pos, dtype=torch.float32, device=device)
    return _sin_cos(p, dim).to(dtype)


# ---------------------------------------------------------------- RoPE


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # theta filled on the device: ``torch.tensor`` would copy it from the
    # host, a sync on the card at every call
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
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
