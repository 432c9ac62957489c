"""AdamW with cosine schedule and global-norm clipping, over a dict or list
of tensors: the update of ``repro.optim.adamw`` op for op in float32 (the
schedule and the bias corrections on an f32 step, m and v in f32, decay on
tensors of two or more dims only), its ``sqrt``, ``pow`` and ``cos``
correctly rounded.  Divisors are tensors, never Python scalars, which the
GPU would turn into a multiply by the reciprocal."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    end_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


class OptState(NamedTuple):
    step: torch.Tensor     # int32, 0-dim
    mu: Any                # like the params, f32
    nu: Any


def _leaves(tree):
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def _like(tree, leaves):
    """``leaves`` in ``tree``'s structure (a dict's keys, or a list)."""
    return dict(zip(tree, leaves)) if isinstance(tree, dict) else leaves


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _rounded(fn, *xs: torch.Tensor) -> torch.Tensor:
    """``fn`` of f32 operands in f64, rounded once to f32: the correctly
    rounded value that XLA's f32 ``sqrt`` (and mostly its ``pow`` and
    ``cos``) gives, where torch's vectorized f32 versions on the CPU, and
    CUDA's ``powf``, may miss by an ulp (torch 2.13's f32 ``sqrt`` on an
    AVX-512 CPU does at 0.6 % of inputs in [0, 1))."""
    return fn(*(x.double() for x in xs)).to(torch.float32)


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / _f32(max(cfg.warmup_steps, 1), step)
    frac = torch.clamp((step - cfg.warmup_steps) / _f32(
        max(cfg.total_steps - cfg.warmup_steps, 1), step), 0, 1)
    cos = cfg.end_lr + 0.5 * (cfg.peak_lr - cfg.end_lr) * (
        1 + _rounded(torch.cos, math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> OptState:
    leaves = _leaves(params)
    zeros = lambda: _like(params, [torch.zeros_like(p, dtype=torch.float32)
                                   for p in leaves])
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].device),
                    mu=zeros(), nu=zeros())


def _flat(leaves) -> torch.Tensor:
    return torch.cat([x.reshape(-1).to(torch.float32) for x in leaves])


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(_flat(_leaves(tree)).square().sum())


def adamw_update(cfg: AdamWConfig, params, grads, state: OptState):
    """(new params, new state, {"lr", "grad_norm"}); the norm is the one
    before clipping.  Nothing leaves the device; each step of the formula
    is one multi-tensor launch over all leaves."""
    p, g = _leaves(params), [x.to(torch.float32) for x in _leaves(grads)]
    step = state.step + 1
    gnorm = global_norm(g)
    if cfg.clip_norm is not None:
        scale = torch.clamp(_f32(cfg.clip_norm, gnorm) / (gnorm + 1e-9),
                            max=1.0)
        g = torch._foreach_mul(g, scale)
    lr = cosine_lr(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - _rounded(torch.pow, _f32(cfg.b1, stepf), stepf)
    b2c = 1 - _rounded(torch.pow, _f32(cfg.b2, stepf), stepf)
    m = torch._foreach_add(torch._foreach_mul(_leaves(state.mu), cfg.b1),
                           torch._foreach_mul(g, 1 - cfg.b1))
    v = torch._foreach_add(torch._foreach_mul(_leaves(state.nu), cfg.b2),
                           torch._foreach_mul(torch._foreach_mul(g, g),
                                              1 - cfg.b2))
    vh = torch._foreach_div(v, b2c)
    root = _rounded(torch.sqrt, _flat(vh)).split([x.numel() for x in vh])
    delta = torch._foreach_div(
        torch._foreach_div(m, b1c),
        torch._foreach_add([r.view_as(x) for r, x in zip(root, vh)],
                           cfg.eps))
    p32 = [x.to(torch.float32) for x in p]
    # decay matrices only (norms/bias exempt)
    mats = [i for i, x in enumerate(p32) if x.ndim >= 2]
    delta = list(delta)
    if mats:
        for i, d in zip(mats, torch._foreach_add(
                [delta[i] for i in mats],
                torch._foreach_mul([p32[i] for i in mats],
                                   cfg.weight_decay))):
            delta[i] = d
    new = torch._foreach_sub(p32, torch._foreach_mul(delta, lr))
    return (_like(params, [n.to(x.dtype) for n, x in zip(new, p)]),
            OptState(step=step, mu=_like(params, list(m)),
                     nu=_like(params, list(v))),
            {"lr": lr, "grad_norm": gnorm})
