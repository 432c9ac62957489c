"""AdamW with cosine schedule and global-norm clipping, over a nested tree
of tensors (dicts, lists, tuples): the update of ``repro.optim.adamw`` op
for op in float32 (the schedule and the bias corrections on an f32 step,
m and v in f32, decay on tensors of two or more dims unless the caller
says otherwise), leaf by leaf as its ``jax.tree.map`` runs, in place, its
``sqrt``, ``pow`` and ``cos`` correctly rounded.  Divisors are tensors,
never Python scalars, which the GPU would turn into a multiply by the
reciprocal."""
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


#: elements of a leaf updated together: the update's temporaries stay
#: this size, whatever the size of the leaf
CHUNK = 1 << 24


def _walk(tree, path=()):
    """(path, leaf) of a nested dict / list / tuple tree in the JAX
    package's order: a dict's keys sorted, a sequence in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _walk(t, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree) -> list:
    """The tensors of ``tree``, in the JAX package's order."""
    return [leaf for _, leaf in _walk(tree)]


def tree_paths(tree) -> list:
    """Each leaf's keys from the root, joined by ``/`` (``blocks/s0/0/
    attn/wq``), in ``tree_leaves``' order."""
    return ["/".join(map(str, path)) for path, _ in _walk(tree)]


def _build(t, it):
    if isinstance(t, dict):
        built = {k: _build(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(x, it) for x in t)
    return next(it)


def tree_unflatten(like, leaves):
    """``leaves`` (in ``tree_leaves``' order) in ``like``'s structure.  (A
    recursive closure here would hold ``leaves`` in a reference cycle
    until the garbage collector ran: a step's gradients outliving it.)"""
    return _build(like, iter(leaves))


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as an f32 0-dim tensor on ``like``'s device, filled there
    (``torch.tensor`` would copy it from the host and stall it)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


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
    leaves = tree_leaves(params)

    def zeros():
        return tree_unflatten(params, [torch.zeros_like(
            p, dtype=torch.float32) for p in leaves])
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].device),
                    mu=zeros(), nu=zeros())


def global_norm(tree, replicas=None, reduce=None) -> torch.Tensor:
    """sqrt of the sum over the leaves, in tree order, of each leaf's sum
    of squares in f32.  On a mesh the leaves are a rank's shards:
    ``replicas`` gives each leaf's count of ranks that hold the same
    shard (a power of two, so the division is exact), ``reduce`` sums the
    ranks' totals, once, so that each leaf counts once."""
    leaves = tree_leaves(tree)
    parts = (x.float().square().sum() for x in leaves)
    if replicas is not None:
        parts = (x / n if n > 1 else x for x, n in zip(parts, replicas))
    total = sum(parts)
    return _rounded(torch.sqrt, total if reduce is None else reduce(total))


def _chunks(*xs):
    """Matching pieces of same-shaped tensors ``xs``: flat slices of at
    most ``CHUNK`` elements where all are contiguous, else the whole."""
    if xs[0].numel() <= CHUNK or not all(x.is_contiguous() for x in xs):
        return [xs]
    return zip(*(x.view(-1).split(CHUNK) for x in xs))


def decays_matrices(path, leaf) -> bool:
    """The reference's decay rule on its own trees: matrices only (norms
    and biases exempt)."""
    return leaf.ndim >= 2


def adamw_update(cfg: AdamWConfig, params, grads, state: OptState, *,
                 decays=decays_matrices, replicas=None, reduce=None):
    """(params, new state, {"lr", "grad_norm"}); the norm is the one
    before clipping.  ``params``, ``grads`` and the moments are trees of
    one structure (nested dicts, lists, tuples); ``decays(path, leaf)``
    (the leaf's keys from the root) says which leaves take weight decay.
    The caller hands over ``params`` and ``state``, as the reference's
    jitted steps donate them: their tensors are updated in place, leaf by
    leaf, each in pieces of at most ``CHUNK`` elements, so the update's
    temporaries stay that small.  Nothing leaves the device.  On a mesh
    the trees are a rank's shards and the update runs on them;
    ``replicas`` and ``reduce`` make the norm global (``global_norm``), and
    ``decays`` sees the shards, whose dims the full leaves share."""
    decay = [decays(path, x) for path, x in _walk(params)]
    p, g = tree_leaves(params), tree_leaves(grads)
    mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
    step = state.step + 1
    gnorm = global_norm(grads, replicas, reduce)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(_f32(cfg.clip_norm, gnorm) / (gnorm + 1e-9),
                            max=1.0)
    lr = cosine_lr(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - _rounded(torch.pow, _f32(cfg.b1, stepf), stepf)
    b2c = 1 - _rounded(torch.pow, _f32(cfg.b2, stepf), stepf)
    for pl, gl, ml, vl, dl in zip(p, g, mu, nu, decay):
        for pc, gc, m, v in _chunks(pl, gl, ml, vl):
            gc = gc.to(torch.float32)
            if scale is not None:
                gc = gc * scale
            m.mul_(cfg.b1).add_(gc * (1 - cfg.b1))
            v.mul_(cfg.b2).add_((gc * gc) * (1 - cfg.b2))
            delta = (m / b1c) / (_rounded(torch.sqrt, v / b2c) + cfg.eps)
            p32 = pc.to(torch.float32)
            if dl:
                delta = delta + p32 * cfg.weight_decay
            pc.copy_(p32 - delta * lr)
    return (tree_unflatten(params, p),
            OptState(step=step, mu=tree_unflatten(state.mu, mu),
                     nu=tree_unflatten(state.nu, nu)),
            {"lr": lr, "grad_norm": gnorm})
