"""Mixture-of-Experts layer: top-k routing and the dropless expert path.

The JAX package's single-device path (``moe_ragged``) sorts the (token,
expert) pairs by expert, runs ``lax.ragged_dot`` over the groups and
scatter-adds the k weighted outputs of each token in the activation dtype:
every token gets its top-k experts' SiLU-gated MLPs, weighted by the
renormalised router weights.  The port computes that function in two
forms, by the device of the tokens:

* on the CPU, the reference's own (``_experts_sorted``): the sorted rows
  split at each expert's group size (read on the host), one product per
  expert, and the k weighted outputs of a token added one at a time in
  expert-sorted order in the activation dtype, as XLA's scatter-add does
  (``index_add_`` would add them in f32 and round once), so a bf16 result
  rounds as the reference's does;
* on the card, one with no host read (``_experts_all``): every expert
  over every token (products over the stacked [E, d, ff] weights), each
  expert's hidden row scaled by the token's combine weight (zero off its
  top-k), then one product over the experts' concatenated hidden rows and
  stacked down-projections, accumulated in f32 in a fixed order.  That is
  deterministic (bf16 atomics in ``index_add_`` on the card are not) and
  adds the k outputs before rounding.  It runs E / k times the sorted
  form's expert operations; a decode batch reads nearly every expert's
  weights either way.

The router stays f32.  ``moe_capacity_local`` runs in the reference only
under a mesh; here it is a plain function for its relations to
``moe_ragged`` and nothing on the serving path calls it.
"""
from __future__ import annotations

import torch

from .base import ModelConfig
from .layers import apply_mlp, dense_init, init_mlp, silu


def init_moe(gen, cfg: ModelConfig, dtype, device=None):
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": dense_init(gen, (d, e), torch.float32, device=device),
         "w_gate": dense_init(gen, (e, d, ff), dtype, device=device),
         "w_up": dense_init(gen, (e, d, ff), dtype, device=device),
         "w_down": dense_init(gen, (e, ff, d), dtype, device=device)}
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, d, cfg.num_shared_experts * ff, "swiglu",
                               dtype, device)
    return p


def route_topk(router_w, x_flat, top_k: int):
    """(weights [T,k], expert_ids [T,k], router_probs [T,E]), in f32.  A
    stable descending sort puts the lower expert id first among equal
    probabilities, as ``lax.top_k`` does."""
    probs = torch.softmax(x_flat.float() @ router_w, dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :top_k], ids[:, :top_k]
    return weights / weights.sum(dim=-1, keepdim=True), ids, probs


def _dispatch(cfg: ModelConfig, router_w, x_flat):
    """Route, then sort the (token, expert) pairs stably by expert id:
    (token of each sorted pair, its weight, expert ids [T,k], group sizes
    [E] int32, router probs)."""
    t = x_flat.shape[0]
    k, e = cfg.moe_top_k, cfg.num_experts
    weights, ids, probs = route_topk(router_w, x_flat, k)
    flat_ids = ids.reshape(t * k)
    token_idx = torch.arange(t, device=x_flat.device).repeat_interleave(k)
    order = torch.argsort(flat_ids, stable=True)
    group_sizes = torch.bincount(flat_ids, minlength=e).to(torch.int32)
    return (token_idx[order], weights.reshape(t * k)[order], ids,
            group_sizes, probs)


def _aux_loss(cfg: ModelConfig, ids, probs, t: int):
    """Switch-style load-balance loss: E * sum_e f_e * P_e / k."""
    counts = torch.zeros((t, cfg.num_experts), device=probs.device).scatter_(
        1, ids, 1.0)
    f, pbar = counts.mean(dim=0), probs.mean(dim=0)
    return cfg.num_experts * (f * pbar).sum() / cfg.moe_top_k


def _add_in_order(sorted_tok, rows, t: int):
    """Each token's ``rows`` (k of them, in sorted order) added to zero one
    at a time in that order, in the rows' dtype: the reference's
    ``zeros.at[sorted_tok].add(rows)``."""
    pos = torch.argsort(sorted_tok, stable=True).view(t, -1)
    out = torch.zeros((t, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    for j in range(pos.shape[1]):
        out = out + rows[pos[:, j]]
    return out


def _expert(p, e: int, rows):
    return (silu(rows @ p["w_gate"][e]) * (rows @ p["w_up"][e])) \
        @ p["w_down"][e]


def _experts_sorted(p, x_flat, sorted_tok, sorted_w, group_sizes):
    """The reference's form: one product per expert over its group of the
    sorted rows, the weighted outputs added in sorted order."""
    xs = x_flat[sorted_tok]
    y = torch.cat([_expert(p, e, rows) for e, rows in
                   enumerate(xs.split(group_sizes.tolist()))])
    return _add_in_order(sorted_tok, y * sorted_w.to(x_flat.dtype)[:, None],
                         x_flat.shape[0])


def _experts_all(p, x_flat, weights, ids):
    """Every expert over every token, combined by one product: no host
    read, a fixed order of the adds."""
    t = x_flat.shape[0]
    e, ff, d = p["w_down"].shape
    combine = torch.zeros((t, e), device=x_flat.device).scatter_(
        1, ids, weights).to(x_flat.dtype)
    h = silu(x_flat @ p["w_gate"]) * (x_flat @ p["w_up"])       # [E, T, ff]
    h = h * combine.T[:, :, None]
    return h.permute(1, 0, 2).reshape(t, e * ff) @ p["w_down"].reshape(
        e * ff, d)


def moe_ragged(p, cfg: ModelConfig, x_flat, *, aux: bool = True):
    """x_flat [T, d] -> (out [T, d] in x's dtype, the load-balance loss, or
    None without ``aux``): every token's top-k experts, SiLU-gated and
    weighted, with no token dropped."""
    t = x_flat.shape[0]
    if x_flat.is_cuda:
        weights, ids, probs = route_topk(p["router"], x_flat, cfg.moe_top_k)
        out = _experts_all(p, x_flat, weights, ids)
    else:
        sorted_tok, sorted_w, ids, sizes, probs = _dispatch(cfg, p["router"],
                                                            x_flat)
        out = _experts_sorted(p, x_flat, sorted_tok, sorted_w, sizes)
    return out, (_aux_loss(cfg, ids, probs, t) if aux else None)


def moe_capacity_local(p, cfg: ModelConfig, x_flat):
    """The reference's capacity-bounded expert scan over the sorted rows:
    each expert takes a window of ``capacity`` rows from its group's
    offset, in ascending expert order, so a later expert's write overrides
    the masked tail of the previous window; rows past an expert's capacity
    are dropped."""
    t, d = x_flat.shape
    e, k = cfg.num_experts, cfg.moe_top_k
    sorted_tok, sorted_w, ids, group_sizes, probs = _dispatch(
        cfg, p["router"], x_flat)
    cap = int(-(-t * k * cfg.moe_capacity_factor // e))  # ceil
    cap = max(((cap + 7) // 8) * 8, 8)
    sizes = group_sizes.tolist()
    xs = torch.nn.functional.pad(x_flat[sorted_tok], (0, 0, 0, cap))
    y = torch.zeros_like(xs)
    off = 0
    for i, size in enumerate(sizes):
        mask = (torch.arange(cap, device=xs.device) < size)[:, None]
        y[off:off + cap] = _expert(p, i, xs[off:off + cap]) * mask.to(
            xs.dtype)
        off += size
    out = _add_in_order(sorted_tok,
                        y[:t * k] * sorted_w.to(x_flat.dtype)[:, None], t)
    return out, _aux_loss(cfg, ids, probs, t)


def apply_moe(p, cfg: ModelConfig, x, *, return_aux: bool = False):
    """x [B,S,d] -> [B,S,d] (and the load-balance loss): ``moe_ragged``,
    plus the shared experts' MLP when the config has them."""
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    out, aux = moe_ragged(p, cfg, x_flat, aux=return_aux)
    if cfg.num_shared_experts:
        out = out + apply_mlp(p["shared"], x_flat, "swiglu")
    out = out.reshape(b, s, d)
    return (out, aux) if return_aux else out
