"""Mixture-of-Experts layer: top-k routing and the dropless expert path.

The JAX package's single-device path (``moe_ragged``) sorts the (token,
expert) pairs by expert, runs ``lax.ragged_dot`` over the groups and
scatter-adds the k weighted outputs of each token in the activation dtype:
every token gets its top-k experts' SiLU-gated MLPs, weighted by the
renormalised router weights.  The port computes that function in two
forms:

* the reference's own (``_experts_sorted``): the sorted rows, one grouped
  product per weight over the experts' groups (``torch._grouped_mm``, the
  group ends kept on the tokens' device, so nothing is read on the host),
  and the k weighted outputs of a token added one at a time in
  expert-sorted order in the activation dtype, as XLA's scatter-add does
  (``index_add_`` would add them in f32 and round once), so a bf16 result
  rounds as the reference's does.  On the CPU the grouped product is the
  per-group ``mm``, bit for bit;
* every expert over every token (``_experts_all``): products over the
  stacked [E, d, ff] weights, each expert's hidden row scaled by the
  token's combine weight (zero off its top-k), then one product over the
  experts' concatenated hidden rows and stacked down-projections,
  accumulated in f32 in a fixed order.  It runs E / k times the sorted
  form's expert operations, which a decode batch pays anyway: its few
  tokens read nearly every expert's weights.

The card runs the sorted form on bf16 batches whose every-expert form
would take at least ``SORTED_MIN_MACS`` multiply-adds a product (T x E x
d x ff), and the every-expert form on the rest: the grouped product keeps
its group ends on the card only in bf16 (in f32 it reads them on the
host), and below that size the sorted form's fixed cost (the sort, the
gathers, k adds) loses to the every-expert products.  The CPU runs the
sorted form; the meta device, where the dry run measures a training
step's memory, follows the card's rule (``runs_sorted``).  The router
stays f32.  ``moe_capacity_local`` runs in the reference only under a
mesh; here it is a plain function for its relations to ``moe_ragged``
and nothing on the serving path calls it.
"""
from __future__ import annotations

import torch

from .base import ModelConfig
from .layers import apply_mlp, dense_init, init_mlp, silu

#: the every-expert form's multiply-adds a product (T x E x d x ff) from
#: which the card runs the sorted form on a bf16 batch.  On an NVIDIA H100
#: 80GB HBM3 at 700 W (``chip_smoke.py`` phase 37) the sorted form's device
#: time is the lower from ~2.5e10 (deepseek-v2-lite's T = 128), but it
#: issues about three times the launches: its call time was the longer at
#: deepseek-v2-lite's T = 256 (4.7e10) and granite's T = 2048 (3.4e10),
#: the shorter at deepseek-v2-lite's T = 512 (9.4e10) and granite's
#: T = 8192 (1.4e11)
SORTED_MIN_MACS = 6e10


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
    [E] int32, router probs).  Nothing is read on the host (``bincount``
    on the card would read its input's range)."""
    t = x_flat.shape[0]
    k, e = cfg.moe_top_k, cfg.num_experts
    weights, ids, probs = route_topk(router_w, x_flat, k)
    flat_ids = ids.reshape(t * k)
    token_idx = torch.arange(t, device=x_flat.device).repeat_interleave(k)
    order = torch.argsort(flat_ids, stable=True)
    group_sizes = torch.zeros(e, dtype=torch.int32,
                              device=x_flat.device).scatter_add_(
        0, flat_ids, torch.ones_like(flat_ids, dtype=torch.int32))
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
    """The reference's form: each expert's MLP over its group of the sorted
    rows (grouped products, group ends on the rows' device), the weighted
    outputs added in sorted order."""
    xs = x_flat[sorted_tok]
    ends = torch.cumsum(group_sizes, 0, dtype=torch.int32)

    def grouped(rows, w):
        return torch._grouped_mm(rows, w, offs=ends)

    y = grouped(silu(grouped(xs, p["w_gate"])) * grouped(xs, p["w_up"]),
                p["w_down"])
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


def runs_sorted(cfg: ModelConfig, x_flat) -> bool:
    """Whether ``moe_ragged`` runs the sorted form on ``x_flat`` [T, d]:
    always on the CPU; on any other device (the card, the meta device) on
    bf16 batches of at least ``SORTED_MIN_MACS`` multiply-adds a
    product."""
    t, d = x_flat.shape
    return x_flat.device.type == "cpu" or (
        x_flat.dtype == torch.bfloat16
        and t * cfg.num_experts * d * cfg.moe_d_ff >= SORTED_MIN_MACS)


def moe_ragged(p, cfg: ModelConfig, x_flat, *, aux: bool = True):
    """x_flat [T, d] -> (out [T, d] in x's dtype, the load-balance loss, or
    None without ``aux``): every token's top-k experts, SiLU-gated and
    weighted, with no token dropped."""
    t = x_flat.shape[0]
    if runs_sorted(cfg, x_flat):
        sorted_tok, sorted_w, ids, sizes, probs = _dispatch(cfg, p["router"],
                                                            x_flat)
        out = _experts_sorted(p, x_flat, sorted_tok, sorted_w, sizes)
    else:
        weights, ids, probs = route_topk(p["router"], x_flat, cfg.moe_top_k)
        out = _experts_all(p, x_flat, weights, ids)
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
