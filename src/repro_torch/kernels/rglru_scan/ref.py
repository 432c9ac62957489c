"""Plain PyTorch RG-LRU gated linear recurrence (RecurrentGemma): the JAX
package's ``kernels/rglru_scan/ref.py``, function for function.

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gates run in f32 whatever x's dtype.  ``linear_scan`` is the
recurrence h_t = a_t h_{t-1} + b_t as a sequential loop over time (the
JAX oracle runs an associative scan, which rounds in another order).
"""
from __future__ import annotations

from typing import Optional

import torch

RGLRU_C = 8.0


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def rglru_gates(x, w_a, b_a, w_x, b_x, log_lambda):
    """Per-step (a, b) of the recurrence, f32.  x [b, s, w]."""
    xf = x.float()
    r = torch.sigmoid(xf @ w_a.float() + b_a.float())
    i = torch.sigmoid(xf @ w_x.float() + b_x.float())
    log_a = -RGLRU_C * _softplus(log_lambda.float()) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably via log: 0.5*log1p(-exp(2 log_a))
    sq = torch.exp(0.5 * torch.log1p(-torch.exp(2.0 * log_a) + 1e-12))
    return a, sq * (i * xf)


def linear_scan(a, b, h0: Optional[torch.Tensor] = None):
    """h_t = a_t h_{t-1} + b_t over axis 1, from h0 (zeros when None).
    a, b [bsz, s, w] -> h [bsz, s, w] in a's dtype."""
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0.to(a.dtype)
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def rglru(x, w_a, b_a, w_x, b_x, log_lambda, h0=None, *,
          return_final_state: bool = False):
    """x [bsz, s, w] -> h [bsz, s, w] (x's dtype), and with
    ``return_final_state`` the state after the last step, f32."""
    a, b = rglru_gates(x, w_a, b_a, w_x, b_x, log_lambda)
    h = linear_scan(a, b, h0)
    if return_final_state:
        return h.to(x.dtype), h[:, -1]
    return h.to(x.dtype)


def rglru_decode_step(x, w_a, b_a, w_x, b_x, log_lambda, h_prev):
    """x [bsz, w]; h_prev [bsz, w] f32 -> (y in x's dtype, new state)."""
    a, b = rglru_gates(x[:, None], w_a, b_a, w_x, b_x, log_lambda)
    h = a[:, 0] * h_prev + b[:, 0]
    return h.to(x.dtype), h
