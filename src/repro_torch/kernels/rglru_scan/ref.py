"""Plain PyTorch RG-LRU gated linear recurrence (RecurrentGemma): the JAX
package's ``kernels/rglru_scan/ref.py``, function for function.

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gates run in f32 whatever x's dtype.  ``linear_scan`` is the
recurrence h_t = a_t h_{t-1} + b_t as a sequential loop over time (the
JAX oracle runs an associative scan, which rounds in another order).

One departure from the JAX package, in the gradient only: the derivative
of sqrt(1 - a^2) is bounded (``SQRT_MAX_GRADIENT``), as RecurrentGemma's
own implementation bounds it.  The JAX formula's gradient there is
-a^2 / sqrt(1 - a^2); once r_t is small enough that a_t rounds to 1 in
f32, the 1e-12 under the root is lost to rounding and that gradient is
inf times 0, NaN, which reaches every parameter.
"""
from __future__ import annotations

from typing import Optional

import torch

RGLRU_C = 8.0
#: the largest derivative of the square root in sqrt(1 - a^2)
SQRT_MAX_GRADIENT = 1000.0


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


class _SqrtOneMinusSquare(torch.autograd.Function):
    """sqrt(1 - a^2) of a = exp(log_a), the JAX package's expression bit
    for bit, whose derivative -a^2 / sqrt(1 - a^2) takes the square root's
    derivative 1 / (2 sqrt(x)) at most ``SQRT_MAX_GRADIENT``: -a^2 /
    max(sqrt(1 - a^2), 1 / (2 SQRT_MAX_GRADIENT))."""

    @staticmethod
    def forward(ctx, log_a):
        a2 = torch.exp(2.0 * log_a)
        # sqrt(1 - a^2) computed stably via log: 0.5*log1p(-exp(2 log_a))
        sq = torch.exp(0.5 * torch.log1p(-a2 + 1e-12))
        ctx.save_for_backward(a2, sq)
        return sq

    @staticmethod
    def backward(ctx, g):
        a2, sq = ctx.saved_tensors
        return g * -a2 / sq.clamp(min=0.5 / SQRT_MAX_GRADIENT)


def rglru_gates(x, w_a, b_a, w_x, b_x, log_lambda):
    """Per-step (a, b) of the recurrence, f32.  x [b, s, w]."""
    xf = x.float()
    r = torch.sigmoid(xf @ w_a.float() + b_a.float())
    i = torch.sigmoid(xf @ w_x.float() + b_x.float())
    log_a = -RGLRU_C * _softplus(log_lambda.float()) * r
    a = torch.exp(log_a)
    return a, _SqrtOneMinusSquare.apply(log_a) * (i * xf)


def linear_scan(a, b, h0: Optional[torch.Tensor] = None):
    """h_t = a_t h_{t-1} + b_t over axis 1, from h0 (zeros when None).
    a, b [bsz, s, w] -> h [bsz, s, w] in a's dtype."""
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0.to(a.dtype)
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def linear_scan_backward_reference(a, h, dh, h0=None):
    """The gradient of ``linear_scan`` at the cotangent ``dh`` of its
    output ``h`` -> (da, db, dh0; dh0 None without h0), as a sequential
    reverse loop: g_t = dh_t + a_{t+1} g_{t+1}, da_t = g_t h_{t-1} (h_{-1}
    = h0 or 0), db_t = g_t, dh0 = a_0 g_0.  The product and the sum round
    apart, as in the forward loop."""
    da, db = torch.empty_like(a), torch.empty_like(a)
    carry = None
    for t in reversed(range(a.shape[1])):
        g = dh[:, t] if carry is None else dh[:, t] + carry
        db[:, t] = g
        if t > 0:
            da[:, t] = g * h[:, t - 1]
        else:
            da[:, 0] = g * (torch.zeros_like(g) if h0 is None
                            else h0.to(a.dtype))
        carry = a[:, t] * g
    return da, db, None if h0 is None else carry.to(h0.dtype)


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
