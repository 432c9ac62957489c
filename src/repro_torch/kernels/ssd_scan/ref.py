"""Plain PyTorch Mamba-2 SSD (state-space duality) chunked scan: the JAX
package's ``ssd_chunked`` and ``ssd_decode_step``, formula for formula.

Math (per head, state dim N, head dim P):
    h_t = exp(A * dt_t) * h_{t-1} + dt_t * B_t x_t^T          (h in R^{P x N})
    y_t = C_t^T-contraction of h_t  + D * x_t

Chunked form [arXiv:2405.21060]: an intra-chunk quadratic term with the
decay matrix L[i, j] = exp(a_cum_i - a_cum_j), a_cum the cumulative sum
of A * dt over the whole chunk, plus an inter-chunk recurrence over the
per-chunk final states.  Everything runs in f32 (or in x's dtype when that
is f64, for reference runs); y comes back in x's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def segsum(a):
    """a [..., Q] -> lower-triangular M[i, j] = sum_{j<k<=i} a_k, as the
    difference of cumulative sums, -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    m = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, m, -torch.inf)


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int,
                return_final_state: bool = False):
    """x [b, s, h, p], dt [b, s, h] (softplus applied), A [h] (< 0),
    B and C [b, s, n], D [h] -> y [b, s, h, p] in x's dtype, and with
    ``return_final_state`` the state after the last token [b, h, p, n].
    The scan starts from a zero state (the model's prefill)."""
    b, s_orig, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s_orig)
    # pad seq to a chunk multiple; dt = 0 on pads => decay 1, no input =>
    # the state passes through unchanged and padded outputs are sliced off
    s = -(-s_orig // q) * q
    if s != s_orig:
        x = F.pad(x, (0, 0, 0, 0, 0, s - s_orig))
        dt = F.pad(dt, (0, 0, 0, s - s_orig))
        B = F.pad(B, (0, 0, 0, s - s_orig))
        C = F.pad(C, (0, 0, 0, s - s_orig))
    c = s // q
    f = torch.float64 if x.dtype == torch.float64 else torch.float32

    xd = (x.to(f) * dt.to(f)[..., None]).reshape(b, c, q, h, p)
    a = (A.to(f) * dt.to(f)).reshape(b, c, q, h)  # log-decay per step
    Bc = B.to(f).reshape(b, c, q, n)
    Cc = C.to(f).reshape(b, c, q, n)

    a_cum = torch.cumsum(a, dim=2)  # [b, c, q, h]

    # intra-chunk (diagonal) term
    L = torch.exp(segsum(a.movedim(3, 2)))              # [b, c, h, q, q]
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)    # [b, c, q, q]
    y_diag = torch.einsum("bchij,bcij,bcjhp->bcihp", L, scores, xd)

    # per-chunk final states
    decay_out = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # [b, c, q, h]
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bc, decay_out, xd)

    # inter-chunk recurrence over chunk states: the state entering each
    chunk_decay = torch.exp(a_cum[:, :, -1, :])         # [b, c, h]
    state = torch.zeros((b, h, p, n), dtype=f, device=x.device)
    h_in = []
    for i in range(c):
        h_in.append(state)
        state = state * chunk_decay[:, i, :, None, None] + states[:, i]
    h_in = torch.stack(h_in, dim=1)                     # [b, c, h, p, n]

    # inter-chunk (off-diagonal) output term
    decay_in = torch.exp(a_cum)
    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc, decay_in, h_in)

    y = (y_diag + y_off).reshape(b, s, h, p)
    y = y + x.to(f) * D.to(f)[None, None, :, None]
    y = y[:, :s_orig].to(x.dtype)
    if return_final_state:
        return y, state
    return y


def ssd_decode_step(x, dt, A, B, C, D, state):
    """Single-token recurrence.  x [b, h, p]; dt [b, h]; B, C [b, n];
    state [b, h, p, n] f32 -> (y [b, h, p] in x's dtype, new state)."""
    f32 = torch.float32
    xf, dtf = x.to(f32), dt.to(f32)
    decay = torch.exp(A.to(f32)[None] * dtf)            # [b, h]
    upd = torch.einsum("bhp,bn->bhpn", xf * dtf[..., None], B.to(f32))
    new_state = state * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C.to(f32))
    y = y + xf * D.to(f32)[None, :, None]
    return y.to(x.dtype), new_state
