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


def ssd_backward_reference(x, dt, A, B, C, D, dy, *, chunk: int,
                           d_state=None):
    """The gradient of ``ssd_chunked`` at the cotangent ``dy`` [b, s, h, p]
    of y (and ``d_state`` [b, h, p, n] of the final state, or none) ->
    (dx, ddt, dA, dB, dC, dD), in f32 (f64 for f64 x), chunk by chunk by
    the forward's formulas.  With xd_j = x_j dt_j, a_cum the chunk-wide
    cumulative sum of A dt, L_ij = exp(a_cum_i - a_cum_j) (j <= i), S_c
    the state entering chunk c and G_c the gradient of the state leaving
    it (taken over the chunks in reverse from ``d_state``):

        dC_i  = sum_j L_ij (dy_i . xd_j) B_j + exp(a_cum_i) S_c^T dy_i
        dB_j  = sum_i L_ij (dy_i . xd_j) C_i + w_j G_c^T xd_j
        dxd_j = sum_i L_ij (C_i . B_j) dy_i  + w_j G_c B_j

    with w_j = exp(a_last - a_cum_j), dB and dC summed over heads.  Each
    exp term adds its value to d a_cum of its first index and takes it
    from its second; a_last also gets exp(a_last) <G_c, S_c>.  da is the
    reverse cumulative sum of d a_cum within the chunk; dx = dt dxd + D dy,
    ddt = x . dxd + A da, dA = sum dt da, dD = sum dy . x."""
    b, s_orig, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s_orig)
    s = -(-s_orig // q) * q
    if s != s_orig:
        x = F.pad(x, (0, 0, 0, 0, 0, s - s_orig))
        dy = F.pad(dy, (0, 0, 0, 0, 0, s - s_orig))
        dt = F.pad(dt, (0, 0, 0, s - s_orig))
        B = F.pad(B, (0, 0, 0, s - s_orig))
        C = F.pad(C, (0, 0, 0, s - s_orig))
    c = s // q
    f = torch.float64 if x.dtype == torch.float64 else torch.float32

    xf = x.to(f).reshape(b, c, q, h, p)
    dtf = dt.to(f).reshape(b, c, q, h)
    Af = A.to(f)
    xd = xf * dtf[..., None]
    a = Af * dtf
    Bc = B.to(f).reshape(b, c, q, n)
    Cc = C.to(f).reshape(b, c, q, n)
    dyc = dy.to(f).reshape(b, c, q, h, p)
    a_cum = torch.cumsum(a, dim=2)                      # [b, c, q, h]
    a_last = a_cum[:, :, -1]                            # [b, c, h]

    # the states entering each chunk, as the forward computes them
    decay_out = torch.exp(a_last[:, :, None] - a_cum)   # [b, c, q, h]
    local = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bc, decay_out, xd)
    chunk_decay = torch.exp(a_last)                     # [b, c, h]
    state = torch.zeros((b, h, p, n), dtype=f, device=x.device)
    h_in = []
    for i in range(c):
        h_in.append(state)
        state = state * chunk_decay[:, i, :, None, None] + local[:, i]
    h_in = torch.stack(h_in, dim=1)                     # [b, c, h, p, n]

    # the gradient of the state leaving each chunk, in reverse
    decay_in = torch.exp(a_cum)
    g_local = torch.einsum("bcqh,bcqhp,bcqn->bchpn", decay_in, dyc, Cc)
    g = (torch.zeros((b, h, p, n), dtype=f, device=x.device)
         if d_state is None else d_state.to(f))
    g_out = [None] * c
    for i in reversed(range(c)):
        g_out[i] = g
        g = g_local[:, i] + chunk_decay[:, i, :, None, None] * g
    g_out = torch.stack(g_out, dim=1)                   # [b, c, h, p, n]

    # the intra-chunk (diagonal) terms: L is 0 above the diagonal
    L = torch.exp(segsum(a.movedim(3, 2)))              # [b, c, h, q, q]
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)    # C_i . B_j
    m = L * torch.einsum("bcihp,bcjhp->bchij", dyc, xd)  # L (dy_i . xd_j)
    t = m * scores[:, :, None]                          # [b, c, h, i, j]
    dC = torch.einsum("bchij,bcjn->bcin", m, Bc)
    dB = torch.einsum("bchij,bcin->bcjn", m, Cc)
    dxd = torch.einsum("bchij,bcij,bcihp->bcjhp", L, scores, dyc)
    d_acum = (t.sum(-1) - t.sum(-2)).movedim(2, 3)      # [b, c, q, h]

    # the off-diagonal term and the states
    u = torch.einsum("bcqhp,bchpn->bcqhn", dyc, h_in)   # S_c^T dy_i
    dC = dC + torch.einsum("bcqh,bcqhn->bcqn", decay_in, u)
    d_acum = d_acum + decay_in * torch.einsum("bcqhn,bcqn->bcqh", u, Cc)
    gb = torch.einsum("bchpn,bcqn->bcqhp", g_out, Bc)   # G_c B_j
    dB = dB + torch.einsum("bcqh,bchpn,bcqhp->bcqn", decay_out, g_out, xd)
    dxd = dxd + decay_out[..., None] * gb
    st = decay_out * (xd * gb).sum(-1)                  # [b, c, q, h]
    d_acum = d_acum - st
    d_acum[:, :, -1] += st.sum(2) + chunk_decay * (g_out * h_in).sum((-2, -1))

    da = torch.flip(torch.cumsum(torch.flip(d_acum, (2,)), dim=2), (2,))
    dx = dtf[..., None] * dxd + D.to(f)[:, None] * dyc
    ddt = (xf * dxd).sum(-1) + Af * da
    dA = (dtf * da).sum((0, 1, 2))
    dD = (dyc * xf).sum((0, 1, 2, 4))
    return (dx.reshape(b, s, h, p)[:, :s_orig],
            ddt.reshape(b, s, h)[:, :s_orig], dA,
            dB.reshape(b, s, n)[:, :s_orig],
            dC.reshape(b, s, n)[:, :s_orig], dD)


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
