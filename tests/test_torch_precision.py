"""The rounding of the port's bf16 tensor-core kernels, emulated on the
CPU: ``csrc/flash_attention.cu``'s ``flash_kernel_wgmma`` and
``csrc/ssd_scan.cu``'s three bf16 passes, operation by operation in plain
PyTorch (bf16 operands, products summed in f32 per tile, the f32 operand
of each product split into bf16 parts: two for flash's P, three for the
SSD's folded operands), held to the bars that
``chip_smoke.py`` and the ``cuda`` tests apply to the kernels themselves:

- flash, bf16 output against the plain version in f32 (phase 12):
  1e-4 + 2^-8 |want| per element;
- SSD, bf16 y against the f32 plain version rounded to bf16 (phase 13):
  one bf16 ulp of |want| plus twice the f32 plain version's own error
  against f64; the final state within the JAX tests' atol 1e-4, rtol 1e-3.

A rounding scheme that misses a bar here would miss it on the card.  The
emulations live here only; no path of the port runs them.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.ssd_scan import ref as ssd_ref

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
NEG_INF = -1e30


def _parts(x, k):
    """f32 -> k bf16 values held in f32 that sum to ~8 k bits of x (the
    kernels' ``split_bf16`` for k = 2 and ``split3_bf16`` for k = 3)."""
    out = []
    for _ in range(k):
        out.append(x.bfloat16().float())
        x = x - out[-1]
    return out


def flash_emulation(q, k, v, *, window=None, softcap=None, block_k=64,
                    split=True):
    """``flash_kernel_wgmma``'s arithmetic: per K tile of ``block_k``
    columns the scores (exact bf16 products, f32 sums), scale (in log2
    units), softcap and mask, the online softmax in f32 with exp2, and P V
    with P as bf16 hi + lo (``split``) or rounded to bf16 once; the output
    rounded to bf16."""
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, kv, h // kv, s, d)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    rows = torch.arange(s)[:, None]
    m = torch.full((b, kv, h // kv, s), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for c0 in range(0, t, block_k):
        kt, vt = kf[..., c0:c0 + block_k, :], vf[..., c0:c0 + block_k, :]
        sc = qf @ kt.transpose(-1, -2)
        if softcap is not None:
            sc = torch.tanh(sc * d ** -0.5 / softcap) * softcap * LOG2E
        else:
            sc = sc * (d ** -0.5 * LOG2E)
        cols = torch.arange(c0, c0 + kt.shape[-2])[None, :]
        ok = cols <= rows
        if window is not None:
            ok &= cols > rows - window
        sc = torch.where(ok, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None]
        for part in _parts(p, 2 if split else 1):
            acc = acc + part @ vt
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, s, d).bfloat16()


def ssd_emulation(x, dt, A, B, C, D, *, chunk, parts=3):
    """The three bf16 passes of ``csrc/ssd_scan.cu`` in their order:
    chunk states sum_j split(x_j w_j dt_j)^T B_j; the carry
    S_c = exp(a_last) S_c-1 + local_c-1; then per chunk
    exp(a_cum_i) (C split(S_c)^T) + split(G') x + D x with
    G' = (C B^T) exp(a_cum_i - a_cum_j) dt_j on and below the diagonal,
    each split into ``parts`` bf16 parts.  x, B, C bf16; dt, A, D f32.
    Returns y (bf16) and the final state."""
    b, s0, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s0)
    s = -(-s0 // q) * q
    pad = s - s0
    f = torch.nn.functional.pad
    xf = f(x.float(), (0, 0, 0, 0, 0, pad)).reshape(b, -1, q, h, p)
    dtf = f(dt.float(), (0, 0, 0, pad)).reshape(b, -1, q, h)
    Bf = f(B.float(), (0, 0, 0, pad)).reshape(b, -1, q, n)
    Cf = f(C.float(), (0, 0, 0, pad)).reshape(b, -1, q, n)
    nc = xf.shape[1]
    a_cum = torch.cumsum(A.float() * dtf, dim=2)              # [b, c, q, h]
    a_last = a_cum[:, :, -1:, :]
    # pass 1: each chunk's own state, the f32 factors folded into x
    w = torch.exp(a_last - a_cum) * dtf
    local = sum(torch.einsum("bcqhp,bcqn->bchpn", t, Bf)
                for t in _parts(xf * w[..., None], parts))
    # pass 2: the carry, in f32
    state = torch.zeros((b, h, p, n))
    enter = []
    for c in range(nc):
        enter.append(state)
        state = state * torch.exp(a_last[:, c, 0])[..., None, None] \
            + local[:, c]
    enter = torch.stack(enter, 1)                             # [b, c, h, p, n]
    # pass 3: the entering state's term, then the diagonal blocks
    y = sum(torch.einsum("bcin,bchpn->bcihp", Cf, t)
            for t in _parts(enter, parts)) * torch.exp(a_cum)[..., None]
    cb = torch.einsum("bcin,bcjn->bcij", Cf, Bf)              # exact products
    below = torch.tril(torch.ones(q, q, dtype=torch.bool))
    ac = a_cum.movedim(3, 2)                                  # [b, c, h, q]
    decay = torch.where(below, torch.exp(
        torch.where(below, ac[..., :, None] - ac[..., None, :], 0.0)), 0.0)
    g = cb[:, :, None] * decay * dtf.movedim(3, 2)[..., None, :]
    y = y + sum(torch.einsum("bchij,bcjhp->bcihp", t, xf)
                for t in _parts(g, parts))
    y = y + xf * D.float()[None, None, None, :, None]
    return y.reshape(b, s, h, p)[:, :s0].bfloat16(), state


def _normal(shapes, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, np.float32)).to(dtype)
            for s in shapes]


def _flash_share(shape, kw, seed, **emu):
    """The largest share of phase 12's bar an output element takes."""
    b, h, kv, s, d = shape
    q, k, v = _normal([(b, h, s, d), (b, kv, s, d), (b, kv, s, d)], seed)
    got = flash_emulation(q, k, v, **kw, **emu).float()
    want = flash_ref.mha_reference(q.float(), k.float(), v.float(), **kw)
    return float(((got - want).abs() / (1e-4 + 2 ** -8 * want.abs())).max())


#: flash at reduced main-path shapes: llama3-8b's head dim and group
#: (64-column K tiles), recurrentgemma-2b's 10 heads of 256 over one KV
#: head (32-column tiles, window 2048)
FLASH_CASES = [((2, 4, 2, 256, 128), {}, 64),
               ((2, 4, 2, 256, 128), {"window": 64}, 64),
               ((2, 4, 2, 256, 128), {"softcap": 30.0}, 64),
               ((1, 10, 1, 128, 256), {"window": 2048}, 32)]


@pytest.mark.parametrize("shape,kw,block_k", FLASH_CASES)
def test_flash_rounding_meets_the_f32_bar(shape, kw, block_k):
    assert _flash_share(shape, kw, sum(shape), block_k=block_k) <= 1


def test_flash_needs_the_split_of_p():
    """One bf16 rounding of P misses phase 12's bar: the hi + lo split is
    what the kernel pays for it."""
    shape, kw, block_k = FLASH_CASES[0]
    assert _flash_share(shape, kw, sum(shape), block_k=block_k,
                        split=False) > 1


def _ssd_inputs(shape, seed, mamba):
    """x, B, C bf16; dt = softplus(normal); A = -linspace(1, 16, h), the
    mamba2 decays of phase 13, or -exp(normal) as in the JAX tests; D
    normal."""
    b, s, h, p, n = shape
    x, B, C = _normal([(b, s, h, p), (b, s, n), (b, s, n)], seed)
    dt, A, D = _normal([(b, s, h), (h,), (h,)], seed + 1, torch.float32)
    A = -torch.linspace(1.0, 16.0, h) if mamba else -torch.exp(A)
    return x, torch.nn.functional.softplus(dt), A, B, C, D


def _ssd_share(shape, chunk, seed, mamba, parts=3):
    """The largest share of phase 13's y bar an element takes, and the
    final state's error against the f32 plain version's."""
    args = _ssd_inputs(shape, seed, mamba)
    y, state = ssd_emulation(*args, chunk=chunk, parts=parts)
    f32 = [a.float() for a in args]
    want, want_state = ssd_ref.ssd_chunked(*f32, chunk=chunk,
                                           return_final_state=True)
    y64 = ssd_ref.ssd_chunked(*(a.double() for a in f32), chunk=chunk)
    bar32 = 2 * float((want.double() - y64).abs().max())
    _, e = torch.frexp(want.abs())
    ulp = torch.where(want == 0, 0.0, torch.ldexp(torch.ones_like(want),
                                                  e - 8))
    err = (y.float() - want.bfloat16().float()).abs()
    return float((err / (ulp + bar32)).max()), state, want_state


#: mamba2-370m's widths and chunk at a reduced batch and length, and the
#: JAX tests' shapes and decays at chunks of 8, 16 and 100 (among them
#: inputs on which two-part splits miss the bar)
SSD_CASES = [((2, 300, 4, 64, 128), 256, 0, True),
             ((1, 32, 2, 8, 4), 8, 0, False),
             ((2, 64, 4, 16, 8), 8, 0, False),
             ((2, 37, 3, 8, 4), 16, 0, False),
             ((2, 250, 3, 16, 16), 8, 19, False),
             ((2, 250, 3, 16, 16), 100, 3, False)]


@pytest.mark.parametrize("shape,chunk,seed,mamba", SSD_CASES)
def test_ssd_rounding_meets_the_bars(shape, chunk, seed, mamba):
    share, state, want_state = _ssd_share(shape, chunk, seed, mamba)
    assert share <= 1
    np.testing.assert_allclose(state.numpy(), want_state.numpy(), atol=1e-4,
                               rtol=1e-3)


def test_ssd_needs_three_parts():
    """Two bf16 parts (~16 bits) of the folded f32 operands miss the bar
    where the f32 formula's own error is small."""
    assert _ssd_share(*SSD_CASES[4], parts=2)[0] > 1
