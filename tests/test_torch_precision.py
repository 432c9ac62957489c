"""The rounding of the port's bf16 tensor-core kernels, emulated on the
CPU: ``csrc/flash_attention.cu``'s ``flash_kernel_wgmma``, its backward
``csrc/flash_attention_bwd.cu``'s two ``wgmma`` kernels,
``csrc/decode_attention.cu``'s ``decode_kernel_mma``,
``csrc/ssd_scan.cu``'s three bf16 passes and its backward's bf16 kernels
(``csrc/ssd_scan_bwd.cu``, ``tc``), operation by operation in plain
PyTorch (bf16 operands, products summed in f32 per tile, the f32 operand
of each product split into bf16 parts: two for the forward attention
kernels' P, three for the backward's P and dS and for the SSD's folded
operands and its backward's), held to the bars that ``chip_smoke.py`` and
the ``cuda`` tests apply to the kernels themselves:

- flash and decode, bf16 output against the plain version in f32 (phase
  12): 1e-4 + 2^-8 |want| per element;
- the flash backward, bf16 gradients against the plain backward in f64
  (phase 43, ``tests/test_torch_lm_flash_grad.py``): 4 times the f32
  plain backward's own largest error + 1e-7 + 2^-8 |want|;
- SSD, bf16 y against the f32 plain version rounded to bf16 (phase 13):
  one bf16 ulp of |want| plus twice the f32 plain version's own error
  against f64; the final state within the JAX tests' atol 1e-4, rtol 1e-3;
- the SSD backward, bf16 gradients against the plain backward in f64
  (phase 46, ``tests/test_torch_scan_grads.py``): 4 times the f32 plain
  backward's own largest error + 1e-7 + 2^-8 |want|.

A rounding scheme that misses a bar here would miss it on the card.  The
same goes for the Canny kernel's two schemes, which must give the plain
version's bits: hysteresis on bit-packed rows (``hysteresis_bits``) and
64 x 64 output tiles each computed on its own window, the tile and a
12-pixel halo clipped to the frame (``canny_by_windows``).  The
emulations live here only; no path of the port runs them.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.canny_fused import ref as canny_ref
from repro_torch.kernels.decode_attention import ref as decode_ref
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


def flash_emulation(q, k, v, *, causal=True, window=None, softcap=None,
                    block_k=64, split=True):
    """``flash_kernel_wgmma``'s arithmetic: per K tile of ``block_k``
    columns the scores (exact bf16 products, f32 sums), scale (in log2
    units), softcap and mask (causal or not), the online softmax in f32
    with exp2, and P V with P as bf16 hi + lo (``split``) or rounded to
    bf16 once; the output rounded to bf16."""
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
        ok = cols <= rows if causal else torch.ones(s, kt.shape[-2],
                                                    dtype=torch.bool)
        if window is not None:
            ok = ok & (cols > rows - window)
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


def _flash_share(shape, kw, seed, t=None, **emu):
    """The largest share of phase 12's bar an output element takes, over
    keys of ``t`` rows (default S)."""
    b, h, kv, s, d = shape
    t = t or s
    q, k, v = _normal([(b, h, s, d), (b, kv, t, d), (b, kv, t, d)], seed)
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


#: flash without the causal mask, T != S: whisper's encoder (MHA, D = 64,
#: T = S ragged past the last 64-column tile), its cross-attention (S the
#: prompt, T the frames), and the generic cases (GQA, D = 32 and 256, S >
#: T, a window or a softcap without the mask)
NONCAUSAL_CASES = [((2, 4, 4, 100, 64), 100, {}, 64),
                   ((2, 4, 4, 48, 64), 300, {}, 64),
                   ((2, 4, 2, 37, 32), 130, {}, 64),
                   ((2, 4, 2, 200, 128), 150, {"window": 96}, 64),
                   ((2, 4, 2, 64, 128), 200, {"softcap": 30.0}, 64),
                   ((1, 10, 1, 70, 256), 90, {}, 32)]


@pytest.mark.parametrize("shape,t,kw,block_k", NONCAUSAL_CASES)
def test_flash_noncausal_rounding_meets_the_f32_bar(shape, t, kw, block_k):
    assert _flash_share(shape, {"causal": False, **kw}, sum(shape) + t, t,
                        block_k=block_k) <= 1


def test_flash_needs_the_split_of_p():
    """One bf16 rounding of P misses phase 12's bar: the hi + lo split is
    what the kernel pays for it."""
    shape, kw, block_k = FLASH_CASES[0]
    assert _flash_share(shape, kw, sum(shape), block_k=block_k,
                        split=False) > 1


def flash_bwd_emulation(q, k, v, do, *, causal=True, window=None,
                        softcap=None, p_parts=3, ds_parts=3, rounded=True):
    """The bf16 backward kernels' arithmetic (``csrc/flash_attention_bwd.cu``,
    ``flash_bwd_dq_wgmma`` then ``flash_bwd_dkv_wgmma``): S and dP from
    exact bf16 products summed in f32; scale, softcap and mask in log2
    units; the dQ kernel's first pass over its key tiles (64 columns, 32
    at D = 256) carrying each row's max, sum of exp2 and sum of P dP
    online, then 1 / l and Delta; P = exp2(s - m) / l and dS = P (dP -
    Delta) ds/dx; dQ summed a key tile at a time, dK and dV a (head of the
    group, 64-row Q tile) at a time in the kernels' order, P and dS each
    split into ``p_parts`` and ``ds_parts`` bf16 parts against the exact
    bf16 K, Q and dO; the gradients rounded to bf16 (``rounded``) or kept
    in f32."""
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    g, bk = h // kv, 32 if d == 256 else 64
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    qf = q.float().reshape(b, kv, g, s, d)
    dof = do.float().reshape(b, kv, g, s, d)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    x = qf @ kf.transpose(-1, -2)
    dp = dof @ vf.transpose(-1, -2)
    if softcap is not None:
        th = torch.tanh(x * scale / softcap)
        sc, dcap = th * softcap * LOG2E, 1 - th * th
    else:
        sc, dcap = x * (scale * LOG2E), 1.0
    rows, cols = torch.arange(s)[:, None], torch.arange(t)[None, :]
    ok = cols <= rows if causal else torch.ones(s, t, dtype=torch.bool)
    if window is not None:
        ok = ok & (cols > rows - window)
    sc = torch.where(ok, sc, NEG_INF)
    m = torch.full((b, kv, g, s), NEG_INF)
    l, pd = torch.zeros_like(m), torch.zeros_like(m)
    for c0 in range(0, t, bk):
        tile = sc[..., c0:c0 + bk]
        m_new = torch.maximum(m, tile.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(tile - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pd = pd * alpha + (p * dp[..., c0:c0 + bk]).sum(-1)
        m = m_new
    inv_l = torch.where(l > 0, 1 / l, 0.0)
    delta = pd * inv_l
    p = torch.where(ok, torch.exp2(sc - m[..., None]) * inv_l[..., None], 0.0)
    ds = p * (dp - delta[..., None]) * dcap
    dq = torch.zeros_like(qf)
    for c0 in range(0, t, bk):
        for part in _parts(ds[..., c0:c0 + bk], ds_parts):
            dq = dq + part @ kf[..., c0:c0 + bk, :]
    dk, dv = torch.zeros(b, kv, t, d), torch.zeros(b, kv, t, d)
    for gi in range(g):
        for r0 in range(0, s, 64):
            rs = slice(r0, r0 + 64)
            for part in _parts(p[:, :, gi, rs].transpose(-1, -2), p_parts):
                dv = dv + part @ dof[:, :, gi, rs]
            for part in _parts(ds[:, :, gi, rs].transpose(-1, -2), ds_parts):
                dk = dk + part @ qf[:, :, gi, rs]
    out = ((dq * scale).reshape(b, h, s, d), dk * scale, dv)
    return tuple(x.bfloat16() for x in out) if rounded else out


def _flash_bwd_shares(shape, kw, seed, pre=False, **emu):
    """Per gradient (dq, dk, dv), the largest share of the backward
    kernel's bar (``tests/test_torch_lm_flash_grad.py::kernel_close``,
    phase 43) an element takes: against the plain backward in f64 from the
    same bf16 inputs, 4 times the f32 plain backward's own largest error +
    1e-7 + 2^-8 |want|; ``pre``: the emulation's gradients before their
    rounding to bf16, against 4 times that error alone."""
    b, h, kv, s, t, d = shape
    q, k, v, do = _normal([(b, h, s, d), (b, kv, t, d), (b, kv, t, d),
                           (b, h, s, d)], seed)
    got = flash_bwd_emulation(q, k, v, do, **kw, **emu, rounded=not pre)
    want = flash_ref.mha_backward_reference(
        *(x.double() for x in (q, k, v, do)), **kw)
    plain = flash_ref.mha_backward_reference(
        *(x.float() for x in (q, k, v, do)), **kw)
    shares = []
    for g, w, p32 in zip(got, want, plain):
        e32 = float((p32.double() - w).abs().max())
        bar = 4 * e32 + (0.0 if pre else 1e-7 + 2 ** -8 * w.abs())
        shares.append(float(((g.double() - w).abs() / bar).max()))
    return shares


#: the backward at reduced main-path shapes: llama3-8b's D 128 at G 4
#: (causal), whisper-small's D 64 at G 1 without the mask and S != T,
#: gemma2-9b's D 256 with a window and the softcap (32-column key tiles),
#: and D 32 (B, H, KV, S, T, D)
FLASH_BWD_CASES = [((1, 8, 2, 256, 256, 128), {}),
                   ((2, 4, 4, 150, 200, 64), {"causal": False}),
                   ((1, 4, 2, 192, 192, 256), {"window": 96,
                                               "softcap": 50.0}),
                   ((2, 4, 2, 160, 160, 32), {})]


@pytest.mark.parametrize("shape,kw", FLASH_BWD_CASES)
def test_flash_bwd_rounding_meets_the_kernel_bar(shape, kw):
    assert max(_flash_bwd_shares(shape, kw, sum(shape))) <= 1


@pytest.mark.parametrize("shape,kw", FLASH_BWD_CASES)
def test_flash_bwd_three_parts_round_like_f32(shape, kw):
    """Before the gradients' rounding to bf16, P and dS in three bf16 parts
    stay within 4 times the f32 plain backward's error; in two (hi + lo,
    as the forward takes P) they do not, and the bar above would hold them
    only through its 2^-8 |want| term, by where values fall between bf16
    neighbours."""
    seed = sum(shape)
    assert max(_flash_bwd_shares(shape, kw, seed, pre=True)) <= 1
    assert max(_flash_bwd_shares(shape, kw, seed, pre=True, p_parts=2,
                                 ds_parts=2)) > 1


def test_flash_bwd_needs_the_split_of_ds():
    """One bf16 rounding of dS (P still in three parts) misses the bar."""
    shape, kw = FLASH_BWD_CASES[0]
    assert max(_flash_bwd_shares(shape, kw, sum(shape), ds_parts=1)) > 1


def _softmax_merge(states):
    """(max, denom, acc) of several online-softmax states in log2 units,
    merged as the decode kernel merges its warps and its splits."""
    m = torch.stack([st[0] for st in states])
    w = torch.exp2(m - m.amax(0))
    return (m.amax(0), (torch.stack([st[1] for st in states]) * w).sum(0),
            (torch.stack([st[2] for st in states]) * w[..., None]).sum(0))


def decode_emulation(q, k, v, lengths, *, window=None, softcap=None,
                     block_k=64, split=True, chunk=None):
    """``decode_kernel_mma``'s arithmetic: each split of ``chunk`` cache
    rows (one piece when None) in block tiles of ``block_k`` rows, of
    which each of ``block_k // 16`` warps takes 16 and keeps its own
    online softmax (exact bf16 products summed in f32, scale and softcap
    in log2 units, exp2, P V with P as bf16 hi + lo (``split``) or rounded
    to bf16 once); the warps' states merged, then the splits'; the output
    rounded to bf16."""
    b, h, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    out = torch.empty(b, h, d)
    for bi in range(b):
        n = int(lengths[bi])
        lo = max(0, n - window) if window is not None else 0
        qf = q[bi].float().reshape(kv, h // kv, d)
        kf, vf = k[bi].float(), v[bi].float()
        states = []
        for s0 in range(0, t, chunk or t):
            begin, end = max(lo, s0), min(n, t, s0 + (chunk or t))
            warps = [(torch.full((kv, h // kv), NEG_INF),
                      torch.zeros(kv, h // kv), torch.zeros(kv, h // kv, d))
                     for _ in range(block_k // 16)]
            for c0 in range(begin, end, block_k):
                for w, (m, l, acc) in enumerate(warps):
                    r0 = c0 + 16 * w
                    if r0 >= end:
                        continue
                    sc = qf @ kf[:, r0:min(r0 + 16, end)].transpose(-1, -2)
                    if softcap is not None:
                        sc = torch.tanh(sc * d ** -0.5 / softcap) \
                            * softcap * LOG2E
                    else:
                        sc = sc * (d ** -0.5 * LOG2E)
                    m_new = torch.maximum(m, sc.amax(-1))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(sc - m_new[..., None])
                    acc = acc * alpha[..., None]
                    for part in _parts(p, 2 if split else 1):
                        acc = acc + part @ vf[:, r0:r0 + p.shape[-1]]
                    warps[w] = (m_new, l * alpha + p.sum(-1), acc)
            states.append(_softmax_merge(warps))
        _, l, acc = _softmax_merge(states)
        out[bi] = (acc / l.clamp_min(1e-30)[..., None]).reshape(h, d)
    return out.bfloat16()


def _decode_share(shape, kw, lengths, **emu):
    """The largest share of phase 12's bar an output element takes."""
    b, h, kv, t, d = shape
    q, k, v = _normal([(b, h, d), (b, kv, t, d), (b, kv, t, d)], sum(shape))
    lens = torch.tensor(lengths, dtype=torch.int32)
    got = decode_emulation(q, k, v, lens, **kw, **emu).float()
    want = decode_ref.decode_reference(q.float(), k.float(), v.float(), lens,
                                       **kw)
    return float(((got - want).abs() / (1e-4 + 2 ** -8 * want.abs())).max())


#: decode at reduced main-path shapes: llama3-8b's head dim and group 4,
#: qwen2.5-3b's group 8 (64-row block tiles of 4 warps), recurrentgemma-2b's
#: group 10 at D = 256 with window 2048 (32-row tiles of 2 warps), a softcap;
#: each with lengths random, 1, full and short, in one piece and in splits
DECODE_CASES = [((3, 8, 2, 300, 128), {}, 64),
                ((3, 16, 2, 270, 128), {}, 64),
                ((3, 10, 1, 300, 256), {"window": 2048}, 32),
                ((3, 8, 2, 300, 128), {"softcap": 25.0}, 64)]
DECODE_LENGTHS = {"random": lambda t: np.random.default_rng(t).integers(
                      1, t + 1, 3),
                  "one": lambda t: np.ones(3, int),
                  "full": lambda t: np.full(3, t),
                  "short": lambda t: np.array([2, 3, 5])}


@pytest.mark.parametrize("lengths", DECODE_LENGTHS)
@pytest.mark.parametrize("shape,kw,block_k", DECODE_CASES)
def test_decode_rounding_meets_the_f32_bar(shape, kw, block_k, lengths):
    lens = DECODE_LENGTHS[lengths](shape[3])
    for chunk in (None, 64):
        assert _decode_share(shape, kw, lens, block_k=block_k,
                             chunk=chunk) <= 1


def test_decode_needs_the_split_of_p():
    """One bf16 rounding of P misses phase 12's bar (by ~14x at short
    lengths, where each probability weighs most)."""
    shape, kw, block_k = DECODE_CASES[0]
    assert _decode_share(shape, kw, DECODE_LENGTHS["short"](0),
                         block_k=block_k, split=False) > 1


def _pack(x):
    """[H, W] bool -> [H, ceil(W / 32)] int64 words of 32 bits: bit c of
    word s is column 32 s + c, as ``__ballot_sync`` packs a warp's row."""
    h, w = x.shape
    nseg = -(-w // 32)
    bits = torch.zeros(h, nseg * 32, dtype=torch.int64)
    bits[:, :w] = x
    return (bits.reshape(h, nseg, 32) << torch.arange(32)).sum(-1)


def _unpack(words, w):
    bits = (words[..., None] >> torch.arange(32)) & 1
    return bits.reshape(words.shape[0], -1)[:, :w].bool()


def hysteresis_bits(strong, weak, iters=canny_ref.HYSTERESIS_ITERS):
    """The Canny kernel's hysteresis on packed rows: each round ORs every
    word with its shifts by one column (carrying across words) and with
    the rows above and below (zero past the edges), then ANDs weak."""
    st, wk = _pack(strong), _pack(weak)
    word = 0xFFFFFFFF
    zcol = torch.zeros(st.shape[0], 1, dtype=torch.int64)
    zrow = torch.zeros(1, st.shape[1], dtype=torch.int64)
    for _ in range(iters):
        prev = torch.cat([zcol, st[:, :-1]], 1)   # word s - 1
        nxt = torch.cat([st[:, 1:], zcol], 1)     # word s + 1
        hd = (st | ((st << 1) & word) | (prev >> 31) | (st >> 1)
              | ((nxt << 31) & word))
        st = wk & (torch.cat([zrow, hd[:-1]]) | hd
                   | torch.cat([hd[1:], zrow]))
    return _unpack(st, strong.shape[1])


def _thin(h, w, seed):
    """A random thinned-magnitude frame with strong (> 1.0) and weak
    (> 0.6) pixels, strong edges sparse and weak ones plentiful."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.choice(
        np.float32([0.0, 0.7, 1.5]), (h, w), p=[0.35, 0.6, 0.05]))


@pytest.mark.parametrize("widths", [range(1, 65), range(65, 131)],
                         ids=["1-64", "65-130"])
def test_packed_hysteresis_equals_the_plain_version(widths):
    for w in widths:
        for h in (1, 7, 40):
            thin = _thin(h, w, 1000 * h + w)
            got = hysteresis_bits(thin > 1.0, thin > 0.6)
            assert torch.equal(got, canny_ref.hysteresis(thin[None], 0.6,
                                                         1.0)[0]), (h, w)


@pytest.mark.parametrize("array,frame", [((64, 128), (64, 64)),
                                         ((64, 64), (64, 64)),
                                         ((64, 128), (37, 100)),
                                         ((130, 96), (129, 65))])
def test_packed_hysteresis_at_ragged_dims(array, frame):
    """Strong and weak False past the frame's true extent, as the kernel
    thresholds them: the frame's hysteresis, False beyond it."""
    thin = torch.zeros(array)
    thin[:frame[0], :frame[1]] = _thin(*frame, sum(frame))
    want = torch.zeros(array, dtype=torch.bool)
    want[:frame[0], :frame[1]] = canny_ref.hysteresis(
        thin[None, :frame[0], :frame[1]], 0.6, 1.0)[0]
    assert torch.equal(hysteresis_bits(thin > 1.0, thin > 0.6), want)


def canny_dir(gx, gy):
    """The Canny kernel's direction bin without atan2 (its ``canny_dir``):
    0 below tan(pi / 8), 2 above tan(3 pi / 8), 1 or 3 between (by the
    signs), where |gy| / |gx| lies 2^-10 of itself clear of both; -1 where
    the kernel asks atan2."""
    t1, t2 = np.float32(0.414213562373095), np.float32(2.414213562373095)
    e = np.float32(1 / 1024)
    ax, ay = np.abs(gx), np.abs(gy)
    ok = (ax + ay > np.float32(1e-30)) & (ax + ay < np.float32(1e30))
    out = np.full(gx.shape, -1)
    low = ok & (ay < ax * np.float32(t1 * (1 - e)))
    high = ok & ~low & (ay > ax * np.float32(t2 * (1 + e)))
    mid = ok & ~low & ~high & (ay > ax * np.float32(t1 * (1 + e))) \
        & (ay < ax * np.float32(t2 * (1 - e)))
    out[low], out[high] = 0, 2
    out[mid] = np.where((gx[mid] > 0) == (gy[mid] > 0), 1, 3)
    return out


def test_canny_direction_without_atan2_where_it_decides():
    """Wherever the kernel skips atan2, its bin is the plain version's, at
    random angles, at angles within ~1e-3 rad of every bin edge, and at
    magnitudes from 1e-26 to 1e26."""
    rng = np.random.default_rng(0)
    ang = np.concatenate([rng.uniform(-np.pi, np.pi, 200_000), np.repeat(
        np.pi / 8 * np.arange(-8, 9), 2000) + rng.normal(0, 1e-3, 34_000)])
    r = np.exp(rng.uniform(-60, 60, ang.size))
    gx = (r * np.cos(ang)).astype(np.float32)
    gy = (r * np.sin(ang)).astype(np.float32)
    got = canny_dir(gx, gy)
    quarter = torch.tensor(np.float32(np.pi / 4))
    angle = torch.atan2(torch.from_numpy(gy), torch.from_numpy(gx))
    want = (torch.round(angle / quarter).to(torch.int32) % 4).numpy()
    decided = got >= 0
    assert decided.mean() > 0.95
    np.testing.assert_array_equal(got[decided], want[decided])


def canny_by_windows(img, h, w, lo, hi, tile=64,
                     halo=4 + canny_ref.HYSTERESIS_ITERS):
    """The Canny kernel's tiling of one [H, W] frame whose true extent is
    h x w: each tile of the array is cut from the plain version run on its
    window, the tile and ``halo`` pixels around it clipped to the true
    extent, with the frame's edge rules at the window's edges; False past
    the true extent."""
    out = torch.zeros(img.shape, dtype=torch.bool)
    for r in range(0, img.shape[0], tile):
        for c in range(0, img.shape[1], tile):
            r0, c0 = max(0, r - halo), max(0, c - halo)
            r1, c1 = min(h, r + tile + halo), min(w, c + tile + halo)
            if r1 <= r0 or c1 <= c0:
                continue
            win = canny_ref.canny_edge(img[None, r0:r1, c0:c1], lo, hi)[0]
            got = win[r - r0:r - r0 + tile, c - c0:c - c0 + tile]
            out[r:r + got.shape[0], c:c + got.shape[1]] = got
    return out


@pytest.mark.parametrize("array,frame", [((64, 64), (64, 64)),
                                         ((64, 128), (41, 64)),
                                         ((150, 200), (150, 200)),
                                         ((192, 256), (150, 200)),
                                         ((65, 64), (65, 64))])
@pytest.mark.parametrize("lo,hi", [(0.2, 0.5), (0.1, 0.4), (0.05, 0.1)])
def test_canny_by_windows_equals_the_plain_version(array, frame, lo, hi):
    """A halo of 2 (blur) + 1 (Sobel) + 1 (NMS) + 8 (hysteresis) pixels
    keeps every tile exact."""
    img = torch.from_numpy(np.random.default_rng(sum(frame)).random(
        array, np.float32))
    h, w = frame
    want = torch.zeros(array, dtype=torch.bool)
    want[:h, :w] = canny_ref.canny_edge(img[None, :h, :w], lo, hi)[0]
    assert torch.equal(canny_by_windows(img, h, w, lo, hi), want)


def test_canny_by_windows_needs_the_hysteresis_halo():
    """A halo that covers the stencils and only 2 of the 8 hysteresis
    rounds gets tiles wrong."""
    img = torch.from_numpy(np.random.default_rng(1).random((130, 130),
                                                           np.float32))
    want = canny_ref.canny_edge(img[None], 0.1, 0.4)[0]
    assert not torch.equal(canny_by_windows(img, 130, 130, 0.1, 0.4,
                                            halo=6), want)


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


def ssd_bwd_emulation(x, dt, A, B, C, D, dy, *, chunk, d_state=None,
                      m_parts=3, l_parts=3, parts=3, group=2, summed=8):
    """The bf16 backward kernels' arithmetic (``csrc/ssd_scan_bwd.cu``,
    ``tc``): a_cum in f32; the chunks' own states from x w dt and dy
    exp(a_cum), each split into ``parts`` bf16 parts against exact B and
    C; the carries in f32, S_c and G_c split in ``parts``; per chunk
    C B^T and P = dy x^T from exact bf16 products summed in f32, M = L (P
    dt_j), T = M (C B^T) formed once in f64 with d a_cum's row and column
    sums; M summed in f32 over each ``group`` of heads, those sums over
    each ``summed`` heads, split into ``m_parts`` against B (dC) and C
    (dB); L o C B^T split into
    ``l_parts`` against dy (dxd); the state terms; d a_cum's reverse sum,
    ddt, dA and dD in f64.  x, B, C, dy bf16; dt, A, D, d_state f32.
    Returns (dx, ddt, dA, dB, dC, dD) rounded as the kernels round them."""
    b, s0, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s0)
    s = -(-s0 // q) * q
    pad = s - s0
    f = torch.nn.functional.pad
    xf = f(x.float(), (0, 0, 0, 0, 0, pad)).reshape(b, -1, q, h, p)
    dyf = f(dy.float(), (0, 0, 0, 0, 0, pad)).reshape(b, -1, q, h, p)
    dtf = f(dt.float(), (0, 0, 0, pad)).reshape(b, -1, q, h)
    Bf = f(B.float(), (0, 0, 0, pad)).reshape(b, -1, q, n)
    Cf = f(C.float(), (0, 0, 0, pad)).reshape(b, -1, q, n)
    nc = xf.shape[1]
    a_cum = torch.cumsum(A.float() * dtf, dim=2)              # [b, c, q, h]
    a_last = a_cum[:, :, -1]                                  # [b, c, h]
    w = torch.exp(a_last[:, :, None] - a_cum)                 # w_j
    ea = torch.exp(a_cum)

    def split(t, k):
        return _parts(t, k)

    own_s = sum(torch.einsum("bcqhp,bcqn->bchpn", t, Bf)
                for t in split(xf * (w * dtf)[..., None], parts))
    own_g = sum(torch.einsum("bcqhp,bcqn->bchpn", t, Cf)
                for t in split(dyf * ea[..., None], parts))
    S = [torch.zeros(b, h, p, n)]
    for c in range(nc - 1):
        S.append(S[-1] * torch.exp(a_last[:, c])[..., None, None]
                 + own_s[:, c])
    G = [torch.zeros(b, h, p, n) if d_state is None else d_state.float()]
    for c in range(nc - 1, 0, -1):
        G.insert(0, own_g[:, c] + torch.exp(a_last[:, c])[..., None, None]
                 * G[0])
    S, G = torch.stack(S, 1), torch.stack(G, 1)               # [b,c,h,p,n]
    gs = (G * S).sum((-2, -1))

    below = torch.tril(torch.ones(q, q, dtype=torch.bool))
    ac = a_cum.movedim(3, 2)                                  # [b, c, h, q]
    L = torch.where(below, torch.exp(torch.where(
        below, ac[..., :, None] - ac[..., None, :], 0.0)), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", Cf, Bf)
    pm = torch.einsum("bcihp,bcjhp->bchij", dyf, xf)
    m = L * (pm * dtf.movedim(3, 2)[..., None, :])            # [b,c,h,i,j]
    t = m.double() * cb[:, :, None].double()
    d_acum = (t.sum(-1) - t.sum(-2)).movedim(2, 3)            # [b, c, q, h]
    # M over each group of 2 heads, those sums over each 8 heads, in f32
    msum = torch.stack([m[:, :, g0:g0 + group].sum(2)
                        for g0 in range(0, h, group)], 2)     # [b,c,g,i,j]
    per = summed // group
    msum = torch.stack([msum[:, :, g0:g0 + per].sum(2)
                        for g0 in range(0, msum.shape[2], per)], 2)
    dC = sum(torch.einsum("bcgij,bcjn->bcin", t, Bf)
             for t in split(msum, m_parts))
    dB = sum(torch.einsum("bcgij,bcin->bcjn", t, Cf)
             for t in split(msum, m_parts))
    dxd = sum(torch.einsum("bchij,bcihp->bcjhp", t, dyf)
              for t in split(L * cb[:, :, None], l_parts))
    # the entering state's terms (S_0 = 0) and the leaving gradient's
    u = sum(torch.einsum("bcqhp,bchpn->bcqhn", dyf, t) for t in split(S, parts))
    dC = dC + (ea[..., None] * u).sum(3)
    d_acum = d_acum + (ea * (u * Cf[:, :, :, None]).sum(-1)).double()
    gb = sum(torch.einsum("bcqn,bchpn->bcqhp", Bf, t) for t in split(G, parts))
    v = sum(torch.einsum("bcqhp,bchpn->bcqhn", xf, t) for t in split(G, parts))
    dB = dB + ((w * dtf)[..., None] * v).sum(3)
    dxd = dxd + w[..., None] * gb
    st = w * ((xf * dtf[..., None]) * gb).sum(-1)
    d_acum = d_acum - st.double()
    d_acum[:, :, -1] += st.double().sum(2) + torch.exp(
        a_last.double()) * gs.double()
    da = torch.flip(torch.cumsum(torch.flip(d_acum, (2,)), 2), (2,))
    ddt = ((xf * dxd).sum(-1).double() + A.double() * da).float()
    dA = (dtf.double() * da).sum((0, 1, 2)).float()
    dD = (dyf * xf).sum(-1).double().sum((0, 1, 2)).float()
    dx = dtf[..., None] * dxd + D.float()[:, None] * dyf
    cut = (slice(None), slice(0, s0))
    return (dx.reshape(b, s, h, p)[cut].bfloat16(),
            ddt.reshape(b, s, h)[cut], dA, dB.reshape(b, s, n)[cut].bfloat16(),
            dC.reshape(b, s, n)[cut].bfloat16(), dD)


def _ssd_bwd_shares(shape, chunk, seed, with_state, mamba=False, **emu):
    """Per gradient (dx, ddt, dA, dB, dC, dD), the largest share of phase
    46's bar an element takes: against the plain backward in f64 from the
    same bf16 inputs, 4 times the f32 plain backward's own largest error +
    1e-7 + 2^-8 |want|.  Inputs as ``tests/test_torch_scan_grads.py``
    draws them; ``mamba``: A = -linspace(1, 16, h), mamba2-370m's decays."""
    b, s, h, p, n = shape
    rng = np.random.default_rng(seed)
    x, dt, A, B, C, D, dy = (rng.standard_normal(z) for z in (
        (b, s, h, p), (b, s, h), h, (b, s, n), (b, s, n), h, (b, s, h, p)))
    ds = rng.standard_normal((b, h, p, n)) if with_state else None
    dt = np.log1p(np.exp(dt))
    A = -np.linspace(1.0, 16.0, h) if mamba else -np.exp(A)
    x, B, C, dy = (torch.from_numpy(a).bfloat16() for a in (x, B, C, dy))
    dt, A, D = (torch.from_numpy(a).float() for a in (dt, A, D))
    ds = None if ds is None else torch.from_numpy(ds).float()
    got = ssd_bwd_emulation(x, dt, A, B, C, D, dy, chunk=chunk, d_state=ds,
                            **emu)
    args = (x, dt, A, B, C, D, dy)
    want, plain = (ssd_ref.ssd_backward_reference(
        *(a.to(fl) for a in args), chunk=chunk,
        d_state=None if ds is None else ds.to(fl))
        for fl in (torch.float64, torch.float32))
    shares = []
    for g, w, p32 in zip(got, want, plain):
        e32 = float((p32.double() - w).abs().max())
        bar = 4 * e32 + 1e-7 + 2 ** -8 * w.abs()
        shares.append(float(((g.double() - w).abs() / bar).max()))
    return shares


#: the SSD backward's cases of ``tests/test_torch_scan_grads.py``
#: (the JAX tests' shapes and chunks, a ragged S, d_state) and one
#: 256-row chunk with mamba2-370m's decays at narrow widths
SSD_BWD_CASES = [((1, 32, 2, 8, 4), 8, False, False),
                 ((1, 32, 2, 8, 4), 16, False, False),
                 ((2, 64, 4, 16, 8), 8, False, False),
                 ((2, 64, 4, 16, 8), 16, True, False),
                 ((2, 37, 3, 8, 4), 16, False, False),
                 ((2, 37, 3, 8, 4), 16, True, False),
                 ((1, 300, 2, 16, 16), 256, True, True)]


@pytest.mark.parametrize("group,summed", [(2, 8), (1, 1)])
@pytest.mark.parametrize("shape,chunk,with_state,mamba", SSD_BWD_CASES)
def test_ssd_bwd_rounding_meets_the_kernel_bar(shape, chunk, with_state,
                                               mamba, group, summed):
    """M summed over 2 heads and those sums over 8, as at mamba2-370m's
    widths, or taken head by head, as the kernels do where fewer heads a
    block fill the card."""
    shares = _ssd_bwd_shares(shape, chunk, sum(shape), with_state, mamba,
                             group=group, summed=summed)
    assert max(shares) <= 1, shares


@pytest.mark.parametrize("split", ["m_parts", "l_parts"])
def test_ssd_bwd_needs_the_split_of_its_f32_operands(split):
    """One bf16 rounding of M (against B and C) or of L o C B^T (against
    dy) misses the bar by far, the other operands still in three parts;
    two parts of every f32 operand meet it in these cases, as three do."""
    for shape, chunk, with_state, mamba in (SSD_BWD_CASES[2],
                                            SSD_BWD_CASES[-1]):
        seed = sum(shape)
        assert max(_ssd_bwd_shares(shape, chunk, seed, with_state, mamba,
                                   **{split: 1})) > 10
        assert max(_ssd_bwd_shares(shape, chunk, seed, with_state, mamba,
                                   m_parts=2, l_parts=2, parts=2)) <= 1
