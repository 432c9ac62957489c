"""The gradients of ``kernels.ssd_scan`` and ``kernels.rglru_scan``: the
plain backwards (``ref.ssd_backward_reference``,
``ref.linear_scan_backward_reference``) against the vjp of the JAX
package's oracles and against autograd through the port's plain versions,
on the CPU; the backward kernels (``csrc/ssd_scan_bwd.cu``,
``rglru_scan_backward`` in ``csrc/rglru_scan.cu``) against the plain
backwards on a GPU (marked ``cuda``; skipped on a machine without one).

Bars.  The SSD's plain backward in f32 against ``jax.vjp`` in f32: the
forward tests' atol 2e-4 with rtol 1e-3 for every gradient, the sums over
(batch, seq) and heads (dA, dD, dB, dC) too: at these shapes none needs
more (the largest error is under a fifth of the bar).  In f64 against
autograd through the port's ``ref.ssd_chunked``: 1e-10 of each gradient's
largest |value|.  The RG-LRU's plain backward equals autograd through the
port's sequential ``ref.linear_scan`` bit for bit; against ``jax.vjp`` of
the JAX associative scan, which rounds in another order, atol 1e-5 with
rtol 1e-5.  The kernels against the plain backward computed in f64 from
the same inputs: within four times the f32 plain backward's own largest
error against that f64 result (plus 1e-7), and for bf16 inputs also the
rounding of each output to bf16 (2^-8 of each value); two calls give equal
bits; the RG-LRU kernel equals the f32 plain backward bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan import ref as jax_lru
from repro.kernels.ssd_scan import ref as jax_ssd
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.rglru_scan import ref as lru_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref

torch.set_num_threads(1)

NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")

#: (b, s, h, p, n), chunk, and whether the final state gets a cotangent:
#: the JAX tests' shapes and chunks, a ragged S and a nonzero d_state
SSD_CASES = [((1, 32, 2, 8, 4), 8, False), ((1, 32, 2, 8, 4), 16, False),
             ((2, 64, 4, 16, 8), 8, False), ((2, 64, 4, 16, 8), 16, True),
             ((2, 37, 3, 8, 4), 16, False), ((2, 37, 3, 8, 4), 16, True)]


def _ssd_draw(shape, seed, with_state, dtype=np.float32):
    """x, dt (softplus applied), A (< 0), B, C, D, dy and d_state (None
    unless ``with_state``) as numpy arrays of ``dtype``."""
    b, s, h, p, n = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))
    A = -np.exp(rng.standard_normal(h))
    B = rng.standard_normal((b, s, n))
    C = rng.standard_normal((b, s, n))
    D = rng.standard_normal(h)
    dy = rng.standard_normal((b, s, h, p))
    ds = rng.standard_normal((b, h, p, n)) if with_state else None
    return [None if a is None else a.astype(dtype)
            for a in (x, dt, A, B, C, D, dy, ds)]


@pytest.mark.parametrize("shape,chunk,with_state", SSD_CASES)
def test_ssd_plain_backward_equals_the_vjp_of_the_jax_oracle(
        shape, chunk, with_state):
    *arrays, dy, ds = _ssd_draw(shape, sum(shape) + chunk, with_state)

    @jax.jit
    def vjp(args, cots):
        return jax.vjp(lambda *a: jax_ssd.ssd_chunked(
            *a, chunk=chunk, return_final_state=True), *args)[1](cots)
    b, _, h, p, n = shape
    want = vjp(tuple(map(jnp.asarray, arrays)),
               (jnp.asarray(dy), jnp.zeros((b, h, p, n), jnp.float32)
                if ds is None else jnp.asarray(ds)))
    got = ssd_ref.ssd_backward_reference(
        *map(torch.from_numpy, arrays), torch.from_numpy(dy), chunk=chunk,
        d_state=None if ds is None else torch.from_numpy(ds))
    for name, g, w, a in zip(NAMES, got, want, arrays):
        assert g.dtype == torch.float32 and g.shape == a.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("shape,chunk,with_state", SSD_CASES)
def test_ssd_plain_backward_equals_autograd_in_f64(shape, chunk,
                                                   with_state):
    *arrays, dy, ds = (None if a is None else torch.from_numpy(a)
                       for a in _ssd_draw(shape, chunk, with_state,
                                          np.float64))
    leaves = [a.clone().requires_grad_() for a in arrays]
    y, state = ssd_ref.ssd_chunked(*leaves, chunk=chunk,
                                   return_final_state=True)
    outs, cots = ((y, state), (dy, ds)) if ds is not None else ((y,), (dy,))
    want = torch.autograd.grad(outs, leaves, cots)
    got = ssd_ref.ssd_backward_reference(*arrays, dy, chunk=chunk,
                                         d_state=ds)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64, name
        torch.testing.assert_close(
            g, w, rtol=0, atol=1e-10 * float(w.abs().max()), msg=name)


def test_ssd_cpu_call_is_differentiated_through_the_plain_version():
    """On CPU tensors ``ops.ssd`` is the plain version, which autograd
    differentiates, and no backward launch is counted."""
    *arrays, dy, _ = (None if a is None else torch.from_numpy(a)
                      for a in _ssd_draw((2, 40, 3, 8, 4), 3, False,
                                         np.float64))
    before = ssd_ops.backward_launches
    leaves = [a.clone().requires_grad_() for a in arrays]
    got = torch.autograd.grad(ssd_ops.ssd(*leaves, chunk=16), leaves, dy)
    want = ssd_ref.ssd_backward_reference(*arrays, dy, chunk=16)
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-10 * float(w.abs().max()),
                                   msg=name)
    assert ssd_ops.backward_launches == before


def _lru_draw(shape, seed, with_h0):
    """a in (0, 1), b, dh and h0 (None unless ``with_h0``), f32 numpy."""
    bsz, s, w = shape
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    dh = rng.standard_normal(shape).astype(np.float32)
    h0 = rng.standard_normal((bsz, w)).astype(np.float32) if with_h0 \
        else None
    return a, b, dh, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", [(2, 33, 8), (1, 100, 5)])
def test_lru_plain_backward_equals_the_vjp_and_autograd(shape, with_h0):
    a, b, dh, h0 = _lru_draw(shape, sum(shape), with_h0)
    ins = (a, b) if h0 is None else (a, b, h0)
    want = jax.jit(lambda args, cot: jax.vjp(jax_lru.linear_scan, *args)[1](
        cot))(tuple(map(jnp.asarray, ins)), jnp.asarray(dh))
    t = [torch.from_numpy(x).requires_grad_() for x in ins]
    h = lru_ref.linear_scan(*t)
    auto = torch.autograd.grad(h, t, torch.from_numpy(dh))
    got = lru_ref.linear_scan_backward_reference(
        t[0].detach(), h.detach(), torch.from_numpy(dh),
        None if h0 is None else t[2].detach())
    assert (got[2] is None) == (h0 is None)
    for g, w, au in zip(got, want, auto):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
        assert torch.equal(g, au)


def test_lru_cpu_call_is_differentiated_through_the_plain_version():
    a, b, dh, h0 = (torch.from_numpy(x)
                    for x in _lru_draw((2, 20, 6), 4, True))
    before = lru_ops.backward_launches
    t = [x.clone().requires_grad_() for x in (a, b, h0)]
    got = torch.autograd.grad(lru_ops.linear_scan(*t), t, dh)
    h = lru_ref.linear_scan(a, b, h0)
    want = lru_ref.linear_scan_backward_reference(a, h, dh, h0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert lru_ops.backward_launches == before


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the backward kernels run on the "
                    "card, and this machine has no GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def ssd_kernel_close(name, got, x, dt, A, B, C, D, dy, chunk, ds=None):
    """Hold the kernel's six gradients to the plain backward in f64 at the
    module docstring's bar."""
    args = (x, dt, A, B, C, D, dy)
    want = ssd_ref.ssd_backward_reference(
        *(t.double() for t in args), chunk=chunk,
        d_state=None if ds is None else ds.double())
    plain = ssd_ref.ssd_backward_reference(
        *(t.float() for t in args), chunk=chunk,
        d_state=None if ds is None else ds.float())
    rel = 2.0 ** -8 if x.dtype == torch.bfloat16 else 0.0
    for part, g, w, p, a in zip(NAMES, got, want, plain, args):
        assert g.dtype == a.dtype and g.shape == a.shape, part
        e32 = float((p.double() - w).abs().max())
        err = (g.double() - w).abs()
        assert bool((err <= 4 * e32 + 1e-7 + rel * w.abs()).all()), (
            f"{name} {part}: off by up to {float(err.max())} (the f32 plain "
            f"backward's own error {e32})")


def _ssd_on(dev, shape, seed, dtype, with_state=False):
    *arrays, dy, ds = _ssd_draw(shape, seed, with_state)
    t = [torch.from_numpy(a).to(dev) for a in arrays]
    for i in (0, 3, 4):   # x, B, C in the working type
        t[i] = t[i].to(dtype)
    dy = torch.from_numpy(dy).to(dev, dtype)
    return t, dy, None if ds is None else torch.from_numpy(ds).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk,with_state",
                         SSD_CASES + [((2, 300, 4, 64, 128), 256, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_kernel_matches_the_plain_backward(
        cuda, shape, chunk, with_state, dtype):
    arrays, dy, ds = _ssd_on(cuda, shape, sum(shape), dtype, with_state)
    ssd_ops.backward_launches = 0
    runs = []
    for _ in range(2):
        leaves = [a.clone().requires_grad_() for a in arrays]
        y, state = ssd_ops.ssd(*leaves, chunk=chunk, return_final_state=True)
        outs, cots = ((y, state), (dy, ds)) if ds is not None else (
            (y,), (dy,))
        runs.append(torch.autograd.grad(outs, leaves, cots))
    torch.cuda.synchronize()
    assert ssd_ops.backward_launches == 2
    ssd_kernel_close(f"{shape} {chunk} {dtype}", runs[0], *arrays, dy,
                     chunk, ds)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_kernel_da_is_nearer_exact_than_the_f32_plain(cuda,
                                                                   dtype):
    """dA comes from d a_cum, row sums minus column sums of T that nearly
    cancel over a 256-row chunk: the kernel adds each T_ij up in f64 (the
    bf16 kernels form each T tile once), so its dA lies nearer the f64
    plain backward than the f32 plain backward's does (summed in f32 it
    lay 3x further), from f32 or bf16 inputs alike."""
    shape, chunk = (2, 300, 4, 64, 128), 256
    arrays, dy, ds = _ssd_on(cuda, shape, sum(shape), dtype, True)
    got = ssd_ops._launch_backward(*arrays, dy, ds, chunk)[2]
    args = (*arrays, dy)
    want, plain = (ssd_ref.ssd_backward_reference(
        *(t.to(f) for t in args), chunk=chunk, d_state=ds.to(f))[2]
        for f in (torch.float64, torch.float32))
    err = float((got.double() - want).abs().max())
    e32 = float((plain.double() - want).abs().max())
    assert err < e32, (err, e32)


@pytest.mark.cuda
def test_ssd_backward_kernel_reads_the_models_strided_views(cuda):
    """x, B and C as column views of one [b, s, h p + 2 n + 1] tensor at
    an odd element offset, as the Mamba-2 block's conv output gives them."""
    b, s, h, p, n = 2, 130, 4, 64, 128
    gen = torch.Generator(device=cuda).manual_seed(9)
    for dtype in (torch.float32, torch.bfloat16):
        conv = torch.randn(b, s, 1 + h * p + 2 * n, generator=gen,
                           device=cuda, dtype=dtype).requires_grad_()
        x = conv[..., 1:1 + h * p].reshape(b, s, h, p)
        B = conv[..., 1 + h * p:1 + h * p + n]
        C = conv[..., 1 + h * p + n:]
        dt = torch.rand(b, s, h, generator=gen, device=cuda) + 0.1
        A = -torch.rand(h, generator=gen, device=cuda) - 0.5
        D = torch.randn(h, generator=gen, device=cuda)
        dy = torch.randn(b, s, h, p, generator=gen, device=cuda,
                         dtype=dtype)
        leaves = [dt.requires_grad_(), A.requires_grad_(),
                  D.requires_grad_()]
        y = ssd_ops.ssd(x, dt, A, B, C, D, chunk=64)
        got = torch.autograd.grad(y, [conv] + leaves, dy)
        gx, gB, gC = (got[0][..., 1:1 + h * p].reshape(b, s, h, p),
                      got[0][..., 1 + h * p:1 + h * p + n],
                      got[0][..., 1 + h * p + n:])
        assert not bool(got[0][..., 0].any())
        ssd_kernel_close(f"strided {dtype}",
                         [gx, got[1], got[2], gB, gC, got[3]],
                         *(t.detach() for t in (x, dt, A, B, C, D)), dy, 64)


@pytest.mark.cuda
def test_ssd_backward_kernel_after_a_call_at_an_odd_offset(cuda):
    """The bf16 kernels built for rows at an odd element offset and those
    for aligned rows launch one final kernel: a call of the first at a
    shorter chunk leaves the second able to launch at its own chunk."""
    arrays, dy, ds = _ssd_on(cuda, (2, 300, 4, 64, 128), 5, torch.bfloat16,
                             True)
    ssd_ops._launch_backward(*arrays, dy, ds, 256)
    b, s, h, p, n = 2, 300, 4, 64, 128
    conv = torch.zeros(b, s, 1 + h * p + 2 * n, device=cuda,
                       dtype=torch.bfloat16)
    conv[..., 1:1 + h * p] = arrays[0].reshape(b, s, h * p)
    conv[..., 1 + h * p:1 + h * p + n] = arrays[3]
    conv[..., 1 + h * p + n:] = arrays[4]
    odd = (conv[..., 1:1 + h * p].reshape(b, s, h, p), *arrays[1:3],
           conv[..., 1 + h * p:1 + h * p + n], conv[..., 1 + h * p + n:],
           arrays[5])
    ssd_kernel_close("odd offset, chunk 200",
                     ssd_ops._launch_backward(*odd, dy, ds, 200), *odd, dy,
                     200, ds)
    ssd_kernel_close("aligned after it, chunk 256",
                     ssd_ops._launch_backward(*arrays, dy, ds, 256),
                     *arrays, dy, 256, ds)


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", [(8, 256, 2560), (3, 77, 1000),
                                   (2, 5, 37)])
def test_lru_backward_kernel_equals_the_plain_backward(cuda, shape,
                                                       with_h0):
    a, b, dh, h0 = (None if x is None else torch.from_numpy(x).to(cuda)
                    for x in _lru_draw(shape, sum(shape), with_h0))
    lru_ops.backward_launches = 0
    runs = []
    for _ in range(2):
        t = [x.clone().requires_grad_() for x in (a, b, h0)
             if x is not None]
        runs.append(torch.autograd.grad(lru_ops.linear_scan(*t), t, dh))
    torch.cuda.synchronize()
    assert lru_ops.backward_launches == 2
    h = lru_ref.linear_scan(a, b, h0)
    want = [w for w in lru_ref.linear_scan_backward_reference(a, h, dh, h0)
            if w is not None]
    for g, w in zip(runs[0], want):
        assert torch.equal(g, w)
    for x, y in zip(*runs):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_scan_calls_without_a_gradient_take_the_forward_kernel(cuda):
    """No input that requires a gradient, or gradients disabled: the
    forward kernels run and nothing is recorded."""
    arrays, _, _ = _ssd_on(cuda, (1, 16, 2, 8, 4), 1, torch.float32)
    ssd_ops.launches = 0
    with torch.no_grad():
        y = ssd_ops.ssd(*[a.requires_grad_() for a in arrays], chunk=8)
    assert y.grad_fn is None and ssd_ops.launches == 1
    la = torch.rand(1, 16, 8, device=cuda)
    lru_ops.launches = 0
    assert lru_ops.linear_scan(la, la).grad_fn is None
    assert lru_ops.launches == 1


def test_lru_gates_gradient_is_bounded_where_a_rounds_to_one():
    """Where r is so small that a = exp(log_a) rounds to 1 in f32, the JAX
    formula's gradient of sqrt(1 - a^2) is NaN; the port's takes the
    square root's derivative at most ``SQRT_MAX_GRADIENT`` and stays
    finite.  Elsewhere it is the JAX gradient (rtol 1e-5) and the values
    are the JAX ones bit for bit."""
    w = 6
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 4, w)).astype(np.float32)
    w_a = np.zeros((w, w), np.float32)
    w_x = (rng.standard_normal((w, w)) / np.sqrt(w)).astype(np.float32)
    b_x = np.zeros(w, np.float32)
    # b_a -40 puts r near 4e-18 in the first three lanes: a rounds to 1
    b_a = np.array([-40.0] * 3 + [0.5] * 3, np.float32)
    lam = np.log(np.expm1(-np.log(np.linspace(0.9, 0.99, w)) / 8))
    log_lambda = lam.astype(np.float32)
    args = (x, w_a, b_a, w_x, b_x, log_lambda)

    def jax_b(*t):
        return jax_lru.rglru_gates(*t)[1].sum()

    want = jax.jit(jax.grad(jax_b, argnums=2))(*map(jnp.asarray, args))
    t = [torch.from_numpy(v).requires_grad_() for v in args]
    a, b = lru_ref.rglru_gates(*t)
    ja, jb = jax_lru.rglru_gates(*map(jnp.asarray, args))
    assert np.array_equal(b.detach().numpy(), np.asarray(jb))
    assert np.array_equal(a.detach().numpy(), np.asarray(ja))
    assert bool((a[..., :3] == 1).all())
    (g,) = torch.autograd.grad(b.sum(), [t[2]])
    assert np.isnan(np.asarray(want)[:3]).all()
    assert bool(torch.isfinite(g).all())
    np.testing.assert_allclose(g.numpy()[3:], np.asarray(want)[3:],
                               rtol=1e-5)
