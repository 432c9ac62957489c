"""The port's SSD scan, ``kernels.ssd_scan``: the plain version against the
JAX package's ``ssd_chunked`` and ``ssd_pallas`` (interpret mode) on the
CPU, the single-token recurrence against the chunked scan, and the CUDA
kernel against the plain version on a GPU (marked ``cuda``; skipped on a
machine without one).

The bar is the JAX one (``tests/test_kernels.py``): atol 2e-4, rtol 1e-3
for y; atol 1e-4 for the final state and for the recurrence against the
chunked scan.  Inputs are drawn with numpy from a seed, so both frameworks
see the same values.
"""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ref as jax_ref
from repro.kernels.ssd_scan.ssd_scan import ssd_pallas
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref

torch.set_num_threads(1)

#: the shapes (b, s, h, p, n) and chunks of tests/test_kernels.py
SHAPES = [(1, 32, 2, 8, 4), (2, 64, 4, 16, 8)]
CHUNKS = [8, 16]


def _inputs(shape, seed):
    """x, dt (softplus applied), A (< 0), B, C, D as numpy f32."""
    b, s, h, p, n = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), np.float32)))
    A = -np.exp(rng.standard_normal(h, np.float32))
    B = rng.standard_normal((b, s, n), np.float32)
    C = rng.standard_normal((b, s, n), np.float32)
    D = rng.standard_normal(h, np.float32)
    return x, dt, A, B, C, D


def _close(got, want, atol=2e-4, rtol=1e-3):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_plain_matches_jax_chunked_and_pallas(shape, chunk):
    arrays = _inputs(shape, sum(shape) + chunk)
    y, state = ssd_ref.ssd_chunked(*map(torch.from_numpy, arrays),
                                   chunk=chunk, return_final_state=True)
    jx = [jnp.asarray(a) for a in arrays]
    want, want_state = jax_ref.ssd_chunked(*jx, chunk=chunk,
                                           return_final_state=True)
    _close(y, want)
    _close(state, want_state, atol=1e-4, rtol=0)
    _close(y, ssd_pallas(*jx, chunk=chunk, interpret=True))


@pytest.mark.parametrize("s,chunk", [(37, 16), (5, 8), (29, 8)])
def test_plain_ragged_sequence_matches_jax(s, chunk):
    """S not a multiple of the chunk (padded with dt = 0), or shorter."""
    arrays = _inputs((2, s, 3, 8, 4), s)
    y, state = ssd_ref.ssd_chunked(*map(torch.from_numpy, arrays),
                                   chunk=chunk, return_final_state=True)
    want, want_state = jax_ref.ssd_chunked(
        *map(jnp.asarray, arrays), chunk=chunk, return_final_state=True)
    assert y.shape == (2, s, 3, 8) and state.shape == (2, 3, 8, 4)
    _close(y, want)
    _close(state, want_state, atol=1e-4, rtol=0)


def test_decode_steps_equal_the_chunked_scan():
    """tests/test_kernels.py's sequential check, on the port and against the
    JAX recurrence."""
    x, dt, A, B, C, D = map(torch.from_numpy, _inputs((1, 24, 2, 4, 4), 5))
    y_chunked, st_c = ssd_ref.ssd_chunked(x, dt, A, B, C, D, chunk=8,
                                          return_final_state=True)
    st = torch.zeros((1, 2, 4, 4))
    jst = jnp.zeros((1, 2, 4, 4))
    ys = []
    for t in range(24):
        args = (x[:, t], dt[:, t], A, B[:, t], C[:, t], D)
        y, st = ssd_ref.ssd_decode_step(*args, st)
        jy, jst = jax_ref.ssd_decode_step(*(jnp.asarray(a.numpy())
                                            for a in args), jst)
        _close(y, jy, atol=1e-5, rtol=1e-5)
        ys.append(y)
    _close(torch.stack(ys, 1), y_chunked, atol=1e-4, rtol=0)
    _close(st, st_c, atol=1e-4, rtol=0)
    _close(st, jst, atol=1e-5, rtol=1e-5)


def test_plain_in_f64_agrees_with_f32_and_keeps_the_chunk():
    """The f64 run (the reference the card's phases hold both f32 runs to)
    computes the same function."""
    arrays = _inputs((1, 40, 2, 8, 4), 2)
    y32 = ssd_ref.ssd_chunked(*map(torch.from_numpy, arrays), chunk=16)
    y64, st64 = ssd_ref.ssd_chunked(
        *(torch.from_numpy(a).double() for a in arrays), chunk=16,
        return_final_state=True)
    assert y64.dtype == st64.dtype == torch.float64
    _close(y32, y64, atol=1e-5, rtol=1e-5)


def test_wrapper_takes_the_plain_version_on_cpu_and_counts_no_launch():
    arrays = [torch.from_numpy(a) for a in _inputs((1, 20, 2, 8, 4), 1)]
    before = ssd_ops.launches
    y, state = ssd_ops.ssd(*arrays, chunk=8, return_final_state=True)
    want, want_state = ssd_ref.ssd_chunked(*arrays, chunk=8,
                                           return_final_state=True)
    assert torch.equal(y, want) and torch.equal(state, want_state)
    assert torch.equal(ssd_ops.ssd(*arrays, chunk=8), want)
    assert ssd_ops.launches == before
    with pytest.raises(ValueError, match="chunk"):
        ssd_ops.ssd(*arrays, chunk=0)


# ------------------------------------------------- on a GPU (cuda marker)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU for the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, arrays, dtype=torch.float32):
    """x, B and C in ``dtype``; dt, A and D in f32; on ``dev``."""
    x, dt, A, B, C, D = (torch.from_numpy(a).to(dev) for a in arrays)
    return x.to(dtype), dt, A, B.to(dtype), C.to(dtype), D


def _kernel_vs_plain(dev, shape, chunk, dtype=torch.float32, seed=0):
    args = _on(dev, _inputs(shape, seed), dtype)
    before = ssd_ops.launches
    y, state = ssd_ops.ssd(*args, chunk=chunk, return_final_state=True)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    want, want_state = ssd_ref.ssd_chunked(*args, chunk=chunk,
                                           return_final_state=True)
    assert y.dtype == dtype and state.dtype == torch.float32
    return y.cpu(), state.cpu(), want.cpu(), want_state.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(2, 37, 3, 8, 4),
                                            (2, 250, 3, 16, 16)])
@pytest.mark.parametrize("chunk", CHUNKS + [100, 256])
def test_kernel_matches_plain(cuda, shape, chunk):
    """The JAX tests' shapes and bar, a ragged S, and chunks of more than
    one 64-row tile that are not a multiple of it."""
    y, state, want, want_state = _kernel_vs_plain(cuda, shape, chunk)
    _close(y, want)
    _close(state, want_state, atol=1e-4, rtol=1e-3)


def _mamba_inputs(shape, seed):
    """mamba2-like decays: A = -linspace(1, 16, h) (its A_log init), so
    a_cum reaches thousands within a 256-row chunk."""
    x, dt, _, B, C, D = _inputs(shape, seed)
    return x, dt, -np.linspace(1, 16, shape[2], dtype=np.float32), B, C, D


@pytest.mark.cuda
def test_kernel_at_full_width_within_the_f32_formulas_own_error(cuda):
    """P = 64, N = 128, chunk 256, ragged S: against the plain version in
    f64 the kernel errs at most twice as much as the plain version in f32
    (the two sum in different orders)."""
    arrays = _mamba_inputs((2, 300, 4, 64, 128), 7)
    args = _on(cuda, arrays)
    y, state = ssd_ops.ssd(*args, chunk=256, return_final_state=True)
    y32, st32 = ssd_ref.ssd_chunked(*args, chunk=256,
                                    return_final_state=True)
    y64, st64 = ssd_ref.ssd_chunked(*(a.double() for a in args), chunk=256,
                                    return_final_state=True)
    for got, plain, ref in ((y, y32, y64), (state, st32, st64)):
        bar = 2 * float((plain.double() - ref).abs().max())
        assert float((got.double() - ref).abs().max()) <= bar


@pytest.mark.cuda
def test_kernel_in_bf16_within_one_ulp_of_the_f32_plain_version(cuda):
    """bf16 x, B, C: the kernel rounds y to bf16 once, so it lies within
    one bf16 ulp of the f32 plain version's y, plus the f32 formula's own
    error against f64."""
    arrays = _mamba_inputs((2, 300, 4, 64, 128), 8)
    args = _on(cuda, arrays, torch.bfloat16)
    y = ssd_ops.ssd(*args, chunk=256)
    f32 = [a.float() for a in args]
    want = ssd_ref.ssd_chunked(*f32, chunk=256)
    y64 = ssd_ref.ssd_chunked(*(a.double() for a in f32), chunk=256)
    bar32 = 2 * float((want.double() - y64).abs().max())
    _, e = torch.frexp(want.abs())
    ulp = torch.where(want == 0, 0.0, torch.ldexp(torch.ones_like(want),
                                                  e - 8))
    assert bool(((y.float() - want.bfloat16().float()).abs()
                 <= ulp + bar32).all())


def _bf16_bar(y, args, chunk):
    """bf16 x, B, C: y within one bf16 ulp of the f32 plain version's y,
    plus twice the f32 formula's own error against f64 (phase 13)."""
    f32 = [a.float() for a in args]
    want = ssd_ref.ssd_chunked(*f32, chunk=chunk)
    y64 = ssd_ref.ssd_chunked(*(a.double() for a in f32), chunk=chunk)
    bar32 = 2 * float((want.double() - y64).abs().max())
    _, e = torch.frexp(want.abs())
    ulp = torch.where(want == 0, 0.0, torch.ldexp(torch.ones_like(want),
                                                  e - 8))
    err = (y.float() - want.bfloat16().float()).abs()
    assert bool((err <= ulp + bar32).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(2, 37, 3, 8, 4),
                                            (2, 250, 3, 16, 16)])
@pytest.mark.parametrize("chunk", CHUNKS + [100])
def test_kernel_in_bf16_at_the_jax_shapes(cuda, shape, chunk):
    """The tensor-core passes at P = 8 or 16 and N = 4 to 16 (zero-padded
    to the mma tiles), chunks of 8, 16 and 100 rows, a ragged S."""
    args = _on(cuda, _inputs(shape, sum(shape) + chunk), torch.bfloat16)
    before = ssd_ops.launches
    y, state = ssd_ops.ssd(*args, chunk=chunk, return_final_state=True)
    assert ssd_ops.launches == before + 1
    _bf16_bar(y, args, chunk)
    want_state = ssd_ref.ssd_chunked(*(a.float() for a in args), chunk=chunk,
                                     return_final_state=True)[1]
    _close(state.cpu(), want_state.cpu(), atol=1e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4, 6])
def test_kernel_reads_column_views_not_16_byte_aligned(cuda, offset):
    """x, B and C as column slices of one bf16 [b, s, ch] tensor that
    start ``offset`` elements in: rows 2, 4 or 8 bytes aligned (C at
    column 28 + offset of a 32 + offset wide row)."""
    b, s, h, p, n = 2, 50, 3, 8, 4
    rng = np.random.default_rng(offset)
    xbc = torch.from_numpy(rng.standard_normal(
        (b, s, offset + h * p + 2 * n), np.float32)).to(cuda, torch.bfloat16)
    _, dt, A, _, _, D = _on(cuda, _inputs((b, s, h, p, n), offset))
    x = xbc[..., offset:offset + h * p].reshape(b, s, h, p)
    B = xbc[..., offset + h * p:offset + h * p + n]
    C = xbc[..., offset + h * p + n:]
    _bf16_bar(ssd_ops.ssd(x, dt, A, B, C, D, chunk=16), (x, dt, A, B, C, D),
              16)


#: sha256 (first 16 hex digits) of the f32 kernel's y and final state on
#: these inputs (column views of one conv output, mamba2 decays), as the
#: CUDA-core kernel computed them before the bf16 path moved to the tensor
#: cores (NVIDIA H100 80GB HBM3)
F32_BITS = {((2, 64, 4, 16, 8), 16): "7e97ace701cb02f5",
            ((2, 37, 3, 8, 4), 16): "a777c16e0cf867c0",
            ((2, 300, 4, 64, 128), 256): "304484ff3b53f1ed"}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk", list(F32_BITS))
def test_f32_kernel_bits_unchanged(cuda, shape, chunk):
    b, s, h, p, n = shape
    rng = np.random.default_rng(sum(shape) + chunk)

    def normal(*size):
        return torch.from_numpy(rng.standard_normal(size, np.float32)).to(
            cuda)

    xbc = normal(b, s, h * p + 2 * n)
    dt = torch.nn.functional.softplus(normal(b, s, h))
    A = -torch.from_numpy(np.linspace(1, 16, h, dtype=np.float32)).to(cuda)
    D = normal(h)
    y, state = ssd_ops.ssd(xbc[..., :h * p].reshape(b, s, h, p), dt, A,
                           xbc[..., h * p:h * p + n], xbc[..., h * p + n:], D,
                           chunk=chunk, return_final_state=True)
    digest = hashlib.sha256(y.cpu().numpy().tobytes())
    digest.update(state.cpu().numpy().tobytes())
    assert digest.hexdigest()[:16] == F32_BITS[(shape, chunk)]


@pytest.mark.cuda
def test_kernel_reads_strided_column_views(cuda):
    """x, B and C as column slices of one [b, s, ch] tensor, as the
    Mamba-2 block passes them."""
    b, s, h, p, n = 2, 50, 4, 16, 16
    rng = np.random.default_rng(3)
    xbc = torch.from_numpy(rng.standard_normal(
        (b, s, h * p + 2 * n), np.float32)).to(cuda, torch.bfloat16)
    _, dt, A, _, _, D = _on(cuda, _inputs((b, s, h, p, n), 3))
    x = xbc[..., :h * p].reshape(b, s, h, p)
    B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    y = ssd_ops.ssd(x, dt, A, B, C, D, chunk=16)
    want = ssd_ref.ssd_chunked(x, dt, A, B, C, D, chunk=16)
    _close(y.float().cpu(), want.float().cpu(), atol=2e-2, rtol=1e-2)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, dt, A, B, C, D = _on(cuda, _inputs((1, 8, 2, 8, 4), 0))
    with pytest.raises(ValueError, match="dtype"):
        ssd_ops.ssd(x.half(), dt, A, B.half(), C.half(), D, chunk=8)
    with pytest.raises(ValueError, match="p <= 64"):
        ssd_ops.ssd(torch.zeros(1, 8, 2, 80, device=cuda), dt, A, B, C, D,
                    chunk=8)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd(x, dt, A, B.transpose(1, 2).contiguous().transpose(1, 2),
                    C, D, chunk=8)
