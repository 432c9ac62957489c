"""The port's RG-LRU scan, ``kernels.rglru_scan``, and the recurrent block
``models/rglru.py`` built on it: the plain versions against the JAX
package's ``linear_scan``, ``rglru_gates``, ``rglru`` and
``rglru_decode_step`` and against ``rglru_scan_pallas`` (interpret mode) on
the CPU, the block's prefill and decode against ``repro.models.rglru`` in
f32 and bf16, and the CUDA kernel against the plain version on a GPU
(marked ``cuda``; skipped on a machine without one).

The scan's bar is the JAX one (``tests/test_kernels.py``): atol 1e-5.  The
block in f32 is held to 1e-5; in bf16 to the JAX kernel tests' bf16 bar
(atol 2e-2, rtol 1e-2), since a bf16 matrix product rounds an element
differently now and then in the two frameworks.  Inputs are drawn with
numpy from a seed, so both frameworks see the same values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.rglru_scan import ref as jax_ref
from repro.kernels.rglru_scan.rglru_scan import rglru_scan_pallas
from repro.models import rglru as jax_rec
from repro_torch.configs import get_config
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.rglru_scan import ref as lru_ref
from repro_torch.models import rglru as rec

torch.set_num_threads(1)

#: the shapes (b, s, w) of tests/test_kernels.py
SHAPES = [(1, 16, 128), (2, 33, 256)]


def _scan_inputs(shape, seed):
    """a in [0.3, 0.999), b normal, h0 normal, as numpy f32."""
    b, s, w = shape
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.3, 0.999, shape).astype(np.float32),
            rng.standard_normal(shape, np.float32),
            rng.standard_normal((b, w), np.float32))


def _gate_params(w, seed):
    """W_a, b_a, W_x, b_x, Lambda as the recurrent block draws them (the
    fan-in scale, Lambda from lam in [0.9, 0.999]), biases perturbed."""
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.9, 0.999, w)
    return [(rng.standard_normal((w, w)) / np.sqrt(w)).astype(np.float32),
            (0.1 * rng.standard_normal(w)).astype(np.float32),
            (rng.standard_normal((w, w)) / np.sqrt(w)).astype(np.float32),
            (0.1 * rng.standard_normal(w)).astype(np.float32),
            np.log(np.expm1(-np.log(lam) / 8.0)).astype(np.float32)]


def _close(got, want, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


# ------------------------------------------------------- plain vs JAX

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_h0", [True, False])
def test_linear_scan_matches_jax_and_pallas(shape, with_h0):
    a, b, h0 = _scan_inputs(shape, sum(shape))
    h0 = h0 if with_h0 else None
    got = lru_ref.linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                              None if h0 is None else torch.from_numpy(h0))
    assert got.shape == shape and got.dtype == torch.float32
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    jh0 = None if h0 is None else jnp.asarray(h0)
    _close(got, jax_ref.linear_scan(ja, jb, jh0))
    _close(got, rglru_scan_pallas(ja, jb, jh0, interpret=True, block_w=128))


def test_linear_scan_in_f64_agrees_with_f32():
    """The f64 run (the reference the card's phases hold both f32 runs to)
    computes the same function."""
    a, b, h0 = map(torch.from_numpy, _scan_inputs((2, 40, 64), 3))
    h64 = lru_ref.linear_scan(a.double(), b.double(), h0.double())
    assert h64.dtype == torch.float64
    _close(lru_ref.linear_scan(a, b, h0), h64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gates_layer_and_decode_step_match_jax(dtype):
    w = 64
    params = _gate_params(w, 1)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 12, w), np.float32), dtype)
    h0 = rng.standard_normal((2, w), np.float32)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p) for p in params]
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    for got, want in zip(lru_ref.rglru_gates(tx, *tp),
                         jax_ref.rglru_gates(x, *jp)):
        _close(got, want)
    h, final = lru_ref.rglru(tx, *tp, torch.from_numpy(h0),
                             return_final_state=True)
    jh, jfinal = jax_ref.rglru(x, *jp, jnp.asarray(h0),
                               return_final_state=True)
    assert h.dtype == tx.dtype and final.dtype == torch.float32
    bf16 = dtype == "bfloat16"
    _close(h.float(), jh.astype(jnp.float32), atol=2e-2 if bf16 else 1e-5,
           rtol=1e-2 if bf16 else 0.0)
    _close(final, jfinal)
    y, state = lru_ref.rglru_decode_step(tx[:, 0], *tp, torch.from_numpy(h0))
    jy, jstate = jax_ref.rglru_decode_step(x[:, 0], *jp, jnp.asarray(h0))
    _close(state, jstate)
    _close(y.float(), jy.astype(jnp.float32), atol=2e-2 if bf16 else 1e-5,
           rtol=1e-2 if bf16 else 0.0)


def test_wrapper_takes_the_plain_version_on_cpu_and_counts_no_launch():
    a, b, h0 = map(torch.from_numpy, _scan_inputs((2, 9, 48), 4))
    before = lru_ops.launches
    assert torch.equal(lru_ops.linear_scan(a, b, h0),
                       lru_ref.linear_scan(a, b, h0))
    params = [torch.from_numpy(p) for p in _gate_params(48, 5)]
    got, final = lru_ops.rglru(b, *params, return_final_state=True)
    want, want_final = lru_ref.rglru(b, *params, return_final_state=True)
    assert torch.equal(got, want) and torch.equal(final, want_final)
    assert lru_ops.launches == before


# --------------------------------------------- the recurrent block vs JAX

def _block(dtype, seed=0):
    """One recurrent block of the reduced recurrentgemma-2b in both
    packages: the JAX parameters (biases perturbed) and the port's, with
    the gate parameters in f32 and the rest in the activation dtype."""
    jc = jax_get_config("recurrentgemma-2b").reduced(activ_dtype=dtype)
    tc = get_config("recurrentgemma-2b").reduced(activ_dtype=dtype)
    jp = jax_rec.init_rec(jax.random.PRNGKey(seed), jc, jnp.float32)
    rng = np.random.default_rng(seed)
    for name in ("conv_b", "lru_ba", "lru_bx"):
        jp[name] = jp[name] + jnp.asarray(
            0.1 * rng.standard_normal(jp[name].shape), jnp.float32)
    tp = {n: torch.from_numpy(np.array(a)).to(
        torch.float32 if n.startswith(("lru", "log")) else tc.adtype)
        for n, a in jp.items()}
    return jc, tc, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rec_forward_and_decode_steps_match_jax(dtype):
    """Prefill with the state it leaves (both convs' rounding: the prefill
    sum in the activation dtype, the decode einsum in f32), then 4 decode
    steps."""
    jc, tc, jp, tp = _block(dtype)
    atol, rtol = (2e-2, 1e-2) if dtype == "bfloat16" else (1e-5, 0.0)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 21, jc.d_model), np.float32),
                    dtype)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tc.adtype)
    out, state = rec.rec_forward(tp, tc, tx, return_state=True)
    jout, jstate = jax_rec.rec_forward(jp, jc, x, return_state=True)
    assert out.dtype == tc.adtype and state.h.dtype == torch.float32
    assert state.conv.shape == (2, tc.conv_width - 1, tc.lru_width)
    _close(out.float(), jout.astype(jnp.float32), atol, rtol)
    _close(state.h, jstate.h, 1e-5)
    _close(state.conv.float(), jstate.conv.astype(jnp.float32), atol, rtol)
    _close(rec.rec_forward(tp, tc, tx).float(), jout.astype(jnp.float32),
           atol, rtol)
    for t in range(4):
        xt = jnp.asarray(rng.standard_normal((2, 1, jc.d_model), np.float32),
                         dtype)
        out, state = rec.rec_decode_step(
            tp, tc, torch.from_numpy(np.array(xt.astype(jnp.float32))).to(
                tc.adtype), state)
        jout, jstate = jax_rec.rec_decode_step(jp, jc, xt, jstate)
        _close(out.float(), jout.astype(jnp.float32), atol, rtol)
        _close(state.h, jstate.h, 1e-5)


def test_rec_state_of_a_prompt_shorter_than_the_conv():
    """A 2-token prompt leaves a conv history with a zero row first, as
    the JAX block pads it."""
    jc, tc, jp, tp = _block("float32", seed=1)
    x = np.random.default_rng(4).standard_normal((1, 2, jc.d_model),
                                                 np.float32)
    _, state = rec.rec_forward(tp, tc, torch.from_numpy(x),
                               return_state=True)
    _, jstate = jax_rec.rec_forward(jp, jc, jnp.asarray(x),
                                    return_state=True)
    _close(state.conv, jstate.conv)
    assert float(state.conv[:, 0].abs().max()) == 0.0


def test_init_rec_matches_the_jax_shapes_and_lambda_range():
    tc = get_config("recurrentgemma-2b").reduced()
    jc = jax_get_config("recurrentgemma-2b").reduced()
    gen = torch.Generator().manual_seed(0)
    own = rec.init_rec(gen, tc, torch.bfloat16)
    jp = jax_rec.init_rec(jax.random.PRNGKey(0), jc, jnp.float32)
    assert {n: tuple(t.shape) for n, t in own.items()} == \
        {n: a.shape for n, a in jp.items()}
    assert {n for n, t in own.items() if t.dtype == torch.float32} == {
        "lru_wa", "lru_ba", "lru_wx", "lru_bx", "log_lambda"}
    # a = lam ** 8 at r = 1, lam in [0.9, 0.999]
    lam = torch.exp(-lru_ref.RGLRU_C * lru_ref._softplus(own["log_lambda"]))
    assert float(lam.min()) >= 0.9 - 1e-6 and float(lam.max()) <= 0.999


# ------------------------------------------------- on a GPU (cuda marker)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU for the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(2, 33, 200), (3, 70, 1000)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_kernel_matches_plain(cuda, shape, with_h0):
    """The JAX tests' shapes and bar, a W that is not a multiple of 128 or
    of the block, and an S that is not a multiple of the loads ahead."""
    a, b, h0 = (torch.from_numpy(x).to(cuda)
                for x in _scan_inputs(shape, sum(shape)))
    h0 = h0 if with_h0 else None
    before = lru_ops.launches
    got = lru_ops.linear_scan(a, b, h0)
    torch.cuda.synchronize()
    assert lru_ops.launches == before + 1
    assert got.shape == shape and got.dtype == torch.float32
    _close(got.cpu(), lru_ref.linear_scan(a, b, h0).cpu())


@pytest.mark.cuda
def test_kernel_at_full_width_within_the_f32_formulas_own_error(cuda):
    """W = 2560 with a and b drawn by the gates: against the plain version
    in f64 the kernel errs at most twice as much as the plain version in
    f32."""
    w = 2560
    params = [torch.from_numpy(p).to(cuda) for p in _gate_params(w, 6)]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 300, w), np.float32)).to(cuda)
    a, b = lru_ref.rglru_gates(x, *params)
    got = lru_ops.linear_scan(a, b)
    plain = lru_ref.linear_scan(a, b)
    ref64 = lru_ref.linear_scan(a.double(), b.double())
    own = float((plain.double() - ref64).abs().max())
    assert float((got.double() - ref64).abs().max()) <= 2 * own


@pytest.mark.cuda
def test_rglru_layer_on_cuda_matches_cpu(cuda):
    """The whole layer (gates in PyTorch, the scan in the kernel) against
    the CPU's plain run, with h0 and the final state."""
    params = [torch.from_numpy(p) for p in _gate_params(96, 8)]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 40, 96), np.float32))
    h0 = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 96), np.float32))
    got, final = lru_ops.rglru(x.to(cuda), *(p.to(cuda) for p in params),
                               h0.to(cuda), return_final_state=True)
    want, want_final = lru_ops.rglru(x, *params, h0, return_final_state=True)
    _close(got.cpu(), want, 1e-5, 1e-5)
    _close(final.cpu(), want_final, 1e-5, 1e-5)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    a = torch.zeros(2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="f32"):
        lru_ops.linear_scan(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="one shape"):
        lru_ops.linear_scan(a, a[:, :4])
    with pytest.raises(ValueError, match="h0 must be"):
        lru_ops.linear_scan(a, a, torch.zeros(2, 32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        lru_ops.linear_scan(a.transpose(0, 1), a.transpose(0, 1))
