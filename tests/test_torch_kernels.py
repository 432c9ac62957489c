"""The port's Canny and Sobel kernels: plain versions against the JAX
oracles on the CPU, and the CUDA kernels against the plain versions on a
GPU (marked ``cuda``; skipped on a machine without one).

The JAX tests hold the Pallas Canny kernel to exact equality with
``repro.kernels.canny_fused.ref.canny_edge``, so the port's plain version
is held to exact equality with that same oracle, and the CUDA kernel to
exact equality with the plain version.  Sobel's bar is the JAX one
(``tests/test_kernels.py``): magnitude within a tolerance, directions
equal.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _propcheck import given, settings, st

from repro.detection.canny import canny_count_batch as jax_count_batch
from repro.kernels.canny_fused import ref as jax_canny
from repro.kernels.sobel import ref as jax_sobel
from repro.kernels.sobel.sobel import sobel_grad_pallas
from repro_torch.detection.canny import canny_count_batch
from repro_torch.kernels.canny_fused import ops as canny_ops
from repro_torch.kernels.canny_fused import ref as canny_ref
from repro_torch.kernels.sobel import ops as sobel_ops
from repro_torch.kernels.sobel import ref as sobel_ref

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

#: the frame geometries of tests/test_canny_fused.py (the Pallas tilings
#: there do not apply: the CUDA kernel tiles 32x32 whatever the frame)
GEOMETRIES = [(1, 32, 32), (3, 64, 64), (1, 96, 64), (2, 40, 56),
              (1, 37, 41), (1, 64, 200), (2, 80, 600), (1, 48, 31),
              (1, 48, 65), (1, 48, 63), (1, 48, 64)]
#: Sobel: the JAX tests' shapes, then the kernel's ragged edges: widths
#: that are not a multiple of 4 (its scalar path), heights and widths of 1,
#: a width past one 32-lane segment (130)
SOBEL_SHAPES = [(1, 32, 32), (3, 64, 64), (2, 37, 41), (1, 48, 63),
                (1, 48, 65), (1, 1, 7), (1, 5, 1), (1, 3, 130)]


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape, np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode, and this machine has no GPU")
    return torch.device("cuda")


# ------------------------------------------------------------ plain vs JAX

def test_gauss_weights_bit_identical_to_jax():
    assert (canny_ref.gauss_kernel().numpy().tobytes()
            == np.asarray(jax_canny.gauss_kernel()).tobytes())


@pytest.mark.parametrize("shape", GEOMETRIES)
def test_canny_plain_bit_identical_to_jax_oracle(shape):
    img = _rand(shape, sum(shape))
    want = np.asarray(jax_canny.canny_edge(jnp.asarray(img)))
    got = canny_ops.canny_edge(img, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        canny_ref.gaussian_blur(torch.from_numpy(img)).numpy(),
        np.asarray(jax_canny.gaussian_blur(jnp.asarray(img))))


def test_canny_plain_other_thresholds():
    img = _rand((2, 64, 64), 5)
    want = np.asarray(jax_canny.canny_edge(jnp.asarray(img), 0.2, 0.5))
    got = canny_ref.canny_edge(torch.from_numpy(img), 0.2, 0.5).numpy()
    np.testing.assert_array_equal(got, want)


@settings(max_examples=6, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 99))
def test_canny_plain_matches_jax_on_any_frame(h, w, seed):
    img = _rand((1, h, w), seed)
    np.testing.assert_array_equal(
        canny_ref.canny_edge(torch.from_numpy(img)).numpy(),
        np.asarray(jax_canny.canny_edge(jnp.asarray(img))))


def test_ragged_batch_and_counts_match_jax():
    frames = [_rand((64, 64), 1), _rand((40, 56), 2), _rand((64, 64), 3),
              _rand((37, 130), 4)]
    got = canny_ops.canny_edge_batch(frames, device="cpu")
    for f, g in zip(frames, got):
        assert g.shape == f.shape and g.dtype == np.bool_
        np.testing.assert_array_equal(
            g, np.asarray(jax_canny.canny_edge(jnp.asarray(f)[None]))[0])
    np.testing.assert_array_equal(canny_count_batch(frames, device="cpu"),
                                  jax_count_batch(frames))
    uniform = np.stack([_rand((64, 64), s) for s in range(4)])
    np.testing.assert_array_equal(canny_count_batch(uniform, device="cpu"),
                                  jax_count_batch(uniform))


def test_ragged_batch_rejects_empty_frames():
    with pytest.raises(ValueError, match="non-empty"):
        canny_ops.canny_edge_batch([np.zeros((0, 5), np.float32)],
                                   device="cpu")


@pytest.mark.parametrize("shape", SOBEL_SHAPES)
def test_sobel_plain_matches_jax(shape):
    img = _rand(shape, 0)
    m_jax, d_jax = jax_sobel.sobel_grad(jnp.asarray(img))
    mag, direction = sobel_ops.sobel_grad(img, device="cpu")
    assert direction.dtype == torch.int32
    # the magnitudes differ by at most 1 ulp of values up to ~4
    np.testing.assert_allclose(mag.numpy(), np.asarray(m_jax), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(direction.numpy(), np.asarray(d_jax))
    # the Pallas kernel, run as tests/test_kernels.py runs it, at its bar
    m_pl, d_pl = sobel_grad_pallas(jnp.asarray(img), interpret=True)
    np.testing.assert_allclose(mag.numpy(), np.asarray(m_pl), atol=1e-5)
    assert (direction.numpy() == np.asarray(d_pl)).mean() > 0.999


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = (canny_ops.launches, sobel_ops.launches)
    canny_ops.canny_edge(_rand((1, 16, 16), 0), device="cpu")
    sobel_ops.sobel_grad(_rand((1, 16, 16), 0), device="cpu")
    canny_ops.canny_edge_batch([_rand((16, 16), 0)], device="cpu")
    assert (canny_ops.launches, sobel_ops.launches) == before


def test_port_imports_neither_jax_nor_the_jax_package():
    """``repro_torch`` and every module under it load no ``jax`` and no
    ``repro`` module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, leaked = out.stdout.splitlines()
    assert int(n_modules) >= 25
    assert leaked == "[]"


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU, so the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        canny_ops.canny_edge(_rand((1, 8, 8), 0))


# ------------------------------------------------- CUDA kernels vs plain

@pytest.mark.cuda
@pytest.mark.parametrize("shape", GEOMETRIES + [(1, 24, 4224), (32, 64, 64)])
def test_canny_kernel_bit_identical_to_plain(cuda, shape):
    x = torch.from_numpy(_rand(shape, sum(shape))).to(cuda)
    before = canny_ops.launches
    got = canny_ops.canny_edge(x)
    assert canny_ops.launches == before + 1
    torch.testing.assert_close(got, canny_ref.canny_edge(x), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 65, 64), (1, 64, 65), (2, 130, 129),
                                   (1, 200, 300)])
@pytest.mark.parametrize("lo,hi", [(0.2, 0.5), (0.05, 0.1)])
def test_canny_kernel_tiles_and_halos(cuda, shape, lo, hi):
    """Frames one pixel past a 64 x 64 tile (a window clipped to the frame
    on one side, a halo on the other) and frames of several tiles, at
    thresholds low enough for the hysteresis to run far."""
    x = torch.from_numpy(_rand(shape, sum(shape))).to(cuda)
    torch.testing.assert_close(canny_ops.canny_edge(x, lo, hi),
                               canny_ref.canny_edge(x, lo, hi), rtol=0,
                               atol=0)


@pytest.mark.cuda
def test_canny_kernel_ragged_batch(cuda):
    frames = [_rand((100, 300), 1), _rand((64, 64), 2), _rand((65, 129), 3),
              _rand((37, 50), 4), _rand((64, 100), 5)]
    for f, g in zip(frames, canny_ops.canny_edge_batch(frames)):
        want = canny_ref.canny_edge(torch.from_numpy(f)[None].to(cuda))[0]
        np.testing.assert_array_equal(g, want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SOBEL_SHAPES + [
    (256, 64, 64), (8, 1080, 1920), (2, 1080, 1917), (64, 64, 64),
    (64, 64, 63), (16384, 3, 64)])
def test_sobel_kernel_matches_plain(cuda, shape):
    """Batches up to 64 x 64 x 64 take 2 columns a lane (too few warps
    for 4), the gateway's 256 frames and 1080p 4, each with vector loads
    where the width allows and scalar ones where it does not (odd widths,
    1917); 3-row frames in a batch large enough for strips of 32 rows have
    H < R.  Each input runs again from a pointer 4 bytes past 16-byte
    alignment, which takes the scalar path."""
    x = torch.from_numpy(_rand(shape, 0)).to(cuda)
    unaligned = torch.empty(x.numel() + 1, device=cuda)[1:].view(shape)
    unaligned.copy_(x)
    m2, d2 = sobel_ref.sobel_grad(x)
    for img in (x, unaligned):
        m1, d1 = sobel_ops.sobel_grad(img)
        torch.testing.assert_close(m1, m2, rtol=0, atol=1e-5)
        assert (d1 == d2).float().mean().item() >= 0.999


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError, match="float32"):
        canny_ops._launch(torch.zeros(1, 8, 8, dtype=torch.float64,
                                      device=cuda), None, 0.6, 1.0)
    with pytest.raises(ValueError, match="dims"):
        canny_ops._launch(torch.zeros(2, 8, 8, device=cuda),
                          torch.zeros(1, 2, dtype=torch.int32, device=cuda),
                          0.6, 1.0)
    with pytest.raises(ValueError, match="float32"):
        sobel_ops._launch(torch.zeros(8, 8, device=cuda))
