"""Mamba-2 block (SSD / state-space duality), attention-free.

Layer structure (n_groups = 1), as in the JAX package's ``models/ssm.py``:
  in_proj: d -> [z (d_in), x (d_in), B (N), C (N), dt (H)]
  causal depthwise conv width K over (x, B, C), then SiLU
  SSD scan over heads (P = headdim, N = ssm_state)
  gated RMSNorm(y * silu(z)) without the plus-one, out_proj: d_in -> d

Prefill runs the scan through the SSD kernel's wrapper (the CUDA kernel on
the card, its plain version on the CPU); decode runs the plain single-token
recurrence, as the JAX package does.  Rounding follows the JAX package in
bf16: the prefill conv sums its K products in the activation dtype in
order, the decode conv accumulates them in f32 and rounds once, SiLU
rounds after each op, and softplus and the gate's SiLU run in f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref

from .base import ModelConfig
from .layers import causal_conv, conv_history, dense_init, rms_norm, silu


class SSMState(NamedTuple):
    ssm: torch.Tensor   # [b, h, p, n] f32
    conv: torch.Tensor  # [b, conv_width - 1, conv_channels], activation dtype


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def init_ssm(gen, cfg: ModelConfig, dtype, device=None):
    """Seeded parameters of one block: matrices and the conv in ``dtype``,
    the per-head scalars and the gated norm's weight in f32."""
    d, d_in, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    ch = conv_channels(cfg)

    def f32(t):
        return t.to(device=device, dtype=torch.float32)

    return {
        "in_proj": dense_init(gen, (d, 2 * d_in + 2 * n + h), dtype,
                              device=device),
        "conv_w": dense_init(gen, (cfg.ssm_conv_width, ch), dtype, scale=0.5,
                             device=device),
        "conv_b": torch.zeros(ch, dtype=dtype, device=device),
        "dt_bias": f32(torch.zeros(h)),
        "A_log": f32(torch.log(torch.linspace(1.0, 16.0, h))),
        "D": f32(torch.ones(h)),
        "norm_w": f32(torch.ones(d_in)),
        "out_proj": dense_init(gen, (d_in, d), dtype, device=device),
    }


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def _split_proj(cfg: ModelConfig, zxbcdt):
    d_in, n = cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * n],
            zxbcdt[..., 2 * d_in + 2 * n:])


def _gated_out(p, cfg: ModelConfig, y, z):
    """out_proj(RMSNorm(y * silu(z))), the gate in f32."""
    g = (y * silu(z.float())).to(z.dtype)
    return rms_norm(g, p["norm_w"], cfg.norm_eps, plus_one=False) \
        @ p["out_proj"]


def ssm_forward(p, cfg: ModelConfig, u, *, return_state: bool = False):
    """u [bsz, s, d] -> [bsz, s, d]; with ``return_state`` also the
    ``SSMState`` after the last token, for ``ssm_decode_step``."""
    bsz, s, _ = u.shape
    d_in, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xbc, dt = _split_proj(cfg, u @ p["in_proj"])
    xbc_c = silu(causal_conv(xbc, p["conv_w"], p["conv_b"]))
    # x, B and C stay column views of the conv output: the kernel reads them
    # strided
    x = xbc_c[..., :d_in].reshape(bsz, s, h, pd)
    B = xbc_c[..., d_in:d_in + n]
    C = xbc_c[..., d_in + n:]
    dt = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = ssd_ops.ssd(x, dt, A, B, C, p["D"], chunk=cfg.ssm_chunk,
                    return_final_state=return_state)
    if return_state:
        y, final = y
    out = _gated_out(p, cfg, y.reshape(bsz, s, d_in), z)
    if not return_state:
        return out
    return out, SSMState(ssm=final,
                         conv=conv_history(xbc, cfg.ssm_conv_width))


def ssm_init_state(cfg: ModelConfig, bsz: int, dtype, device) -> SSMState:
    return SSMState(
        ssm=torch.zeros((bsz, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                        dtype=torch.float32, device=device),
        conv=torch.zeros((bsz, cfg.ssm_conv_width - 1, conv_channels(cfg)),
                         dtype=dtype, device=device))


def ssm_decode_step(p, cfg: ModelConfig, u, state: SSMState):
    """u [bsz, 1, d] -> (out [bsz, 1, d], new state)."""
    bsz = u.shape[0]
    d_in, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xbc, dt = _split_proj(cfg, u @ p["in_proj"])
    conv_in = torch.cat([state.conv, xbc], dim=1)  # [bsz, K, ch]
    # the JAX package's einsum("bkc,kc->bc") in the activation dtype: an f32
    # sum, rounded once
    out = (conv_in.float() * p["conv_w"].float()).sum(dim=1).to(u.dtype)
    xbc_c = silu(out + p["conv_b"])
    x = xbc_c[:, :d_in].reshape(bsz, h, pd)
    B = xbc_c[:, d_in:d_in + n]
    C = xbc_c[:, d_in + n:]
    dtv = _softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, new_ssm = ssd_ref.ssd_decode_step(x, dtv, A, B, C, p["D"], state.ssm)
    out = _gated_out(p, cfg, y.reshape(bsz, 1, d_in), z)
    return out, SSMState(ssm=new_ssm, conv=conv_in[:, 1:])
