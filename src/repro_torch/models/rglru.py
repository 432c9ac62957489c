"""RecurrentGemma recurrent block: conv1d + RG-LRU gated linear recurrence,
the counterpart of the JAX package's ``models/rglru.py``.

Block (Griffin [arXiv:2402.19427]):
  branch1: W_gate(x) -> tanh GeLU
  branch2: W_x(x) -> causal depthwise conv1d (width 4) -> RG-LRU
  out    : W_out(branch1 * branch2)

Prefill runs the recurrence through the RG-LRU kernel's wrapper (the CUDA
kernel on the card, its plain version on the CPU); the gates stay plain
PyTorch in f32, as the JAX package computes them outside its kernel.
Decode runs the plain single-step recurrence, as the JAX package does.
``lru_wa``, ``lru_wx``, ``lru_ba``, ``lru_bx`` and ``log_lambda`` stay in
f32 (the gates read them in f32); the other matrices and the conv take the
activation dtype.  Rounding follows the JAX package in bf16: the prefill
conv sums its K products in the activation dtype in order, the decode conv
accumulates them in f32 and rounds once.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.rglru_scan import ref as lru_ref

from .base import ModelConfig
from .layers import causal_conv, conv_history, dense_init, gelu_tanh


class RecState(NamedTuple):
    h: torch.Tensor     # [bsz, w] f32 recurrence state
    conv: torch.Tensor  # [bsz, conv_width - 1, w], activation dtype


def init_rec(gen, cfg: ModelConfig, dtype, device=None):
    """Seeded parameters of one block; Lambda so that a = lam^c at r = 1
    for lam uniform in [0.9, 0.999] (the Griffin init)."""
    d, w = cfg.d_model, cfg.lru_width
    lam = 0.9 + 0.099 * torch.rand(w, generator=gen, device=device)
    return {
        "w_gate": dense_init(gen, (d, w), dtype, device=device),
        "w_x": dense_init(gen, (d, w), dtype, device=device),
        "conv_w": dense_init(gen, (cfg.conv_width, w), dtype, scale=0.5,
                             device=device),
        "conv_b": torch.zeros(w, dtype=dtype, device=device),
        "lru_wa": dense_init(gen, (w, w), torch.float32, device=device),
        "lru_ba": torch.zeros(w, device=device),
        "lru_wx": dense_init(gen, (w, w), torch.float32, device=device),
        "lru_bx": torch.zeros(w, device=device),
        "log_lambda": torch.log(torch.expm1(-torch.log(lam)
                                            / lru_ref.RGLRU_C)),
        "w_out": dense_init(gen, (w, d), dtype, device=device),
    }


def _gates(p):
    return (p["lru_wa"], p["lru_ba"], p["lru_wx"], p["lru_bx"],
            p["log_lambda"])


def rec_forward(p, cfg: ModelConfig, x, *, return_state: bool = False):
    """x [bsz, s, d] -> [bsz, s, d]; with ``return_state`` also the
    ``RecState`` after the last token, for ``rec_decode_step``."""
    gate = gelu_tanh(x @ p["w_gate"])
    u = x @ p["w_x"]
    h = lru_ops.rglru(causal_conv(u, p["conv_w"], p["conv_b"]), *_gates(p),
                      return_final_state=return_state)
    if return_state:
        h, h_final = h
    out = (gate * h) @ p["w_out"]
    if not return_state:
        return out
    return out, RecState(h=h_final, conv=conv_history(u, cfg.conv_width))


def rec_init_state(cfg: ModelConfig, bsz: int, dtype, device) -> RecState:
    return RecState(
        h=torch.zeros((bsz, cfg.lru_width), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((bsz, cfg.conv_width - 1, cfg.lru_width),
                         dtype=dtype, device=device))


def rec_decode_step(p, cfg: ModelConfig, x, state: RecState):
    """x [bsz, 1, d] -> (out [bsz, 1, d], new state)."""
    gate = gelu_tanh(x @ p["w_gate"])
    conv_in = torch.cat([state.conv, x @ p["w_x"]], dim=1)  # [bsz, K, w]
    # the JAX package's einsum("bkc,kc->bc") in the activation dtype: an f32
    # sum, rounded once
    u_c = (conv_in.float() * p["conv_w"].float()).sum(dim=1).to(x.dtype) \
        + p["conv_b"]
    y, h = lru_ref.rglru_decode_step(u_c, *_gates(p), state.h)
    return (gate * y[:, None]) @ p["w_out"], RecState(h=h,
                                                      conv=conv_in[:, 1:])
