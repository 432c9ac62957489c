"""Synthetic LM data: deterministic token streams (a Zipf-distributed
vocabulary with a Markov bigram structure, so a model can learn it) and
the stub modality frontends (patch or frame embeddings for the vlm and
encdec families, whose vision or audio towers are not modelled).

The draws are the JAX package's ``repro.data.tokens``, call for call, in
numpy: the same seed gives the same tokens and embeddings.  The arrays
become torch tensors on the caller's device at the end.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.base import ModelConfig


@dataclasses.dataclass
class DataConfig:
    seq_len: int = 512
    batch_size: int = 8
    seed: int = 0


def _zipf_probs(vocab: int, alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -alpha
    return (p / p.sum()).astype(np.float64)


class TokenStream:
    """Markov-bigram synthetic corpus over the first min(vocab, 4096)
    tokens: each token is followed by one of 4 fixed random successors
    with probability 0.7, else by a fresh Zipf draw."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg, self.data = cfg, data
        self.rng = np.random.default_rng(data.seed)
        v = min(cfg.vocab_size, 4096)  # active vocabulary slice
        self.v = v
        self.base = _zipf_probs(v)
        self.succ = self.rng.integers(0, v, size=(v, 4))

    def _sample_seq(self, length: int) -> np.ndarray:
        out = np.empty(length, np.int32)
        tok = int(self.rng.choice(self.v, p=self.base))
        for i in range(length):
            out[i] = tok
            if self.rng.random() < 0.7:
                tok = int(self.succ[tok, self.rng.integers(0, 4)])
            else:
                tok = int(self.rng.choice(self.v, p=self.base))
        return out

    def batches(self, device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
        """Endless batches on ``device``: ``tokens`` and ``labels`` [B, S]
        int64 (the labels are the tokens shifted by one), plus the
        config's ``modality_inputs``."""
        dev = resolve_device(device)
        s, b = self.data.seq_len, self.data.batch_size
        while True:
            arr = torch.from_numpy(np.stack([self._sample_seq(s + 1)
                                             for _ in range(b)])).long()
            batch = {"tokens": arr[:, :-1].to(dev),
                     "labels": arr[:, 1:].to(dev)}
            batch.update(modality_inputs(self.cfg, b, self.rng, device=dev))
            yield batch


def modality_inputs(cfg: ModelConfig, batch: int, rng,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """The stub frontends' outputs, drawn from ``rng`` (a numpy
    ``Generator``) in f32: ``prefix_embeds`` [batch, num_prefix_embeds,
    vision_dim] for a vlm config, [batch, enc_seq, vision_dim] for an
    encdec one; nothing is drawn for the other families."""
    if cfg.family == "vlm" and cfg.num_prefix_embeds:
        shape = (batch, cfg.num_prefix_embeds, cfg.vision_dim)
    elif cfg.family == "encdec":
        shape = (batch, cfg.enc_seq, cfg.vision_dim)
    else:
        return {}
    return {"prefix_embeds": torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(resolve_device(device))}
