"""Roofline terms of one measured step on one card: the JAX package's
``launch/roofline.py`` with the chip's rates in a ``Chip`` record.

Three terms per (arch x shape x card), in seconds:

  compute    = counted operations / peak operations per second
  memory     = counted bytes / HBM bytes per second
  collective = collective bytes / link bytes per second

The counts come from ``launch/cost.py`` (the reference reads them from
the compiled HLO) and the collective bytes from ``sharding/comm.py`` (a
mesh row's; one card moves none, so its collective term is 0).
``h100`` is the card's record: the data sheet's bf16, HBM and NVLink
rates, and the power limit and idle draw read from the card by
``nvidia-smi``.  The link rate is one card's NVLink to the others of its
node: a mesh of 256 cards spans 32 nodes of 8, and the network between
nodes, slower than NVLink, is not modelled.
"""
from __future__ import annotations

import dataclasses
import math
import subprocess
import time
from typing import Dict, Optional

import torch

from repro_torch.models import init_params
from repro_torch.optim.adamw import tree_leaves, tree_paths


@dataclasses.dataclass(frozen=True)
class Chip:
    """One chip's peak rates and power."""
    name: str
    peak_flops: float              # operations/s at the roofline's type
    hbm_bw: float                  # bytes/s
    link_bw: Optional[float]       # bytes/s per link; None: no link
    power_idle: float              # W
    power_peak: float              # W
    memory_bytes: float = 80e9     # device memory


#: NVIDIA's data sheet for one H100 SXM: dense bf16 and HBM3
H100_PEAK_FLOPS = 989e12
H100_HBM_BW = 3.35e12
#: the same data sheet's NVLink (4th generation): 900 GB/s a card, both
#: directions together, so 450 GB/s each way
H100_LINK_BW = 450e9
#: the data sheet's power limit, for a rehearsal on the CPU (no card to
#: read); its idle draw is taken as 0 W there
H100_POWER_LIMIT = 700.0


def _watts(field: str) -> float:
    return float(field.strip().split()[0])


#: the idle draw: the least of this many samples of ``power.draw``, one
#: every ``REST_INTERVAL_S`` after the card's queue has drained, so that a
#: card still settling from earlier work reads its rest
REST_SAMPLES = 8
REST_INTERVAL_S = 0.25


def _query(index: int):
    """(name, power limit, power draw) of card ``index`` as ``nvidia-smi``
    prints them; raises if it fails."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}",
         "--query-gpu=name,power.limit,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return [f.strip() for f in out.strip().splitlines()[0].split(",")]


def h100(device="cuda") -> Chip:
    """The card's record.  On a CUDA device: its name, power limit (the
    peak power), idle draw (the least of ``REST_SAMPLES`` samples of the
    power draw over ~2 s at rest: call it before the first step) and
    memory.  Raises if ``nvidia-smi`` fails.  On the CPU: the data
    sheet's rates with ``H100_POWER_LIMIT`` and an idle draw of 0 W, named
    so."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return Chip("NVIDIA H100 data sheet (no card read)",
                    H100_PEAK_FLOPS, H100_HBM_BW, H100_LINK_BW, 0.0,
                    H100_POWER_LIMIT)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    torch.cuda.synchronize(index)
    draws = []
    for _ in range(REST_SAMPLES):
        time.sleep(REST_INTERVAL_S)
        name, limit, draw = _query(index)
        draws.append(_watts(draw))
    return Chip(f"{name}, {limit}", H100_PEAK_FLOPS, H100_HBM_BW,
                H100_LINK_BW, min(draws), _watts(limit),
                float(torch.cuda.get_device_properties(index).total_memory))


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                # per-chip counted operations
    bytes_accessed: float       # per-chip counted bytes
    coll_bytes: float           # per-chip weighted collective bytes
    coll_by_kind: Dict[str, float]
    per_device_memory: float    # bytes (peak allocation)
    model_flops: float          # analytic 6ND / 2ND (global)
    chip: Chip

    @property
    def t_compute(self) -> float:
        return self.flops / self.chip.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / self.chip.hbm_bw

    @property
    def t_collective(self) -> float:
        """0 on a chip without a link, and for a row of one chip: it has
        no peer to move collective bytes to."""
        if not self.chip.link_bw or self.chips == 1:
            return 0.0
        return self.coll_bytes / self.chip.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_step(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (chips x per-chip counted flops)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def energy_j(self) -> float:
        """First-order energy per step: busy time x chip power x chips."""
        t = self.t_step
        if t == 0:
            return 0.0
        util = self.t_compute / t
        p = self.chip.power_idle + (self.chip.power_peak
                                    - self.chip.power_idle) * util
        return t * p * self.chips

    def energy_over(self, seconds: float) -> float:
        """The same first-order energy for a step that took ``seconds``:
        the idle draw over that time, plus the draw above idle over the
        compute term.  ``energy_over(t_step)`` is ``energy_j``."""
        return (seconds * self.chip.power_idle + (
            self.chip.power_peak - self.chip.power_idle)
            * self.t_compute) * self.chips

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_chip": self.flops,
            "bytes_per_chip": self.bytes_accessed,
            "coll_bytes_per_chip": self.coll_bytes,
            "coll_by_kind": self.coll_by_kind,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_step_s": self.t_step,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "per_device_memory_gb": self.per_device_memory / 2**30,
            "energy_j": self.energy_j,
        }


def model_flops(cfg, shape, n_params: int, n_active: int) -> float:
    """6·N·D for training, 2·N·D for inference (N = active params)."""
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def count_params(cfg) -> Dict[str, int]:
    """Total and active (MoE top-k weighted) param counts from the
    shapes of ``init_params`` on the meta device: nothing is allocated."""
    params = init_params(cfg, device="meta")
    total = active = 0
    for keys, leaf in zip(tree_paths(params), tree_leaves(params)):
        n = math.prod(leaf.shape)
        total += n
        if "moe/w_" in keys and cfg.num_experts:
            active += n * cfg.moe_top_k / cfg.num_experts
        elif "embed/table" in keys:
            active += 0  # embedding lookups are not matmul FLOPs
        else:
            active += n
    return {"total": total, "active": int(active)}
