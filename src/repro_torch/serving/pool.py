"""Backend pool + ECORE routing for LLM serving.

The 'heterogeneous edge pool' of the paper becomes a pool of (architecture
x device) serving backends.  Request 'complexity' is the prompt-length
bucket (the LLM analog of the paper's object count), and the same
Algorithm 1 greedy router picks the cheapest backend within the accuracy
tolerance δ.

Accuracy proxy: each backend carries a capability score derived from
log10(active params), scaled to a 0..100 'mAP-like' range and saturating
per bucket (easy requests do not reward capacity), so no backend
dominates every bucket.  ``synthetic_pool_table`` builds the analytic
profile of the JAX package's ``launch/serve.py``; ``pool_table_from_dryrun``
reads the rows of a dry-run roofline artifact (``dryrun.jsonl``), which
the serve driver prefers when the file exists.  The artifact is the
port's own (``launch/dryrun.py``: mesh ``1x1``, each row with the batch
it ran and the step measured on the card, which routing reads) or the
JAX package's (a TPU mesh's compiled costs: the roofline estimate).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import List, Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.core.profiles import ProfileEntry, ProfileTable
from repro_torch.core.router import feasible_set, route_batch

#: the JAX package's default serving pool (``launch/serve.py``)
DEFAULT_POOL = ("qwen2.5-3b", "llama3-8b", "mamba2-370m",
                "granite-moe-1b-a400m", "recurrentgemma-2b")

# prompt-length buckets = the serving "object count groups"
LENGTH_BUCKETS = ((0, 512, 0), (513, 2048, 1), (2049, 8192, 2),
                  (8193, 32768, 3), (32769, None, 4))


def bucket_of(prompt_len: int) -> int:
    for lo, hi, label in LENGTH_BUCKETS:
        if prompt_len >= lo and (hi is None or prompt_len <= hi):
            return label
    return LENGTH_BUCKETS[-1][2]


#: quality saturation per bucket: short prompts are EASY (a 1B model ties a
#: 34B one); long prompts discriminate by capacity
_BUCKET_CAP = {0: 72.0, 1: 78.0, 2: 84.0, 3: 92.0, 4: 99.0}


def capability_score(params_active: int, subquadratic: bool,
                     bucket: int) -> float:
    """0..100 'accuracy' proxy: larger active models score higher, but each
    complexity bucket saturates; very long prompts favor architectures
    that handle them natively."""
    base = 20.0 * math.log10(max(params_active, 1) / 1e8 + 1.0) + 40.0
    if bucket >= 4 and not subquadratic:
        base -= 6.0  # degraded effective quality at extreme context
    return min(base, _BUCKET_CAP.get(bucket, 99.0))


def synthetic_pool_table(archs, *, device="cuda") -> ProfileTable:
    """Analytic profile of a pool (``launch/serve.py``'s fallback when
    no dry-run artifact exists), with the same numbers, so routing
    decisions equal the JAX package's.  The profile state lives on
    ``device``."""
    entries = []
    for arch in archs:
        cfg = get_config(arch)
        n = cfg.num_layers * cfg.d_model * cfg.d_model * 8  # rough
        for _, _, bucket in LENGTH_BUCKETS:
            entries.append(ProfileEntry(
                model=arch, device="pod-16x16", group=bucket,
                map_pct=capability_score(n, cfg.is_subquadratic, bucket),
                time_ms=n / 1e9, energy_mwh=n / 1e10))
    return ProfileTable(entries, device=device)


def pool_table_from_dryrun(dryrun_jsonl: str,
                           shapes: Sequence[str] = ("prefill_32k",),
                           mesh: str = "16x16", *,
                           device="cuda") -> ProfileTable:
    """Build a routing ProfileTable from dry-run roofline rows: the ``ok``
    rows of ``mesh`` at one of ``shapes``, each row's step time and energy
    split over the requests it served: its ``global_batch`` (a row of the
    port's dry run), else its shape's (the reference's rows).  The step
    is the measured one where the row has it (``measured_step_s`` and
    ``measured_energy_j``, the port's one-card rows), else the roofline
    estimate (``t_step_s`` and ``energy_j``): the reference's rows, and the
    port's mesh rows, whose measured step is rank 0's compute alone
    (``measured_scope``), without the collectives' term.  The profile
    state lives on ``device``."""
    with open(dryrun_jsonl) as f:
        rows = [json.loads(line) for line in f]
    entries: List[ProfileEntry] = []
    for r in rows:
        if r.get("status") != "ok" or r["mesh"] != mesh:
            continue
        if r["shape"] not in shapes:
            continue
        cfg = get_config(r["arch"])
        n_req = r.get("global_batch") or {
            "prefill_32k": 32, "decode_32k": 128, "long_500k": 1,
            "train_4k": 256}[r["shape"]]
        if "measured_step_s" in r and "measured_scope" not in r:
            time_ms = r["measured_step_s"] * 1e3 / n_req
            energy_mwh = r["measured_energy_j"] / 3.6 / n_req
        else:
            time_ms = r["t_step_s"] * 1e3 / n_req
            energy_mwh = r["energy_j"] / 3.6 / n_req
        for _, _, bucket in LENGTH_BUCKETS:
            entries.append(ProfileEntry(
                model=r["arch"], device=f"pod-{mesh}", group=bucket,
                map_pct=capability_score(r["params_active"],
                                         cfg.is_subquadratic, bucket),
                time_ms=time_ms, energy_mwh=energy_mwh))
    return ProfileTable(entries, device=device)


@dataclasses.dataclass
class PoolDecision:
    arch: str
    bucket: int
    time_ms: float
    energy_mwh: float
    score: float
    device: str = "pod"   # device the profile row belongs to


class ServingPool:
    """ECORE gateway over profiled serving backends."""

    def __init__(self, table: ProfileTable, delta: float = 5.0):
        self.table = table
        self.delta = delta

    def route(self, prompt_len: int) -> PoolDecision:
        bucket = bucket_of(prompt_len)
        # buckets ARE the profile groups: Algorithm 1's feasible set, then
        # the greedy argmin-energy pick
        e = min(feasible_set(bucket, self.table, self.delta),
                key=lambda e: e.energy_mwh)
        return PoolDecision(arch=e.model, bucket=bucket, time_ms=e.time_ms,
                            energy_mwh=e.energy_mwh, score=e.map_pct,
                            device=e.device)

    def route_batch(self, prompt_lens: Sequence[int]) -> List[PoolDecision]:
        """Route a whole batch in one tensorized Algorithm 1 call over the
        length buckets, decision for decision equal to ``route``."""
        out = []
        for i in route_batch(prompt_lens, self.table, self.delta,
                             group_rules=LENGTH_BUCKETS):
            e = self.table.entries[i]
            out.append(PoolDecision(arch=e.model, bucket=e.group,
                                    time_ms=e.time_ms,
                                    energy_mwh=e.energy_mwh,
                                    score=e.map_pct, device=e.device))
        return out

    def observe(self, arch: str, *, time_ms: Optional[float] = None,
                energy_mwh: Optional[float] = None,
                map_pct: Optional[float] = None,
                bucket: Optional[int] = None,
                alpha: float = 0.1) -> None:
        """Closed loop: EWMA-fold measured serving signals into the
        profile.  Latency/energy touch every row of ``arch`` (they are
        bucket-independent); a measured QUALITY signal (``map_pct``) is
        bucket-specific — pass the ``bucket`` it was measured on."""
        if map_pct is not None and bucket is None:
            raise ValueError(
                "map_pct is per-bucket: pass bucket= with the measurement")
        matched = False
        for pair in self.table.pairs():
            if pair[0] == arch:
                if time_ms is not None or energy_mwh is not None:
                    self.table.observe_pair(pair, time_ms=time_ms,
                                            energy_mwh=energy_mwh,
                                            alpha=alpha)
                if map_pct is not None:
                    self.table.observe(pair, bucket, map_pct=map_pct,
                                       alpha=alpha)
                matched = True
        if not matched:
            raise KeyError(arch)
