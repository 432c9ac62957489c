"""Routing: the paper's greedy Algorithm 1, scalar and over ProfileState.

Algorithm 1 (faithful):
  1-7   determine group from the (estimated) object count via group rules
  8-9   filter profiling data to that group
  10-11 mAP_max over the group; mAP_min = mAP_max - delta_mAP
  12-13 keep pairs with mAP >= mAP_min (feasible set F)
  14-15 return argmin energy over F

Beside it: the paper's baselines (RR, Rnd, LE, LI, HM, HMG, Orc) and the
repo's multi-objective ``WeightedRouter`` and ``ParetoRouter``.  The
scalar routers compare the entries' Python floats (float64) on the host;
the tensorized ``decide_state``/``route_batch`` compare in f32 on the
state's device, as the JAX package's jitted router does.
"""
from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .groups import DEFAULT_GROUP_RULES, group_of
from .profiles import ProfileArrays, ProfileEntry, ProfileState, ProfileTable

Pair = Tuple[str, str]


def feasible_set(group: int, profiling_data: ProfileTable,
                 delta_map: float) -> List[ProfileEntry]:
    """Algorithm 1 lines 8-13: group filter -> mAP threshold."""
    group_data = profiling_data.for_group(group)            # lines 8-9
    if not group_data:
        known = sorted({e.group for e in profiling_data.entries})
        raise ValueError(
            f"no profile rows for group {group} (table covers groups "
            f"{known}); profile every group the router can be asked for")
    max_map = max(e.map_pct for e in group_data)            # line 10
    map_min = max_map - delta_map                           # line 11
    return [e for e in group_data if e.map_pct >= map_min]  # lines 12-13


def feasible_for_count(count: int, profiling_data: ProfileTable,
                       delta_map: float,
                       group_rules: Sequence = DEFAULT_GROUP_RULES
                       ) -> List[ProfileEntry]:
    """Algorithm 1 lines 1-13: group lookup + feasible set."""
    group = group_of(count, group_rules)                    # lines 1-7
    return feasible_set(group, profiling_data, delta_map)


def pareto_front(entries: Sequence[ProfileEntry]) -> List[ProfileEntry]:
    """Entries not dominated in BOTH (energy, time) by another entry, in
    their input order."""
    return [e for e in entries
            if not any(o.energy_mwh <= e.energy_mwh and o.time_ms <= e.time_ms
                       and o is not e
                       and (o.energy_mwh < e.energy_mwh
                            or o.time_ms < e.time_ms)
                       for o in entries)]


def greedy_route(number_of_objects: int, profiling_data: ProfileTable,
                 delta_map: float,
                 group_rules: Sequence = DEFAULT_GROUP_RULES) -> ProfileEntry:
    """Algorithm 1, line for line."""
    refined = feasible_for_count(number_of_objects, profiling_data,
                                 delta_map, group_rules)    # lines 1-13
    return min(refined, key=lambda e: e.energy_mwh)         # lines 14-15


def runner_up_route(number_of_objects: int, profiling_data: ProfileTable,
                    delta_map: float, exclude: Sequence[Pair],
                    group_rules: Sequence = DEFAULT_GROUP_RULES
                    ) -> Optional[ProfileEntry]:
    """Algorithm 1's NEXT pick: the argmin-energy entry of the feasible set
    without the ``exclude``d pairs — where a hedged retry goes when the
    first pick's device fails (``serving.resilience``).  An empty
    exclusion gives the greedy pick; None when every feasible pair is
    excluded."""
    excluded = set(exclude)
    refined = [e for e in feasible_for_count(number_of_objects,
                                             profiling_data, delta_map,
                                             group_rules)
               if e.pair not in excluded]
    return min(refined, key=lambda e: e.energy_mwh) if refined else None


# ------------------------------------------------------- tensorized routing

def decide_state(state: ProfileState, count, delta, lo, hi, rule_rows,
                 quarantine_after=None):
    """Algorithm 1 for a tensor of counts (any shape, 0-dim included)
    against a ``ProfileState``, without leaving the device.

    ``lo``/``hi``/``rule_rows`` are the group rules as tensors (see
    ``rules_arrays``).  Returns ``(group_row, col, ok)`` shaped like
    ``count``: the state row the count landed in (-1 = unprofiled group),
    the masked-argmin column (lines 14-15; ties break like the scalar
    ``min`` because rows keep table order and argmin takes the first
    minimum), and whether the feasible set was non-empty.

    ``quarantine_after`` (None = off) excludes cells whose ``fails`` count
    reached it from both the mAP_max scan and the feasible set; when every
    pair of the group is quarantined the unquarantined mask is restored.
    """
    m = (count[..., None] >= lo) & (count[..., None] <= hi)  # lines 1-7
    rule = torch.where(m.any(-1), torch.argmax(m.to(torch.int32), -1),
                       lo.shape[0] - 1)
    g = rule_rows[rule]                                     # lines 8-9
    g_safe = g.clamp(min=0)
    gm = state.map_pct[g_safe]                              # [..., P]
    v = state.valid[g_safe]
    if quarantine_after is not None:
        qv = v & (state.fails[g_safe] < quarantine_after)
        v = torch.where(qv.any(-1, keepdim=True), qv, v)   # fail open
        max_map = torch.where(v, gm, -torch.inf).amax(-1)   # line 10
    else:
        max_map = gm.amax(-1)               # line 10 (pads already -inf)
    feasible = v & (gm >= (max_map - delta)[..., None])     # lines 11-13
    e = torch.where(feasible, state.energy_mwh[g_safe], torch.inf)
    col = torch.argmin(e, -1)                               # lines 14-15
    return g, col, feasible.any(-1)


def rules_arrays(group_rules: Sequence, row_of, device
                 ) -> Tuple[torch.Tensor, ...]:
    """Group rules as (lo, hi, rule_rows) int64 tensors on ``device``."""
    lo = [r[0] for r in group_rules]
    hi = [r[1] if r[1] is not None else np.iinfo(np.int32).max
          for r in group_rules]
    rule_rows = [row_of.get(label, -1) for _, _, label in group_rules]
    return tuple(torch.tensor(a, dtype=torch.int64, device=device)
                 for a in (lo, hi, rule_rows))


def route_batch(counts, profiling_data, delta_map: float,
                group_rules: Sequence = DEFAULT_GROUP_RULES) -> np.ndarray:
    """Algorithm 1 lines 1-15 over a whole batch of counts at once, on the
    device the profile state lives on.

    ``profiling_data`` is a ``ProfileTable`` or a ``ProfileArrays``
    snapshot.  Returns indices into the table's ``entries`` — exactly the
    entries scalar ``greedy_route`` would pick.  The comparisons run in
    f32, as the JAX package's jitted router does.  Raises the scalar
    path's ``ValueError`` when any count lands in an unprofiled group.
    """
    arrays = (profiling_data if isinstance(profiling_data, ProfileArrays)
              else profiling_data.as_arrays())
    dev = arrays.state.map_pct.device
    lo, hi, rule_rows = rules_arrays(group_rules, arrays.row_of, dev)
    counts = np.asarray(counts, np.int64)
    g, pick, ok = decide_state(
        arrays.state, torch.from_numpy(counts).to(dev),
        torch.tensor(delta_map, dtype=torch.float32, device=dev),
        lo, hi, rule_rows)
    g, pick, ok = g.cpu().numpy(), pick.cpu().numpy(), ok.cpu().numpy()
    if (bad := ~(ok & (g >= 0))).any():
        group = group_of(int(counts[np.argmax(bad)]), group_rules)
        raise ValueError(
            f"no profile rows for group {group} (table covers groups "
            f"{sorted(arrays.groups)}); profile every group the router "
            f"can be asked for")
    return arrays.entry_index[g, pick]


class Router:
    """Base: given request metadata, pick a (model, device) pair."""
    name = "base"
    #: True if the router consumes an object-count estimate
    uses_estimate = False
    #: True if the router consumes the ground-truth count (oracle-class)
    uses_ground_truth = False
    #: True if route_batch is a single tensorized call (stateless routers
    #: whose per-frame decision depends only on the count)
    batchable = False

    def __init__(self, table: ProfileTable, delta_map: float = 5.0,
                 group_rules: Sequence = DEFAULT_GROUP_RULES):
        self.table = table
        self.delta = delta_map
        self.rules = group_rules

    def route(self, *, estimated_count: Optional[int] = None,
              true_count: Optional[int] = None) -> Pair:
        raise NotImplementedError

    def route_batch(self, *, estimated_counts=None,
                    true_counts=None) -> List[Pair]:
        """Route a whole batch; the generic fallback loops ``route``."""
        n = len(estimated_counts if estimated_counts is not None
                else true_counts)
        est = ([None] * n if estimated_counts is None
               else list(estimated_counts))
        true = [None] * n if true_counts is None else list(true_counts)
        return [self.route(estimated_count=e, true_count=t)
                for e, t in zip(est, true)]

    def _route_batch_greedy(self, counts) -> List[Pair]:
        idx = route_batch(counts, self.table, self.delta, self.rules)
        entries = self.table.entries
        return [entries[i].pair for i in idx]

    def reset(self):
        pass


class GreedyEstimateRouter(Router):
    """The ECORE router: Algorithm 1 over an ESTIMATED count."""
    name = "greedy"
    uses_estimate = True
    batchable = True

    def route(self, *, estimated_count=None, true_count=None) -> Pair:
        return greedy_route(int(estimated_count or 0), self.table, self.delta,
                            self.rules).pair

    def route_batch(self, *, estimated_counts=None, true_counts=None):
        return self._route_batch_greedy([int(c or 0)
                                         for c in estimated_counts])


class OracleRouter(Router):
    """Orc: Algorithm 1 with perfect knowledge of the object count."""
    name = "Orc"
    uses_ground_truth = True
    batchable = True

    def route(self, *, estimated_count=None, true_count=None) -> Pair:
        return greedy_route(int(true_count), self.table, self.delta,
                            self.rules).pair

    def route_batch(self, *, estimated_counts=None, true_counts=None):
        return self._route_batch_greedy([int(c) for c in true_counts])


class RoundRobinRouter(Router):
    name = "RR"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._i = 0
        self._pairs = self.table.pairs()

    def route(self, **_) -> Pair:
        p = self._pairs[self._i % len(self._pairs)]
        self._i += 1
        return p

    def reset(self):
        self._i = 0


class RandomRouter(Router):
    """Rnd: a uniform pick from an explicit ``random.Random(seed)``, so the
    choices equal the JAX router's for the same seed; ``reset`` reseeds."""
    name = "Rnd"

    def __init__(self, *a, seed: int = 0, **kw):
        super().__init__(*a, **kw)
        self._seed = seed
        self._rng = random.Random(seed)
        self._pairs = self.table.pairs()

    def route(self, **_) -> Pair:
        return self._rng.choice(self._pairs)

    def reset(self):
        self._rng = random.Random(self._seed)


class LowestEnergyRouter(Router):
    name = "LE"

    def route(self, **_) -> Pair:
        return min(self.table.entries, key=lambda e: e.energy_mwh).pair


class LowestInferenceRouter(Router):
    name = "LI"

    def route(self, **_) -> Pair:
        return min(self.table.entries, key=lambda e: e.time_ms).pair


class HighestMAPRouter(Router):
    """HM: highest overall mAP, independent of object count."""
    name = "HM"

    def route(self, **_) -> Pair:
        return max(self.table.pairs(), key=self.table.mean_map)


class HighestMAPPerGroupRouter(Router):
    """HMG: best mAP within the (true) object-count group; the paper's
    accuracy upper bound."""
    name = "HMG"
    uses_ground_truth = True

    def route(self, *, estimated_count=None, true_count=None) -> Pair:
        group = group_of(int(true_count), self.rules)
        return max(self.table.for_group(group), key=lambda e: e.map_pct).pair


class WeightedRouter(Router):
    """Multi-objective greedy (the paper's §6 future work):
    min  w_e * energy/energy_max + w_t * time/time_max
    s.t. group match and mAP >= mAP_max - delta.
    (w_e, w_t) = (1, 0) recovers Algorithm 1.  The normalizers are
    recomputed on every call, because closed-loop ``observe`` mutates the
    table; so the router is not batchable."""
    name = "Wgt"
    uses_estimate = True
    batchable = False

    def __init__(self, table: ProfileTable, delta_map: float = 5.0,
                 group_rules: Sequence = DEFAULT_GROUP_RULES,
                 w_energy: float = 0.5, w_time: float = 0.5):
        super().__init__(table, delta_map, group_rules)
        self.w_energy, self.w_time = w_energy, w_time

    def route(self, *, estimated_count=None, true_count=None) -> Pair:
        feasible = feasible_for_count(int(estimated_count or 0), self.table,
                                      self.delta, self.rules)
        e_max = max(e.energy_mwh for e in self.table.entries)
        t_max = max(e.time_ms for e in self.table.entries)
        return min(feasible, key=lambda e: (
            self.w_energy * e.energy_mwh / e_max
            + self.w_time * e.time_ms / t_max)).pair


class ParetoRouter(Router):
    """Restrict the feasible set to its (energy, time) Pareto front before
    the greedy pick: never selects a pair dominated in both objectives.
    The front is not tensorized, so the router is not batchable."""
    name = "Par"
    uses_estimate = True
    batchable = False

    def route(self, *, estimated_count=None, true_count=None) -> Pair:
        feasible = feasible_for_count(int(estimated_count or 0), self.table,
                                      self.delta, self.rules)
        return min(pareto_front(feasible), key=lambda e: e.energy_mwh).pair


BASELINE_ROUTERS = (OracleRouter, RoundRobinRouter, RandomRouter,
                    LowestEnergyRouter, LowestInferenceRouter,
                    HighestMAPRouter, HighestMAPPerGroupRouter)
