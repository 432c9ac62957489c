"""The closed loop: estimate->route->observe over a whole stream, with the
profile state kept on the device.

Each observation changes the profile the NEXT decision reads, so the loop
is sequential.  ``scan_stream`` runs it as a loop of tensor operations
over ``ProfileState`` — ``decide_state`` (Algorithm 1's masked argmin)
then ``observe_state`` (EWMA fold) per step — with no host round trip
between frames: every per-step value stays a device tensor until the
trace is read back at the end.

The contract that makes this possible: per-step measurements are
DECISION-INDEPENDENT.  A ``DriftingFleet``'s cost at step t depends only
on (device, step), never on which pair was routed, so the caller
precomputes ``measurements[t, j]`` — what pair j WOULD have cost at step t
— and the loop gathers the routed pair's column.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .groups import DEFAULT_GROUP_RULES, group_of
from .profiles import (ProfileArrays, ProfileState, observe_state,
                       probe_state, quarantine_state, with_fails)
from .router import decide_state, rules_arrays


@dataclasses.dataclass(frozen=True)
class StreamMeasurements:
    """Decision-independent per-step, per-pair runtime measurements.

    ``time_ms``/``energy_mwh`` are [T, n_pairs] arrays aligned to the
    snapshot's ``pairs`` order: row t holds what EACH pair would have
    measured serving step t.  ``map_pct`` is optional ([T, n_pairs] or
    None); NaN cells mean "no measurement".  An INF ``time_ms`` cell is
    the failure sentinel: the pair did not answer at step t, so no
    measurement is folded and the routed cell's quarantine count rises.
    """
    time_ms: np.ndarray
    energy_mwh: np.ndarray
    map_pct: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class ScanDecisions:
    """One closed-loop run's routing trace, mapped back to table identity:
    ``pair_idx[t]`` indexes the snapshot's ``pairs``, ``group_row[t]`` the
    state rows, ``entry_idx[t]`` the table's ``entries`` (-1 when an
    explored pair has no row for that step's group), ``explored[t]`` marks
    round-robin exploration overrides."""
    pair_idx: np.ndarray    # [T] int into arrays.pairs
    group_row: np.ndarray   # [T] int state row
    entry_idx: np.ndarray   # [T] int32 into table.entries; -1 = no row
    explored: np.ndarray    # [T] bool


def measurements_from_fleet(pairs, n_steps: int,
                            fleet=None) -> StreamMeasurements:
    """The builder of the loop's measurement matrices: for each (model,
    device) pair, the cost at step t is ``fleet.cost(device,
    model_flops, t)`` (vectorized via ``DriftingFleet.cost_profile``).
    Without a fleet, measurements equal the offline device model.
    ``pairs`` must be the snapshot's ``arrays.pairs`` order."""
    from repro_torch.detection.detectors import DETECTOR_CONFIGS
    from repro_torch.detection.devices import DEVICES
    t = np.empty((n_steps, len(pairs)))
    e = np.empty((n_steps, len(pairs)))
    for j, (model, device) in enumerate(pairs):
        flops = DETECTOR_CONFIGS[model].flops
        if fleet is not None:
            t[:, j], e[:, j] = fleet.cost_profile(device, flops, n_steps)
        else:
            t[:, j] = DEVICES[device].time_ms(flops)
            e[:, j] = DEVICES[device].energy_mwh(flops)
    return StreamMeasurements(time_ms=t, energy_mwh=e)


def _run(state, counts, t_meas, e_meas, m_meas, explore, lo, hi, rule_rows,
         col_of_pair, delta, alpha, quarantine):
    """The loop itself: every argument is a tensor on one device, and so
    is every value it computes.  Per-step values are kept as shape-[1]
    tensors: indexing with a 0-dim tensor would read it back to the host
    (PyTorch turns it into a Python int), a sync per index."""
    nan = torch.tensor([float("nan")], device=t_meas.device)
    gs, cols, pairs = [counts[:0]], [counts[:0]], [counts[:0]]
    for t in range(counts.shape[0]):
        g, col, _ = decide_state(state, counts[t:t + 1], delta, lo, hi,
                                 rule_rows, quarantine_after=quarantine)
        pair = state.pair_id[g, col]
        # round-robin exploration override (expl = -1: router's pick); the
        # explored pair's column in this group row maps the decision back
        # to an entry (-1 when the pair has no row here).  Under
        # quarantine this IS the half-open probe.
        expl = explore[t:t + 1]
        explored = expl >= 0
        pair = torch.where(explored, expl, pair)
        col = torch.where(explored, col_of_pair[g, pair], col)
        # inf time = the pair did not answer: no EWMA evidence, one more
        # consecutive failure at the routed cell
        t_ms = t_meas[t][pair]
        failed = torch.isinf(t_ms)
        state = observe_state(
            state, pair, g,
            time_ms=torch.where(failed, nan, t_ms),
            energy_mwh=torch.where(failed, nan, e_meas[t][pair]),
            map_pct=torch.where(failed, nan, m_meas[t][pair]), alpha=alpha)
        state = quarantine_state(state, pair, g, failed)
        state = probe_state(state, pair, explored & ~failed)
        gs.append(g)
        cols.append(col)
        pairs.append(pair)
    return state, torch.cat(gs), torch.cat(cols), torch.cat(pairs)


def scan_stream(state: ProfileState, counts, measurements: StreamMeasurements,
                *, arrays: ProfileArrays, delta: float, alpha: float = 0.1,
                group_rules: Sequence = DEFAULT_GROUP_RULES,
                explore_pairs=None, quarantine_after: Optional[int] = None
                ) -> Tuple[ProfileState, ScanDecisions]:
    """Run estimate->route->observe for a whole frame sequence on the
    state's device; returns the final state and the routing trace.

    Per step t: Algorithm 1 routes ``counts[t]`` against the CURRENT state
    (``decide_state``), the routed pair's decision-independent measurement
    ``measurements[t, pair]`` is gathered, and ``observe_state``
    EWMA-folds it before step t+1 decides — the scalar closed loop's order
    of operations, in f32 as the JAX package's scan computes it.

    ``arrays`` is the snapshot ``state`` was exported from.
    ``explore_pairs`` (optional [T], -1 = no override) serves step t on
    that pair index instead of the router's pick.  ``quarantine_after``
    (optional) arms the per-(group, pair) circuit breaker: after that many
    CONSECUTIVE failed steps the cell is excluded from routing until an
    ``explore_pairs`` probe of the pair succeeds.

    Raises the scalar path's ``ValueError`` when any count lands in an
    unprofiled group (checked on the host before the loop starts).
    """
    counts = np.asarray(counts, np.int64)
    T = len(counts)
    for c in counts:
        group = group_of(int(c), group_rules)
        if group not in arrays.row_of:
            raise ValueError(
                f"no profile rows for group {group} (table covers groups "
                f"{sorted(arrays.groups)}); profile every group the router "
                f"can be asked for")
    n_pairs = len(arrays.pairs)
    t_meas = np.asarray(measurements.time_ms, np.float32)
    e_meas = np.asarray(measurements.energy_mwh, np.float32)
    m_meas = (np.full((T, n_pairs), np.nan, np.float32)
              if measurements.map_pct is None
              else np.asarray(measurements.map_pct, np.float32))
    for name, arr in (("time_ms", t_meas), ("energy_mwh", e_meas),
                      ("map_pct", m_meas)):
        if arr.shape != (T, n_pairs):
            raise ValueError(
                f"measurements.{name} has shape {arr.shape}, expected "
                f"({T}, {n_pairs}) — one row per step, one column per "
                f"profiled pair in arrays.pairs order")
    explore = (np.full(T, -1, np.int64) if explore_pairs is None
               else np.asarray(explore_pairs, np.int64))
    dev = state.map_pct.device

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    lo, hi, rule_rows = rules_arrays(group_rules, arrays.row_of, dev)
    state, g, col, pair = _run(
        with_fails(state), on_dev(counts), on_dev(t_meas), on_dev(e_meas),
        on_dev(m_meas), on_dev(explore), lo, hi, rule_rows,
        on_dev(arrays.col_of_pair.astype(np.int64)),
        torch.tensor(delta, dtype=torch.float32, device=dev),
        torch.tensor(alpha, dtype=torch.float32, device=dev),
        quarantine_after)
    g, col, pair = g.cpu().numpy(), col.cpu().numpy(), pair.cpu().numpy()
    entry_idx = np.where(col >= 0, arrays.entry_index[g, np.maximum(col, 0)],
                         -1).astype(np.int32)
    return state, ScanDecisions(pair_idx=pair, group_row=g,
                                entry_idx=entry_idx, explored=explore >= 0)
