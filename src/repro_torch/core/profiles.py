"""Profile plane: ProfileState (the device-resident tensors) and
ProfileTable (the Python-facing facade Algorithm 1's scalar faces consume).

Each row profiles one (model, device) pair for one object-count group:
mAP (per group — accuracy depends on scene complexity), inference time and
energy (group-independent in the paper's testbed, replicated per group).

``ProfileState`` is a NamedTuple of padded per-group tensors that pure
functions thread: ``observe_state`` EWMA-folds a runtime measurement and
returns a NEW state, ``core.router.decide_state`` is Algorithm 1's masked
argmin over it, and ``core.closed_loop.scan_stream`` loops the two over a
stream with the state kept on the device.  ``ProfileTable`` owns the
entries and the device the state lives on: ``as_state()`` exports the
state, ``load_state()`` folds an updated state back into the entries, and
``observe``/``observe_pair`` are the scalar mirrors of ``observe_state``.
``add_pair``/``retire_pair`` grow and shrink the fleet on the state.
"""
from __future__ import annotations

import dataclasses
import json
import operator
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ProfileEntry:
    model: str
    device: str
    group: int
    map_pct: float       # mean Average Precision in [0, 100]
    time_ms: float       # inference latency
    energy_mwh: float    # energy per request

    @property
    def pair(self) -> Tuple[str, str]:
        return (self.model, self.device)

    @property
    def pair_name(self) -> str:
        return f"{self.model}@{self.device}"


class ProfileState(NamedTuple):
    """One [G, P] tensor per profile column, padded to the widest group
    (pads carry -inf mAP / +inf cost, ``valid=False``, ``pair_id=-1``).

    Within a row, entries keep the table's order, so a masked argmin
    breaks ties exactly like the scalar ``min`` over ``for_group``.
    ``pair_id[g, p]`` indexes the table's ``pairs()`` list.  ``fails`` is
    the quarantine plane: consecutive failed attempts per (group, pair)
    cell; all zeros = every breaker CLOSED.
    """
    map_pct: torch.Tensor      # [G, P] f32
    time_ms: torch.Tensor      # [G, P] f32
    energy_mwh: torch.Tensor   # [G, P] f32
    valid: torch.Tensor        # [G, P] bool
    pair_id: torch.Tensor      # [G, P] int64; -1 on pads
    fails: Optional[torch.Tensor] = None  # [G, P] int32; None = off


def observe_state(state: ProfileState, pair_idx, group_row, *,
                  time_ms=None, energy_mwh=None, map_pct=None,
                  alpha=0.1) -> ProfileState:
    """Pure EWMA fold of one runtime measurement — the tensor mirror of
    ``ProfileTable.observe_pair`` + ``observe``.

    Latency/energy are group-independent, so they update EVERY row of
    ``pair_idx``; measured quality is per-group, so ``map_pct`` only
    touches the (``group_row``, pair) cell.  A measurement may be None
    (skipped) or NaN (skipped without leaving the device — the
    no-measurement sentinel ``scan_stream`` relies on).  ``pair_idx``,
    ``group_row`` and the measurements may be 0-dim tensors.
    """
    pair_mask = state.pair_id == pair_idx
    rows = torch.arange(state.map_pct.shape[0],
                        device=state.map_pct.device)[:, None]
    cell_mask = pair_mask & (rows == group_row)

    def fold(old, new, mask):
        if new is None:
            return old
        new = torch.as_tensor(new, dtype=torch.float32, device=old.device)
        upd = (1.0 - alpha) * old + alpha * new
        return torch.where(mask & ~torch.isnan(new), upd, old)

    return state._replace(
        time_ms=fold(state.time_ms, time_ms, pair_mask),
        energy_mwh=fold(state.energy_mwh, energy_mwh, pair_mask),
        map_pct=fold(state.map_pct, map_pct, cell_mask))


def with_fails(state: ProfileState) -> ProfileState:
    """State with the quarantine counter materialized (all breakers
    CLOSED); identity when ``fails`` is already a tensor."""
    if state.fails is not None:
        return state
    return state._replace(fails=torch.zeros(state.pair_id.shape,
                                            dtype=torch.int32,
                                            device=state.pair_id.device))


def quarantine_state(state: ProfileState, pair_idx, group_row,
                     failed) -> ProfileState:
    """Pure circuit-breaker fold of ONE attempt outcome at the routed
    (group, pair) cell: a failure increments the cell's consecutive-failure
    count, a success resets it to zero.  ``failed`` may be a bool tensor."""
    state = with_fails(state)
    rows = torch.arange(state.pair_id.shape[0],
                        device=state.pair_id.device)[:, None]
    cell = (state.pair_id == pair_idx) & (rows == group_row)
    upd = torch.where(torch.as_tensor(failed, device=state.fails.device),
                      state.fails + 1, torch.zeros_like(state.fails))
    return state._replace(fails=torch.where(cell, upd, state.fails))


def probe_state(state: ProfileState, pair_idx, success) -> ProfileState:
    """Pure half-open-probe fold: a SUCCESSFUL probe of ``pair_idx``
    closes the breaker on EVERY group row of the pair; a failed probe is
    the identity (the per-cell count already moved through
    ``quarantine_state``)."""
    state = with_fails(state)
    closed = (state.pair_id == pair_idx) & torch.as_tensor(
        success, device=state.fails.device)
    return state._replace(
        fails=torch.where(closed, torch.zeros_like(state.fails),
                          state.fails))


def add_pair(state: ProfileState, *, map_pct, time_ms, energy_mwh,
             pair_idx: Optional[int] = None) -> Tuple[ProfileState, int]:
    """A NEW (model, device) pair joins the profile as one column appended
    on every group row, on the state's device.  Returns the new state and
    the pair's index (default: one past the current maximum).

    Each profile argument is a scalar (replicated across groups) or a
    length-[G] vector.  The column is appended LAST, so the masked argmin
    in ``decide_state`` sees every existing cell at the same position with
    the same tie-break order.  Host-side by contract: the shapes change,
    and the default index is the one value read back from the device."""
    G = state.pair_id.shape[0]
    dev = state.pair_id.device
    if pair_idx is None:
        pair_idx = operator.index(state.pair_id.max().cpu()) + 1

    def col(v, dtype=torch.float32):
        return torch.as_tensor(v, dtype=dtype, device=dev).expand(G)[:, None]

    def cat(old, new):
        return torch.cat([old, new], dim=1)

    new = state._replace(
        map_pct=cat(state.map_pct, col(map_pct)),
        time_ms=cat(state.time_ms, col(time_ms)),
        energy_mwh=cat(state.energy_mwh, col(energy_mwh)),
        valid=cat(state.valid, torch.ones((G, 1), dtype=torch.bool,
                                          device=dev)),
        pair_id=cat(state.pair_id, col(pair_idx, state.pair_id.dtype)),
        fails=(None if state.fails is None else
               cat(state.fails, torch.zeros((G, 1), dtype=torch.int32,
                                            device=dev))))
    return new, pair_idx


def retire_pair(state: ProfileState, pair_idx) -> ProfileState:
    """Every cell of ``pair_idx`` becomes a pad (-inf mAP, +inf costs,
    invalid, ``pair_id=-1``, breaker reset): the pair leaves every group's
    feasible set without changing any shape, and ``pair_idx`` may be a
    device tensor (no host read).  ``add_pair`` followed by
    ``retire_pair`` of the same index restores decisions bit for bit."""
    gone = state.pair_id == pair_idx
    return state._replace(
        map_pct=state.map_pct.masked_fill(gone, -torch.inf),
        time_ms=state.time_ms.masked_fill(gone, torch.inf),
        energy_mwh=state.energy_mwh.masked_fill(gone, torch.inf),
        valid=state.valid & ~gone,
        pair_id=state.pair_id.masked_fill(gone, -1),
        fails=(None if state.fails is None else
               state.fails.masked_fill(gone, 0)))


@dataclasses.dataclass(frozen=True)
class ProfileArrays:
    """Snapshot binding a ``ProfileState`` to one table's identity: group
    labels, the ``row_of`` group->row map, ``pairs`` (the ``pair_id``
    index space, in ``ProfileTable.pairs()`` order), ``col_of_pair[g, j]``
    (the column of pair j inside group row g; -1 when absent) and
    ``entry_index[g, p]`` back into ``ProfileTable.entries``.  Built for
    one table ``version`` and cached until an ``observe`` bumps it."""
    groups: Tuple[int, ...]
    row_of: Dict[int, int]
    pairs: Tuple[Tuple[str, str], ...]
    state: ProfileState
    entry_index: np.ndarray  # [G, P] int32
    col_of_pair: np.ndarray  # [G, n_pairs] int32; -1 = pair absent in group
    version: int


class ProfileTable:
    """The profile's entries plus the device its ``ProfileState`` lives on
    (``device`` follows the port's rule: CUDA unless the caller asks for
    the CPU)."""

    def __init__(self, entries: Iterable[ProfileEntry], *, device="cuda"):
        self.entries: List[ProfileEntry] = list(entries)
        if not self.entries:
            raise ValueError("empty profiling table")
        self.device = resolve_device(device)
        #: bumped on every observe()/load_state(); invalidates as_arrays()
        self.version = 0
        self._arrays: Optional[ProfileArrays] = None

    def for_group(self, group: int) -> List[ProfileEntry]:
        return [e for e in self.entries if e.group == group]

    def pairs(self) -> List[Tuple[str, str]]:
        seen, out = set(), []
        for e in self.entries:
            if e.pair not in seen:
                seen.add(e.pair)
                out.append(e.pair)
        return out

    def entry(self, pair: Tuple[str, str], group: int) -> ProfileEntry:
        for e in self.entries:
            if e.pair == pair and e.group == group:
                return e
        raise KeyError((pair, group))

    def mean_map(self, pair: Tuple[str, str]) -> float:
        rows = [e.map_pct for e in self.entries if e.pair == pair]
        return sum(rows) / len(rows)

    def as_arrays(self) -> ProfileArrays:
        """Padded per-group snapshot on ``self.device`` (cached; rebuilt
        after an ``observe``/``load_state`` bumps ``version``)."""
        if self._arrays is not None and self._arrays.version == self.version:
            return self._arrays
        groups = sorted({e.group for e in self.entries})
        row_of = {g: i for i, g in enumerate(groups)}
        pairs = tuple(self.pairs())
        pair_col = {p: j for j, p in enumerate(pairs)}
        per_row = [[i for i, e in enumerate(self.entries) if e.group == g]
                   for g in groups]
        G, P = len(groups), max(len(r) for r in per_row)
        map_pct = np.full((G, P), -np.inf, np.float32)
        energy = np.full((G, P), np.inf, np.float32)
        time_ms = np.full((G, P), np.inf, np.float32)
        valid = np.zeros((G, P), bool)
        pair_id = np.full((G, P), -1, np.int64)
        entry_index = np.zeros((G, P), np.int32)
        col_of_pair = np.full((G, len(pairs)), -1, np.int32)
        for r, idxs in enumerate(per_row):
            for p, i in enumerate(idxs):
                e = self.entries[i]
                map_pct[r, p] = e.map_pct
                energy[r, p] = e.energy_mwh
                time_ms[r, p] = e.time_ms
                valid[r, p] = True
                pair_id[r, p] = pair_col[e.pair]
                entry_index[r, p] = i
                col_of_pair[r, pair_col[e.pair]] = p
        dev = self.device
        state = ProfileState(
            map_pct=torch.from_numpy(map_pct).to(dev),
            time_ms=torch.from_numpy(time_ms).to(dev),
            energy_mwh=torch.from_numpy(energy).to(dev),
            valid=torch.from_numpy(valid).to(dev),
            pair_id=torch.from_numpy(pair_id).to(dev),
            fails=torch.zeros((G, P), dtype=torch.int32, device=dev))
        self._arrays = ProfileArrays(
            groups=tuple(groups), row_of=row_of, pairs=pairs, state=state,
            entry_index=entry_index, col_of_pair=col_of_pair,
            version=self.version)
        return self._arrays

    def as_state(self) -> ProfileState:
        """Export the device-resident state (see ``as_arrays`` for the
        snapshot carrying its identity metadata)."""
        return self.as_arrays().state

    def load_state(self, state: ProfileState) -> None:
        """Fold an updated ``ProfileState`` derived from THIS table at its
        current version back into the entries; bumps ``version``."""
        arrays = self.as_arrays()
        if tuple(state.valid.shape) != arrays.entry_index.shape:
            raise ValueError(
                f"state shape {tuple(state.valid.shape)} does not match "
                f"this table's layout {arrays.entry_index.shape}; "
                f"load_state expects a state derived from this table's "
                f"as_state()")
        m = state.map_pct.cpu().numpy()
        t = state.time_ms.cpu().numpy()
        e = state.energy_mwh.cpu().numpy()
        valid = arrays.state.valid.cpu().numpy()
        for g, p in zip(*np.nonzero(valid)):
            i = int(arrays.entry_index[g, p])
            self.entries[i] = dataclasses.replace(
                self.entries[i], map_pct=float(m[g, p]),
                time_ms=float(t[g, p]), energy_mwh=float(e[g, p]))
        self.version += 1

    def with_state(self, state: ProfileState) -> "ProfileTable":
        """Independent table (same device) with ``state``'s values folded
        in — the non-mutating half of the state<->table round trip."""
        out = self.copy()
        out.load_state(state)
        return out

    # ----------------------------------------------------- dynamic profiling
    def observe(self, pair: Tuple[str, str], group: int, *,
                time_ms: Optional[float] = None,
                energy_mwh: Optional[float] = None,
                map_pct: Optional[float] = None,
                alpha: float = 0.1) -> None:
        """EWMA-update one profile row from runtime observations, so the
        router tracks drift.  Scalar mirror of ``observe_state``."""
        for i, e in enumerate(self.entries):
            if e.pair == pair and e.group == group:
                upd = {}
                if time_ms is not None:
                    upd["time_ms"] = (1 - alpha) * e.time_ms + alpha * time_ms
                if energy_mwh is not None:
                    upd["energy_mwh"] = ((1 - alpha) * e.energy_mwh
                                         + alpha * energy_mwh)
                if map_pct is not None:
                    upd["map_pct"] = (1 - alpha) * e.map_pct + alpha * map_pct
                self.entries[i] = dataclasses.replace(e, **upd)
                self.version += 1
                return
        raise KeyError((pair, group))

    def observe_pair(self, pair: Tuple[str, str], *,
                     time_ms: Optional[float] = None,
                     energy_mwh: Optional[float] = None,
                     alpha: float = 0.1) -> None:
        """EWMA-update latency/energy for EVERY group row of ``pair``
        (they are group-independent, so a measurement taken while serving
        one group is evidence for all of them)."""
        groups = [e.group for e in self.entries if e.pair == pair]
        if not groups:
            raise KeyError(pair)
        for g in groups:
            self.observe(pair, g, time_ms=time_ms, energy_mwh=energy_mwh,
                         alpha=alpha)

    def copy(self) -> "ProfileTable":
        """Independent table with the same (immutable) entries on the same
        device."""
        return ProfileTable(self.entries, device=self.device)

    # ------------------------------------------------------------------ io
    def to_json(self, path: str) -> None:
        """The JAX package's file format: a list of entry dicts."""
        with open(path, "w") as f:
            json.dump([dataclasses.asdict(e) for e in self.entries], f,
                      indent=1)

    @classmethod
    def from_json(cls, path: str, *, device="cuda") -> "ProfileTable":
        with open(path) as f:
            return cls((ProfileEntry(**row) for row in json.load(f)),
                       device=device)
