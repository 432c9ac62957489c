"""One step's operations and bytes, counted as the step runs: the port's
stand-in for the JAX package's ``launch/hlo_cost.py``.

The reference walks the compiled HLO: fusions move only their boundary
bytes, loop bodies count once per trip.  In eager PyTorch every aten op
is its own kernel and its operands cross HBM, so ``StepCost``, a
``TorchDispatchMode``, counts each aten op as it runs:

- operations: ``torch.utils.flop_counter``'s formula where it has one
  (matrix products, convolutions; ``_grouped_mm``, the MoE's grouped
  products, by its own), else 1 per output element, as ``hlo_cost``
  counts elementwise ops;
- bytes: every tensor the op reads and every tensor it writes, once;
- views and allocations (``empty*``) add nothing, nor does a copy
  between devices (a scalar made on the host and sent to the card): it
  crosses the bus, not the card's memory, and a step on the CPU has none;
- nor do the collectives (the ``c10d`` ops): ``sharding/comm.py`` counts
  their bytes, the roofline's collective term.

The hand-written kernels are ctypes launches the mode does not see: each
entry point adds its own analytic operations and bytes (the counts
``PERF.md``'s bound column uses) through ``kernels/_build.py::counted``,
and the aten ops of its wrapper or of its plain version are not counted.
So a step counts alike on the card and on the CPU, wherever the model
code runs the same aten ops on both.  Nothing reads a device tensor.

    with StepCost() as cost:
        step(...)
    cost.flops, cost.bytes

``StepBytes``, another dispatch mode, measures the most bytes a step
holds at once (the meta device's tensors have sizes and no data, so a
full-size step runs there in seconds); the dry run's skip rule reads it.
"""
from __future__ import annotations

from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

#: aten ops that move no data: allocations, and views not flagged as such
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view"}
#: aten copies, which move no device memory when they cross devices
_COPIES = {"_to_copy", "copy_", "copy"}


def _grouped_mm_flops(a, b, *args, out_val=None, **kwargs) -> int:
    """2 a multiply-add: each output element of a group contracts K; a 2-D
    by 2-D product splits K over the groups of its leading output dim."""
    k = a.shape[-1]
    if a.dim() == 2 and b.dim() == 2:
        return 2 * out_val.numel() // out_val.shape[0] * k
    return 2 * out_val.numel() * k


_FORMULAS = {**flop_registry,
             torch.ops.aten._grouped_mm: _grouped_mm_flops}


def _tensors(tree):
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _tensors(tree))


class StepCost(TorchDispatchMode):
    """Operations and bytes of everything run under it (its backward
    too: the autograd engine carries the mode into its threads).
    ``by_kind`` and ``bytes_by_kind`` split them by aten op, or by
    ``kernel`` for the hand-written kernels' analytic counts."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.by_kind: Counter = Counter()
        self.bytes_by_kind: Counter = Counter()
        #: > 0 while a counted kernel's own ops run (``_build.counted``)
        self.held = 0

    def add_kernel(self, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        self.by_kind["kernel"] += flops
        self.bytes_by_kind["kernel"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if self.held or func.is_view or name in _FREE or \
                func.namespace == "c10d":
            return out
        if name in _COPIES and len(
                {x.device for x in _tensors((args, kwargs, out))}) > 1:
            return out
        formula = _FORMULAS.get(func.overloadpacket)
        if formula is not None:
            flops = formula(*args, **kwargs, out_val=out)
        else:
            flops = sum(x.numel() for x in _tensors(out))
        nbytes = _bytes((args, kwargs)) + _bytes(out)
        self.flops += flops
        self.bytes += nbytes
        self.by_kind[name] += flops
        self.bytes_by_kind[name] += nbytes
        return out


class StepBytes(TorchDispatchMode):
    """The bytes of the storages alive while it is entered: those of
    ``held`` (tensors that exist already, e.g. the parameters, moments and
    batch, counted from the start) and of every aten op's outputs, each
    storage once, until it is freed.  ``peak`` is the most at once, taken
    after each op (its outputs allocated, its inputs not yet freed).  A
    storage the mode has not seen (a library's workspace) is not
    counted."""

    def __init__(self, held=()):
        super().__init__()
        self._held = {}
        for t in held:
            st = t.untyped_storage()
            self._held[st._cdata] = (StorageWeakRef(st), st.nbytes())
        self._live = {}
        self.peak = self._bound = self._now()

    def _now(self) -> int:
        self._live = {k: v for k, v in self._live.items()
                      if not v[0].expired()}
        return sum(n for _, n in self._held.values()) + sum(
            n for _, n in self._live.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held:
                continue
            seen = self._live.get(key)
            if seen is None or seen[0].expired():
                self._live[key] = (StorageWeakRef(st), st.nbytes())
                self._bound += st.nbytes()
        # the bound counts freed storages too: only when it passes the
        # peak can the peak have moved, and then the live ones are summed
        if self._bound > self.peak:
            self._bound = self._now()
            self.peak = max(self.peak, self._bound)
        return out
