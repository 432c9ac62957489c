"""The model code's sharding context.

The reference's launcher traces its steps inside
``activation_sharding(batch_axes, n_shards, mesh, mode)``, and the model
code reads the mesh from it (``current_mesh``, ``current_mode``) and pins
activations to the batch axes (``constrain_batch``).  The port's steps
enter the same context, without the shard count, which nothing here
reads, around a step on a ``DeviceMesh``; the model code
reads the mesh from it to run its sharded path, and calls
``constrain_batch`` where the reference does.  Each rank's activations
are its batch shard by construction (the step hands every rank its rows),
so ``constrain_batch`` has nothing to pin and returns its input.  Outside
the context (one device) every call here is a no-op.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

_batch_axes: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_batch_axes", default=None)


@contextlib.contextmanager
def activation_sharding(batch_axes: Tuple[str, ...], mesh=None,
                        mode: str = "train"):
    token = _batch_axes.set((tuple(batch_axes), mesh, mode))
    try:
        yield
    finally:
        _batch_axes.reset(token)


def snapshot():
    """The context's state, for ``restored``: a context variable does not
    follow the work into the autograd engine's threads, where a
    checkpoint's recompute runs."""
    return _batch_axes.get()


@contextlib.contextmanager
def restored(state):
    """The context as ``snapshot`` found it."""
    token = _batch_axes.set(state)
    try:
        yield
    finally:
        _batch_axes.reset(token)


def batch_axes() -> Optional[Tuple[str, ...]]:
    v = _batch_axes.get()
    return v[0] if v else None


def current_mesh():
    v = _batch_axes.get()
    return v[1] if v else None


def current_mode() -> str:
    v = _batch_axes.get()
    return v[2] if v else "train"


def constrain_batch(x):
    """``x``: a rank's tensors hold its batch shard already."""
    return x
