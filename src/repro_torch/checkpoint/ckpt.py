"""Flat-key checkpointing of a nested dict/list of arrays to one ``.npz``:
the layout of ``repro.checkpoint.ckpt`` (keys such as ``convs/0/w1``), so
each package loads what the other saved."""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

SEP = "/"


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _flatten(t, path + (i,))
    else:
        yield SEP.join(str(p) for p in path), tree


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{k: _numpy(v) for k, v in _flatten(tree)})


def _restore(like, path, data):
    if isinstance(like, dict):
        return {k: _restore(v, path + (k,), data) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_restore(v, path + (i,), data)
                          for i, v in enumerate(like))
    key = SEP.join(str(p) for p in path)
    arr = data[key]
    if arr.shape != tuple(like.shape):
        raise ValueError(f"{key}: ckpt {arr.shape} != model "
                         f"{tuple(like.shape)}")
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(dtype=like.dtype, device=like.device)
    return np.asarray(arr, like.dtype)


def load(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (shapes must match), each leaf
    a tensor or a numpy array as ``like``'s is, in its dtype."""
    with np.load(path) as data:
        return _restore(like, (), data)
