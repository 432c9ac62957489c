"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``lib<name>.so`` with a plain C interface
(no PyTorch headers, so a build takes seconds), compiled for Hopper:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared \\
         -Xcompiler -fPIC -o lib<name>.so csrc/<name>.cu

The libraries go into ``BUILD_DIR`` (git-ignored) at first use and are
rebuilt when a source is newer.  ``build`` starts one nvcc per source, all
at once.  Nothing here runs at import time: the CPU tests import every
module on a machine without nvcc.

``counted`` lets a step cost counter (``launch/cost.py``) see the kernels:
a dispatch mode sees every aten op but no ctypes launch, so each kernel
entry point adds its own analytic operations and bytes, and the aten ops
of its wrapper or of its plain version are not counted.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("sobel", "canny_fused", "flash_attention", "flash_attention_bwd",
           "decode_attention", "ssd_scan", "ssd_scan_bwd", "rglru_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
#: guards every wrapper's ``launches`` count: pods of a cluster launch from
#: their own threads, and ``+=`` on a module global is not atomic
_count_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.glob("*.cu*"))
    return lib.stat().st_mtime < newest


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile ``csrc/<name>.cu`` for each name, one nvcc process each, all
    started together.  Returns the seconds each took; the ptxas report
    (registers, shared memory, spills) lands in ``lib<name>.log``.  Raises
    with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        # build under a unique name, then rename: concurrent processes
        # never load a half-written library
        tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (time.perf_counter(), tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    seconds, failed = {}, []
    for name, (t0, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"lib{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first when missing or stale."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            if _stale(name):
                build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: Sequence) -> object:
    """``symbol`` of ``lib<name>.so`` with its argument types declared and
    an ``int`` (the CUDA error code) as its result; cached, so a launch
    pays only for the call."""
    key = (name, symbol)
    fn = _functions.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return fn


def count_launch(module: str, count: str = "launches") -> None:
    """Add one to the ``count`` attribute (``launches`` unless named) of the
    wrapper module ``module`` (its ``__name__``), under a lock: callers set
    the count to 0 and read it back as a plain module attribute."""
    mod = sys.modules[module]
    with _count_lock:
        setattr(mod, count, getattr(mod, count) + 1)


def _cost_counters() -> list:
    """The active dispatch modes that count a step's cost (those with an
    ``add_kernel`` method), innermost last; none without a dispatch mode.
    The autograd engine carries the mode stack into its device threads,
    so a backward kernel finds the counter of its step."""
    if not torch._C._len_torch_dispatch_stack():
        return []
    return [m for m in _get_current_dispatch_mode_stack()
            if hasattr(m, "add_kernel")]


class _Hold(torch.autograd.Function):
    """Identity on the outputs of a counted kernel call: its backward adds
    the backward's cost to the counters and holds their aten counting
    until ``_Release`` (on the call's inputs) runs.  The engine runs the
    nodes made inside the call between the two: they are the only nodes
    whose sequence numbers lie between them."""

    @staticmethod
    def forward(ctx, counters, cost, *xs):
        ctx.counters, ctx.cost = counters, cost
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        for c in ctx.counters:
            c.add_kernel(*ctx.cost)
            c.held += 1
        return (None, None, *grads)


class _Release(torch.autograd.Function):
    """Identity on the inputs of a counted kernel call; its backward ends
    ``_Hold``'s hold."""

    @staticmethod
    def forward(ctx, counters, *xs):
        ctx.counters = counters
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        for c in ctx.counters:
            c.held -= 1
        return (None, *grads)


def counted(cost: Callable, backward_cost: Callable = None):
    """Decorator of a kernel entry point whose tensor arguments come first.
    Without an active counter it calls the entry point and nothing else.
    With one, it adds ``cost(*args, **kwargs)`` (operations, bytes) to each
    counter and holds their aten counting during the call, on the card and
    on the CPU alike: the wrapper's allocations and a plain version's ops
    are the kernel's, counted once, analytically.  When autograd records
    the call, ``backward_cost(*args, **kwargs)`` is added where the
    gradient passes through it, and the backward's ops (the backward
    kernel's wrapper, or autograd through the plain version) are held
    too.  Neither cost reads a device tensor: shapes only."""
    def wrap(entry):
        @functools.wraps(entry)
        def call(*args, **kwargs):
            counters = _cost_counters()
            if not counters:
                return entry(*args, **kwargs)
            n = next((i for i, a in enumerate(args)
                      if not isinstance(a, torch.Tensor)), len(args))
            xs = args[:n]
            recorded = backward_cost is not None and \
                torch.is_grad_enabled() and any(x.requires_grad for x in xs)
            for c in counters:
                c.add_kernel(*cost(*args, **kwargs))
            if recorded:
                bwd = backward_cost(*args, **kwargs)
                xs = _Release.apply(counters, *xs)
            for c in counters:
                c.held += 1
            try:
                out = entry(*xs, *args[n:], **kwargs)
            finally:
                for c in counters:
                    c.held -= 1
            if not recorded:
                return out
            outs = out if isinstance(out, tuple) else (out,)
            outs = _Hold.apply(counters, bwd, *outs)
            return outs if isinstance(out, tuple) else outs[0]
        return call
    return wrap
