"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``lib<name>.so`` with a plain C interface
(no PyTorch headers, so a build takes seconds), compiled for Hopper:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared \\
         -Xcompiler -fPIC -o lib<name>.so csrc/<name>.cu

The libraries go into ``BUILD_DIR`` (git-ignored) at first use and are
rebuilt when a source is newer.  ``build`` starts one nvcc per source, all
at once.  Nothing here runs at import time: the CPU tests import every
module on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

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
