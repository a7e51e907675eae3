"""Build the CUDA sources under ``kernels/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/repro_torch/lib<name>.so`` at the
root of the checkout, on first use in a process. :func:`build` starts one
``nvcc`` per source, all at once. A missing ``nvcc`` or a failed build
raises; nothing falls back to the plain PyTorch versions.

Also here: the launch counter each kernel wrapper bumps when it launches,
the launch timer a caller can hold around wrapper calls, and the operand
checks the wrappers share.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("ranged_spgemm", "sparse_accum_spgemm", "hash_accum_spgemm",
           "hash_masked_accum_spgemm", "bsr_spgemm", "bsr_spmm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_BOUND: dict = {}
# name -> {"seconds": float, "ptxas": str, "kernels": {entry: resources}}
BUILD_LOG: dict = {}
_TIMER = None          # the active LaunchTimer, if any


class LaunchCounter:
    """Count of a wrapper's calls that launched its kernel on the card."""

    def __init__(self):
        self.count = 0

    def bump(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


class LaunchTimer:
    """Device time of the kernels launched while the timer is active: CUDA
    events recorded on the launch stream just before and just after each C
    entry point. The wrapper's host work around a launch (allocations,
    copies, the overflow read) is outside the events; the microseconds the
    host takes to issue the launches are inside."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        global _TIMER
        _TIMER = self
        return self

    def __exit__(self, *exc) -> None:
        global _TIMER
        _TIMER = None

    def ms(self) -> float:
        """Summed milliseconds of the timed launches (synchronizes)."""
        torch.cuda.synchronize()
        return sum(start.elapsed_time(end) for start, end in self.events)


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def ptxas_resources(text: str) -> dict:
    """Per-kernel resources from ``nvcc -Xptxas -v`` output: for each entry
    function (its mangled name), the registers a thread uses, the bytes of
    spill stores and loads, and the bytes of static shared memory."""
    out, entry = {}, None
    for line in text.splitlines():
        if (m := _ENTRY.search(line)) is not None:
            entry = m.group(1)
            out[entry] = {"registers": None, "spill_stores": None,
                          "spill_loads": None, "smem_bytes": 0}
        elif entry is not None and (m := _SPILLS.search(line)) is not None:
            out[entry]["spill_stores"], out[entry]["spill_loads"] = map(int, m.groups())
        elif entry is not None and (m := _USED.search(line)) is not None:
            out[entry]["registers"] = int(m.group(1))
            out[entry]["smem_bytes"] = int(m.group(2) or 0)
    return out


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found is None and Path("/usr/local/cuda/bin/nvcc").exists():
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build(names=SOURCES) -> dict:
    """Compile ``names`` in parallel (one nvcc each) and load them. Returns
    the build log: per source its seconds, the ptxas output, and each
    kernel's registers, spills and static shared memory."""
    names = [n for n in names if n not in _LIBS]
    if not names:
        return BUILD_LOG
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = BUILD_DIR / f"lib{name}.so"
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        _LIBS[name] = ctypes.CDLL(str(out))
        BUILD_LOG[name] = {"seconds": seconds, "ptxas": stderr.strip(),
                           "kernels": ptxas_resources(stderr)}
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return BUILD_LOG


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        build((name,))
    return _LIBS[name]


def bind(name: str, fn: str, n_ptr: int, n_int: int):
    """The C entry point ``fn`` of library ``name`` with ``n_ptr`` pointer
    arguments, ``n_int`` int arguments and a trailing stream, and its
    ``<fn>_error_string``."""
    if (name, fn) in _BOUND:
        return _BOUND[name, fn]
    lib = library(name)
    f = getattr(lib, fn)
    f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    err = getattr(lib, f"{fn}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    _BOUND[name, fn] = (f, err)
    return f, err


def launch(name: str, fn: str, pointers, ints) -> None:
    """Call ``fn`` on the current stream; raise on a non-zero CUDA error."""
    f, err = bind(name, fn, len(pointers), len(ints))
    stream = torch.cuda.current_stream().cuda_stream
    timer = _TIMER
    if timer is not None:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    code = f(*[t.data_ptr() for t in pointers], *[int(v) for v in ints], stream)
    if timer is not None:
        end.record()
        timer.events.append((start, end))
    if code != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {code} "
                           f"({err(code).decode()})")


def require(t: torch.Tensor, what: str, dtype: torch.dtype,
            device: torch.device) -> None:
    """Device, dtype and contiguity of one kernel operand."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
