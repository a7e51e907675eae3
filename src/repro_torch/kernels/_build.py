"""Build the CUDA sources under ``kernels/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/repro_torch/lib<name>.so`` at the
root of the checkout, on first use in a process. :func:`build` starts one
``nvcc`` per source, all at once. A missing ``nvcc`` or a failed build
raises; nothing falls back to the plain PyTorch versions.

Also here: the launch counter each kernel wrapper bumps when it launches,
the launch timer a caller can hold around wrapper calls, the operand checks
the wrappers share, and the device address of an operand a kernel reads in
place from pinned host memory (:class:`InPlace`, ``csrc/host_map.cu``).
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
           "hash_masked_accum_spgemm", "bsr_spgemm", "bsr_spmm", "flash_prefill",
           "chunked_attention", "grouped_matmul", "host_map")
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


class InPlace:
    """A kernel operand in pinned host memory that the kernel reads (or
    writes) where it lies, through the address the card maps it at
    (:func:`device_address`): the reference's ``memory_space=ANY`` operand
    in ``pinned_host`` memory."""

    __slots__ = ("tensor",)

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor


def device_address(t: torch.Tensor) -> int:
    """The address a kernel reads the pinned host tensor ``t`` at (from
    ``cudaHostGetDevicePointer``, checked by ``cudaPointerGetAttributes``).
    Memory the card has not mapped raises; nothing copies it."""
    f = _BOUND.get(("host_map", "host_device_pointer"))
    if f is None:
        f = library("host_map").host_device_pointer
        f.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                      ctypes.POINTER(ctypes.c_int)]
        f.restype = ctypes.c_int
        _BOUND["host_map", "host_device_pointer"] = f
    address, kind = ctypes.c_void_p(), ctypes.c_int()
    code = f(t.data_ptr(), ctypes.byref(address), ctypes.byref(kind))
    if code != 0 or not address.value:
        err = library("host_map").host_device_pointer_error_string
        err.restype = ctypes.c_char_p
        raise ValueError(
            f"host memory at {t.data_ptr():#x} is not mapped for the card (CUDA "
            f"error {code}: {err(code).decode()}; memory type {kind.value}): a kernel "
            "reads in place only pinned memory (place(x, 'slow'))")
    return address.value


def pointer(t: torch.Tensor):
    """A launch operand: a card tensor as it is, a host one (pinned, checked
    by :func:`require`) read in place (:class:`InPlace`)."""
    return InPlace(t) if t.device.type == "cpu" else t


def alloc_like(t: torch.Tensor, *, zero: bool = False) -> torch.Tensor:
    """An output shaped like ``t`` in ``t``'s space: on its card, or in
    pinned host memory where ``t`` is a host operand read in place."""
    if t.device.type == "cpu":
        make = torch.zeros if zero else torch.empty
        return make(t.shape, dtype=t.dtype, pin_memory=True)
    return torch.zeros_like(t) if zero else torch.empty_like(t)


def _address(p):
    if p is None:
        return None
    if isinstance(p, InPlace):
        return device_address(p.tensor)
    return p.data_ptr()


def launch(name: str, fn: str, pointers, ints) -> None:
    """Call ``fn`` on the current stream; raise on a non-zero CUDA error. A
    pointer given as None is passed as NULL, an :class:`InPlace` operand as
    its mapped device address, any other tensor as its ``data_ptr``
    (which a C entry reads on the host where it takes a host array)."""
    f, err = bind(name, fn, len(pointers), len(ints))
    stream = torch.cuda.current_stream().cuda_stream
    addresses = [_address(p) for p in pointers]
    timer = _TIMER
    if timer is not None:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    code = f(*addresses, *[int(v) for v in ints], stream)
    if timer is not None:
        end.record()
        timer.events.append((start, end))
    if code != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {code} "
                           f"({err(code).decode()})")


def require(t: torch.Tensor, what: str, dtype: torch.dtype,
            device: torch.device, in_place: bool = False) -> None:
    """Device, dtype and contiguity of one kernel operand. With
    ``in_place`` an operand in pinned host memory is accepted too: the
    kernel reads it there (:func:`pointer`); pageable host memory raises."""
    if in_place and t.device.type == "cpu":
        if not t.is_pinned():
            raise ValueError(
                f"{what} is in pageable host memory: a kernel reads host memory in "
                "place only where it is pinned (place(x, 'slow'))")
    elif t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
