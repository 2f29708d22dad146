"""Build and load the port's CUDA kernels.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C
interface. ``nvcc`` compiles it for Hopper (``sm_90a``) into a shared
library under ``build/`` (listed in ``.gitignore``), named by a hash of the
source and flags so an edited source is rebuilt; ``ctypes`` loads it.
Nothing is compiled when a module is imported: the first launch builds
what it needs, and :func:`build` compiles several sources at once (one
``nvcc`` process each, started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class LaunchCounter:
    """How many device kernels a wrapper launched. Each wrapper adds one
    per kernel it launches, where it launches them, and nowhere else (the
    plain CPU path counts nothing), so a run can show its main path went
    through the kernels."""

    def __init__(self, kernel: str):
        self.kernel = kernel
        self.count = 0

    def add(self, launches: int = 1) -> None:
        self.count += launches


#: every kernel's counter, by kernel name
COUNTERS: dict[str, LaunchCounter] = {}


def counter(kernel: str) -> LaunchCounter:
    return COUNTERS.setdefault(kernel, LaunchCounter(kernel))


def reset_counts() -> None:
    for c in COUNTERS.values():
        c.count = 0


def counts() -> dict[str, int]:
    return {k: c.count for k, c in COUNTERS.items()}


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME`` or
    the toolkit's conventional install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or $CUDA_HOME)")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + (CSRC / "common.cuh").read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{h}.so"


def build(names: list[str]) -> dict[str, float]:
    """Compile every named source that has no up-to-date library, all at
    once; returns seconds per compiled source. ``ptxas``'s register and
    shared-memory report is kept beside each library."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use), with
    ``argtypes`` set from ``signatures`` and every function returning the
    ``cudaError_t`` of its launch as an int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.nidt_error_string.argtypes = [ctypes.c_int]
            lib.nidt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check_device(*tensors: torch.Tensor) -> None:
    """The kernels are built for ``sm_90a``: every tensor must be on one
    CUDA device of compute capability 9.0."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(f"kernels are built for sm_90a; {dev} has "
                           f"compute capability {cap}")


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch was refused (``cudaGetLastError`` after it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.nidt_error_string(err).decode()})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
