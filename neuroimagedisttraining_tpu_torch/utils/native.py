"""The host's row gather, in C++ (``csrc/gather.cpp``), through ctypes.

``g++ -O3 -shared -fPIC -pthread`` builds the library into ``build/``
(listed in ``.gitignore``) at first use, named by a hash of the source and
flags as ``ops/_cuda.py`` names the kernels' libraries, so an edited source
is rebuilt. A failed build raises with the compiler's output: there is no
quiet fallback. :func:`gather_rows_plain` is the plain numpy version the
tests hold the library against; :func:`gather_rows` also takes it for a
source that is not contiguous uint8, a choice made on the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from neuroimagedisttraining_tpu_torch.ops._cuda import BUILD, CSRC

SRC = CSRC / "gather.cpp"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]
DEFAULT_THREADS = min(8, os.cpu_count() or 1)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path():
    h = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
                       ).hexdigest()[:12]
    return BUILD / f"libnidt_gather-{h}.so"


def load() -> ctypes.CDLL:
    """The loaded gather library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            BUILD.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
            except OSError as e:
                raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {SRC.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.nidt_gather_rows_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
        lib.nidt_gather_rows_u8.restype = None
        _lib = lib
        return lib


def gather_rows_plain(src: np.ndarray, idx: np.ndarray,
                      out: np.ndarray | None = None) -> np.ndarray:
    """``src[idx]`` in numpy, into ``out[:len(idx)]`` where given."""
    gathered = src[np.asarray(idx, np.int64)]
    if out is None:
        return gathered
    out[: len(gathered)] = gathered
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray,
                out: np.ndarray | None = None,
                n_threads: int = DEFAULT_THREADS) -> np.ndarray:
    """``dst[i] = src[idx[i]]``: the native multithreaded gather for a
    C-contiguous uint8 source, the plain one otherwise. ``out`` may give
    the target (a slice of a padded chunk), filled in its first
    ``len(idx)`` rows."""
    idx = np.ascontiguousarray(idx, np.int64)
    if src.dtype != np.uint8 or not src.flags["C_CONTIGUOUS"]:
        return gather_rows_plain(src, idx, out)
    if len(idx) and (idx.min() < 0 or idx.max() >= len(src)):
        raise IndexError(f"row index out of range [0, {len(src)})")
    if out is None:
        out = np.empty((len(idx),) + src.shape[1:], src.dtype)
    dst = out[: len(idx)]
    if not dst.flags["C_CONTIGUOUS"] or dst.shape[1:] != src.shape[1:]:
        raise ValueError("out must hold C-contiguous rows of src's shape")
    row_bytes = int(np.prod(src.shape[1:], dtype=np.int64))
    load().nidt_gather_rows_u8(src.ctypes.data, idx.ctypes.data, len(idx),
                               row_bytes, dst.ctypes.data, n_threads)
    return out
