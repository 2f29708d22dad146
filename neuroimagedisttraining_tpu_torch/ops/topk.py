"""Global top-k threshold over a flattened saliency vector by
histogram-select: each of ``rounds`` rounds counts ``x >= t`` over a ladder
of ``nbins`` thresholds spanning the bracket and narrows the bracket to the
longest prefix of bins still holding at least ``k`` elements. With 4 rounds
of 512 bins the bracket shrinks by 512^4 > 2^32: the result is the exact
k-th largest float32 value, with no sort of the vector (where the k-th
value sits near the bottom of heavy-tailed scores the ladder stops at a
float's resolution first, in the reference too: the contract is parity
with the reference's loop, not the true k-th value).

The counting pass is the CUDA kernel of ``csrc/count_ge.cu`` (replacing
the TPU kernel of the reference package, ``ops/topk.py``
``_count_ge_pallas`` -> ``_count_ge_kernel``). On the card the whole
select runs in that source, 1 + ``rounds`` launches over a zeroed device
state and no host sync: a min/max pass, then one counting launch per round
whose last block applies :func:`select_bracket` and builds the next ladder.
On the CPU it is the plain loop below, op by op.

The ladder is the reference's ``linspace`` formula,
``start * (1 - i / (n - 1)) + stop * i / (n - 1)`` with ``stop`` appended,
each operation rounded on its own: ``torch.linspace`` rounds differently
at the ulp level, and one ulp moves the final bracket.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from neuroimagedisttraining_tpu_torch.ops import _cuda

LAUNCHES = _cuda.counter("count_ge")  # the standalone count_ge kernel
SELECT_LAUNCHES = _cuda.counter("kth_select")  # kth_largest's kernels
MAX_BINS = 1024  # the widest ladder the kernel sorts in shared memory
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIG = {"count_ge_num_blocks": [ctypes.POINTER(_I)],
        "count_ge_launch": [_P, _L, _P, _I, _P, _I, _P],
        "kth_state_layout": [ctypes.POINTER(_I), ctypes.POINTER(_I)],
        "kth_select_launch": [_P, _L, _L, _I, _I, _P, _I, _P]}


def linspace(lo: torch.Tensor, hi: torch.Tensor, num: int) -> torch.Tensor:
    """``num`` float32 values from ``lo`` to ``hi`` (0-d tensors), both
    ends included, by the reference's formula."""
    div = num - 1
    dev = lo.device
    # a device tensor divisor: a CPU-scalar divisor would be turned into a
    # multiply by its reciprocal, which rounds differently
    step = (torch.arange(div, dtype=torch.float32, device=dev)
            / torch.full((div,), float(div), dtype=torch.float32, device=dev))
    out = lo * (1 - step) + hi * step
    return torch.cat([out, hi.reshape(1)])


def count_ge_plain(x: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """float32 ``counts[j] = #{x >= thr[j]}``: each threshold's insertion
    point in the sorted values, with no host sync. NaN compares false: a
    NaN element sorts as -inf (below every threshold but -inf, whose count
    then drops the NaN elements), and a NaN threshold counts nothing."""
    nan = torch.isnan(x)
    xs = torch.sort(torch.where(nan, float("-inf"), x)).values
    counts = x.numel() - torch.searchsorted(xs, thr)
    counts = counts - torch.where(thr == float("-inf"), nan.sum(), 0)
    return torch.where(torch.isnan(thr), 0, counts).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _num_blocks(device_index: int) -> int:
    lib = _cuda.load("count_ge", _SIG)
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _cuda.check_launch(lib, lib.count_ge_num_blocks(ctypes.byref(n)),
                           "count_ge_num_blocks")
    return n.value


def count_ge(x: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """float32 ``counts[j] = #{x >= thr[j]}`` for 1-D float32 ``x``."""
    if x.device.type == "cpu" and thr.device.type == "cpu":
        return count_ge_plain(x, thr)
    if x.device.type != "cuda" or thr.device.type != "cuda":
        raise ValueError(f"count_ge: tensors on {x.device} and {thr.device}")
    nbins = thr.numel()
    if (x.dtype != torch.float32 or thr.dtype != torch.float32
            or x.dim() != 1 or thr.dim() != 1 or not x.is_contiguous()
            or not thr.is_contiguous() or not 0 < nbins <= MAX_BINS):
        raise ValueError("count_ge kernel takes contiguous 1-D float32 x and "
                         f"1..{MAX_BINS} float32 thresholds")
    if x.data_ptr() % 16:
        raise ValueError("count_ge: x must be 16-byte aligned")
    _cuda.check_device(x, thr)
    lib = _cuda.load("count_ge", _SIG)
    dev = x.device
    counts = torch.zeros(nbins, dtype=torch.int64, device=dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(dev):
        err = lib.count_ge_launch(x.data_ptr(), x.numel(), thr.data_ptr(),
                                  nbins, counts.data_ptr(), _num_blocks(index),
                                  _cuda.stream_ptr(dev))
    _cuda.check_launch(lib, err, "count_ge_launch")
    LAUNCHES.add()
    return counts.to(torch.float32)


def select_bracket(thr: torch.Tensor, counts: torch.Tensor, k: int,
                   hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The next bracket from one round's ladder ``thr`` and its ``counts``:
    ``[thr[j], thr[j + 1]]`` for ``j`` the last index of the longest prefix
    of ``counts >= k`` (0 when there is none), and the old ``hi`` above the
    ladder's top. Counts fall as the threshold rises, except for sub-ulp
    ladder wiggle in the last rounds: hence the prefix, not the number of
    counts >= k. The kernel's last block does the same."""
    nbins = thr.numel()
    prefix = torch.cumprod((counts >= k).to(torch.int32), 0)
    j = torch.clamp(prefix.sum() - 1, min=0).reshape(1)
    # gather, not thr[j]: indexing with a 0-d tensor reads it on the host
    pair = thr.gather(0, torch.cat([j, torch.clamp(j + 1, max=nbins - 1)]))
    return pair[0], torch.where(j[0] + 1 < nbins, pair[1], hi)


def kth_largest_plain(x: torch.Tensor, k: int, rounds: int = 4,
                      nbins: int = 512) -> torch.Tensor:
    """The select as the reference runs it, op by op (plain counts)."""
    lo, hi = x.min(), x.max()
    for _ in range(rounds):
        thr = linspace(lo, hi, nbins)
        lo, hi = select_bracket(thr, count_ge_plain(x, thr), k, hi)
    ok = torch.isfinite(x).all()
    return torch.where(ok, lo, torch.full_like(lo, float("nan")))


@functools.lru_cache(maxsize=None)
def _state_layout() -> tuple[int, int]:
    lib = _cuda.load("count_ge", _SIG)
    nbytes, off = ctypes.c_int(0), ctypes.c_int(0)
    lib.kth_state_layout(ctypes.byref(nbytes), ctypes.byref(off))
    return nbytes.value, off.value


def kth_largest(x: torch.Tensor, k: int, rounds: int = 4,
                nbins: int = 512) -> torch.Tensor:
    """Exact (float32) k-th largest value of 1-D ``x`` as a 0-d tensor;
    NaN when ``x`` holds a non-finite value (a NaN poisons any ``>=`` mask
    visibly, and the SNIP caller raises on it)."""
    if x.dim() != 1:
        raise ValueError("kth_largest takes a 1-D vector")
    if not 2 <= nbins <= MAX_BINS:
        raise ValueError(f"nbins must be in [2, {MAX_BINS}]")
    x = x.to(torch.float32).contiguous()
    if x.device.type == "cpu":
        return kth_largest_plain(x, k, rounds, nbins)
    if x.device.type != "cuda":
        raise ValueError(f"kth_largest: tensor on {x.device}")
    if x.numel() == 0:
        raise ValueError("kth_largest of an empty vector")
    if x.data_ptr() % 16:
        x = x.clone()  # a fresh allocation: 16-byte aligned for the kernel
    _cuda.check_device(x)
    lib = _cuda.load("count_ge", _SIG)
    dev = x.device
    nbytes, result_at = _state_layout()
    # counts, ladder, bracket and result: zeroed once, then kept by the
    # kernels (each launch's last block leaves its counts zero)
    state = torch.zeros((nbytes + 7) // 8, dtype=torch.int64, device=dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(dev):
        err = lib.kth_select_launch(x.data_ptr(), x.numel(), k, nbins, rounds,
                                    state.data_ptr(), _num_blocks(index),
                                    _cuda.stream_ptr(dev))
    _cuda.check_launch(lib, err, "kth_select_launch")
    SELECT_LAUNCHES.add(1 + rounds)  # the min/max pass, one launch a round
    return state.view(torch.float32)[result_at // 4]


def topk_threshold_mask(x: torch.Tensor, k: int, **kw):
    thr = kth_largest(x, k, **kw)
    return x >= thr, thr
