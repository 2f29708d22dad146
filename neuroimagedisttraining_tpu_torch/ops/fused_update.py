"""Fused masked-SGD tail: clip + weight decay + momentum + update + mask in
one pass over every parameter leaf, updating params and momentum in place.

The stage-by-stage SGD chain reads and writes a params-sized intermediate
per stage. On CUDA tensors :func:`fused_sgd_step` makes one host call that
queues two kernels of ``csrc/fused_sgd.cu`` a table of leaves (which replaces the TPU kernel
of the reference package, ``ops/fused_update.py`` ``_leaf_pallas`` ->
``_make_kernel``): the global norm of the grads, finished on the device
into a 3-float buffer ``[ok, gnorm, lr]``, then one multi-tensor pass over
every leaf reading those scalars (read param, grad, momentum, mask; write
param, momentum). Without a clip the step is the pass alone.
:func:`fused_sgd_apply` is the pass under given scalars. clip, wd and
momentum are Python floats passed by value; the per-round lr stays on the
device.

The pass works on a table of leaf descriptors cut into fixed chunks
(:func:`plan_chunks`). A launch takes at most ``MAX_LEAVES`` descriptors,
so a longer leaf list (resnet18's 62 leaves) is stepped as consecutive
tables of ``MAX_LEAVES`` leaves, one norm and one pass launch each, whose
norm partials share one buffer; the last norm launch finishes the scalars.
The flagship's 24 leaves are one table. The host table is kept between
calls: within one ``local_train`` the params, momentum and mask of a
client stay the same tensors from step to step, and only the grad
pointers are written anew.

:func:`sgd_apply_plain` is the same arithmetic in plain PyTorch, in the
reference's operation order (``where(ok, g, (g / gnorm) * clip)``,
``g + wd * p``, ``g + momentum * t``, ``p + (-lr) * g``, ``p * mask``),
each operation rounded on its own as the kernel does. It is the wrappers'
CPU path and, through :func:`sgd_step_plain`, the unfused optimizer chain
(core/optim.py). Given the same scalars the kernel is bit-equal to it; its
global norm is summed in fp64 in the order of :func:`global_norm_blocked`
and agrees with :func:`global_norm` within rtol 2e-6.
"""

from __future__ import annotations

import ctypes
import functools
import operator
from typing import NamedTuple

import numpy as np
import torch

from neuroimagedisttraining_tpu_torch.ops import _cuda

LAUNCHES = _cuda.counter("fused_sgd")
CHUNK = 4096        # floats a chunk: a block's unit of work
MAX_LEAVES = 32     # leaf descriptors in one launch's table
LEAF_WORDS = 6      # a descriptor: p, g, t, m, n, first chunk (int64 each)
# the kernels' table parameter (descriptors, leaf and chunk counts) must
# fit, beside under 128 bytes of other parameters, in the classic 4 KB
# kernel-parameter limit
TABLE_BYTES = MAX_LEAVES * LEAF_WORDS * 8 + 8
TABLE_BUDGET = 4096 - 128
assert TABLE_BYTES <= TABLE_BUDGET
CLIP, WD, TRACE, MASK = 1, 2, 4, 8  # the kernels' stage flags

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIG = {"fused_sgd_layout": [ctypes.POINTER(_I)] * 3,
        "fused_sgd_num_blocks": [ctypes.POINTER(_I)] * 2,
        "fused_sgd_apply_launch": [_P, _I, _I, _F, _F, _F, _I, _P, _I, _P],
        "fused_sgd_step_launch": [_P, _I, _I, _F, _F, _F, _I, _P, _F, _P, _P,
                                  _I, _I, _P]}


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares over every leaf), summed leaf by leaf."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def sgd_scalars(grads, *, clip: float, lr) -> torch.Tensor:
    """The step's device scalars ``[ok, gnorm, lr]`` (float32): ``ok`` is
    1 where the global norm is below ``clip`` (the clip stage is skipped);
    without a clip both are 1. ``lr`` may be a 0-d device tensor."""
    dev = grads[0].device
    lr_t = torch.as_tensor(lr, dtype=torch.float32, device=dev).reshape(())
    if clip > 0:
        gnorm = global_norm(grads)
        return torch.stack([(gnorm < clip).to(torch.float32), gnorm, lr_t])
    return torch.stack([torch.ones_like(lr_t), torch.ones_like(lr_t), lr_t])


def sgd_apply_plain(params, grads, trace, mask, scal: torch.Tensor, *,
                    clip: float, wd: float, momentum: float) -> None:
    """The SGD chain leaf by leaf in plain PyTorch with the scalars of
    :func:`sgd_scalars`; updates ``params`` and ``trace`` (the momentum
    buffers) in place."""
    ok, gnorm, lr = scal[0] > 0.5, scal[1], scal[2]
    for i, (p, g) in enumerate(zip(params, grads)):
        if clip > 0:
            g = torch.where(ok, g, (g / gnorm) * clip)
        if wd > 0:
            g = g + wd * p
        if momentum > 0:
            g = g + momentum * trace[i]
            trace[i].copy_(g)
        p_new = p + (-lr) * g
        if mask is not None:
            p_new = p_new * mask[i]
        p.copy_(p_new)


def sgd_step_plain(params, grads, trace, mask, *, clip: float, wd: float,
                   momentum: float, lr) -> None:
    """One step of the plain SGD chain, in place on ``params`` and
    ``trace``."""
    sgd_apply_plain(params, grads, trace, mask,
                    sgd_scalars(grads, clip=clip, lr=lr), clip=clip, wd=wd,
                    momentum=momentum)


# ---------------------------------------------------------------------------
# the chunk and leaf-table planner (pure Python; the kernels read its plan)
# ---------------------------------------------------------------------------

class Plan(NamedTuple):
    """The chunks of a leaf list: ``first[i]`` is leaf ``i``'s first chunk;
    ``tables`` the launches' tables, each ``(leaf_start, leaf_end,
    chunk_start, chunk_end)``: ``MAX_LEAVES`` consecutive leaves a table
    (the last one ragged), as ``csrc/fused_sgd.cu`` cuts them."""
    nchunks: int
    first: tuple[int, ...]
    tables: tuple[tuple[int, int, int, int], ...]


def plan_chunks(sizes) -> Plan:
    """Cut leaves of ``sizes`` elements into ``CHUNK``-element chunks, a
    leaf's last chunk ragged and no chunk straddling two leaves, and the
    leaves into tables of at most ``MAX_LEAVES``."""
    sizes = [int(n) for n in sizes]
    if any(n < 0 for n in sizes):
        raise ValueError(f"negative leaf size in {sizes}")
    first, c = [], 0
    for n in sizes:
        first.append(c)
        c += -(-n // CHUNK)
    if c >= 2 ** 31:
        raise ValueError(f"{c} chunks: too many for a launch")
    bounds = list(range(0, len(sizes), MAX_LEAVES)) + [len(sizes)]
    tables = tuple((a, b, first[a], first[b] if b < len(sizes) else c)
                   for a, b in zip(bounds[:-1], bounds[1:]))
    return Plan(c, tuple(first), tables)


def chunk_leaf(first, c: int) -> int:
    """The leaf owning chunk ``c``: the last whose first
    chunk is <= c, by the kernels' binary search (an empty leaf owns none)."""
    lo, hi = 0, len(first) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if first[mid] <= c:
            lo = mid
        else:
            hi = mid - 1
    return lo


def global_norm_blocked(grads, nblocks: int) -> torch.Tensor:
    """The kernel's global norm in plain PyTorch: in each table's launch,
    block ``b`` of ``min(nblocks, the table's chunks)`` sums the squares of
    the table's chunks ``b``, ``b + nblocks``, ... in fp64 into one
    partial; the partials of every launch are summed in fp64 and ``sqrt``
    is rounded to float32 once. Sums inside a chunk run in another fp64
    order than the kernel's."""
    zero = torch.zeros((), dtype=torch.float64, device=grads[0].device)
    plan = plan_chunks([g.numel() for g in grads])
    leaves = [g.reshape(-1).double() for g in grads]
    sums = []
    for c in range(plan.nchunks):
        i = chunk_leaf(plan.first, c)
        x = leaves[i][(c - plan.first[i]) * CHUNK:][:CHUNK]
        sums.append(torch.sum(x * x))
    partials = []
    for _, _, c0, c1 in plan.tables:
        blocks = max(min(nblocks, c1 - c0), 1)
        partials += [sum(sums[c0:c1][b::blocks], zero) for b in range(blocks)]
    return torch.sqrt(torch.stack(partials).sum()).to(torch.float32)


# ---------------------------------------------------------------------------
# the CUDA path
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library(device_index: int) -> tuple[ctypes.CDLL, int, int]:
    """The loaded kernels, checked against this module's table layout, and
    the most blocks a launch of the pass and of the norm uses on the device
    (one resident wave of each)."""
    lib = _cuda.load("fused_sgd", _SIG)
    got = [ctypes.c_int(0) for _ in range(3)]
    lib.fused_sgd_layout(*map(ctypes.byref, got))
    if [v.value for v in got] != [CHUNK, MAX_LEAVES, LEAF_WORDS]:
        raise RuntimeError(f"csrc/fused_sgd.cu's table layout "
                           f"{[v.value for v in got]} != the wrapper's")
    apply_n, norm_n = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _cuda.check_launch(lib, lib.fused_sgd_num_blocks(
            ctypes.byref(apply_n), ctypes.byref(norm_n)),
            "fused_sgd_num_blocks")
    return lib, apply_n.value, norm_n.value


_dtype = operator.attrgetter("dtype")
_shape = operator.attrgetter("shape")


def _check_leaves(what: str, leaves, shapes, dev: torch.device) -> None:
    """Every leaf a contiguous float32 tensor of its param's shape on
    ``dev``: checked a list at a time (a leaf at a time costs a step more
    host time than its launches), then leaf by leaf to name a failure."""
    n = len(shapes)
    index = -1 if dev.type == "cpu" else dev.index
    if (list(map(_dtype, leaves)) == [torch.float32] * n
            and list(map(torch.Tensor.get_device, leaves)) == [index] * n
            and all(map(torch.Tensor.is_contiguous, leaves))
            and list(map(_shape, leaves)) == shapes):
        return
    for i, (x, shape) in enumerate(zip(leaves, shapes)):
        if (x.dtype is not torch.float32 or x.device != dev
                or not x.is_contiguous() or x.shape != shape):
            raise ValueError(
                f"fused_sgd: {what} leaf {i} must be a contiguous float32 "
                f"tensor of shape {tuple(shape)} on {dev}; got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}, strides {x.stride()}")


class _Table:
    """The host table of one list of leaves: ``LEAF_WORDS`` int64 words a
    leaf, as the kernels read them. Holds the params,
    momentum and mask tensors it describes, so that while a caller steps
    the same tensors their pointers stay valid and only the grads'
    pointers are written anew."""

    def __init__(self, params, trace, mask, dev: torch.device):
        n = len(params)
        if any(x is not None and len(x) != n for x in (trace, mask)):
            raise ValueError("fused_sgd: params, momentum and mask lists "
                             "differ in length")
        self.shapes = [p.shape for p in params]
        self.held = [*params, *(trace or ()), *(mask or ())]
        for what, leaves in (("param", params), ("momentum", trace),
                             ("mask", mask)):
            if leaves is not None:
                _check_leaves(what, leaves, self.shapes, dev)
        self.ptrs = [x.data_ptr() for x in self.held]
        plan = plan_chunks([p.numel() for p in params])
        rows = np.zeros((n, LEAF_WORDS), np.int64)
        rows[:, 0] = self.ptrs[:n]
        if trace is not None:
            rows[:, 2] = self.ptrs[n:2 * n]
        if mask is not None:
            rows[:, 3] = self.ptrs[-n:]
        rows[:, 4] = [p.numel() for p in params]
        rows[:, 5] = plan.first
        self.rows = rows
        self.nchunks = plan.nchunks
        self.ntables = len(plan.tables)
        self.dev = dev
        self.rows_ptr = rows.ctypes.data

    def holds(self, params, trace, mask) -> bool:
        """True where the lists are the tensors of this table, at the same
        addresses."""
        leaves = [*params, *(trace or ()), *(mask or ())]
        return (len(leaves) == len(self.held)
                and len(params) == len(self.shapes)
                and all(map(operator.is_, leaves, self.held))
                and list(map(torch.Tensor.data_ptr, leaves)) == self.ptrs)

    def set_grads(self, grads) -> None:
        if len(grads) != len(self.shapes):
            raise ValueError(f"fused_sgd: {len(grads)} grads for "
                             f"{len(self.shapes)} params")
        _check_leaves("grad", grads, self.shapes, self.dev)
        self.rows[:, 1] = list(map(torch.Tensor.data_ptr, grads))


_last_table: _Table | None = None


def _table(params, grads, trace, mask, momentum: float) -> _Table:
    """The table of these leaves (the last one where it holds them), with
    the grads' pointers written in."""
    global _last_table
    dev = params[0].device
    if dev.type != "cuda":
        raise ValueError(f"fused_sgd: unsupported device {dev}")
    if momentum > 0 and trace is None:
        raise ValueError("fused_sgd: momentum > 0 needs momentum buffers")
    trace = trace if momentum > 0 else None
    tab = _last_table
    if tab is None or not tab.holds(params, trace, mask):
        tab = _Table(params, trace, mask, dev)
        _cuda.check_device(*tab.held)
        _last_table = tab
    tab.set_grads(grads)
    return tab


def _flags(clip: float, wd: float, momentum: float, mask) -> int:
    return ((CLIP if clip > 0 else 0) | (WD if wd > 0 else 0)
            | (TRACE if momentum > 0 else 0) | (MASK if mask is not None
                                                 else 0))


_workspaces: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(dev: torch.device, stream: int, npartials: int):
    """The step's device buffers on one stream: ``scal`` ``[ok, gnorm, lr]``
    and ``work`` (the norm's ticket, then one fp64 partial a block of every
    table's launch), zeroed once and left so by every step."""
    ws = _workspaces.get((dev.index, stream))
    if ws is None or ws[1].numel() < 1 + npartials:
        ws = _workspaces[(dev.index, stream)] = (
            torch.zeros(3, dtype=torch.float32, device=dev),
            torch.zeros(1 + npartials, dtype=torch.float64, device=dev))
    return ws


def fused_sgd_apply(params, grads, trace, mask, scal: torch.Tensor, *,
                    clip: float, wd: float, momentum: float) -> None:
    """The fused pass over every leaf with the scalars ``scal`` of
    :func:`sgd_scalars`, in place on ``params`` and ``trace`` (None when
    momentum is 0); ``mask`` is None for dense runs. One kernel launch a
    table on CUDA tensors; the plain chain on CPU tensors."""
    dev = params[0].device
    if dev.type == "cpu":
        sgd_apply_plain(params, grads, trace, mask, scal, clip=clip, wd=wd,
                        momentum=momentum)
        return
    tab = _table(params, grads, trace, mask, momentum)
    if (scal.dtype != torch.float32 or scal.numel() != 3
            or not scal.is_contiguous() or scal.device != dev):
        raise ValueError(f"scal must be [ok, gnorm, lr] float32 on {dev}, got "
                         f"{scal.dtype} {tuple(scal.shape)} on {scal.device}")
    lib, apply_blocks, _ = _library(dev.index)
    with torch.cuda.device(dev):
        err = lib.fused_sgd_apply_launch(
            tab.rows_ptr, len(tab.shapes), tab.nchunks, clip, wd, momentum,
            _flags(clip, wd, momentum, mask), scal.data_ptr(), apply_blocks,
            _cuda.stream_ptr(dev))
    _cuda.check_launch(lib, err, "fused_sgd_apply_launch")
    LAUNCHES.add(tab.ntables)


def fused_sgd_step(params, grads, trace, mask, *, clip: float, wd: float,
                   momentum: float, lr) -> torch.Tensor | None:
    """One fused SGD step over lists of leaves, in place on ``params`` and
    ``trace``; ``lr`` may be a 0-d device tensor (the per-round lr). On
    CUDA tensors one host call queues the norm and the pass of each table
    (the passes alone without a clip). Returns the step's scalars ``[ok, gnorm, lr]`` where
    there is a clip (on the card, a buffer the next step on this device
    and stream overwrites), else None."""
    dev = params[0].device
    if dev.type == "cpu":
        scal = sgd_scalars(grads, clip=clip, lr=lr)
        sgd_apply_plain(params, grads, trace, mask, scal, clip=clip, wd=wd,
                        momentum=momentum)
        return scal if clip > 0 else None
    tab = _table(params, grads, trace, mask, momentum)
    if isinstance(lr, torch.Tensor) and lr.device.type != "cpu":
        if (lr.dtype != torch.float32 or lr.numel() != 1
                or lr.device != dev):
            raise ValueError(f"fused_sgd: lr must be one float32 on {dev}, "
                             f"got {lr.dtype} {tuple(lr.shape)} on "
                             f"{lr.device}")
        lr_ptr, lr_value = lr.data_ptr(), 0.0
    else:
        lr_ptr, lr_value = None, float(lr)
    lib, apply_blocks, norm_blocks = _library(dev.index)
    stream = _cuda.stream_ptr(dev)
    scal, work = _workspace(dev, stream, norm_blocks * tab.ntables)
    with torch.cuda.device(dev):
        err = lib.fused_sgd_step_launch(
            tab.rows_ptr, len(tab.shapes), tab.nchunks, clip, wd, momentum,
            _flags(clip, wd, momentum, mask), lr_ptr, lr_value,
            scal.data_ptr(), work.data_ptr(), apply_blocks, norm_blocks,
            stream)
    _cuda.check_launch(lib, err, "fused_sgd_step_launch")
    LAUNCHES.add((2 if clip > 0 else 1) * tab.ntables)
    return scal if clip > 0 else None
