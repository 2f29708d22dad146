"""Fused masked-SGD tail: clip + weight decay + momentum + update + mask in
one pass over each parameter leaf, updating params and momentum in place.

The stage-by-stage SGD chain reads and writes a params-sized intermediate
per stage. :func:`fused_sgd_apply` launches the CUDA kernel of
``csrc/fused_sgd.cu`` (which replaces the TPU kernel of the reference
package, ``ops/fused_update.py`` ``_leaf_pallas`` -> ``_make_kernel``)
once per leaf: read param, grad, momentum, mask; write param, momentum.
The global-norm reduction for the clip stays one separate pass
(:func:`sgd_scalars`); its result and the lr stay on the device, in a
3-float buffer ``[ok, gnorm, lr]`` the kernel reads. clip, wd and momentum
are Python floats passed by value.

:func:`sgd_apply_plain` is the same arithmetic in plain PyTorch, in the
reference's operation order (``where(ok, g, (g / gnorm) * clip)``,
``g + wd * p``, ``g + momentum * t``, ``p + (-lr) * g``, ``p * mask``),
each operation rounded on its own as the kernel does. It is the wrapper's
CPU path and, through :func:`sgd_step_plain`, the unfused optimizer chain
(core/optim.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from neuroimagedisttraining_tpu_torch.ops import _cuda

LAUNCHES = _cuda.counter("fused_sgd")
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIG = {"fused_sgd_launch": [_P, _P, _P, _P, _P, ctypes.c_longlong, _F, _F,
                             _F, _I, _I, _I, _I, _I, _P]}


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


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int) -> int:
    return 8 * torch.cuda.get_device_properties(
        device_index).multi_processor_count


def fused_sgd_apply(params, grads, trace, mask, scal: torch.Tensor, *,
                    clip: float, wd: float, momentum: float) -> None:
    """The fused pass over every leaf with the scalars of
    :func:`sgd_scalars`, in place on ``params`` and ``trace`` (None when
    momentum is 0); ``mask`` is None for dense runs. One kernel launch per
    leaf on CUDA tensors; the plain chain on CPU tensors."""
    dev = params[0].device
    if dev.type == "cpu":
        sgd_apply_plain(params, grads, trace, mask, scal, clip=clip, wd=wd,
                        momentum=momentum)
        return
    if dev.type != "cuda":
        raise ValueError(f"fused_sgd_apply: unsupported device {dev}")
    has_trace = momentum > 0
    leaves = [*params, *grads, *(trace if has_trace else ()),
              *(mask if mask is not None else ())]
    for t in (*leaves, scal):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fused_sgd kernel takes contiguous float32 "
                             f"tensors (got {t.dtype}, strides {t.stride()})")
    if scal.numel() != 3:
        raise ValueError(f"scal must be [ok, gnorm, lr], got {scal.shape}")
    _cuda.check_device(*leaves, scal)
    lib = _cuda.load("fused_sgd", _SIG)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = _cuda.stream_ptr(dev)
    with torch.cuda.device(dev):
        for i, (p, g) in enumerate(zip(params, grads)):
            t = trace[i] if has_trace else None
            m = mask[i] if mask is not None else None
            if any(o is not None and o.shape != p.shape for o in (g, t, m)):
                raise ValueError(f"leaf {i}: grad/momentum/mask shapes differ "
                                 f"from the param's {tuple(p.shape)}")
            err = lib.fused_sgd_launch(
                p.data_ptr(), g.data_ptr(),
                t.data_ptr() if t is not None else None,
                m.data_ptr() if m is not None else None,
                scal.data_ptr(), p.numel(), clip, wd, momentum,
                int(clip > 0), int(wd > 0), int(has_trace),
                int(m is not None), _max_blocks(index), stream)
            _cuda.check_launch(lib, err, "fused_sgd_launch")
            LAUNCHES.add()


def fused_sgd_step(params, grads, trace, mask, *, clip: float, wd: float,
                   momentum: float, lr) -> None:
    """One fused SGD step over lists of leaves, in place on ``params`` and
    ``trace``: :func:`sgd_scalars`, then :func:`fused_sgd_apply`. ``lr``
    may be a 0-d device tensor (the per-round lr)."""
    fused_sgd_apply(params, grads, trace, mask,
                    sgd_scalars(grads, clip=clip, lr=lr), clip=clip, wd=wd,
                    momentum=momentum)
