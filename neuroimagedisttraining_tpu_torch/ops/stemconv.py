"""Stem convolution with a hand-written weight gradient (``NIDT_FAST_STEM=1``).

AlexNet3D opens with ``Conv3d(1, 64, kernel_size=5, stride=2)`` over the
whole 121x145x121 volume, and that layer's weight gradient contracts about
4 M output positions onto a [125, 64] result. :func:`stem_conv3d` keeps the
forward as ``F.conv3d`` (cuDNN) and computes dW with the CUDA kernel in
``csrc/stem_dw.cu``, which replaces the TPU kernel of the reference package
(``ops/stemconv.py``, ``_dw_pallas`` -> ``_dw_kernel``): a split-K product
on the tensor cores in split TF32 (each operand as a TF32 high part and a
TF32 remainder, three products summed in f32), which keeps fp32 accuracy
while the port runs with TF32 off; dx is the
transposed convolution, computed only when the input needs a gradient
(training data never does).

Shapes at the public function :func:`stem_dw` are the reference's:
x ``[B, D, H, W, 1]`` (for one channel, NDHWC and NCDHW are the same
memory), g ``[B, OD, OH, OW, C]``, dW ``[5, 5, 5, 1, C]`` (DHWIO). The
kernel reads g in the convolution's own NCDHW memory, so on the card g is
the channels-last view ``g_ncdhw.permute(0, 2, 3, 4, 1)`` of a contiguous
NCDHW tensor and no copy is made. On CPU tensors (any strides) it runs
:func:`stem_dw_plain`; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from neuroimagedisttraining_tpu_torch.ops import _cuda

K = 5       # kernel size per spatial dim
S = 2       # stride
C_OUT = 64  # the kernel's output-channel width

LAUNCHES = _cuda.counter("stem_dw")
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"stem_dw_num_parts": [ctypes.POINTER(ctypes.c_int)],
        "stem_dw_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P]}


def stem_dw_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version: one [R] x [R, C] product per tap over the stride-2
    view of x that the tap reads."""
    b, d, h, w = x.shape[:4]
    od, oh, ow, c = g.shape[1:]
    xb = x.reshape(b, d, h, w)
    g2 = g.reshape(-1, c)
    rows = []
    for kd in range(K):
        for kh in range(K):
            for kw in range(K):
                sl = xb[:, kd:kd + S * (od - 1) + 1:S,
                        kh:kh + S * (oh - 1) + 1:S,
                        kw:kw + S * (ow - 1) + 1:S]
                rows.append(sl.reshape(1, -1) @ g2)
    return torch.cat(rows).reshape(K, K, K, 1, c)


@functools.lru_cache(maxsize=None)
def _num_parts(device_index: int) -> int:
    lib = _cuda.load("stem_dw", _SIG)
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _cuda.check_launch(lib, lib.stem_dw_num_parts(ctypes.byref(n)),
                           "stem_dw_num_parts")
    return n.value


def stem_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW ``[5, 5, 5, 1, C]`` of ``conv3d(x, W, stride 2, VALID)`` for the
    output gradient ``g``."""
    if x.device.type == "cpu" and g.device.type == "cpu":
        return stem_dw_plain(x, g)
    if x.device.type != "cuda" or g.device.type != "cuda":
        raise ValueError(f"stem_dw: tensors on {x.device} and {g.device}")
    if x.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError("stem_dw kernel takes float32 x and g")
    if x.dim() != 5 or x.shape[-1] != 1 or not x.is_contiguous():
        raise ValueError(f"stem_dw: x must be contiguous [B,D,H,W,1], got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    b, d, h, w = x.shape[:4]
    od, oh, ow = (d - K) // S + 1, (h - K) // S + 1, (w - K) // S + 1
    if (tuple(g.shape) != (b, od, oh, ow, C_OUT)
            or not g.permute(0, 4, 1, 2, 3).is_contiguous()):
        raise ValueError(
            f"stem_dw: g must be the {(b, od, oh, ow, C_OUT)} view of a "
            f"contiguous NCDHW tensor, got {tuple(g.shape)} strides "
            f"{g.stride()}")
    if x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("stem_dw: x and g must be 16-byte aligned (the "
                         "kernel copies 16-byte chunks)")
    _cuda.check_device(x, g)
    lib = _cuda.load("stem_dw", _SIG)
    dev = x.device
    nparts = _num_parts(dev.index if dev.index is not None
                        else torch.cuda.current_device())
    # nparts partials [125, 64], then one int flag per part
    part = torch.empty(nparts * (K ** 3 * C_OUT + 1), dtype=torch.float32,
                       device=dev)
    dw = torch.empty((K ** 3, C_OUT), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.stem_dw_launch(x.data_ptr(), g.data_ptr(), part.data_ptr(),
                                 dw.data_ptr(), nparts, b, d, h, w, od, oh,
                                 ow, _cuda.stream_ptr(dev))
    _cuda.check_launch(lib, err, "stem_dw_launch")
    LAUNCHES.add(3)  # the x low-part pass, the partial products, the reduce
    return dw.reshape(K, K, K, 1, C_OUT)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, copied where its memory is not 16-byte aligned."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


class _StemConv3d(torch.autograd.Function):
    """``conv3d(x, w, stride 2)``; backward dW through :func:`stem_dw`."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv3d(x, w, stride=S)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv3d_input(x.shape, w, gy, stride=S)
        if ctx.needs_input_grad[1]:
            b, _, d, h, wd = x.shape
            # a view: the kernel reads gy's own NCDHW memory
            g = _aligned(gy).permute(0, 2, 3, 4, 1)
            dw = stem_dw(_aligned(x).reshape(b, d, h, wd, 1), g)
            dw = dw.permute(4, 3, 0, 1, 2).contiguous()  # DHWIO -> OIDHW
        return dx, dw


def stem_conv3d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-2 VALID conv of single-channel NCDHW ``x`` with OIDHW ``w``."""
    return _StemConv3d.apply(x, w)
