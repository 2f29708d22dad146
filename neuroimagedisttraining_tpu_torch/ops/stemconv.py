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

Under ``bf16_mixed`` x, g and the weight are bfloat16. dW then runs in
``csrc/stem_dw_bf16.cu``: one bf16 product on the tensor cores
(``wgmma``, fed by a warp-specialised TMA ring) accumulated in float32 (a
bf16 x bf16 product is exact in f32), rounded to the bf16 weight by the
wrapper, as the reference's ``_bwd`` casts its f32-accumulated dW; autograd
carries it to the float32 master weight through the forward's cast. The
plain version takes the same product in float32 and rounds it the same
way. On a CUDA tensor a bf16 call launches the bf16 kernel or raises: it
never falls back to the plain version or to float32. :func:`bf16_plan`
cuts the call into the kernel's work items and refuses the shapes the
kernel does not take.

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
import dataclasses
import functools

import torch
import torch.nn.functional as F

from neuroimagedisttraining_tpu_torch.ops import _cuda

K = 5       # kernel size per spatial dim
S = 2       # stride
C_OUT = 64  # the kernel's output-channel width

LAUNCHES = _cuda.counter("stem_dw")
LAUNCHES_BF16 = _cuda.counter("stem_dw_bf16")
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
_SIG = {"stem_dw_num_parts": [ctypes.POINTER(ctypes.c_int)],
        "stem_dw_launch": _ARGS}
# the bf16 launch also takes the plan's rows an item
_SIG_BF16 = {"stem_dw_bf16_num_parts": [ctypes.POINTER(ctypes.c_int)],
             "stem_dw_bf16_launch": _ARGS[:-1] + [_I, _P]}
_DTYPES = (torch.float32, torch.bfloat16)

#: the bf16 kernel's work items (``csrc/stem_dw_bf16.cu``): positions an
#: item at most (4 boxes of 64, each one accumulator chain), elements of
#: one x plane slot, and the rows of 8 elements g's tensor map may address
#: (its coordinate is a signed 32-bit int)
BF16_KCAP = 256
BF16_BOX = 64
BF16_XPL = 1728
BF16_MAX_ROWS = 2 ** 31
#: the kernel's error code for a tensor map the driver refused (+ CUresult)
_TMAP_ERR = 100000


@dataclasses.dataclass(frozen=True)
class Bf16Plan:
    """How the bf16 kernel cuts one call: items of ``nr`` output rows of one
    (b, od), ``items`` of them; each output row takes ``bpr`` boxes of 64
    positions (its columns past OW zero), each box one chain."""

    nr: int
    bpr: int
    items: int
    od: int
    oh: int
    ow: int


def bf16_x_reach(nr: int, bpr: int, w: int) -> int:
    """Elements of an x plane slot the kernel's A loads reach for an item of
    ``nr`` rows of ``bpr`` boxes (its ``x_reach``): padded columns too."""
    return 2 * (nr + 1) * w + 32 * (4 * bpr - 1) + 42


def bf16_plan(b: int, d: int, h: int, w: int) -> Bf16Plan:
    """The bf16 kernel's plan for x ``[b, d, h, w]``: rows of ``ceil(OW /
    64)`` boxes, and the most output rows an item (4 boxes at most) whose x
    rows fit a plane slot. Raises ``ValueError`` for rows too wide for one
    item, or for a g too large for its tensor map."""
    od, oh, ow = (d - K) // S + 1, (h - K) // S + 1, (w - K) // S + 1
    if min(od, oh, ow) < 1:
        raise ValueError(f"stem_dw bf16: x {(b, d, h, w)} is smaller than "
                         f"the {K}^3 kernel")
    if (b * C_OUT - 56) * od * oh * ow // 8 >= BF16_MAX_ROWS:
        raise ValueError(
            f"stem_dw bf16: g of {b * C_OUT * od * oh * ow} elements is "
            f"past the kernel's tensor map (2^31 rows of 8 elements)")
    bpr = -(-ow // BF16_BOX)
    nr = min(oh, BF16_KCAP // BF16_BOX // bpr)
    while nr >= 1 and max((2 * nr + 3) * w + 7,
                          bf16_x_reach(nr, bpr, w)) > BF16_XPL:
        nr -= 1
    if nr < 1:
        raise ValueError(
            f"stem_dw bf16: rows of {w} x values ({ow} outputs) do not fit "
            f"one work item (at most {BF16_KCAP} outputs and an x plane "
            f"slot of {BF16_XPL} values)")
    return Bf16Plan(nr=nr, bpr=bpr, items=b * od * -(-oh // nr), od=od,
                    oh=oh, ow=ow)


def stem_dw_plain(x: torch.Tensor, g: torch.Tensor,
                  out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version: one [R] x [R, C] product per tap over the stride-2
    view of x that the tap reads, in float32 or wider (bf16 inputs are
    exact in float32), returned in ``out_dtype`` (default: x's dtype)."""
    out_dtype = out_dtype or x.dtype
    acc = torch.promote_types(x.dtype, torch.float32)
    b, d, h, w = x.shape[:4]
    od, oh, ow, c = g.shape[1:]
    xb = x.reshape(b, d, h, w).to(acc)
    g2 = g.reshape(-1, c).to(acc)
    rows = []
    for kd in range(K):
        for kh in range(K):
            for kw in range(K):
                sl = xb[:, kd:kd + S * (od - 1) + 1:S,
                        kh:kh + S * (oh - 1) + 1:S,
                        kw:kw + S * (ow - 1) + 1:S]
                rows.append(sl.reshape(1, -1) @ g2)
    return torch.cat(rows).reshape(K, K, K, 1, c).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _num_parts(name: str, device_index: int) -> int:
    lib = _cuda.load(name, _SIG if name == "stem_dw" else _SIG_BF16)
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        fn = getattr(lib, f"{name}_num_parts")
        _cuda.check_launch(lib, fn(ctypes.byref(n)), f"{name}_num_parts")
    return n.value


def stem_dw(x: torch.Tensor, g: torch.Tensor,
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """dW ``[5, 5, 5, 1, C]`` of ``conv3d(x, W, stride 2, VALID)`` for the
    output gradient ``g``, both float32 or both bfloat16, in ``out_dtype``
    (default: x's dtype; bf16 dW is the f32 sum rounded once)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu" and g.device.type == "cpu":
        return stem_dw_plain(x, g, out_dtype)
    if x.device.type != "cuda" or g.device.type != "cuda":
        raise ValueError(f"stem_dw: tensors on {x.device} and {g.device}")
    if x.dtype != g.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"stem_dw kernels take float32 or bfloat16 x and g "
                        f"of one dtype, got {x.dtype} and {g.dtype}")
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
    bf16 = x.dtype == torch.bfloat16
    plan = bf16_plan(b, d, h, w) if bf16 else None
    _cuda.check_device(x, g)
    name = "stem_dw_bf16" if bf16 else "stem_dw"
    lib = _cuda.load(name, _SIG_BF16 if bf16 else _SIG)
    dev = x.device
    nparts = _num_parts(name, dev.index if dev.index is not None
                        else torch.cuda.current_device())
    # nparts partials [125, 64] (f32: then one int flag per part)
    part = torch.empty(nparts * (K ** 3 * C_OUT + (0 if bf16 else 1)),
                       dtype=torch.float32, device=dev)
    dw = torch.empty((K ** 3, C_OUT), dtype=torch.float32, device=dev)
    launch = getattr(lib, f"{name}_launch")
    args = [x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
            nparts, b, d, h, w, od, oh, ow] + ([plan.nr] if bf16 else [])
    with torch.cuda.device(dev):
        err = launch(*args, _cuda.stream_ptr(dev))
    if bf16 and err >= _TMAP_ERR:
        raise RuntimeError(f"stem_dw_bf16_launch: cuTensorMapEncodeTiled "
                           f"refused g's map (CUresult {err - _TMAP_ERR})")
    _cuda.check_launch(lib, err, f"{name}_launch")
    if bf16:
        LAUNCHES_BF16.add(2)  # the partial products, the reduce
    else:  # the x low-part pass, the partial products, the reduce
        LAUNCHES.add(3)
    return dw.reshape(K, K, K, 1, C_OUT).to(out_dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, copied where its memory is not 16-byte aligned."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


class _StemConv3d(torch.autograd.Function):
    """``conv3d(x, w, stride 2)``; backward dW through :func:`stem_dw`, in
    the dtype of x and w (float32, or bf16 under ``bf16_mixed``)."""

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
