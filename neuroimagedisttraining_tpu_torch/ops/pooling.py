"""The non-overlapping 3D max pool with a tie-splitting gradient
(``NIDT_FAST_POOL=1``), the reference package's ``ops/pooling.py``.

For windows of size ``k`` at stride ``k`` (the AlexNet family's 3^3 pools,
Tiny3DCNN's 2^3) the gradient has a closed form:
``dx = (x == upsample(y)) * upsample(g / count)``, where ``count`` is the
number of elements of the window tied at its maximum. The window's gradient
is split equally across its tied maxima, where ``torch.max_pool3d`` routes
it all to one of them; on inputs without ties the two agree. It is plain
PyTorch in both packages (plain XLA in the reference), not a kernel. The
arithmetic runs in the gradient's dtype, as the reference's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _upsample(y: torch.Tensor, k: int, spatial) -> torch.Tensor:
    """Nearest-neighbour upsample of NCDHW ``y`` by ``k``, zero-padded to
    ``spatial`` (the voxels past the last full window belong to none)."""
    n, c, d, h, w = y.shape
    y = y[:, :, :, None, :, None, :, None].expand(n, c, d, k, h, k, w, k)
    y = y.reshape(n, c, d * k, h * k, w * k)
    pad = (0, spatial[2] - w * k, 0, spatial[1] - h * k,
           0, spatial[0] - d * k)
    return F.pad(y, pad) if any(pad) else y


class _MaxPoolNonOverlap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        y = F.max_pool3d(x, k, k)
        ctx.save_for_backward(x, y)
        ctx.k = k
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        k = ctx.k
        spatial = x.shape[2:]
        mask = (x == _upsample(y, k, spatial)).to(g.dtype)
        n, c, d, h, w = y.shape
        cnt = mask[:, :, :d * k, :h * k, :w * k].reshape(
            n, c, d, k, h, k, w, k).sum((3, 5, 7))
        return mask * _upsample(g / torch.clamp(cnt, min=1.0), k,
                                spatial), None


def max_pool_3d_nonoverlap(x: torch.Tensor, k: int) -> torch.Tensor:
    """``max_pool3d(x, k, stride k)`` over NCDHW ``x`` (VALID windows),
    with the tie-splitting gradient."""
    return _MaxPoolNonOverlap.apply(x, k)
