"""Analytic FLOPs and communication-volume accounting (the reference's
``stat_info``).

FLOPs come from the conv and dense kernels' shapes and the conv layers'
output shapes, which one forward pass on the ``meta`` device records
through forward hooks: no activation is allocated and nothing is computed,
so counting at the flagship volume costs nothing. Per kernel, a conv counts
``2 * prod(kernel) * prod(out spatial) * density`` and a dense layer
``2 * in * out * density``, where ``density`` is the kept fraction of its
mask (1 when dense). Training FLOPs are 3x inference (forward plus about
twice that backward), the reference's convention. Communication volume is
the nonzero entry count of an update.

The port counts the convolutions that run. Two models differ from the
reference package's counter there: ``cnn_meta``, whose conv kernels are
top-level parameters (``meta_conv1_weight``), is counted at its
``meta_conv1`` module's output where the reference's counter raises, and
``resnet_meta``'s generated kernels (``KernelConv2d.kernel_shape``) are
counted beside its hypernetworks' dense kernels, which are all the
reference's counter sees.
"""

from __future__ import annotations

import math

import torch
from torch.func import functional_call

from neuroimagedisttraining_tpu_torch.ops.masks import is_weight_kernel

State = dict[str, torch.Tensor]


def probe_shape(model: torch.nn.Module,
                input_shape: tuple[int, ...]) -> tuple[int, ...]:
    """The one-sample batch the model takes for a sample of
    ``input_shape``: ``[1, 1, D, H, W]`` for a volume, ``[1, C, H, W]``
    for a 2D model's ``[H, W, C]`` image (``[1, 1, H, W]`` for ``[H,
    W]``)."""
    if getattr(model, "input_rank", 5) == 4 and len(input_shape) == 3:
        h, w, c = input_shape
        return (1, c, h, w)
    return (1, 1, *input_shape)


def _conv_output_shapes(model: torch.nn.Module,
                        input_shape: tuple[int, ...]) -> dict[str, tuple]:
    """Output shape of every module, by name, from one evaluation-mode
    forward of one ``input_shape`` sample on the meta device."""
    shapes: dict[str, tuple] = {}

    def hook(name):
        def record(_mod, _inp, out):
            shapes[name] = tuple(out.shape)
        return record

    handles = [m.register_forward_hook(hook(n))
               for n, m in model.named_modules() if n]
    meta = {k: torch.empty_like(v, device="meta")
            for k, v in (*model.named_parameters(), *model.named_buffers())}
    try:
        with torch.no_grad():
            functional_call(model, meta, (torch.empty(
                probe_shape(model, input_shape), device="meta"),),
                {"train": False})
    finally:
        for h in handles:
            h.remove()
    return shapes


def count_inference_flops(model: torch.nn.Module,
                          input_shape: tuple[int, ...],
                          mask_density: dict[str, float] | None = None
                          ) -> float:
    """FLOPs (2 per MAC) of one forward pass of one ``input_shape`` volume;
    ``mask_density`` maps a kernel's name to its kept fraction. Raises
    ``ValueError`` where a conv kernel's output shape was not seen (it
    would be undercounted by its whole spatial extent)."""
    out_shapes = _conv_output_shapes(model, input_shape)
    total = 0.0
    for name, w in model.named_parameters():
        if not is_weight_kernel(name, w):
            continue
        density = 1.0 if mask_density is None else float(
            mask_density.get(name, 1.0))
        macs_per_pos = float(math.prod(w.shape))
        if w.dim() > 2:  # conv weight [Cout, Cin, *k]
            # its module's output; a top-level kernel X_weight: module X's
            mod_path = (name.rsplit(".", 1)[0] if "." in name
                        else name.removesuffix("_weight"))
            out = out_shapes.get(mod_path)
            if out is None:
                raise ValueError(
                    f"FLOPs counter: no output shape seen for conv module "
                    f"{mod_path!r} (kernel {name!r}); seen: "
                    f"{sorted(out_shapes)[:8]}...")
            spatial = float(math.prod(out[2:]))  # NCDHW spatial dims
            total += 2.0 * macs_per_pos * spatial * density
        else:  # dense [out, in]
            total += 2.0 * macs_per_pos * density
    for name, mod in model.named_modules():  # generated kernels (dense)
        kernel = getattr(mod, "kernel_shape", None)
        if kernel is not None:
            total += 2.0 * math.prod(kernel) * math.prod(out_shapes[name][2:])
    return total


def count_training_flops_per_sample(model: torch.nn.Module,
                                    input_shape: tuple[int, ...],
                                    mask_density: dict[str, float] | None
                                    = None) -> float:
    """3x inference, the reference's convention."""
    return 3.0 * count_inference_flops(model, input_shape, mask_density)


def count_communication_params(update: State) -> float:
    """Nonzero entries of an update."""
    return float(sum(int(torch.count_nonzero(x)) for x in update.values()))


def densities_from_masks(masks: State) -> dict[str, float]:
    """Kept fraction of each maskable leaf's mask, as the reference's mean
    rounds it: the float32 sum times the float32 reciprocal of the count."""
    return {k: float(m.sum() * (1.0 / m.numel())) for k, m in masks.items()
            if is_weight_kernel(k, m)}
