"""Model registry: the reference's 3D model names (``--model 3DCNN`` ->
``AlexNet3D_Dropout(num_classes=1)``, the reference harness's choice)."""

from __future__ import annotations

import os

import torch

from neuroimagedisttraining_tpu_torch.models.neuro3d import (  # noqa: F401
    AlexNet3D_Deeper_Dropout,
    AlexNet3D_Dropout,
    AlexNet3D_Dropout_Regression,
    BasicBlock3D,
    Bottleneck3D,
    ResNet3D_l3,
    Tiny3DCNN,
    flat_features,
    resnet_flat_features,
    tiny_flat_features,
)

#: the 3D models the port has, by CLI name and its aliases
MODELS_3D = {
    "3dcnn": ("alexnet3d", "alexnet3d_dropout"),
    "3dcnn_gn": ("alexnet3d_dropout_gn",),
    "3dcnn_deeper": ("alexnet3d_deeper_dropout",),
    "3dcnn_regression": ("alexnet3d_dropout_regression",),
    "3dcnn_tiny": ("tiny3dcnn",),
    "resnet3d": ("resnet_l3", "resnet3d_l3"),
}
_CANONICAL = {a: k for k, al in MODELS_3D.items() for a in (k, *al)}


def create_model(name: str, input_shape: tuple[int, int, int],
                 num_classes: int = 1, dtype: torch.dtype = torch.float32,
                 remat: bool | str = False):
    """Build a model by its CLI name for volumes of ``input_shape``, in the
    compute ``dtype`` (parameters stay float32), with the remat policy
    ``remat`` (``False``, ``"stem"`` or ``True``; the AlexNet family only,
    as in the reference). ``NIDT_FAST_STEM=1`` routes the 5^3 stem's weight
    gradient through the hand-written kernel (ops/stemconv.py), as in the
    reference: the AlexNet family has that stem, Tiny3DCNN and ResNet3D do
    not."""
    key = _CANONICAL.get(name.lower())
    if key is None:
        raise ValueError(f"unknown model {name!r}; the port has the 3D "
                         f"models {', '.join(MODELS_3D)}")
    shape = tuple(input_shape)
    fast = os.environ.get("NIDT_FAST_STEM") == "1"
    common = dict(num_classes=num_classes, dtype=dtype)
    if key == "3dcnn_tiny":
        return Tiny3DCNN(flat_features=tiny_flat_features(shape), **common)
    if key == "resnet3d":
        return ResNet3D_l3(flat_features=resnet_flat_features(shape),
                           **common)
    common.update(fast_stem=fast, remat=remat)
    if key == "3dcnn_deeper":
        return AlexNet3D_Deeper_Dropout(
            flat_features=flat_features(shape, 256), **common)
    cls = (AlexNet3D_Dropout_Regression if key == "3dcnn_regression"
           else AlexNet3D_Dropout)
    if key == "3dcnn_gn":
        common["norm"] = "group"
    return cls(flat_features=flat_features(shape), **common)


def primary_logits(out):
    """Some models return ``(logits, aux)`` (the deeper, regression and
    ResNet models, as the reference's); the logits tensor."""
    if isinstance(out, (tuple, list)):
        return out[0]
    return out
