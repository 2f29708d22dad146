"""Model registry: ``--model 3DCNN`` -> ``AlexNet3D_Dropout(num_classes=1)``."""

from __future__ import annotations

import os

from neuroimagedisttraining_tpu_torch.models.neuro3d import (  # noqa: F401
    AlexNet3D_Dropout,
    flat_features,
)


def create_model(name: str, input_shape: tuple[int, int, int],
                 num_classes: int = 1):
    """Build a model by its CLI name for volumes of ``input_shape``.
    ``NIDT_FAST_STEM=1`` routes the stem's weight gradient through the
    hand-written kernel (ops/stemconv.py), as in the reference."""
    name = name.lower()
    if name in ("3dcnn", "alexnet3d", "alexnet3d_dropout"):
        return AlexNet3D_Dropout(
            num_classes=num_classes,
            flat_features=flat_features(tuple(input_shape)),
            fast_stem=os.environ.get("NIDT_FAST_STEM") == "1")
    raise ValueError(f"unknown model {name!r}; the port has: 3dcnn")
