"""Model registry: the reference's model names (``--model 3DCNN`` ->
``AlexNet3D_Dropout(num_classes=1)``, the reference harness's choice), the
3D zoo and the 2D one (the DARTS family among it: ``darts`` / ``darts_v2``
and ``fednas_v1``, the fixed networks of those genotypes at C=36 and 20
cells, and ``darts_search``, the search supernet at C=16 and 8 cells),
with the reference package's aliases."""

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
from neuroimagedisttraining_tpu_torch.models.darts import (  # noqa: F401
    DARTS_V2,
    DartsNetwork,
    DartsSearchNet,
    FedNAS_V1,
)
from neuroimagedisttraining_tpu_torch.models.meta import (  # noqa: F401
    CHANNEL_SCALE,
    CNNCifarMeta,
    MetaNet,
    ResNetMeta,
    SlimBottleneckMeta,
)
from neuroimagedisttraining_tpu_torch.models.layers2d import in_channels
from neuroimagedisttraining_tpu_torch.models.resnet2d import (  # noqa: F401
    ResNet18,
    customized_resnet18,
    original_resnet18,
    resnet18_ip,
    tiny_resnet18,
)
from neuroimagedisttraining_tpu_torch.models.vision2d import (  # noqa: F401
    VGG,
    CNN_DropOut,
    CNN_OriginalFedAvg,
    CNNCifar,
    CNNCifarBN,
    LeNet5,
    LeNet5_cifar,
    cnn_dropout_flat,
    vgg11,
    vgg16,
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
#: the 2D models the port has, by CLI name and its aliases
MODELS_2D = {
    "resnet18": ("customized_resnet18",),
    "original_resnet18": (),
    "tiny_resnet18": (),
    "resnet18_ip": ("resnet_ip",),
    "vgg11": (),
    "vgg16": (),
    "cnn_cifar10": ("cnn_cifar100", "simple-cnn"),
    "cnn_cifar10_bn": ("cnn_cifar100_bn",),
    "cnn": ("cnn_originalfedavg",),
    "cnn_dropout": ("femnist-cnn",),
    "lenet5": (),
    "lenet5_cifar": (),
    "cnn_meta": ("cnn_cifar10_meta",),
    "resnet_meta": ("resnet20_meta",),
    "darts": ("darts_v2",),
    "fednas_v1": (),
    "darts_search": (),
}
_CANONICAL = {a: k for k, al in (*MODELS_3D.items(), *MODELS_2D.items())
              for a in (k, *al)}


def _create_2d(key: str, shape: tuple, num_classes: int, dtype):
    """A 2D model for ``[H, W, C]`` (or ``[H, W]``) images."""
    kw = dict(shape=shape, dtype=dtype)
    digits = num_classes <= 10  # the MNIST family: 10 outputs, else 62
    build = {
        "resnet18": customized_resnet18, "original_resnet18":
        original_resnet18, "tiny_resnet18": tiny_resnet18,
        "resnet18_ip": resnet18_ip, "vgg11": vgg11, "vgg16": vgg16,
        "cnn_cifar10": CNNCifar, "cnn_cifar10_bn": CNNCifarBN,
        "lenet5": LeNet5, "lenet5_cifar": LeNet5_cifar,
        "cnn_meta": CNNCifarMeta, "resnet_meta": ResNetMeta,
    }
    darts = {"darts": DARTS_V2, "fednas_v1": FedNAS_V1}
    if key in darts:
        return DartsNetwork(genotype=darts[key], num_classes=num_classes,
                            in_channels=in_channels(shape), dtype=dtype)
    if key == "darts_search":
        return DartsSearchNet(num_classes=num_classes,
                              in_channels=in_channels(shape), dtype=dtype)
    if key == "cnn":
        return CNN_OriginalFedAvg(only_digits=digits, **kw)
    if key == "cnn_dropout":
        return CNN_DropOut(only_digits=digits, **kw)
    return build[key](num_classes=num_classes, **kw)


def create_model(name: str, input_shape: tuple[int, ...],
                 num_classes: int = 1, dtype: torch.dtype = torch.float32,
                 remat: bool | str = False):
    """Build a model by its CLI name for samples of ``input_shape`` (a 3D
    model's ``[D, H, W]`` volume, a 2D model's ``[H, W, C]`` or ``[H, W]``
    image, which sizes its dense layers), in the compute ``dtype``
    (parameters stay float32), with the remat policy ``remat`` (``False``,
    ``"stem"`` or ``True``; the AlexNet family only, as in the reference).
    ``NIDT_FAST_STEM=1`` routes the 5^3 stem's weight gradient through the
    hand-written kernel (ops/stemconv.py), as in the reference: the AlexNet
    family has that stem, Tiny3DCNN, ResNet3D and the 2D models do not."""
    key = _CANONICAL.get(name.lower())
    if key is None:
        raise ValueError(f"unknown model {name!r}; the port has the 3D "
                         f"models {', '.join(MODELS_3D)} and the 2D models "
                         f"{', '.join(MODELS_2D)}")
    shape = tuple(input_shape)
    if key in MODELS_2D:
        return _create_2d(key, shape, num_classes, dtype)
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
