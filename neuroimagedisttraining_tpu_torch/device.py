"""Device selection and the fp32 math contract.

Entry points default to ``"cuda"`` and raise when no CUDA device exists;
the tests pass ``"cpu"``. On the card, float32 stays float32: cuDNN
convolutions would otherwise run in TF32 (about three decimal digits), so
both TF32 switches are set to False here, where a device is chosen.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device to run on; ``cuda`` must exist if asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions")
        # fp32 path: full float32 in cuDNN convolutions and cuBLAS GEMMs
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
