"""Device selection, the fp32 math contract and repeatable runs.

Entry points default to ``"cuda"`` and raise when no CUDA device exists;
the tests pass ``"cpu"``. On the card, float32 stays float32: cuDNN
convolutions would otherwise run in TF32 (about three decimal digits), so
both TF32 switches are set to False here, where a device is chosen. cuDNN
also runs its deterministic algorithms (benchmark off): under its default
ones two runs of one engine differ by up to 1.6e-2 of the largest weight
change, while on a flagship FedAvg round the deterministic ones cost
nothing measurable (-0.9% of the round's seconds in fp32, +0.2% in
bf16_mixed; ``chip_smoke.py`` on an H100 80GB HBM3 at 700 W), so the
port's runs repeat bit for bit, as the reference's do on its chip.
The contract holds wherever work first reaches a CUDA device: the CLI's
``build_experiment`` resolves its device here, and so does every
``LocalTrainer`` (where each engine and library caller puts its model on
the device).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device to run on; ``cuda`` must exist if asked for, and
    gets the fp32 contract and cuDNN's deterministic algorithms."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions")
        # fp32 path: full float32 in cuDNN convolutions and cuBLAS GEMMs
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        # repeatable runs: cuDNN's deterministic algorithms
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return dev
