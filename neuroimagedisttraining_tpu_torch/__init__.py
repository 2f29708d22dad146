"""neuroimagedisttraining_tpu_torch — the PyTorch + CUDA port of the
federated neuroimaging trainer, for NVIDIA Hopper (H100, ``sm_90a``).

The JAX package ``neuroimagedisttraining_tpu`` is the reference; this
package mirrors its module names so each counterpart is easy to find, and
imports nothing from it. Ported so far: the flagship SalientGrads
federation (``--algorithm salientgrads --model 3DCNN``), the dense engines
(FedAvg, FedProx, Ditto, Local-only) and the sparse personalized ones
(Sub-FedAvg, DisPFL):

- ``data/``: synthetic ABCD cohort, site partition, padded uint8 client
  stacks kept on the device;
- ``models/``: ``AlexNet3D_Dropout`` (NCDHW inside, channels-last flatten
  so ``fc1`` sees the reference's feature order);
- ``core/``: BCE loss and AUC, the SGD chain, the local trainer;
- ``ops/``: the three hand-written CUDA kernels (stem weight gradient,
  fused SGD tail, count-greater-or-equal for the global top-k) beside
  their plain PyTorch versions, SNIP scoring, masks (ERK, fire and
  regrow), magnitude pruning, FLOPs accounting;
- ``engines/``: the engines by the reference's algorithm names;
- ``faults/``: DisPFL's seeded activity draw;
- ``weights.py``: carries flax parameter/mask trees across.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
