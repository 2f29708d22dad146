"""neuroimagedisttraining_tpu_torch — the PyTorch + CUDA port of the
federated neuroimaging trainer, for NVIDIA Hopper (H100, ``sm_90a``).

The JAX package ``neuroimagedisttraining_tpu`` is the reference; this
package mirrors its module names so each counterpart is easy to find, and
imports nothing from it. Ported so far: every algorithm the reference
names (the flagship SalientGrads federation, ``--algorithm salientgrads
--model 3DCNN``, the dense, sparse personalized, decentralized and secure
engines) on every 3D model of its zoo, in fp32 or ``bf16_mixed``:

- ``data/``: the HDF5 and synthetic ABCD cohorts, site partition, padded
  uint8 client stacks kept on the device or streamed to it;
- ``models/``: the 3D zoo (NCDHW inside, channels-last flatten so a dense
  layer sees the reference's feature order; flax's compute-dtype and
  normalisation semantics; remat blocks);
- ``core/``: BCE and softmax CE, AUC, the SGD and Adam chains, the
  precision contract, the local trainer;
- ``ops/``: the hand-written CUDA kernels (stem weight gradient in f32 and
  bf16, fused SGD tail, count-greater-or-equal for the global top-k)
  beside their plain PyTorch versions, the tie-splitting max pool, SNIP
  scoring, masks (ERK, fire and regrow), magnitude pruning, FLOPs
  accounting;
- ``engines/``: the engines by the reference's algorithm names;
- ``faults/``: the seeded fault schedule (crashes, Byzantine value faults,
  DisPFL's activity draw) and the attacks on the uploads;
- ``core/robust.py``, ``privacy/``, ``codec/``: the defenses, the RDP
  accountant and the wire codec of the defended round;
- ``weights.py``: carries flax parameter/mask trees across.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
