"""The wire codec's value transform on the device (the reference package's
``codec/device.py``).

``lossy_roundtrip`` is what the aggregating server reconstructs from a
client's encoded upload, with no byte packing: delta against the broadcast
reference, the sparse stage (the engine's mask, or the global top-k over
every leaf of the upload with error feedback), the quantization and back.
The engines apply it to each upload before aggregation, so an in-process
round aggregates what a federation over the wire would. The top-k
threshold is the exact k-th largest ``|residual|`` by ``ops/topk.py``'s
``kth_largest``: on the card the ``kth_select`` kernel, on the CPU its
plain version; the host path (``wire.encode_update``, ``np.partition``)
keeps the same support set. Everything stays on the device: no host sync.
"""

from __future__ import annotations

import torch

from neuroimagedisttraining_tpu_torch.codec.wire import WireSpec
from neuroimagedisttraining_tpu_torch.ops.topk import kth_largest

State = dict[str, torch.Tensor]


def residuals(spec: WireSpec, update: State, reference: State | None,
              ef: State | None) -> State:
    """``update - reference`` (delta) or the update, in float32, plus the
    error feedback."""
    if spec.delta:
        x = {k: u.float() - reference[k].float() for k, u in update.items()}
    else:
        x = {k: u.float() for k, u in update.items()}
    if ef is not None:
        x = {k: v + ef[k] for k, v in x.items()}
    return x


def topk_count(spec: WireSpec, numel: int) -> int:
    """Entries the top-k stage keeps of ``numel``: ``ceil(ratio * n)``,
    at least 1."""
    return max(1, int(-(-spec.topk_ratio * numel // 1)))


def global_topk_keep(spec: WireSpec, x: State) -> State:
    """Top-``topk_ratio`` keep masks over all leaves together (one global
    threshold, as the SNIP mask)."""
    flat = torch.cat([v.abs().reshape(-1) for v in x.values()])
    thr = kth_largest(flat, topk_count(spec, flat.numel()))
    return {k: v.abs() >= thr for k, v in x.items()}


def quant_dequant(spec: WireSpec, v: torch.Tensor) -> torch.Tensor:
    """Per-leaf quantize -> dequantize (what the receiver sees): int8 at
    ``amax / 127`` (1 for an all-zero leaf), round half to even; or
    bfloat16."""
    if spec.quant == "int8":
        amax = v.abs().max()
        scale = torch.where(amax > 0, amax / torch.tensor(
            127.0, dtype=torch.float32, device=v.device),
            torch.ones_like(amax))
        q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
        return q.float() * scale
    if spec.quant == "bf16":
        return v.to(torch.bfloat16).float()
    return v


def lossy_roundtrip(spec: WireSpec, update: State, *,
                    reference: State | None = None,
                    masks: State | None = None, ef: State | None = None
                    ) -> tuple[State, State | None]:
    """decode(encode(update)): what the server reconstructs, and the
    sender's next error-feedback state (top-k mode, else None). ``masks``
    (keyed like ``update``) switches the sparse stage to mask mode, where
    off-mask entries decode to exact zero."""
    if spec.delta and reference is None:
        raise ValueError("wire codec: delta stage needs the broadcast "
                         "reference tree")
    x = residuals(spec, update, reference, ef)
    track_ef = spec.sparse and masks is None
    if spec.sparse:
        keep = ({k: m > 0 for k, m in masks.items()} if masks is not None
                else global_topk_keep(spec, x))
        xs = {k: torch.where(keep[k], v, torch.zeros_like(v))
              for k, v in x.items()}
    else:
        keep, xs = None, x
    deq = {k: quant_dequant(spec, v) for k, v in xs.items()}
    new_ef = {k: x[k] - deq[k] for k in x} if track_ef else None
    # mask-zero semantics only where the sparse stage dropped the
    # off-mask entries
    masked = masks is not None and keep is not None
    if spec.delta:
        decoded = {k: d + reference[k].float() for k, d in deq.items()}
    else:
        decoded = deq
    if masked:
        decoded = {k: torch.where(keep[k], d, torch.zeros_like(d))
                   for k, d in decoded.items()}
    return {k: d.to(update[k].dtype) for k, d in decoded.items()}, new_ef
