"""Typed message model of the cross-silo control plane (the reference
package's ``distributed/message.py``, the same wire format).

A message is ``{msg_type, sender_id, receiver_id}`` plus a key-value
payload whose values may be model trees. On the wire it is a 2-frame
msgpack envelope: the magic ``b"NIDT1"``, then the msgpack of
``{"h": {"t", "s", "r"}, "p": payload}`` through the port's own msgpack
(``codec/wire.py``, maps in sorted key order, arrays as flax's ndarray
ext, numpy scalars as its scalar ext). A message's bytes are the
reference's for the same payload, so a JAX silo and a port silo speak one
control plane. A tensor in the payload goes on the wire as its numpy
values; what comes off the wire is numpy.

An ``ARG_MODEL_PARAMS`` value is the dense tree (``{"params",
"batch_stats"}`` nested as flax nests them, in flax's layout:
``weights.state_to_flax``), a tagged codec frame (``codec/wire.py``,
decoded by the receiver's ``decode_update``), or a secure share tree or
secure-quant frame (``privacy/``).
"""

from __future__ import annotations

import struct
from typing import Any

from neuroimagedisttraining_tpu_torch.codec.wire import (
    msgpack_dumps, msgpack_loads,
)

# protocol message types (the reference's handler keys)
MSG_TYPE_CONNECTION_IS_READY = "connection_ready"
MSG_TYPE_C2S_REGISTER = "client_register"
MSG_TYPE_S2C_INIT_CONFIG = "server_init_config"
MSG_TYPE_S2C_SYNC_MODEL = "server_sync_model"
MSG_TYPE_C2S_SEND_MODEL = "client_send_model"
MSG_TYPE_S2C_FINISH = "server_finish"
#: liveness beats of a silo; the server marks silent silos suspect
MSG_TYPE_C2S_HEARTBEAT = "client_heartbeat"
#: the secure server's weight exchange (``cross_silo.SecureFedAvgServer``)
MSG_TYPE_C2S_NUM_SAMPLES = "client_num_samples"
MSG_TYPE_S2C_AGG_WEIGHTS = "server_agg_weights"
#: grouped secure aggregation (``cross_silo.SlotAggregatorProc``): a silo
#: sends aggregator j ONE share slot; the aggregator sends the server the
#: slot's total over the silos
MSG_TYPE_C2A_SEND_SLOT = "client_send_slot"
MSG_TYPE_A2S_SLOT_TOTAL = "aggregator_slot_total"

# payload keys
ARG_MODEL_PARAMS = "model_params"
ARG_NUM_SAMPLES = "num_samples"
ARG_CLIENT_INDEX = "client_index"
ARG_ROUND_IDX = "round_idx"
ARG_AGG_WEIGHT = "agg_weight"
ARG_SLOT_INDEX = "slot_index"
#: on a sync: the silo clears its codec error feedback before training (the
#: first sync after its quarantine window: the feedback it kept against
#: frames the server dropped matches nothing the server aggregated)
ARG_EF_RESET = "ef_reset"
#: a silo's monotone upload counter; the synchronous server dedups on the
#: round tag and ignores it (the asynchronous plane reads it)
ARG_UPLOAD_SEQ = "upload_seq"
#: ``{"trace_id": int, "span_id": int}`` a silo stamps on every upload
#: (``obs.trace.make_trace_ctx``); optional for a receiver
ARG_TRACE_CTX = "trace_ctx"
#: the sender keeps its connection open for replies (asynchronous plane)
ARG_CONN_PERSISTENT = "persistent_conn"
#: the sender's lifetime nonce, sent at registration (its pid)
ARG_CLIENT_INCARNATION = "client_incarnation"
#: the sender takes delta sync bodies (asynchronous plane)
ARG_SYNC_DELTA_OK = "sync_delta_ok"

_MAGIC = b"NIDT1"


def frame_bytes(msg: "Message") -> bytes:
    """The on-the-wire framing every transport emits: an 8-byte ``!Q``
    length prefix, then the serialized message."""
    raw = msg.to_bytes()
    return struct.pack("!Q", len(raw)) + raw


class Message:
    """A dict-shaped message with a typed header."""

    def __init__(self, msg_type: str = "default", sender_id: int = 0,
                 receiver_id: int = 0):
        self.msg_type = msg_type
        self.sender_id = int(sender_id)
        self.receiver_id = int(receiver_id)
        self.params: dict[str, Any] = {}

    def add(self, key: str, value: Any) -> None:
        self.params[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self.params.get(key, default)

    # ---- codec ----

    def to_bytes(self) -> bytes:
        body = {"h": {"t": self.msg_type, "s": self.sender_id,
                      "r": self.receiver_id},
                "p": self.params}
        return _MAGIC + msgpack_dumps(body)

    @staticmethod
    def from_bytes(raw: bytes) -> "Message":
        if raw[: len(_MAGIC)] != _MAGIC:
            raise ValueError("bad message frame (magic mismatch)")
        body = msgpack_loads(memoryview(raw)[len(_MAGIC):])
        m = Message(body["h"]["t"], body["h"]["s"], body["h"]["r"])
        m.params = body["p"]
        return m

    def __repr__(self) -> str:  # small, no payload dump
        return (f"Message({self.msg_type}, {self.sender_id}->"
                f"{self.receiver_id}, keys={sorted(self.params)})")
