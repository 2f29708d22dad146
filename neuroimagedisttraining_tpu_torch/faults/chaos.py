"""``FaultyCommManager``: a :class:`FaultSchedule` applied to any
transport (the reference package's ``faults/chaos.py``).

A decorator over the ``BaseCommManager`` contract: the wrapped transport's
code is untouched. The wrapper sits between the manager and its observers
on the receive side and in front of ``send_message`` on the send side,
and asks the schedule about every protocol message.

- **crash**: from the crash round on, the peer goes silent: inbound
  dispatch stops (the manager's blocking loop returns, so the process or
  thread winds down as a real death would) and every send is swallowed.
  The latch is permanent: ``distributed/run.py`` refuses ``rejoin:`` specs
  at startup (a replacement process re-registers instead).
- **straggle**: outbound sends sleep the scheduled delay first.
- **drop**: the send never happens.
- **duplicate**: the frame is sent twice (the server's round-tagged dedup
  makes it harmless).
- **disconnect**: the frame is torn mid-write: on the socket transport a
  fresh connection sends a length prefix promising more bytes than follow,
  then closes (the receiver drops the partial frame); on a transport
  without per-frame connections it is a drop.

Determinism: a message's draws are indexed by ``(round, rank,
crc32(msg_type), seq within its type)``, so the decision for the round-3
upload does not depend on how many heartbeats preceded it. Heartbeats and
registrations are exempt from drop / duplicate / disconnect; their loss is
a crash. Given the same spec, seed and message sequence, the decisions
are the reference's (the schedule is ``faults/schedule.py``'s port).
"""

from __future__ import annotations

import logging
import socket
import time
import zlib

from neuroimagedisttraining_tpu_torch.distributed import message as M
from neuroimagedisttraining_tpu_torch.distributed.comm import (
    BaseCommManager,
    Observer,
)
from neuroimagedisttraining_tpu_torch.faults.schedule import FaultSchedule

log = logging.getLogger("neuroimagedisttraining_tpu_torch.faults")


class FaultyCommManager(BaseCommManager, Observer):
    """Wrap ``inner`` so every message it sends/receives is subject to
    ``schedule``'s events for ``rank``. Registers itself as the inner
    manager's only observer and re-dispatches to its own observers."""

    def __init__(self, inner: BaseCommManager, schedule: FaultSchedule,
                 rank: int):
        self.inner = inner
        self.schedule = schedule
        self.rank = int(rank)
        self.crashed = False
        self._round = 0             # last round seen on any tagged message
        self._seq: dict[tuple[int, int], int] = {}  # (round, type-crc) -> next seq
        self._observers: list[Observer] = []
        inner.add_observer(self)

    # ---- receive side (Observer over the inner transport) ----

    def receive_message(self, msg_type: str, msg: M.Message) -> None:
        r = msg.get(M.ARG_ROUND_IDX)
        if r is not None:
            self._round = max(self._round, int(r))
        if self.schedule.crashed(self._round, self.rank):
            self._die()
            return
        for obs in list(self._observers):
            obs.receive_message(msg_type, msg)

    def _die(self) -> None:
        if self.crashed:
            return
        self.crashed = True
        log.warning("rank %d: simulated crash at round %d (%s)",
                    self.rank, self._round, self.schedule.describe())
        # stop inbound dispatch: the owning manager's blocking loop
        # returns and the process/thread winds down like a real death
        self.inner.stop_receive_message()

    # ---- send side ----

    def _next_seq(self, round_idx: int, msg_type: str) -> int:
        key = (round_idx, zlib.crc32(msg_type.encode()))
        seq = self._seq.get(key, 0)
        self._seq[key] = seq + 1
        return seq

    def send_message(self, msg: M.Message, **kw) -> None:
        if self.crashed:
            return
        r = msg.get(M.ARG_ROUND_IDX)
        round_idx = int(r) if r is not None else self._round
        if self.schedule.crashed(round_idx, self.rank):
            self._die()
            return
        if msg.msg_type in (M.MSG_TYPE_C2S_HEARTBEAT,
                            M.MSG_TYPE_C2S_REGISTER):
            # heartbeats bypass message-level chaos (their count is
            # timing-dependent; including them would break seq
            # determinism — losing them is modeled by crash). So does
            # registration: a real client retries registering until
            # acknowledged, and dropping the one-shot register frame
            # would deadlock the strict start barrier rather than model
            # an interesting failure.
            self.inner.send_message(msg, **kw)
            return
        seq = self._next_seq(round_idx, msg.msg_type)
        if self.schedule.drop(round_idx, self.rank, seq):
            log.warning("rank %d: dropping %s (round %d seq %d)",
                        self.rank, msg.msg_type, round_idx, seq)
            return
        delay = self.schedule.straggle_seconds(round_idx, self.rank)
        if delay > 0:
            time.sleep(delay)
        if self.schedule.disconnect(round_idx, self.rank, seq):
            log.warning("rank %d: mid-frame disconnect on %s "
                        "(round %d seq %d)", self.rank, msg.msg_type,
                        round_idx, seq)
            self._send_truncated(msg)
            return
        self.inner.send_message(msg, **kw)
        if self.schedule.duplicate(round_idx, self.rank, seq):
            log.warning("rank %d: duplicating %s (round %d seq %d)",
                        self.rank, msg.msg_type, round_idx, seq)
            self.inner.send_message(msg, **kw)

    def _send_truncated(self, msg: M.Message) -> None:
        """Socket transport: write half a frame then slam the connection
        shut — the receiver's listener must survive (comm.py drops the
        partial frame). Transports without per-frame connections (broker)
        degrade to a plain drop."""
        host_map = getattr(self.inner, "host_map", None)
        base_port = getattr(self.inner, "base_port", None)
        if host_map is None or base_port is None:
            return  # pub/sub stream: tearing it would desync ALL topics
        frame = M.frame_bytes(msg)  # prefix promises more than we send
        addr = (host_map[msg.receiver_id], base_port + msg.receiver_id)
        try:
            with socket.create_connection(addr, timeout=5.0) as conn:
                # a fresh connection: no other writer
                conn.sendall(frame[: 8 + max(1, (len(frame) - 8) // 2)])  # nidt: allow[lock-send] -- fault injection writes a deliberately torn frame on a fresh per-call connection; no concurrent writer exists
        except OSError:
            pass  # receiver gone — the message is lost either way

    # ---- delegated contract ----

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        self._observers.remove(observer)

    def handle_receive_message(self) -> None:
        self.inner.handle_receive_message()

    def stop_receive_message(self) -> None:
        self.inner.stop_receive_message()
