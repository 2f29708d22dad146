"""The broker transport: pub/sub over a dependency-free TCP fan-out daemon
(the reference package's ``distributed/broker.py``, the MQTT role).

Topics follow MQTT's scheme of the original system: the server (id 0)
subscribes ``<topic><c>`` for every client ``c`` in 1..N and publishes to
``<topic>0_<c>``; client ``c`` subscribes ``<topic>0_<c>`` and publishes
to ``<topic><c>``. Peers keep ONE persistent connection carrying
length-prefixed SUB / PUB frames whose payloads are ``Message`` envelopes.
The broker keeps the last frame of each topic (MQTT's ``retain``), so a
subscriber that arrives after a publish still gets the latest state.

Every outbound socket has a write lock (a frame is written whole even when
several serve threads fan out to one subscriber); a retained frame goes
out under the new subscriber's write lock, taken BEFORE its subscription
is visible, so a live PUB is never overtaken by the stale retained frame.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading

from neuroimagedisttraining_tpu_torch.distributed.comm import (
    BaseCommManager,
    QueueDispatchMixin,
    _recv_exact,
)
from neuroimagedisttraining_tpu_torch.distributed.message import Message

_OP_SUB = 0
_OP_PUB = 1
_HDR = struct.Struct("!BHQ")  # op, topic_len, payload_len

log = logging.getLogger("neuroimagedisttraining_tpu_torch.broker")


def _write_frame(conn: socket.socket, op: int, topic: str,
                 payload: bytes = b"") -> None:
    t = topic.encode()
    # every caller holds the destination socket's write lock
    conn.sendall(_HDR.pack(op, len(t), len(payload)) + t + payload)  # nidt: allow[lock-send] -- frame-atomicity helper: every caller holds the destination socket's write lock (contract above)


def _read_frame(conn: socket.socket) -> tuple[int, str, bytes] | None:
    hdr = _recv_exact(conn, _HDR.size)
    if hdr is None:
        return None
    op, tlen, plen = _HDR.unpack(hdr)
    t = _recv_exact(conn, tlen)
    if t is None:
        return None
    payload = _recv_exact(conn, plen) if plen else b""
    if plen and payload is None:
        return None
    return op, t.decode(), payload


class MessageBroker:
    """Topic fan-out daemon: SUB registers the connection under a topic,
    PUB forwards the frame to every subscriber of that topic and retains
    it for late subscribers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen(64)
        self.port = self._server.getsockname()[1]
        self._subs: dict[str, list[socket.socket]] = {}
        self._retained: dict[str, bytes] = {}
        self._wlocks: dict[socket.socket, threading.Lock] = {}
        self._conns: set[socket.socket] = set()
        self._lock = threading.Lock()
        self._running = True
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            # bounded sends broker-side too: a hung subscriber (stopped
            # reader, full TCP buffer) must not wedge the serving thread
            # that is fanning out under that subscriber's write lock —
            # same rationale as BrokerCommManager's SO_SNDTIMEO. Send-only:
            # recv must still block indefinitely for idle subscribers.
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                            struct.pack("ll", 30, 0))
            with self._lock:
                self._conns.add(conn)
                self._wlocks[conn] = threading.Lock()
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _send_to(self, conn: socket.socket, topic: str,
                 payload: bytes) -> bool:
        """Atomic frame write under the connection's write lock."""
        wlock = self._wlocks.get(conn)
        if wlock is None:
            return False
        try:
            with wlock:
                _write_frame(conn, _OP_PUB, topic, payload)
            return True
        except OSError:
            return False

    def _serve(self, conn: socket.socket) -> None:
        try:
            while True:
                frame = _read_frame(conn)
                if frame is None:
                    break
                op, topic, payload = frame
                if op == _OP_SUB:
                    # hold the subscriber's write lock ACROSS registration
                    # + retained delivery: a live PUB that sees the new
                    # subscription must queue behind the retained frame,
                    # so the newest message is never overtaken by a stale
                    # retained one
                    wlock = self._wlocks.get(conn)  # stop()/_drop may race
                    if wlock is None:
                        break
                    with wlock:
                        with self._lock:
                            self._subs.setdefault(topic, []).append(conn)
                            late = self._retained.get(topic)
                        if late is not None:
                            try:
                                _write_frame(conn, _OP_PUB, topic, late)
                            except OSError:
                                break
                elif op == _OP_PUB:
                    with self._lock:
                        targets = list(self._subs.get(topic, ()))
                        self._retained[topic] = payload
                    for t in targets:
                        if not self._send_to(t, topic, payload):
                            # a failed send (timeout mid-frame or OSError)
                            # may leave the subscriber's byte stream torn
                            # mid-length-prefix — every later frame on ANY
                            # topic would be misparsed. Tear the whole
                            # connection down, not just this subscription.
                            self._drop(t)
        except OSError:
            pass  # conn closed under us (peer died / broker.stop()) —
            # normal teardown, not a serve-thread crash to report
        finally:
            self._drop(conn)

    def _drop(self, conn: socket.socket) -> None:
        with self._lock:
            for subs in self._subs.values():
                if conn in subs:
                    subs.remove(conn)
            self._wlocks.pop(conn, None)
            self._conns.discard(conn)
        try:
            conn.close()
        except OSError:
            pass

    def stop(self) -> None:
        """Tear down the listener AND every live connection (their serve
        threads exit on the closed socket)."""
        self._running = False
        try:
            self._server.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            self._drop(c)


class BrokerCommManager(QueueDispatchMixin, BaseCommManager):
    """Pub/sub comm manager over a ``MessageBroker`` with MQTT's topic
    scheme; the same 5-method contract as ``SocketCommManager``."""

    def __init__(self, host: str, port: int, topic: str = "fedml",
                 client_id: int = 0, client_num: int = 0):
        self.client_id = client_id
        self.client_num = client_num
        self._topic = topic
        self._init_dispatch()
        self._conn = socket.create_connection((host, port), timeout=30.0)
        # receives must block indefinitely (an idle subscription is normal
        # — clearing the connect timeout keeps the reader alive), but sends
        # stay bounded via SO_SNDTIMEO so a wedged broker (full TCP buffer)
        # surfaces an error instead of deadlocking publishers on _send_lock
        self._conn.settimeout(None)
        self._conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                              struct.pack("ll", 30, 0))
        self._send_lock = threading.Lock()
        if client_id == 0:  # server: one inbound topic per client
            for cid in range(1, client_num + 1):
                self._subscribe(f"{topic}{cid}")
        else:  # client: the server->me topic
            self._subscribe(f"{topic}0_{client_id}")
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _subscribe(self, t: str) -> None:
        with self._send_lock:
            _write_frame(self._conn, _OP_SUB, t)

    def _read_loop(self) -> None:
        while True:
            try:
                frame = _read_frame(self._conn)
            except OSError:
                frame = None
            if frame is None:
                # broker gone or stream closed: unblock the dispatch loop
                # instead of hanging it forever
                log.warning("peer %d: broker connection closed",
                            self.client_id)
                self._stop_dispatch()
                return
            try:
                self._count_recv(len(frame[2]))
                self._enqueue(Message.from_bytes(frame[2]))
            except Exception as e:  # noqa: BLE001 — framing is intact, so
                # a bad payload is droppable without desyncing the stream
                log.warning("peer %d: dropped malformed payload: %s",
                            self.client_id, e)

    # ---- BaseCommManager contract ----

    def send_message(self, msg: Message) -> None:
        if self.client_id == 0:
            t = f"{self._topic}0_{msg.receiver_id}"
        else:
            t = f"{self._topic}{self.client_id}"
        raw = msg.to_bytes()
        with self._send_lock:
            try:
                _write_frame(self._conn, _OP_PUB, t, raw)
            except OSError:
                # a failed/timed-out sendall may have written a PARTIAL
                # frame — the stream is desynced and must not be reused;
                # closing also stops the reader, which unblocks dispatch
                try:
                    self._conn.close()
                except OSError:
                    pass
                raise
        # count only frames that actually reached the wire (parity with
        # the socket transport's after-sendall accounting): chaos-killed
        # sends must not inflate the A/B byte numbers
        self._count_sent(len(raw))

    def stop_receive_message(self) -> None:
        self._stop_dispatch()
        try:
            self._conn.close()
        except OSError:
            pass
