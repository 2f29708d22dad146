"""The transport-agnostic communication contract and the TCP socket
transport (the reference package's ``distributed/comm.py``).

``BaseCommManager`` is the 5-method contract (send_message / add_observer /
remove_observer / handle_receive_message / stop_receive_message) and
``Observer`` the receive side's. ``SocketCommManager`` is the
dependency-free TCP transport: length-prefixed frames (``message.
frame_bytes``), one listener thread per rank that survives a malformed or
aborted frame, blocking dispatch through a queue, shutdown by a sentinel.
Rank ``r`` listens on ``base_port + r`` at the host ``host_map[r]``.

Every transport counts the bytes and frames it puts on and takes off the
wire (``byte_stats``) and publishes the same numbers as the metrics
``nidt_comm_{bytes,frames}_{sent,recv}_total`` labelled by its rank.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
from abc import ABC, abstractmethod

from neuroimagedisttraining_tpu_torch.distributed.message import Message
from neuroimagedisttraining_tpu_torch.obs import names as obs_names

BASE_PORT = 50000  # rank r listens on BASE_PORT + r by default


class Observer(ABC):
    @abstractmethod
    def receive_message(self, msg_type: str, msg: Message) -> None: ...


class BaseCommManager(ABC):
    """The 5-method contract every transport keeps."""

    @abstractmethod
    def send_message(self, msg: Message) -> None: ...

    @abstractmethod
    def add_observer(self, observer: Observer) -> None: ...

    @abstractmethod
    def remove_observer(self, observer: Observer) -> None: ...

    @abstractmethod
    def handle_receive_message(self) -> None: ...

    @abstractmethod
    def stop_receive_message(self) -> None: ...


def _recv_exact(conn: socket.socket, n: int) -> bytearray | None:
    """Exactly ``n`` bytes off ``conn`` (received in place), or None at
    EOF before them."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = conn.recv_into(view[got:], n - got)
        if not k:
            return None
        got += k
    return buf


class QueueDispatchMixin:
    """The receive side every transport shares: the observer list, a
    blocking message queue and a sentinel shutdown. Subclasses feed the
    queue from their listener thread (``_enqueue``) and call
    ``_stop_dispatch`` on teardown. It also keeps the byte accounting:
    subclasses report each frame's on-the-wire size (``_count_sent`` /
    ``_count_recv``; the listener and the senders race, hence the lock)
    and ``byte_stats()`` returns the totals."""

    _STOP = object()

    def _init_dispatch(self) -> None:
        from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics

        self._observers: list[Observer] = []
        self._q: queue.Queue = queue.Queue()
        self._stats_lock = threading.Lock()
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.frames_sent = 0
        self.frames_recv = 0
        # the same sizes go to the process's metrics registry, labelled
        # by this transport's rank: one /metrics scrape carries what
        # byte_stats() reports, counted once
        rank = str(getattr(self, "rank", getattr(self, "client_id", "?")))
        lab = dict(rank=rank)
        self._obs_bytes_sent = obs_metrics.counter(
            obs_names.COMM_BYTES_SENT,
            "bytes put on the wire by this transport (frame incl. "
            "length prefix)", labelnames=("rank",)).labels(**lab)
        self._obs_bytes_recv = obs_metrics.counter(
            obs_names.COMM_BYTES_RECV,
            "bytes received off the wire by this transport",
            labelnames=("rank",)).labels(**lab)
        self._obs_frames_sent = obs_metrics.counter(
            obs_names.COMM_FRAMES_SENT, "frames sent",
            labelnames=("rank",)).labels(**lab)
        self._obs_frames_recv = obs_metrics.counter(
            obs_names.COMM_FRAMES_RECV, "frames received",
            labelnames=("rank",)).labels(**lab)

    def _count_sent(self, n: int) -> None:
        with self._stats_lock:
            self.bytes_sent += int(n)
            self.frames_sent += 1
        self._obs_bytes_sent.inc(int(n))
        self._obs_frames_sent.inc()

    def _count_recv(self, n: int) -> None:
        with self._stats_lock:
            self.bytes_recv += int(n)
            self.frames_recv += 1
        self._obs_bytes_recv.inc(int(n))
        self._obs_frames_recv.inc()

    def byte_stats(self) -> dict[str, int]:
        with self._stats_lock:
            return {"bytes_sent": self.bytes_sent,
                    "bytes_recv": self.bytes_recv,
                    "frames_sent": self.frames_sent,
                    "frames_recv": self.frames_recv}

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        self._observers.remove(observer)

    def _enqueue(self, msg: Message) -> None:
        self._q.put(msg)

    def handle_receive_message(self) -> None:
        """The blocking dispatch loop, until ``stop_receive_message``."""
        while True:
            item = self._q.get()
            if item is self._STOP:
                return
            for obs in list(self._observers):
                obs.receive_message(item.msg_type, item)

    def _stop_dispatch(self) -> None:
        self._q.put(self._STOP)


class SocketCommManager(QueueDispatchMixin, BaseCommManager):
    """Point-to-point TCP manager for one rank.

    Every rank listens on ``base_port + rank``; ``send_message`` opens a
    short-lived connection to the receiver's port and writes one
    length-prefixed frame. ``handle_receive_message`` blocks dispatching
    queued messages to observers until ``stop_receive_message``.
    """

    def __init__(self, rank: int, world_size: int,
                 host_map: dict[int, str] | None = None,
                 base_port: int = BASE_PORT):
        self.rank = rank
        self.world_size = world_size
        self.base_port = base_port
        self.host_map = host_map or {r: "127.0.0.1"
                                     for r in range(world_size)}
        self._init_dispatch()
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("0.0.0.0", base_port + rank))
        self._server.listen(world_size * 2)
        self._running = True
        self._listener = threading.Thread(target=self._listen_loop,
                                          daemon=True)
        self._listener.start()

    # ---- receive side ----

    def _listen_loop(self) -> None:
        import logging

        log = logging.getLogger("neuroimagedisttraining_tpu_torch.comm")
        while self._running:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return  # socket closed during shutdown
            # one bad peer (RST mid-frame, corrupt payload) must not kill
            # the rank's only listener thread — log and keep serving
            try:
                with conn:
                    header = _recv_exact(conn, 8)
                    if header is None:
                        continue
                    (length,) = struct.unpack("!Q", header)
                    raw = _recv_exact(conn, length)
                    if raw is None:
                        continue
                self._count_recv(length + 8)
                self._enqueue(Message.from_bytes(raw))
            except Exception as e:  # noqa: BLE001 — any bad peer data
                # (wrong schema -> TypeError/KeyError, msgpack OutOfData,
                # RST -> OSError) must not kill the only listener thread
                log.warning("rank %d: dropped malformed/aborted frame: %s",
                            self.rank, e)

    def stop_receive_message(self) -> None:
        self._running = False
        self._stop_dispatch()
        try:
            self._server.close()
        except OSError:
            pass

    # ---- send side ----

    def send_message(self, msg: Message, retries: int = 7,
                     retry_delay: float = 0.1,
                     max_delay: float = 2.0) -> None:
        """Send one frame with capped exponential backoff between
        connection attempts: attempt ``i`` sleeps
        ``min(max_delay, retry_delay * 2**i)``. A fixed interval hammers
        a restarting peer with connect storms; backoff spreads the same
        patience over far fewer attempts. The default budget
        (~5 s: 0.1+0.2+0.4+0.8+1.6+2.0) matches the historical
        50 x 0.1 s fixed-interval wait; callers wanting a longer window
        (e.g. first contact while the server jit-compiles) pass bigger
        ``retries``."""
        import time

        from neuroimagedisttraining_tpu_torch.distributed.message import (
            frame_bytes,
        )

        frame = frame_bytes(msg)
        addr = (self.host_map[msg.receiver_id],
                self.base_port + msg.receiver_id)
        last_err: Exception | None = None
        for attempt in range(retries):  # receiver may not be listening yet
            try:
                with socket.create_connection(addr, timeout=10.0) as conn:
                    conn.sendall(frame)  # nidt: allow[lock-send] -- conn is a fresh per-frame connection local to this call; no concurrent writer exists
                self._count_sent(len(frame))
                return
            except OSError as e:
                last_err = e
                if attempt + 1 < retries:
                    time.sleep(min(max_delay,
                                   retry_delay * (2.0 ** attempt)))
        raise ConnectionError(
            f"rank {self.rank} could not reach rank {msg.receiver_id} "
            f"at {addr}: {last_err}")
