"""``SelectorCommManager``: one event-loop thread, thousands of sockets (the
reference package's ``asyncfl/loop.py``).

The thread-per-connection transport (``distributed/comm.py``) spends one
OS thread a peer and one short-lived connection a frame. This manager
keeps the same ``BaseCommManager`` contract (length-prefixed ``Message``
frames, ``byte_stats()``, blocking dispatch through ``QueueDispatchMixin``)
but runs every socket through ONE ``selectors`` event loop:

- **accept**: the listener is non-blocking; an accepted connection lives
  until its peer closes it. A peer that opens a connection, writes one
  frame and closes (``SocketCommManager``) is served by the same path.
- **read**: a reassembly buffer a connection; every complete frame is
  decoded and handed to the dispatch thread. A mid-frame EOF or a
  malformed body drops that frame (logged) and never stops the loop. A
  peer whose frame carries ``ARG_CONN_PERSISTENT`` is mapped to its
  connection (the latest wins), so replies ride that socket back.
- **write / backpressure**: ``send_message`` appends whole frames to a
  BOUNDED write queue a connection and wakes the loop through a
  self-pipe; the loop flushes as the socket drains. A full queue blocks
  the sender until the reader catches up or the send timeout expires:
  bytes are never dropped and never interleaved, the loop thread being
  the only writer on a persistent socket.
- **dial-out**: a receiver with no live inbound connection is reached
  the old way (a short-lived connection to ``base_port + rank`` with
  capped exponential backoff), so this manager serves the synchronous
  protocol too.

``PersistentClientCommManager`` is the silo's side of a persistent
connection: one socket to rank 0 kept open, every frame flagged
``ARG_CONN_PERSISTENT``, replies read off the same socket. Under
``SO_REUSEPORT`` ingest workers (``asyncfl/ingest.py``) this gives a silo
one worker for the connection's lifetime.

``FaultyCommManager`` wraps either manager like any other transport.
"""

from __future__ import annotations

import logging
import selectors
import socket
import struct
import threading
import time
from collections import deque

from neuroimagedisttraining_tpu_torch.distributed.comm import (
    BASE_PORT, BaseCommManager, QueueDispatchMixin, _recv_exact,
)
from neuroimagedisttraining_tpu_torch.distributed.message import (
    ARG_CONN_PERSISTENT, MSG_TYPE_C2S_REGISTER, MSG_TYPE_S2C_FINISH, Message,
    frame_bytes,
)
from neuroimagedisttraining_tpu_torch.obs import metrics as obs_metrics
from neuroimagedisttraining_tpu_torch.obs import names as obs_names

log = logging.getLogger("neuroimagedisttraining_tpu_torch.asyncfl")

#: refuse absurd length prefixes (a peer speaking another protocol would
#: otherwise make the loop wait for bytes that never come)
_MAX_FRAME = 1 << 32


class _Conn:
    """A connection's state, owned by the loop thread; the write queue and
    the ``open`` flag are shared with senders under the manager's lock."""

    __slots__ = ("sock", "rbuf", "wq", "wq_frames", "rank", "open",
                 "want_write")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rbuf = bytearray()
        #: (memoryview, frame length); the head may be the unwritten tail
        #: of its frame, kept as a view so a partial send re-queues with
        #: no copy
        self.wq: deque[tuple[memoryview, int]] = deque()
        self.wq_frames = 0
        self.rank: int | None = None
        self.open = True
        self.want_write = False


class SelectorCommManager(QueueDispatchMixin, BaseCommManager):
    """The selector-multiplexed manager of one rank (normally the server,
    rank 0). ``send_message`` takes ``SocketCommManager``'s retry keywords,
    so every caller in ``cross_silo.py`` works unchanged.

    ``inline_dispatch`` runs the observers on the loop thread instead of
    handing each frame to the dispatch thread (two futex wakeups a round
    trip saved): for servers whose work a frame is small and bounded (the
    ingest worker's admission and fold). A server with heavy work a frame
    (the buffered server's aggregation) keeps the queue."""

    def __init__(self, rank: int, world_size: int,
                 host_map: dict[int, str] | None = None,
                 base_port: int = BASE_PORT,
                 max_pending_frames: int = 64,
                 send_timeout: float = 30.0,
                 reuse_port: bool = False,
                 inline_dispatch: bool = False):
        self.rank = rank
        self.world_size = world_size
        self.base_port = base_port
        self.host_map = host_map or {}
        self.max_pending_frames = int(max_pending_frames)
        self.send_timeout = float(send_timeout)
        self._inline = bool(inline_dispatch)
        self._init_dispatch()
        #: guards _conns, _by_rank and every write queue; the condition
        #: blocked senders wait on
        self._send_lock = threading.Condition()
        #: a self-pipe wake byte is in flight (under _send_lock): senders
        #: skip the wake syscall while one is pending
        self._wake_armed = False
        self._conns: dict[socket.socket, _Conn] = {}
        self._by_rank: dict[int, _Conn] = {}
        self.peak_connections = 0
        # the loop's health, published from the loop thread at most every
        # _OBS_TICK_S, and the senders' backpressure stalls
        lab = dict(rank=str(rank))
        self._obs_conns = obs_metrics.gauge(
            obs_names.SELECTOR_CONNECTIONS,
            "live connections registered with the selector loop",
            labelnames=("rank",)).labels(**lab)
        self._obs_wq_frames = obs_metrics.gauge(
            obs_names.SELECTOR_WRITE_QUEUE,
            "frames pending across every persistent write queue",
            labelnames=("rank",)).labels(**lab)
        self._obs_stalls = obs_metrics.counter(
            obs_names.BACKPRESSURE_STALLS,
            "sends that blocked on a full per-connection write queue",
            labelnames=("rank",)).labels(**lab)
        self._obs_last_tick = 0.0
        self._running = True
        self._sel = selectors.DefaultSelector()
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if reuse_port:
            # the sharded ingest plane: N worker processes bind one port
            # and the kernel balances connections across their listeners
            self._server.setsockopt(socket.SOL_SOCKET,
                                    socket.SO_REUSEPORT, 1)
        self._server.bind(("0.0.0.0", base_port + rank))
        self._server.listen(1024)
        self._server.setblocking(False)
        self._sel.register(self._server, selectors.EVENT_READ, "accept")
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._loop_thread = threading.Thread(target=self._loop,
                                             daemon=True)
        self._loop_thread.start()

    # ---- the event loop (the only thread that touches the selector or
    # writes a persistent socket) ----

    _OBS_TICK_S = 0.25

    def _obs_tick(self) -> None:
        now = time.monotonic()
        if now - self._obs_last_tick < self._OBS_TICK_S:
            return
        self._obs_last_tick = now
        with self._send_lock:
            n_conns = len(self._conns)
            wq = sum(c.wq_frames for c in self._conns.values())
        self._obs_conns.set(n_conns)
        self._obs_wq_frames.set(wq)

    def _loop(self) -> None:
        while self._running:
            try:
                events = self._sel.select(timeout=0.5)
            except OSError:
                return  # selector closed during shutdown
            self._obs_tick()
            for key, mask in events:
                if key.data == "accept":
                    self._accept_ready()
                elif key.data == "wake":
                    self._drain_wake()
                else:
                    conn: _Conn = key.data
                    if mask & selectors.EVENT_WRITE:
                        self._flush(conn)
                    if mask & selectors.EVENT_READ and conn.open:
                        self._read_ready(conn)

    def _accept_ready(self) -> None:
        while True:
            try:
                sock, _ = self._server.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            conn = _Conn(sock)
            with self._send_lock:
                self._conns[sock] = conn
                self.peak_connections = max(self.peak_connections,
                                            len(self._conns))
            self._sel.register(sock, selectors.EVENT_READ, conn)

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass
        # write interest for every connection with queued frames
        with self._send_lock:
            self._wake_armed = False
            pending = [c for c in self._conns.values()
                       if c.wq and not c.want_write and c.open]
            for c in pending:
                c.want_write = True
        for c in pending:
            try:
                self._sel.modify(c.sock, selectors.EVENT_READ
                                 | selectors.EVENT_WRITE, c)
            except (KeyError, ValueError, OSError):
                pass  # closed between the lock and here

    def _read_ready(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(1 << 16)
        except BlockingIOError:
            return
        except OSError as e:
            self._close(conn, f"read error: {e}")
            return
        if not data:
            why = (f"EOF mid-frame ({len(conn.rbuf)} buffered bytes "
                   "dropped)" if conn.rbuf else "peer closed")
            self._close(conn, why)
            return
        conn.rbuf += data
        while True:
            if len(conn.rbuf) < 8:
                return
            (length,) = struct.unpack("!Q", bytes(conn.rbuf[:8]))
            if length > _MAX_FRAME:
                self._close(conn, f"insane frame length {length}")
                return
            if len(conn.rbuf) < 8 + length:
                return
            raw = bytes(conn.rbuf[8:8 + length])
            del conn.rbuf[:8 + length]
            try:
                msg = Message.from_bytes(raw)
            except Exception as e:  # noqa: BLE001 — a malformed body is a
                # dropped frame, never a dead event loop
                log.warning("rank %d: dropped malformed frame: %s",
                            self.rank, e)
                continue
            self._count_recv(length + 8)
            # the upload-stage histogram's "queue" anchor: handler start
            # minus this read-completion stamp
            msg.recv_ns = time.perf_counter_ns()
            with self._send_lock:
                conn.rank = msg.sender_id
                if msg.get(ARG_CONN_PERSISTENT):
                    # replies to this rank ride this connection (the
                    # latest wins: a rejoined peer's fresh connection
                    # supersedes its old one)
                    self._by_rank[msg.sender_id] = conn
            self._deliver(msg)

    def _deliver(self, msg: Message) -> None:
        if not self._inline:
            self._enqueue(msg)
            return
        # inline: an observer failure is a dropped frame, never a dead loop
        try:
            for obs in list(self._observers):
                obs.receive_message(msg.msg_type, msg)
        except Exception:  # noqa: BLE001 — see above
            log.exception("rank %s: inline observer failed on %s",
                          self.rank, msg.msg_type)

    def _flush(self, conn: _Conn) -> None:
        while True:
            with self._send_lock:
                if not conn.wq:
                    conn.want_write = False
                    self._send_lock.notify_all()  # backpressure release
                    break
                buf, frame_len = conn.wq[0]
            # the send runs outside the lock; only this thread pops wq or
            # closes connections, so the head stays valid between holds
            try:
                n = conn.sock.send(buf)  # nidt: allow[lock-send] -- non-blocking; only the loop thread (this one) ever writes a persistent socket or pops wq, so no concurrent writer can interleave mid-frame
            except BlockingIOError:
                return
            except OSError as e:
                self._close(conn, f"write error: {e}")
                return
            with self._send_lock:
                if n < len(buf):
                    conn.wq[0] = (buf[n:], frame_len)
                    return
                conn.wq.popleft()
                conn.wq_frames -= 1
                self._count_sent(frame_len)
                self._send_lock.notify_all()  # backpressure release
        try:
            self._sel.modify(conn.sock, selectors.EVENT_READ, conn)
        except (KeyError, ValueError, OSError):
            pass

    def _close_locked(self, conn: _Conn, why: str) -> None:
        """Under ``_send_lock``: drop a connection's shared state and wake
        any sender blocked on its queue."""
        if not conn.open:
            return
        conn.open = False
        self._conns.pop(conn.sock, None)  # nidt: allow[lock-shared-map] -- every caller holds _send_lock (method contract in the docstring); the lock cannot be re-taken here without deadlocking
        if conn.rank is not None and \
                self._by_rank.get(conn.rank) is conn:
            self._by_rank.pop(conn.rank, None)
        if conn.wq_frames and self._running:
            log.warning("rank %d: closing conn to rank %s with %d "
                        "unflushed frames (%s)", self.rank, conn.rank,
                        conn.wq_frames, why)
        else:
            log.debug("rank %d: conn to rank %s closed (%s)", self.rank,
                      conn.rank, why)
        self._send_lock.notify_all()

    def _sel_unregister(self, conn: _Conn) -> None:
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    def _close(self, conn: _Conn, why: str) -> None:
        with self._send_lock:
            self._close_locked(conn, why)
        self._sel_unregister(conn)

    # ---- the send side (any thread) ----

    def _wake(self) -> None:
        """One self-pipe byte a loop wakeup: ``_drain_wake`` re-arms before
        it collects the pending writers, so a frame queued after the
        collection sends a fresh byte and no wakeup is lost."""
        with self._send_lock:
            if self._wake_armed:
                return
            self._wake_armed = True
        try:
            self._wake_w.send(b"\0")  # nidt: allow[lock-send] -- 1-byte self-pipe nudge; the pipe has exactly one writer semantic-free byte stream
        except (BlockingIOError, OSError):
            pass  # pipe full: the loop is already due to wake

    def send_message(self, msg: Message, retries: int = 7,
                     retry_delay: float = 0.1,
                     max_delay: float = 2.0) -> None:
        """Route one frame: a live inbound connection from the receiver
        carries it back (bounded queue, blocking backpressure), else the
        dial-out with ``SocketCommManager.send_message``'s retries."""
        frame = frame_bytes(msg)
        deadline = None
        with self._send_lock:
            conn = self._by_rank.get(msg.receiver_id)
            while (conn is not None and conn.open and self._running
                   and conn.wq_frames >= self.max_pending_frames):
                if threading.get_ident() == self._loop_thread.ident:
                    # an inline observer sending from the flusher thread
                    # would deadlock every socket: drop loudly instead
                    # (the peer re-syncs on its next upload)
                    raise ConnectionError(
                        f"rank {self.rank}: write queue to rank "
                        f"{msg.receiver_id} full ({conn.wq_frames} "
                        "frames) on the loop thread; dropping rather "
                        "than deadlocking the flusher")
                if deadline is None:
                    deadline = time.monotonic() + self.send_timeout
                    self._obs_stalls.inc()  # once a stalled send
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ConnectionError(
                        f"rank {self.rank}: send to rank "
                        f"{msg.receiver_id} timed out after "
                        f"{self.send_timeout}s of backpressure "
                        f"({conn.wq_frames} frames pending)")
                self._send_lock.wait(min(remaining, 0.5))
                conn = self._by_rank.get(msg.receiver_id)
            if conn is not None and conn.open and self._running:
                on_loop = (threading.get_ident()
                           == self._loop_thread.ident)
                if on_loop and not conn.wq:
                    # the loop thread with an empty queue: one direct
                    # non-blocking send, no wake pipe, no re-arm
                    try:
                        n = conn.sock.send(frame)
                    except (BlockingIOError, InterruptedError):
                        n = 0
                    except OSError as e:
                        self._close_locked(conn, f"write error: {e}")
                        self._sel_unregister(conn)
                        return
                    if n == len(frame):
                        self._count_sent(len(frame))
                        return
                    conn.wq.append((memoryview(frame)[n:], len(frame)))
                    conn.wq_frames += 1
                else:
                    conn.wq.append((memoryview(frame), len(frame)))
                    conn.wq_frames += 1
                if on_loop:
                    # the loop thread owns the selector: arm write
                    # interest directly
                    if not conn.want_write:
                        conn.want_write = True
                        try:
                            self._sel.modify(
                                conn.sock, selectors.EVENT_READ
                                | selectors.EVENT_WRITE, conn)
                        except (KeyError, ValueError, OSError):
                            pass
                else:
                    self._wake()
                return
        self._dial_out(msg, frame, retries, retry_delay, max_delay)

    def _dial_out(self, msg: Message, frame: bytes, retries: int,
                  retry_delay: float, max_delay: float) -> None:
        host = self.host_map.get(msg.receiver_id, "127.0.0.1")
        addr = (host, self.base_port + msg.receiver_id)
        last_err: Exception | None = None
        for attempt in range(retries):
            try:
                with socket.create_connection(addr, timeout=10.0) as conn:
                    conn.sendall(frame)  # nidt: allow[lock-send] -- fresh per-frame connection local to this call; no concurrent writer exists
                self._count_sent(len(frame))
                return
            except OSError as e:
                last_err = e
                if attempt + 1 < retries:
                    time.sleep(min(max_delay,
                                   retry_delay * (2.0 ** attempt)))
        raise ConnectionError(
            f"rank {self.rank} could not reach rank {msg.receiver_id} "
            f"at {addr} (no live inbound connection either): {last_err}")

    # ---- lifecycle ----

    def connection_count(self) -> int:
        with self._send_lock:
            return len(self._conns)

    def drain_sends(self, timeout: float = 5.0) -> bool:
        """Block until every persistent write queue has flushed (or
        ``timeout``): a caller about to stop the manager keeps a frame it
        just queued (FINISH to every silo)."""
        deadline = time.monotonic() + timeout
        with self._send_lock:
            while any(c.wq for c in self._conns.values()):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._send_lock.wait(min(remaining, 0.2))
        return True

    def stop_receive_message(self) -> None:
        self._running = False
        self._wake()
        self._loop_thread.join(timeout=5.0)
        with self._send_lock:
            conns = list(self._conns.values())
            for c in conns:
                self._close_locked(c, "manager stopped")
        for c in conns:
            self._sel_unregister(c)
        for s in (self._server, self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        try:
            self._sel.close()
        except OSError:
            pass
        self._stop_dispatch()


class PersistentClientCommManager(QueueDispatchMixin, BaseCommManager):
    """A silo's transport to the asynchronous plane's server (rank 0): one
    connection kept open, every frame flagged ``ARG_CONN_PERSISTENT`` so
    the server replies on it, and a reader thread that hands each reply to
    the dispatch queue. A dropped connection is opened again at the next
    send; where it drops with no FINISH read, the silo's register frame is
    sent again on a new one (a reconnect re-registers, the reference's
    migration path), so a silo waiting for its reply is not stranded; where
    no server answers, the silo's run ends. Once a FINISH has been read,
    sends are dropped: the silo's last upload, trained while the federation
    ended, has no receiver."""

    #: connection attempts of a re-register after a dropped connection
    _REREGISTER_TRIES = 5
    #: the wait between a register's connection attempts once it reaches
    #: its cap: silos waiting for a server that is starting join it within
    #: this much of each other (a tiny federation with no registration
    #: barrier can finish within half a second of its first silo)
    _JOIN_CADENCE = 0.05

    def __init__(self, rank: int, world_size: int,
                 host_map: dict[int, str] | None = None,
                 base_port: int = BASE_PORT):
        self.rank = rank
        self.world_size = world_size
        self.base_port = base_port
        self.host_map = host_map or {}
        self._init_dispatch()
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._register: Message | None = None
        self._finished = False
        self._running = True

    def _open(self) -> socket.socket:
        """Under ``_lock``: connect to rank 0 and start the socket's
        reader."""
        addr = (self.host_map.get(0, "127.0.0.1"), self.base_port)
        sock = socket.create_connection(addr, timeout=10.0)
        sock.settimeout(None)
        self._sock = sock
        threading.Thread(target=self._read_loop, args=(sock,),
                         daemon=True).start()
        return sock

    def _read_loop(self, sock: socket.socket) -> None:
        while self._running:
            try:
                header = _recv_exact(sock, 8)
                if header is None:
                    break
                (length,) = struct.unpack("!Q", header)
                raw = _recv_exact(sock, length)
                if raw is None:
                    break
                msg = Message.from_bytes(bytes(raw))
            except (OSError, ValueError) as e:
                log.debug("silo %d: connection read failed: %s", self.rank,
                          e)
                break
            self._count_recv(length + 8)
            if msg.msg_type == MSG_TYPE_S2C_FINISH:
                self._finished = True
            self._enqueue(msg)
        with self._lock:
            if self._sock is sock:
                self._sock = None
        try:
            sock.close()
        except OSError:
            pass
        if self._running and not self._finished \
                and self._register is not None:
            threading.Thread(target=self._reregister, daemon=True).start()

    def _reregister(self) -> None:
        try:
            self.send_message(self._register,
                              retries=self._REREGISTER_TRIES,
                              retry_delay=0.25)
            log.info("silo %d: connection lost; re-registered on a new "
                     "one", self.rank)
        except ConnectionError as e:
            # no server to come back to: the federation ended (its FINISH
            # may be lost with the connection, a close with unread bytes
            # resets it) or the server died; either way the silo's run is
            # over, and its receive loop ends instead of waiting forever
            log.warning("silo %d: connection lost and not re-opened (%s); "
                        "ending the run", self.rank, e)
            self._finished = True
            self._stop_dispatch()

    def send_message(self, msg: Message, retries: int = 7,
                     retry_delay: float = 0.1,
                     max_delay: float = 0.5) -> None:
        """Send on the kept connection, opening it first where there is
        none: attempt ``i`` waits ``min(max_delay, retry_delay * 2**i)``
        before the next. A register keeps the same patience (``retries x
        max_delay``) at a cap of ``_JOIN_CADENCE``, so silos waiting for a
        server that is starting join it within that much of each other (a
        federation with no registration barrier starts at the first); a
        silo's register (150 attempts at the 0.5 s cap) waits about
        75 s."""
        if msg.receiver_id != 0:
            raise ValueError(
                f"rank {self.rank}: a persistent client connection reaches "
                f"rank 0 only, not rank {msg.receiver_id}")
        msg.add(ARG_CONN_PERSISTENT, True)
        if msg.msg_type == MSG_TYPE_C2S_REGISTER:
            self._register = msg
            if max_delay > self._JOIN_CADENCE:
                retries = int(retries * max_delay / self._JOIN_CADENCE)
                max_delay = self._JOIN_CADENCE
        frame = frame_bytes(msg)
        last_err: Exception | None = None
        for attempt in range(retries):
            if self._finished:
                # the federation is over (a FINISH was read, its dispatch
                # pending): an upload trained meanwhile has no receiver
                log.debug("silo %d: %s after FINISH not sent", self.rank,
                          msg.msg_type)
                return
            if not self._running:
                break
            with self._lock:
                try:
                    sock = self._sock or self._open()
                    sock.sendall(frame)  # one writer: under _lock
                    self._count_sent(len(frame))
                    return
                except OSError as e:
                    last_err = e
                    if self._sock is not None:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                    self._sock = None
            if attempt + 1 < retries:
                time.sleep(min(max_delay, retry_delay * (2.0 ** attempt)))
        raise ConnectionError(
            f"rank {self.rank} could not reach rank 0 at port "
            f"{self.base_port}: {last_err}")

    def stop_receive_message(self) -> None:
        self._running = False
        with self._lock:
            sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._stop_dispatch()
