"""The port's asynchronous buffered plane (``neuroimagedisttraining_tpu_torch/
asyncfl/{loop,server}.py``, the codec's sync-delta frames, the silos'
``sync_delta`` and one-phase secure frames) against the reference
package's, on the same numpy inputs.

- Sync-delta frames byte-equal to the reference's, their decode bit for bit
  (NaN and Inf leaves included).
- ``staleness_weight`` equal; the equivalence pin (all-current uploads
  filling a cohort-sized buffer are ``survivor_weighted_mean`` of them, bit
  for bit) in the port.
- One message sequence (staleness 0-3, a future tag, a re-delivered seq, a
  non-finite upload, a lapping silo, a stale codec delta) through both
  servers: equal verdicts, history weights and taus, ``upload_audit``
  dicts, and the models at the tolerance ``tests/test_torch_distributed.py``
  holds ``survivor_weighted_mean`` to (rtol 1e-6, atol 1e-6).
- The selector survives a mid-frame disconnect and a malformed frame; a
  slow reader under backpressure loses nothing; a silo whose kept
  connection closes with no server left ends its run.
- A port server with reference silos and a reference server with port
  silos each finish a federation with a green audit.
- The silos' frames (a delta sync's upload, a one-phase secure upload)
  byte-equal to the reference's for the same update.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest

from neuroimagedisttraining_tpu.codec import wire as rwire
from neuroimagedisttraining_tpu.distributed import message as RM
from neuroimagedisttraining_tpu_torch.asyncfl.loop import (
    PersistentClientCommManager, SelectorCommManager,
)
from neuroimagedisttraining_tpu_torch.asyncfl.server import (
    BufferedFedAvgServer, staleness_weight,
)
from neuroimagedisttraining_tpu_torch.codec import wire
from neuroimagedisttraining_tpu_torch.distributed import message as M
from neuroimagedisttraining_tpu_torch.distributed.comm import Observer
from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (
    named_leaves, survivor_weighted_mean,
)
from neuroimagedisttraining_tpu_torch.distributed.ports import (
    free_port_block,
)


class _CaptureComm:
    """A transport that records what it is given (handler-level tests)."""

    def __init__(self):
        self.sent = []

    def send_message(self, msg, **kw):
        self.sent.append(msg)

    def add_observer(self, obs):
        pass

    def remove_observer(self, obs):
        pass

    def handle_receive_message(self):
        pass

    def stop_receive_message(self):
        pass

    def byte_stats(self):
        return {}


def _tree(seed, scale=1.0, n=12):
    rng = np.random.default_rng(seed)
    return {"params": {"w": (scale * rng.standard_normal(n)
                             ).astype(np.float32),
                       "b": (scale * rng.standard_normal(3)
                             ).astype(np.float32)},
            "batch_stats": {"bn": {"mean": rng.standard_normal(
                4).astype(np.float32)}}}


def _upload(mod, sender, tree, n, version, seq=None):
    msg = mod.Message(mod.MSG_TYPE_C2S_SEND_MODEL, sender, 0)
    msg.add(mod.ARG_MODEL_PARAMS, tree)
    msg.add(mod.ARG_NUM_SAMPLES, float(n))
    msg.add(mod.ARG_ROUND_IDX, version)
    if seq is not None:
        msg.add(mod.ARG_UPLOAD_SEQ, int(seq))
    return msg


def _bits_equal(a, b) -> bool:
    la, lb = named_leaves(a), named_leaves(b)
    return la.keys() == lb.keys() and all(
        np.asarray(la[k]).dtype == np.asarray(lb[k]).dtype
        and np.asarray(la[k]).tobytes() == np.asarray(lb[k]).tobytes()
        for k in la)


# ------------------------------------------------------ sync-delta frames

def _frame_pair():
    a = _tree(3, n=65)  # an odd leaf size: the shuffle's tail
    b = _tree(4, n=65)
    a["params"]["w"][:3] = [np.nan, np.inf, -np.inf]
    return a, b


@pytest.mark.parametrize("nonfinite", [False, True])
def test_sync_delta_frame_byte_equal_and_bitwise(nonfinite):
    a, b = _frame_pair()
    if not nonfinite:
        a = _tree(3, n=65)
    ours = wire.encode_sync_delta(a, b, base_version=5)
    theirs = rwire.encode_sync_delta(a, b, base_version=5)
    assert wire.msgpack_dumps(ours) == wire.msgpack_dumps(theirs)
    assert wire.frame_nbytes(ours) == rwire.frame_nbytes(theirs)
    assert wire.is_sync_delta_frame(ours) and not \
        wire.is_sync_delta_frame(a)
    out = wire.decode_sync_delta(ours, b)
    for k, x in named_leaves(a).items():
        assert np.asarray(x).view(np.uint8).tobytes() == \
            np.asarray(named_leaves(out)[k]).view(np.uint8).tobytes()
    # the reference's frame decodes to the same bytes in the port
    assert _bits_equal(wire.decode_sync_delta(theirs, b), out)


def test_byte_shuffle_matches_reference():
    rng = np.random.default_rng(7)
    for n in (0, 1, 3, 4, 5, 257, 4097):
        x = rng.integers(0, 256, n, dtype=np.uint8)
        s = wire._byte_shuffle(x)
        assert s.tobytes() == rwire._byte_shuffle(x).tobytes()
        assert wire._byte_unshuffle(s).tobytes() == x.tobytes()


# ------------------------------------------------------ the server's math

def test_staleness_weight_equals_reference():
    from neuroimagedisttraining_tpu.asyncfl.server import (
        staleness_weight as rsw,
    )

    for n in (0.0, 1.0, 7.0, 123.5):
        for tau in range(6):
            for alpha in (0.0, 0.5, 0.7, 2.0):
                assert staleness_weight(n, tau, alpha) == rsw(n, tau, alpha)
    assert staleness_weight(7.0, 0, 0.5) == 7.0


def _port_server(num_clients=3, comm_round=10, **kw):
    kw.setdefault("buffer_k", num_clients)
    return BufferedFedAvgServer(_tree(0), comm_round, num_clients,
                                comm=_CaptureComm(), device="cpu", **kw)


def _ref_server(num_clients=3, comm_round=10, **kw):
    from neuroimagedisttraining_tpu.asyncfl.server import (
        BufferedFedAvgServer as RServer,
    )

    kw.setdefault("buffer_k", num_clients)
    return RServer(_tree(0), comm_round, num_clients, comm=_CaptureComm(),
                   **kw)


def test_buffer_k_cohort_zero_staleness_is_the_weighted_mean_bitwise():
    srv = _port_server(buffer_k=3, staleness_alpha=0.7)
    trees = [_tree(s + 1) for s in range(3)]
    ns = [5.0, 9.0, 2.0]
    for s, (t, n) in enumerate(zip(trees, ns), start=1):
        srv._on_model(_upload(M, s, t, n, version=0, seq=0))
    assert srv.round_idx == 1
    assert _bits_equal(srv.params, survivor_weighted_mean(trees, ns, "cpu"))
    assert srv.history[0]["weights"] == ns
    assert srv.history[0]["taus"] == [0, 0, 0]
    # a stale upload is carried to the current base in float32
    base = srv._ring[0]
    srv._on_model(_upload(M, 1, _tree(9), 4.0, version=0, seq=1))
    got = named_leaves(srv._buffer[-1]["tree"])
    for k, u in named_leaves(_tree(9)).items():
        want = u + (named_leaves(srv.params)[k] - named_leaves(base)[k])
        assert got[k].tobytes() == want.tobytes()


def _sequence():
    """``(sender, tree or None for a codec frame, n, version, seq)`` in
    arrival order; the servers run buffer_k 2 over 3 silos, max_staleness
    2."""
    bad = _tree(40)
    bad["params"]["w"][2] = np.nan
    return [
        (1, _tree(11), 6.0, 0, 0),
        (1, _tree(12), 6.0, 0, 1),     # laps its own buffered entry
        (2, _tree(13), 9.0, 0, 0),     # -> version 1
        (3, _tree(14), 4.0, 5, 0),     # future tag
        (3, _tree(15), 4.0, 0, 1),     # tau 1
        (2, _tree(16), 9.0, 0, 0),     # re-delivered seq
        (2, bad, 9.0, 1, 1),           # non-finite
        (1, _tree(17), 6.0, 1, 2),     # -> version 2
        (2, _tree(18), 9.0, 2, 2),
        (3, None, 4.0, 0, 2),          # a codec delta, tau 2 -> version 3
        (1, _tree(19), 6.0, 0, 3),     # tau 3 > max_staleness
        (1, _tree(20), 6.0, 3, 4),
        (2, _tree(21), 9.0, 1, 3),     # tau 2 -> version 4
    ]


def test_message_sequence_matches_reference_server():
    ours = _port_server(buffer_k=2, max_staleness=2, staleness_alpha=0.5)
    theirs = _ref_server(buffer_k=2, max_staleness=2, staleness_alpha=0.5)
    spec = rwire.parse_wire_spec("delta")
    verdicts = []
    for sender, tree, n, version, seq in _sequence():
        if tree is None:
            # the codec frame of an update trained from the version it
            # names, encoded against that version's broadcast
            ref = theirs._ring[version]
            tree, _ = rwire.encode_update(spec, _tree(30), reference=ref)
            assert _bits_equal(ours._ring[version], ref)
        before = dict(ours.upload_stats), dict(theirs.upload_stats)
        ours._on_model(_upload(M, sender, tree, n, version, seq))
        theirs._on_model(_upload(RM, sender, tree, n, version, seq))
        step = [{k: s[k] - b[k] for k in s if s[k] != b[k]}
                for s, b in zip((ours.upload_stats, theirs.upload_stats),
                                before)]
        assert step[0] == step[1], (sender, version, seq)
        verdicts.append(step[0])
        assert ours.round_idx == theirs.round_idx
    assert ours.round_idx == 4
    assert any("dropped_future" in v for v in verdicts)
    assert any("dropped_duplicate" in v for v in verdicts)
    assert any("dropped_nonfinite" in v for v in verdicts)
    assert any("dropped_stale" in v for v in verdicts)
    assert any("superseded_in_buffer" in v for v in verdicts)
    keys = ("version", "clients", "contributors", "taus", "weights")
    assert [{k: h[k] for k in keys} for h in ours.history] == \
        [{k: h[k] for k in keys} for h in theirs.history]
    assert {t for h in ours.history for t in h["taus"]} == {0, 1, 2}
    assert ours.upload_audit() == theirs.upload_audit()
    got, want = named_leaves(ours.params), named_leaves(theirs.params)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_startup_refusals_match_reference():
    for kw, match in (({"round_deadline": 5.0}, "no round barrier"),
                      ({"staleness_alpha": -1.0}, "staleness_alpha"),
                      ({"max_staleness": -1}, "max_staleness"),
                      ({"num_clients": 8, "buffer_k": 2,
                        "defense": "trimmed_mean", "byz_f": 1},
                       "trimmed_mean"),
                      ({"num_clients": 3, "buffer_k": 8, "defense": "krum",
                        "byz_f": 1}, "krum")):
        with pytest.raises(ValueError, match=match) as ours:
            _port_server(**kw)
        with pytest.raises(ValueError, match=match) as theirs:
            _ref_server(**kw)
        assert str(ours.value) == str(theirs.value)


# ------------------------------------------------------ the selector core

class _Collector(Observer):
    def __init__(self):
        self.msgs = []
        self.evt = threading.Event()

    def receive_message(self, msg_type, msg):
        self.msgs.append(msg)
        self.evt.set()


def _mk_selector(n=4):
    port = free_port_block(2)
    mgr = SelectorCommManager(0, n, base_port=port, max_pending_frames=4,
                              send_timeout=5.0)
    col = _Collector()
    mgr.add_observer(col)
    t = threading.Thread(target=mgr.handle_receive_message, daemon=True)
    t.start()
    return mgr, col, port, t


def test_selector_survives_midframe_disconnect_and_malformed():
    mgr, col, port, t = _mk_selector()
    try:
        with socket.create_connection(("127.0.0.1", port)) as s:
            s.sendall(struct.pack("!Q", 100) + b"x" * 10)
        with socket.create_connection(("127.0.0.1", port)) as s:
            s.sendall(struct.pack("!Q", 5) + b"junk!")
        with socket.create_connection(("127.0.0.1", port)) as s:
            s.sendall(M.frame_bytes(M.Message("hello", 3, 0)))
        assert col.evt.wait(5.0)
        assert [m.msg_type for m in col.msgs] == ["hello"]
        assert mgr.byte_stats()["frames_recv"] == 1
    finally:
        mgr.stop_receive_message()
        t.join(5.0)


def test_selector_slow_reader_backpressure_loses_nothing():
    """A reader that stops draining stalls the sender on the bounded write
    queue; once it reads, every frame arrives whole and in order."""
    mgr, col, port, t = _mk_selector()
    n_frames, payload = 12, np.zeros(1_000_000, np.uint8)
    sent_done = threading.Event()
    try:
        cli = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        cli.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 32768)
        cli.connect(("127.0.0.1", port))
        reg = M.Message(M.MSG_TYPE_C2S_REGISTER, 2, 0)
        reg.add(M.ARG_CONN_PERSISTENT, True)
        cli.sendall(M.frame_bytes(reg))
        assert col.evt.wait(5.0)

        def _send_all():
            for i in range(n_frames):
                msg = M.Message("bulk", 0, 2)
                msg.add("i", i)
                msg.add("blob", payload)
                mgr.send_message(msg)
            sent_done.set()

        threading.Thread(target=_send_all, daemon=True).start()
        time.sleep(0.5)
        assert not sent_done.is_set(), \
            "the sender ran ahead of the bounded write queue"
        got, buf = [], b""
        cli.settimeout(10.0)
        while len(got) < n_frames:
            while len(buf) < 8:
                buf += cli.recv(65536)
            (length,) = struct.unpack("!Q", buf[:8])
            while len(buf) < 8 + length:
                buf += cli.recv(65536)
            got.append(M.Message.from_bytes(buf[8:8 + length]))
            buf = buf[8 + length:]
        assert sent_done.wait(10.0)
        assert [int(m.get("i")) for m in got] == list(range(n_frames))
        assert all(np.asarray(m.get("blob")).nbytes == payload.nbytes
                   for m in got)
        assert mgr.byte_stats()["frames_sent"] == n_frames
        cli.close()
    finally:
        mgr.stop_receive_message()
        t.join(5.0)


def test_persistent_silo_ends_its_run_when_the_server_is_gone():
    """A silo's kept connection closed with no FINISH (a server that shut
    down or died): the silo re-registers once, finds no server and its
    receive loop ends instead of waiting forever."""
    mgr, col, port, t = _mk_selector()
    cli = PersistentClientCommManager(1, 2, base_port=port)
    loop = threading.Thread(target=cli.handle_receive_message, daemon=True)
    loop.start()
    try:
        cli.send_message(M.Message(M.MSG_TYPE_C2S_REGISTER, 1, 0))
        assert col.evt.wait(5.0)
        assert col.msgs[0].get(M.ARG_CONN_PERSISTENT)
    finally:
        mgr.stop_receive_message()
        t.join(5.0)
    loop.join(20.0)
    assert not loop.is_alive()
    cli.send_message(M.Message(M.MSG_TYPE_C2S_SEND_MODEL, 1, 0))  # dropped


# ------------------------------------------------------ interoperation

def _train_fn(delta):
    def train_fn(params, round_idx):
        w = np.asarray(params["params"]["w"]) + np.float32(delta)
        return {"params": {"w": w}}, 5.0
    return train_fn


def _federate(server, clients, timeout=30.0):
    st = threading.Thread(target=server.run, daemon=True)
    st.start()
    for c in clients:
        threading.Thread(target=c.run, daemon=True).start()
    st.join(timeout)
    assert server._done.is_set(), server.history
    audit = server.upload_audit()
    assert audit["received_accounted"] and audit["accepted_accounted"]
    return audit


def test_port_server_with_reference_silos():
    """The reference's threaded silos (one frame a connection, the delta
    codec) against the port's selector server."""
    from neuroimagedisttraining_tpu.distributed.cross_silo import (
        FedAvgClientProc as RClient,
    )

    port = free_port_block(8)
    srv = BufferedFedAvgServer({"params": {"w": np.zeros(16, np.float32)}},
                               4, 2, buffer_k=1, max_staleness=10,
                               base_port=port, device="cpu")
    clients = [RClient(r, 2, _train_fn(0.1 * r), base_port=port,
                       wire_codec="delta") for r in (1, 2)]
    audit = _federate(srv, clients)
    assert srv.round_idx == 4 and audit["accepted"] == 4
    assert np.all(np.isfinite(srv.params["params"]["w"]))


def test_reference_server_with_port_silos():
    """The port's silos (a kept connection, the delta codec) against the
    reference's selector server."""
    from neuroimagedisttraining_tpu.asyncfl.server import (
        BufferedFedAvgServer as RServer,
    )
    from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (
        FedAvgClientProc,
    )

    port = free_port_block(8)
    srv = RServer({"params": {"w": np.zeros(16, np.float32)}}, 4, 2,
                  buffer_k=1, max_staleness=10, base_port=port)
    clients = [FedAvgClientProc(
        r, 2, _train_fn(0.1 * r), wire_codec="delta", device="cpu",
        comm=PersistentClientCommManager(r, 3, base_port=port))
        for r in (1, 2)]
    audit = _federate(srv, clients)
    assert srv.round_idx == 4 and audit["accepted"] == 4
    assert srv.com_manager.peak_connections >= 2  # kept connections


# ------------------------------------------------------ the silos' frames

def _sync(mod, params, version):
    msg = mod.Message(mod.MSG_TYPE_S2C_SYNC_MODEL, 0, 1)
    if params is not None:
        msg.add(mod.ARG_MODEL_PARAMS, params)
    msg.add(mod.ARG_ROUND_IDX, version)
    return msg


def _train_add(params, round_idx):
    step = np.float32(0.25 * (round_idx + 1))
    return wire.nest({k: np.asarray(v) + step
                      for k, v in named_leaves(params).items()}), 6.0


def test_delta_sync_silo_uploads_byte_equal_to_reference():
    """A dense sync, a body-less one and a delta sync into both packages'
    silos: equal upload frames, the delta decoded bit for bit; a delta
    naming another base is dropped."""
    from neuroimagedisttraining_tpu.distributed.cross_silo import (
        FedAvgClientProc as RClient,
    )
    from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (
        FedAvgClientProc,
    )

    ours_comm, theirs_comm = _CaptureComm(), _CaptureComm()
    ours = FedAvgClientProc(1, 2, _train_add, sync_delta=True,
                            comm=ours_comm, device="cpu")
    theirs = RClient(1, 2, _train_add, sync_delta=True, comm=theirs_comm)
    v0, v1 = _tree(50), _tree(51)
    v1["params"]["w"][0] = np.inf
    frame = rwire.encode_sync_delta(v1, v0, base_version=0)
    stray = rwire.encode_sync_delta(v1, v0, base_version=7)
    for params, version in ((v0, 0), (None, 0), (frame, 1), (stray, 2)):
        ours._on_sync(_sync(M, params, version))
        theirs._on_sync(_sync(RM, params, version))
    assert len(ours_comm.sent) == len(theirs_comm.sent) == 3
    for a, b in zip(ours_comm.sent, theirs_comm.sent):
        assert M.frame_bytes(a) == RM.frame_bytes(b)
    assert _bits_equal(ours._last_sync_params, v1)
    assert ours._last_sync_version == 1


def test_one_phase_secure_upload_byte_equal_to_reference():
    from neuroimagedisttraining_tpu.distributed.cross_silo import (
        SecureFedAvgClientProc as RSecure,
    )
    from neuroimagedisttraining_tpu.privacy import QuantSpec as RQuant
    from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (
        SecureFedAvgClientProc,
    )
    from neuroimagedisttraining_tpu_torch.privacy import QuantSpec

    ours_comm, theirs_comm = _CaptureComm(), _CaptureComm()
    ours = SecureFedAvgClientProc(
        2, 3, _train_add, quant_spec=QuantSpec.from_bits(32, 10, 3),
        one_phase=True, mpc_seed=5, comm=ours_comm, device="cpu")
    theirs = RSecure(2, 3, _train_add,
                     quant_spec=RQuant.from_bits(32, 10, 3),
                     one_phase=True, mpc_seed=5, comm=theirs_comm)
    for version in (0, 1):
        ours._on_sync(_sync(M, _tree(60 + version), version))
        theirs._on_sync(_sync(RM, _tree(60 + version), version))
    assert [m.msg_type for m in ours_comm.sent] == \
        [M.MSG_TYPE_C2S_SEND_MODEL] * 2
    for a, b in zip(ours_comm.sent, theirs_comm.sent):
        assert M.frame_bytes(a) == RM.frame_bytes(b)
    with pytest.raises(ValueError, match="requires a quant_spec"):
        SecureFedAvgClientProc(2, 3, _train_add, one_phase=True,
                               comm=_CaptureComm(), device="cpu")
