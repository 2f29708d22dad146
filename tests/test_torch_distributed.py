"""The port's cross-silo control plane (``neuroimagedisttraining_tpu_torch/
distributed/``) against the reference package's (``distributed/``).

- ``Message`` frames byte for byte the reference's, for a dense tree, a
  codec frame, a secure share tree, a secure-quant frame and scalar-only
  control messages; the port decodes the reference's frames.
- The socket transport point to point, a listener that survives a
  malformed frame, the broker (publish / subscribe, retained frames for a
  late subscriber, the newest retained, a retained frame never overtaking a
  live one), each as the reference's tests hold the reference.
- The closed-form 3-silo, 2-round protocol at rtol 1e-6; the secure
  protocol against the plain one; grouped secure aggregation with its
  privacy check (no aggregator and not the server receives a plaintext
  update).
- Two port silos training ``3dcnn_tiny`` over sockets (threads, one round):
  the server's aggregate against the reference's federation from the same
  weights, epoch permutations and dropout keep-masks at ``TRAJECTORY``,
  and bit for bit the port's in-process weighted mean of the same two
  ``train_fn`` outputs.
- The codec frame with the device select's threshold route (its plain
  version here) byte for byte the ``np.partition`` encode's.
- The defended aggregation against the reference's on the same uploads.
- One CLI run of 3 OS processes (server + 2 silos, ``--device cpu``, 2
  rounds): its JSON line has the reference's key set.
"""

import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_support import (
    TRAJECTORY, assert_state_close, fixed_dropout, model_dropout_masks,
    torch_threads,
)

from neuroimagedisttraining_tpu.distributed import message as RM
from neuroimagedisttraining_tpu_torch.distributed import message as M
from neuroimagedisttraining_tpu_torch.distributed.comm import (
    SocketCommManager,
)
from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (
    FedAvgClientProc, FedAvgServer, named_leaves, survivor_weighted_mean,
)
from neuroimagedisttraining_tpu_torch.distributed.ports import (
    free_port_block,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = (10, 12, 10)


def _base_port() -> int:
    return free_port_block(8)


def _toy_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"conv": {"kernel": rng.standard_normal(
        (3, 3, 3, 1, 4)).astype(np.float32),
        "bias": rng.standard_normal(4).astype(np.float32)}},
        "batch_stats": {"bn": {"mean": np.zeros(4, np.float32),
                               "var": np.ones(4, np.float32)}}}


def _payloads():
    """name -> (payload key/values) of each message kind on the wire."""
    from neuroimagedisttraining_tpu.codec import wire as rcodec
    from neuroimagedisttraining_tpu.ops import mpc

    tree = _toy_tree()
    upd = _toy_tree(1)
    frame, _ = rcodec.encode_update(
        rcodec.parse_wire_spec("delta+sparse+quant", 0.25), upd,
        reference=tree)
    shares = {"w": mpc.additive_shares(mpc.quantize(
        np.linspace(-1, 1, 6)), 3, rng=np.random.default_rng(0))}
    from neuroimagedisttraining_tpu.privacy import (
        QuantSpec, encode_secure_quant,
    )
    sq = encode_secure_quant(upd, 0.5, QuantSpec.from_bits(16, 10, 3),
                             np.random.default_rng(2))
    return {
        "dense_sync": (M.MSG_TYPE_S2C_SYNC_MODEL, 0, 2,
                       {M.ARG_MODEL_PARAMS: tree, M.ARG_ROUND_IDX: 3,
                        M.ARG_CLIENT_INDEX: 1, M.ARG_EF_RESET: True}),
        "codec_upload": (M.MSG_TYPE_C2S_SEND_MODEL, 2, 0,
                         {M.ARG_MODEL_PARAMS: frame, M.ARG_NUM_SAMPLES: 12.0,
                          M.ARG_ROUND_IDX: 3, M.ARG_UPLOAD_SEQ: 7,
                          M.ARG_TRACE_CTX: {"trace_id": (2 << 24) | 7,
                                            "span_id": 2}}),
        "secure_slot": (M.MSG_TYPE_C2A_SEND_SLOT, 1, 4,
                        {M.ARG_MODEL_PARAMS: {"w": shares["w"][1]},
                         M.ARG_SLOT_INDEX: 1, M.ARG_ROUND_IDX: 0}),
        "secure_shares": (M.MSG_TYPE_C2S_SEND_MODEL, 1, 0,
                          {M.ARG_MODEL_PARAMS: shares, M.ARG_ROUND_IDX: 0}),
        "secure_quant": (M.MSG_TYPE_C2S_SEND_MODEL, 3, 0,
                         {M.ARG_MODEL_PARAMS: sq, M.ARG_ROUND_IDX: 1,
                          M.ARG_UPLOAD_SEQ: 0}),
        "register": (M.MSG_TYPE_C2S_REGISTER, 2, 0,
                     {M.ARG_CLIENT_INCARNATION: 4242}),
        "weights": (M.MSG_TYPE_S2C_AGG_WEIGHTS, 0, 1,
                    {M.ARG_AGG_WEIGHT: 0.25, M.ARG_ROUND_IDX: 2,
                     "x": np.int64(41), "b": np.float32(1.5)}),
    }


@pytest.mark.parametrize("kind", sorted(_payloads()))
def test_message_frames_byte_equal_to_reference(kind):
    """The same message through both packages: equal bytes with the
    length prefix (``frame_bytes``), and each side decodes the other's."""
    t, s, r, params = _payloads()[kind]
    ours, theirs = M.Message(t, s, r), RM.Message(t, s, r)
    for k, v in params.items():
        ours.add(k, v)
        theirs.add(k, v)
    assert M.frame_bytes(ours) == RM.frame_bytes(theirs)
    back = M.Message.from_bytes(theirs.to_bytes())
    assert (back.msg_type, back.sender_id, back.receiver_id) == (t, s, r)
    assert M.Message.from_bytes(ours.to_bytes()).to_bytes() \
        == ours.to_bytes()
    again = RM.Message.from_bytes(back.to_bytes())
    assert again.to_bytes() == theirs.to_bytes()


def test_message_tensor_payload_equals_its_numpy():
    """A tensor in the payload goes on the wire as its numpy values."""
    a = M.Message(M.MSG_TYPE_C2S_SEND_MODEL, 1, 0)
    a.add(M.ARG_MODEL_PARAMS, {"w": torch.arange(6.0).reshape(2, 3)})
    b = RM.Message(M.MSG_TYPE_C2S_SEND_MODEL, 1, 0)
    b.add(M.ARG_MODEL_PARAMS, {"w": np.arange(6.0, dtype=np.float32)
                               .reshape(2, 3)})
    assert a.to_bytes() == b.to_bytes()
    with pytest.raises(ValueError, match="magic"):
        M.Message.from_bytes(b"NOPE" + a.to_bytes())


# ---------------------------------------------------------------- transports

def test_socket_transport_point_to_point():
    bp = _base_port()
    a = SocketCommManager(0, 2, base_port=bp)
    b = SocketCommManager(1, 2, base_port=bp)
    got = []

    class Obs:
        def receive_message(self, t, m):
            got.append((t, int(np.asarray(m.get("x")))))
            b.stop_receive_message()

    b.add_observer(Obs())
    runner = threading.Thread(target=b.handle_receive_message)
    runner.start()
    msg = M.Message("ping", 0, 1)
    msg.add("x", np.int64(41))
    a.send_message(msg)
    runner.join(timeout=10)
    a.stop_receive_message()
    assert got == [("ping", 41)]
    assert a.byte_stats()["frames_sent"] == 1
    assert b.byte_stats()["bytes_recv"] == a.byte_stats()["bytes_sent"] \
        == len(M.frame_bytes(msg))


def test_listener_survives_malformed_frame():
    """A corrupt frame or an aborted connection does not kill the rank's
    listener: a later well-formed message still arrives."""
    import socket
    import struct

    bp = _base_port()
    b = SocketCommManager(1, 2, base_port=bp)
    got = []

    class Obs:
        def receive_message(self, t, m):
            got.append(t)
            b.stop_receive_message()

    b.add_observer(Obs())
    runner = threading.Thread(target=b.handle_receive_message)
    runner.start()
    with socket.create_connection(("127.0.0.1", bp + 1), timeout=5) as c:
        c.sendall(struct.pack("!Q", 4) + b"junk")
    with socket.create_connection(("127.0.0.1", bp + 1), timeout=5) as c:
        c.sendall(struct.pack("!Q", 1 << 20) + b"partial")
    a = SocketCommManager(0, 2, base_port=bp)
    a.send_message(M.Message("after-junk", 0, 1))
    runner.join(timeout=15)
    a.stop_receive_message()
    assert got == ["after-junk"]


def test_port_and_reference_transports_interoperate():
    """A reference rank and a port rank on one socket plane: each
    receives the other's frame."""
    from neuroimagedisttraining_tpu.distributed.comm import (
        SocketCommManager as RSocket,
    )

    bp = _base_port()
    ref = RSocket(0, 2, base_port=bp)
    ours = SocketCommManager(1, 2, base_port=bp)
    got = {}

    class Obs:
        def __init__(self, who, mgr):
            self.who, self.mgr = who, mgr

        def receive_message(self, t, m):
            got[self.who] = (t, m.get("v"))
            self.mgr.stop_receive_message()

    ref.add_observer(Obs("ref", ref))
    ours.add_observer(Obs("port", ours))
    ts = [threading.Thread(target=m.handle_receive_message)
          for m in (ref, ours)]
    for t in ts:
        t.start()
    m1 = RM.Message("to-port", 0, 1)
    m1.add("v", np.arange(3, dtype=np.float32))
    ref.send_message(m1)
    m2 = M.Message("to-ref", 1, 0)
    m2.add("v", np.arange(3, dtype=np.float32) * 2)
    ours.send_message(m2)
    for t in ts:
        t.join(timeout=10)
    assert got["port"][0] == "to-port" and got["ref"][0] == "to-ref"
    np.testing.assert_array_equal(got["port"][1], np.arange(3.0))
    np.testing.assert_array_equal(got["ref"][1], np.arange(3.0) * 2)


def test_broker_pubsub_transport():
    from neuroimagedisttraining_tpu_torch.distributed.broker import (
        BrokerCommManager, MessageBroker,
    )

    broker = MessageBroker()
    mgrs = {cid: BrokerCommManager("127.0.0.1", broker.port,
                                   client_id=cid, client_num=2)
            for cid in (0, 1, 2)}
    got: dict[int, list] = {0: [], 1: [], 2: []}

    class Rec:
        def __init__(self, cid):
            self.cid = cid

        def receive_message(self, msg_type, msg):
            got[self.cid].append((msg_type, msg))

    for cid, mgr in mgrs.items():
        mgr.add_observer(Rec(cid))
        threading.Thread(target=mgr.handle_receive_message,
                         daemon=True).start()
    time.sleep(0.2)  # the SUB frames land first
    for cid in (1, 2):
        msg = M.Message(M.MSG_TYPE_S2C_SYNC_MODEL, 0, cid)
        msg.add(M.ARG_MODEL_PARAMS, {"w": np.full((3,), cid, np.float32)})
        mgrs[0].send_message(msg)
    up = M.Message(M.MSG_TYPE_C2S_SEND_MODEL, 1, 0)
    up.add(M.ARG_MODEL_PARAMS, {"w": np.ones((3,), np.float32)})
    mgrs[1].send_message(up)
    deadline = time.time() + 20
    while time.time() < deadline and not (got[0] and got[1] and got[2]):
        time.sleep(0.05)
    assert got[1] and got[2] and got[0], got
    t, m = got[2][0]
    assert t == M.MSG_TYPE_S2C_SYNC_MODEL
    np.testing.assert_array_equal(m.get(M.ARG_MODEL_PARAMS)["w"],
                                  np.full((3,), 2, np.float32))
    assert got[0][0][0] == M.MSG_TYPE_C2S_SEND_MODEL
    for mgr in mgrs.values():
        mgr.stop_receive_message()
    broker.stop()


def test_broker_retains_for_late_subscriber():
    from neuroimagedisttraining_tpu_torch.distributed.broker import (
        BrokerCommManager, MessageBroker,
    )

    broker = MessageBroker()
    srv = BrokerCommManager("127.0.0.1", broker.port, client_id=0,
                            client_num=1)
    msg = M.Message(M.MSG_TYPE_S2C_SYNC_MODEL, 0, 1)
    msg.add(M.ARG_ROUND_IDX, 42)
    srv.send_message(msg)  # published before the client exists
    time.sleep(0.2)
    got = []
    cli = BrokerCommManager("127.0.0.1", broker.port, client_id=1,
                            client_num=1)

    class Obs:
        def receive_message(self, t, m):
            got.append(m)
            cli.stop_receive_message()

    cli.add_observer(Obs())
    t = threading.Thread(target=cli.handle_receive_message, daemon=True)
    t.start()
    t.join(timeout=20)
    assert got and got[0].get(M.ARG_ROUND_IDX) == 42
    srv.stop_receive_message()
    broker.stop()


def test_broker_retains_latest_frame_for_late_subscriber():
    import socket as sock

    from neuroimagedisttraining_tpu_torch.distributed.broker import (
        _OP_PUB, _OP_SUB, MessageBroker, _read_frame, _write_frame,
    )

    broker = MessageBroker()
    pub = sock.create_connection(("127.0.0.1", broker.port), timeout=10)
    _write_frame(pub, _OP_PUB, "model", b"round-1")
    _write_frame(pub, _OP_PUB, "model", b"round-2")
    time.sleep(0.3)
    sub = sock.create_connection(("127.0.0.1", broker.port), timeout=10)
    sub.settimeout(10)
    _write_frame(sub, _OP_SUB, "model")
    frame = _read_frame(sub)
    assert frame is not None and frame[2] == b"round-2"
    for c in (pub, sub):
        c.close()
    broker.stop()


def test_broker_retained_frame_never_overtakes_live_pub():
    import socket as sock

    from neuroimagedisttraining_tpu_torch.distributed.broker import (
        _OP_PUB, _OP_SUB, MessageBroker, _read_frame, _write_frame,
    )

    broker = MessageBroker()
    pub = sock.create_connection(("127.0.0.1", broker.port), timeout=10)
    _write_frame(pub, _OP_PUB, "seq", b"%08d" % 0)  # the stale retainee
    time.sleep(0.2)
    stop = threading.Event()

    def publisher():
        i = 0
        while not stop.is_set():
            i += 1
            try:
                _write_frame(pub, _OP_PUB, "seq", b"%08d" % i)
            except OSError:
                return
            time.sleep(0.001)

    th = threading.Thread(target=publisher, daemon=True)
    th.start()
    try:
        for _ in range(8):
            sub = sock.create_connection(("127.0.0.1", broker.port),
                                         timeout=10)
            sub.settimeout(10)
            _write_frame(sub, _OP_SUB, "seq")
            seq = []
            for _ in range(5):
                frame = _read_frame(sub)
                assert frame is not None
                seq.append(int(frame[2]))
            assert seq == sorted(seq), seq
            sub.close()
    finally:
        stop.set()
        th.join(timeout=10)
        pub.close()
        broker.stop()


# ---------------------------------------------------------------- protocol

def _toy_train(c, lr=0.5, log=None):
    def train_fn(params, round_idx):
        p = {k: np.asarray(v, np.float32) for k, v in params.items()}
        p["w"] = p["w"] + lr * ((c + 1) - p["w"])
        if log is not None:
            log.append(p["w"].copy())
        return p, 10.0 * (c + 1)
    return train_fn


def _run_protocol(num_clients, comm_round, base_port, lr=0.5):
    init = {"w": np.zeros((3,), np.float32)}
    server = FedAvgServer(init, comm_round, num_clients,
                          base_port=base_port, device="cpu")
    clients = [FedAvgClientProc(c + 1, num_clients, _toy_train(c, lr),
                                base_port=base_port, device="cpu")
               for c in range(num_clients)]
    threads = [threading.Thread(target=m.run) for m in [server] + clients]
    for t in threads:
        t.start()
    assert server._done.wait(timeout=60)
    for t in threads:
        t.join(timeout=10)
    return server


def test_cross_silo_fedavg_protocol_closed_form():
    server = _run_protocol(3, 2, _base_port())
    assert len(server.history) == 2
    lr = 0.5
    r1 = lr * (1 * 1 + 2 * 2 + 3 * 3) / 6.0
    vals = [r1 + lr * ((c + 1) - r1) for c in range(3)]
    r2 = sum((c + 1) * v for c, v in enumerate(vals)) / 6.0
    np.testing.assert_allclose(server.params["w"],
                               np.full(3, r2, np.float32), rtol=1e-6)


def test_cross_silo_secure_aggregation_protocol():
    """Share slots over the socket plane: the secure aggregate within the
    fixed-point step of the plain protocol's."""
    from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (
        SecureFedAvgClientProc, SecureFedAvgServer,
    )

    plain = _run_protocol(3, 2, _base_port())
    bp = _base_port()
    server = SecureFedAvgServer({"w": np.zeros((3,), np.float32)}, 2, 3,
                                base_port=bp, device="cpu")
    clients = [SecureFedAvgClientProc(c + 1, 3, _toy_train(c), n_shares=3,
                                      mpc_seed=c, base_port=bp, device="cpu")
               for c in range(3)]
    threads = [threading.Thread(target=m.run) for m in [server] + clients]
    for t in threads:
        t.start()
    assert server._done.wait(timeout=60)
    for t in threads:
        t.join(timeout=10)
    assert len(server.history) == 2
    np.testing.assert_allclose(server.params["w"], plain.params["w"],
                               atol=1e-3)


def test_cross_silo_multi_aggregator_privacy_and_correctness():
    """2 silos, 3 slot aggregators: the aggregate matches the plain
    protocol, each aggregator saw one slot a silo a round and none equals
    a silo's quantized update, and the server saw only slot totals, none
    equal to a silo's quantized update either."""
    from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (
        SecureFedAvgClientProc, SecureFedAvgServer, SlotAggregatorProc,
    )
    from neuroimagedisttraining_tpu_torch.ops import mpc

    plain = _run_protocol(2, 2, _base_port())
    trained = {1: [], 2: []}
    bp = _base_port()
    server = SecureFedAvgServer({"w": np.zeros((3,), np.float32)}, 2, 2,
                                n_aggregators=3, base_port=bp,
                                record_trace=True, device="cpu")
    aggs = [SlotAggregatorProc(j, 2, 3, base_port=bp, record_trace=True)
            for j in range(3)]
    clients = [SecureFedAvgClientProc(
        c + 1, 2, _toy_train(c, log=trained[c + 1]), n_shares=3,
        n_aggregators=3, mpc_seed=c, base_port=bp, device="cpu")
        for c in range(2)]
    threads = [threading.Thread(target=m.run)
               for m in [server] + aggs + clients]
    for t in threads:
        t.start()
    assert server._done.wait(timeout=60)
    for t in threads:
        t.join(timeout=10)
    assert len(server.history) == 2
    np.testing.assert_allclose(server.params["w"], plain.params["w"],
                               atol=1e-3)
    q_updates = [mpc.quantize((10.0 * c / 30.0) * np.asarray(w, np.float64))
                 for c, ws in trained.items() for w in ws]
    for agg in aggs:
        assert sorted(agg.received) == [1, 2]
        for slots in agg.received.values():
            assert len(slots) == 2
            for slot in slots:
                for q in q_updates:
                    assert not np.array_equal(
                        np.asarray(slot["w"], np.int64) % mpc.P_DEFAULT,
                        q % mpc.P_DEFAULT)
    assert len(server.received_totals) == 3 * 2
    for tot in server.received_totals:
        for q in q_updates:
            assert not np.array_equal(
                np.asarray(tot["w"], np.int64) % mpc.P_DEFAULT,
                q % mpc.P_DEFAULT)


# ------------------------------------------- two silos training the model

def _tiny_shards():
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 255, size=(8,) + TINY).astype(np.uint8),
             rng.integers(0, 2, size=(8,)).astype(np.int32))
            for _ in range(2)]


def _reference_federation(shards, jmasks, lr):
    """The reference's two silos over its own sockets, one round, from
    its seed-0 init; returns ``(init tree, aggregate tree)``."""
    from neuroimagedisttraining_tpu.config import OptimConfig as JOptim
    from neuroimagedisttraining_tpu.core.trainer import (
        ClientState, LocalTrainer as JTrainer,
    )
    from neuroimagedisttraining_tpu.distributed.cross_silo import (
        FedAvgClientProc as RClient, FedAvgServer as RServer,
    )
    from neuroimagedisttraining_tpu.models import create_model as jcreate

    trainer = JTrainer(jcreate("3dcnn_tiny", num_classes=1),
                       JOptim(batch_size=4, epochs=1, lr=lr),
                       num_classes=1)
    gs = trainer.init_client_state(jax.random.key(0),
                                   jnp.zeros((1,) + TINY))
    init = {"params": jax.tree.map(np.asarray, gs.params),
            "batch_stats": jax.tree.map(np.asarray, gs.batch_stats)}

    def make_train_fn(c):
        X, y = (jnp.asarray(a) for a in shards[c])

        def train_fn(tree, round_idx):
            p = jax.tree.map(jnp.asarray, tree["params"])
            b = jax.tree.map(jnp.asarray, tree["batch_stats"])
            cs = ClientState(params=p, batch_stats=b,
                             opt_state=trainer.opt.init(p),
                             rng=jax.random.fold_in(jax.random.key(5), c))
            with fixed_dropout(jmasks):
                cs, _ = trainer.local_train(cs, X, y, jnp.int32(8),
                                            jnp.float32(lr), epochs=1,
                                            batch_size=4, max_samples=8)
            return {"params": jax.tree.map(np.asarray, cs.params),
                    "batch_stats": jax.tree.map(np.asarray,
                                                cs.batch_stats)}, 8.0
        return train_fn

    bp = _base_port()
    server = RServer(init, 1, 2, base_port=bp)
    clients = [RClient(c + 1, 2, make_train_fn(c), base_port=bp)
               for c in range(2)]
    threads = [threading.Thread(target=m.run) for m in [server] + clients]
    for t in threads:
        t.start()
    assert server._done.wait(timeout=300)
    for t in threads:
        t.join(timeout=10)
    return init, server.params


def test_two_port_silos_match_the_reference_federation():
    """Two port silos (``make_silo_train_fn`` over ``LocalTrainer``,
    threads of one process) and the port server over sockets, one round
    from the reference's initial weights with its epoch permutations and
    dropout keep-masks: the aggregate within ``TRAJECTORY`` of the
    reference federation's, and bit for bit the port's in-process
    weighted mean of the same two ``train_fn`` outputs."""
    from neuroimagedisttraining_tpu.core.trainer import epoch_perms_for
    from neuroimagedisttraining_tpu_torch.config import OptimConfig
    from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
    from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (
        make_silo_train_fn,
    )
    from neuroimagedisttraining_tpu_torch.models import create_model
    from neuroimagedisttraining_tpu_torch.weights import params_from_flax

    lr = 1e-3
    shards = _tiny_shards()
    jmasks, pmasks = model_dropout_masks("3dcnn_tiny", TINY, 4, seed=3)
    init, ref_agg = _reference_federation(shards, jmasks, lr)
    with torch_threads(2):
        params, bstats = params_from_flax(init["params"],
                                          init["batch_stats"])
        shapes = {k: tuple(v.shape) for k, v in
                  [*params.items(), *bstats.items()]}

        def make_train_fn(c):
            trainer = LocalTrainer(
                create_model("3dcnn_tiny", TINY),
                OptimConfig(batch_size=4, epochs=1, lr=lr),
                torch.device("cpu"), torch.Generator(),
                dropout_masks=pmasks)
            perms = torch.from_numpy(np.asarray(epoch_perms_for(
                jax.random.fold_in(jax.random.key(5), c), 1, 8, 8)).copy())
            X, y = (torch.from_numpy(a) for a in shards[c])
            return make_silo_train_fn(
                trainer, X, y, 8, rank=c + 1, seed=0, lr=lr, lr_decay=0.998,
                epochs=1, batch_size=4, shapes=shapes,
                perms_for=lambda r: perms, announce=False)

        fns = [make_train_fn(c) for c in range(2)]
        bp = _base_port()
        server = FedAvgServer(init, 1, 2, base_port=bp, device="cpu")
        clients = [FedAvgClientProc(c + 1, 2, fns[c], base_port=bp,
                                    device="cpu") for c in range(2)]
        threads = [threading.Thread(target=m.run)
                   for m in [server] + clients]
        for t in threads:
            t.start()
        assert server._done.wait(timeout=300)
        for t in threads:
            t.join(timeout=10)
        outs = [fn(init, 0) for fn in fns]
    want = survivor_weighted_mean([o[0] for o in outs], [o[1] for o in outs],
                                  device="cpu")
    got, exp = named_leaves(server.params), named_leaves(want)
    assert list(got) == list(exp)
    for k in got:
        assert np.array_equal(got[k], exp[k]), k
    got_p, got_b = params_from_flax(server.params["params"],
                                    server.params["batch_stats"])
    assert_state_close(got_p, got_b, ref_agg["params"],
                       ref_agg["batch_stats"], params, **TRAJECTORY)


# ------------------------------------------------------- codec and defense

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_threshold_route_frames_equal_np_partition(seed):
    """A silo's codec frames through ``CodecThreshold`` (the kernel's
    route, its plain version on the CPU) byte for byte the default
    ``np.partition`` encode's, with the error feedback carried over three
    rounds, and equal to the reference's encode of the same update."""
    from neuroimagedisttraining_tpu.codec import wire as rcodec
    from neuroimagedisttraining_tpu_torch.codec import wire as codec
    from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (
        CodecThreshold,
    )

    rng = np.random.default_rng(seed)
    spec = codec.parse_wire_spec("delta+sparse+quant", 0.25)
    rspec = rcodec.parse_wire_spec("delta+sparse+quant", 0.25)
    ref = named_leaves(_toy_tree(seed))
    thr = CodecThreshold("cpu")
    ef_a = ef_b = None
    ef_r = None
    for _ in range(3):
        upd = {k: (v + rng.standard_normal(v.shape).astype(np.float32)
                   * np.float32(rng.choice([1e-3, 1e-1])))
               for k, v in ref.items()}
        fa, ef_a = codec.encode_update(spec, upd, reference=ref, ef=ef_a,
                                       mask_on_wire=False, threshold_fn=thr)
        fb, ef_b = codec.encode_update(spec, upd, reference=ref, ef=ef_b,
                                       mask_on_wire=False)
        fr, ef_r = rcodec.encode_update(rspec, codec.nest(upd),
                                        reference=codec.nest(ref),
                                        ef=ef_r, mask_on_wire=False)
        assert codec.msgpack_dumps(fa) == codec.msgpack_dumps(fb)
        assert codec.msgpack_dumps(fa) == codec.msgpack_dumps(fr)
    assert thr.calls == 3


@pytest.mark.parametrize("extra", [1, 3, 40])
def test_codec_threshold_refines_a_low_select(extra, monkeypatch):
    """Where the select's threshold sits below the exact k-th value (it
    keeps ``extra`` scores beyond k), ``CodecThreshold`` takes the exact
    value from the kept scores: every round refines, and the frames stay
    byte for byte the ``np.partition`` encode's."""
    from neuroimagedisttraining_tpu_torch.codec import wire as codec
    from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (
        CodecThreshold,
    )
    from neuroimagedisttraining_tpu_torch.ops import topk

    def low_select(x, k, *a, **kw):
        # the (k + extra)-th largest: ``extra`` scores kept beyond k
        return torch.sort(x, descending=True).values[k - 1 + extra]

    monkeypatch.setattr(topk, "kth_largest", low_select)
    rng = np.random.default_rng(7)
    spec = codec.parse_wire_spec("delta+sparse+quant", 0.25)
    ref = named_leaves(_toy_tree(3))
    thr = CodecThreshold("cpu")
    ef_a = ef_b = None
    for _ in range(3):
        upd = {k: v + rng.standard_normal(v.shape).astype(np.float32)
               * np.float32(1e-2) for k, v in ref.items()}
        fa, ef_a = codec.encode_update(spec, upd, reference=ref, ef=ef_a,
                                       mask_on_wire=False, threshold_fn=thr)
        fb, ef_b = codec.encode_update(spec, upd, reference=ref, ef=ef_b,
                                       mask_on_wire=False)
        assert codec.msgpack_dumps(fa) == codec.msgpack_dumps(fb)
    assert thr.calls == 3 and thr.refined == 3
    assert thr.extra_kept == 3 * extra


@pytest.mark.parametrize("defense", ["norm_diff_clipping", "trimmed_mean",
                                     "median", "krum", "geometric_median"])
def test_defended_mean_matches_reference(defense):
    """``survivor_defended_mean`` on 5 silos' uploads (one an outlier)
    against the reference's on the same numpy trees, rtol 1e-6."""
    from neuroimagedisttraining_tpu.distributed.cross_silo import (
        survivor_defended_mean as rdef,
    )
    from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (
        survivor_defended_mean,
    )

    ref = _toy_tree(0)
    rng = np.random.default_rng(4)
    trees = []
    for c in range(5):
        scale = 50.0 if c == 3 else 0.1
        trees.append({k: {m: {n: x + np.float32(scale) * rng.standard_normal(
            x.shape).astype(np.float32) for n, x in mv.items()}
            for m, mv in kv.items()} for k, kv in ref.items()})
    ns = [8.0, 10.0, 12.0, 9.0, 11.0]
    got = survivor_defended_mean(trees, ns, ref, defense=defense, byz_f=1,
                                 norm_bound=1.0, device="cpu")
    want = rdef(trees, ns, ref, defense=defense, byz_f=1, norm_bound=1.0)
    g, w = named_leaves(got), named_leaves(jax.tree.map(np.asarray, want))
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_weak_dp_server_noise_is_the_engines_draw():
    """The weak-DP noise of silo s in round r: each leaf from a generator
    keyed as the engines' ``noise_for`` keys client s - 1's."""
    from types import SimpleNamespace

    from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (
        silo_noise,
    )
    from neuroimagedisttraining_tpu_torch.engines.base import (
        FederatedEngine,
    )

    like = {"a": torch.zeros(3, 4), "b": torch.zeros(5)}
    eng = SimpleNamespace(cfg=SimpleNamespace(seed=11))
    want = FederatedEngine.noise_for(eng, "weak_dp", 2, 3, like)
    got = silo_noise(11, 2, 4, like)
    for k in like:
        assert torch.equal(got[k], want[k])


# ----------------------------------------------------------------- the CLI

def _reference_key_set(extra_keys=("health", "health_timeline",
                                   "actions")) -> set:
    """The keys of the reference runner's result line for a plain
    synchronous run: the literal keys of its ``json.dumps`` call, the
    ``extra`` keys such a run sets, and its transport's byte stats."""
    import ast

    from neuroimagedisttraining_tpu.distributed import run as rrun
    from neuroimagedisttraining_tpu.distributed.comm import (
        SocketCommManager as RSocket,
    )

    tree = ast.parse(open(rrun.__file__).read())
    keys = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "rounds_completed"
                for k in node.keys):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
    mgr = RSocket(0, 1, base_port=_base_port())
    try:
        stats = set(mgr.byte_stats())
    finally:
        mgr.stop_receive_message()
    return keys | set(extra_keys) | stats


def test_cli_runner_three_processes_reference_key_set():
    """Server and 2 silos as OS processes of ``python -m
    neuroimagedisttraining_tpu_torch.distributed.run`` on the CPU, 2
    rounds: the server's last line has the reference's keys, the silos
    trained 2 rounds each."""
    bp = _base_port()
    common = ["--num_clients", "2", "--comm_round", "2",
              "--model", "3dcnn_tiny", "--dataset", "synthetic",
              "--synthetic_num_subjects", "24",
              "--synthetic_shape", "12", "14", "12",
              "--batch_size", "4", "--base_port", str(bp),
              "--device", "cpu"]
    cmd = [sys.executable, "-m",
           "neuroimagedisttraining_tpu_torch.distributed.run"]
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen(cmd + ["--role", "server"] + common,
                              stdout=subprocess.PIPE, text=True, cwd=REPO,
                              env=env)]
    procs += [subprocess.Popen(cmd + ["--role", "client", "--rank", str(r)]
                               + common, stdout=subprocess.PIPE, text=True,
                               cwd=REPO, env=env) for r in (1, 2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    lines = [[json.loads(ln) for ln in o.splitlines() if ln.startswith("{")]
             for o in outs]
    res = lines[0][-1]
    assert set(res) == _reference_key_set()
    assert res["rounds_completed"] == 2 and res["secure"] is False
    assert res["final_param_norm"] > 0 and res["suspects"] == []
    assert len(lines[0][-2]["aggregate_seconds"]) == 2
    for silo in lines[1:]:
        assert silo[-1]["rounds_trained"] == 2
        assert len(silo[-2]["train_seconds"]) == 2
