"""The port's fault-tolerant control plane: ``faults/chaos.py``
(``FaultyCommManager``) against the reference's, and the port server's
deadline, quorum, dedup, stale-round, heartbeat, rejoin and secure-dropout
behaviour, as the reference's ``tests/test_faults.py`` holds the
reference's.

- ``FaultyCommManager``'s decisions (drop, duplicate, delay, tear, crash,
  on the send and the receive side) equal the reference's for the same
  spec, seed and message sequence.
- A ``crash:4@1`` federation with a deadline and a quorum: the survivor
  rounds bit for bit the port's engine aggregation over the same
  survivors (``robust.weighted_mean``, what ``FederatedEngine.aggregate``
  runs) and ``tree_weighted_mean``.
- Duplicates never count twice (sockets and the broker), stale uploads
  are rejected, dropped and torn uploads leave survivor rounds, a killed
  silo is flagged within its heartbeat bound, a replacement silo
  re-registers and contributes.
- The secure server: without a quorum it waits for every silo; with one,
  a crashed silo drops out re-weighted; a stale share upload never folds;
  a phase-B dropout is rescaled.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu_torch.distributed import message as M
from neuroimagedisttraining_tpu_torch.distributed.comm import (
    SocketCommManager,
)
from neuroimagedisttraining_tpu_torch.distributed.cross_silo import (
    FedAvgClientProc, FedAvgServer, SecureFedAvgClientProc,
    SecureFedAvgServer, survivor_weighted_mean,
)
from neuroimagedisttraining_tpu_torch.distributed.ports import (
    free_port_block,
)
from neuroimagedisttraining_tpu_torch.faults.chaos import FaultyCommManager
from neuroimagedisttraining_tpu_torch.faults.schedule import (
    FaultSchedule, parse_fault_spec,
)


def _base_port() -> int:
    return free_port_block(8)


def test_free_port_block_is_bindable():
    base = free_port_block(4)
    socks = []
    try:
        for i in range(4):
            s = socket.socket()
            s.bind(("127.0.0.1", base + i))
            socks.append(s)
    finally:
        for s in socks:
            s.close()
    with pytest.raises(ValueError):
        free_port_block(0)


# ------------------------------------------------- the wrapper's decisions

class _Recorder:
    """An inner transport that records what the wrapper hands it."""

    def __init__(self):
        self.sent = []
        self.stopped = 0
        self.observers = []

    def send_message(self, msg, **kw):
        self.sent.append((msg.msg_type, msg.get(M.ARG_ROUND_IDX),
                          msg.receiver_id))

    def add_observer(self, obs):
        self.observers.append(obs)

    def remove_observer(self, obs):
        self.observers.remove(obs)

    def handle_receive_message(self):
        pass

    def stop_receive_message(self):
        self.stopped += 1


SEQUENCE = [(M.MSG_TYPE_C2S_REGISTER, None)] + [
    (t, r) for r in range(6) for t in (
        M.MSG_TYPE_C2S_HEARTBEAT, M.MSG_TYPE_C2S_SEND_MODEL,
        M.MSG_TYPE_C2S_NUM_SAMPLES, M.MSG_TYPE_C2S_SEND_MODEL,
        M.MSG_TYPE_C2S_HEARTBEAT)]


@pytest.mark.parametrize("spec", [
    "drop:0.3,dup:0.3", "disconnect:0.4,straggle:0.5:0.2",
    "crash:2@3,dup:0.5", "crash_prob:0.3,drop:0.2,straggle:1.0:0.05",
    "byz:2@1:sign_flip,dup:0.2"])
@pytest.mark.parametrize("seed", [0, 1024])
def test_faulty_comm_decisions_equal_reference(spec, seed, monkeypatch):
    """Both wrappers over a recording transport, fed the same sends and
    receives for ranks 1-3: the same frames reach the transport in the
    same order, the same delays are slept, the same ranks crash at the
    same message."""
    from neuroimagedisttraining_tpu.distributed import message as RM
    from neuroimagedisttraining_tpu.faults import (
        FaultSchedule as RSchedule, FaultyCommManager as RFaulty,
        parse_fault_spec as rparse,
    )

    slept = []
    monkeypatch.setattr(time, "sleep", lambda s: slept.append(round(s, 9)))
    runs = {}
    for side, (Faulty, Sched, parse, Msg) in {
            "port": (FaultyCommManager, FaultSchedule, parse_fault_spec,
                     M.Message),
            "ref": (RFaulty, RSchedule, rparse, RM.Message)}.items():
        trace = []
        for rank in (1, 2, 3):
            inner = _Recorder()
            w = Faulty(inner, Sched(parse(spec), seed), rank)
            got = []

            class Obs:
                def receive_message(self, t, m):
                    got.append((t, m.get(M.ARG_ROUND_IDX)))

            w.add_observer(Obs())
            del slept[:]
            for i, (t, r) in enumerate(SEQUENCE):
                if t == M.MSG_TYPE_C2S_SEND_MODEL and r is not None:
                    sync = Msg(M.MSG_TYPE_S2C_SYNC_MODEL, 0, rank)
                    sync.add(M.ARG_ROUND_IDX, r)
                    w.receive_message(sync.msg_type, sync)
                msg = Msg(t, rank, 0)
                if r is not None:
                    msg.add(M.ARG_ROUND_IDX, r)
                w.send_message(msg)
            trace.append((rank, inner.sent, list(slept), got, w.crashed,
                          inner.stopped))
        runs[side] = trace
    assert runs["port"] == runs["ref"]
    # the spec did something somewhere
    assert any(len(t[1]) != len(SEQUENCE) or t[2] or t[4]
               for t in runs["port"])


# ------------------------------------------- the tolerant protocol, threads

def _toy_train(rank, lr=0.5):
    """Float32 'training': pull w toward the rank value."""
    def fn(params, round_idx):
        p = {k: np.asarray(v, np.float32) for k, v in params.items()}
        p["w"] = p["w"] + np.float32(lr) * (np.float32(rank) - p["w"])
        return p, 10.0 * rank
    return fn


def _make_client(rank, num_clients, bp, *, spec=None, seed=0, hb=0.0,
                 train=None):
    comm = SocketCommManager(rank, num_clients + 1, base_port=bp)
    if spec:
        comm = FaultyCommManager(
            comm, FaultSchedule(parse_fault_spec(spec), seed), rank)
    return FedAvgClientProc(rank, num_clients,
                            train or _toy_train(rank), base_port=bp,
                            comm=comm, heartbeat_interval=hb, device="cpu")


def _replay_rounds(init, survivors_per_round, lr=0.5):
    params = {k: np.asarray(v, np.float32) for k, v in init.items()}
    for r, survivors in enumerate(survivors_per_round):
        outs = {c: _toy_train(c, lr)(params, r) for c in survivors}
        senders = sorted(outs)
        params = survivor_weighted_mean(
            [outs[s][0] for s in senders], [outs[s][1] for s in senders],
            device="cpu")
    return params


def _run(server, clients, timeout=90):
    threads = [threading.Thread(target=m.run, daemon=True)
               for m in [server] + clients]
    for t in threads:
        t.start()
    assert server._done.wait(timeout=timeout), server.history
    return threads


def test_deadline_quorum_survivor_aggregate_bitwise():
    """Silo 4 crashes at round 1: the deadline rounds aggregate the 3
    survivors re-weighted, bit for bit the port's engine aggregation
    over the same survivors, and the survivor sets replay from the
    seed."""
    from neuroimagedisttraining_tpu_torch.core import robust
    from neuroimagedisttraining_tpu_torch.utils.pytree import (
        tree_weighted_mean,
    )

    num_clients, rounds = 4, 3
    bp = _base_port()
    init = {"w": np.zeros(3, np.float32)}
    spec, seed = "crash:4@1", 1024
    server = FedAvgServer(init, rounds, num_clients, base_port=bp,
                          round_deadline=2.0, quorum=2, device="cpu")
    clients = [_make_client(c, num_clients, bp, spec=spec, seed=seed)
               for c in range(1, num_clients + 1)]
    for t in _run(server, clients):
        t.join(timeout=15)
    assert len(server.history) == rounds
    assert server.history[0]["survivors"] == [1, 2, 3, 4]
    for entry in server.history[1:]:
        assert entry["survivors"] == [1, 2, 3]
    assert 4 in server.suspect_clients()
    sched = FaultSchedule(parse_fault_spec(spec), seed)
    survivors = [[c for c in range(1, num_clients + 1)
                  if not sched.crashed(r, c)] for r in range(rounds)]
    assert survivors == [e["survivors"] for e in server.history]
    want = _replay_rounds(init, survivors)
    np.testing.assert_array_equal(server.params["w"], want["w"])
    # the last round through the engines' own aggregation
    params_in = _replay_rounds(init, survivors[:-1])
    outs = [_toy_train(c)(params_in, rounds - 1) for c in survivors[-1]]
    states = [{"w": torch.from_numpy(o[0]["w"])} for o in outs]
    w = torch.tensor([o[1] for o in outs], dtype=torch.float32)
    engine_agg = robust.weighted_mean(states, w)
    np.testing.assert_array_equal(server.params["w"],
                                  engine_agg["w"].numpy())
    stacked = {"w": torch.stack([s["w"] for s in states])}
    np.testing.assert_array_equal(server.params["w"],
                                  tree_weighted_mean(stacked, w)["w"]
                                  .numpy())


def test_duplicate_uploads_never_double_count():
    num_clients, rounds = 3, 2
    bp = _base_port()
    init = {"w": np.zeros(3, np.float32)}
    server = FedAvgServer(init, rounds, num_clients, base_port=bp,
                          device="cpu")
    clients = [_make_client(c, num_clients, bp, spec="dup:1.0")
               for c in range(1, num_clients + 1)]
    for t in _run(server, clients, 60):
        t.join(timeout=15)
    assert len(server.history) == rounds
    assert all(e["clients"] == num_clients for e in server.history)
    want = _replay_rounds(init, [[1, 2, 3]] * rounds)
    np.testing.assert_array_equal(server.params["w"], want["w"])


@pytest.mark.parametrize("directive", ["drop:1.0", "disconnect:1.0"])
def test_drop_and_disconnect_survivor_rounds(directive):
    """Silo 2's uploads all lost (dropped, or torn mid-frame): the
    deadline rounds complete over silo 1, and the server's listener
    survives the torn frames."""
    num_clients, rounds = 2, 2
    bp = _base_port()
    init = {"w": np.zeros(2, np.float32)}
    server = FedAvgServer(init, rounds, num_clients, base_port=bp,
                          round_deadline=1.0, quorum=1, device="cpu")
    clients = [_make_client(1, num_clients, bp),
               _make_client(2, num_clients, bp, spec=directive)]
    threads = _run(server, clients, 60)
    threads[0].join(timeout=15)
    assert len(server.history) == rounds
    for e in server.history:
        assert e["survivors"] == [1], server.history
    want = _replay_rounds(init, [[1]] * rounds)
    np.testing.assert_array_equal(server.params["w"], want["w"])
    for cl in clients:
        cl.com_manager.stop_receive_message()
    for t in threads[1:]:
        t.join(timeout=15)


class _NullComm:
    def send_message(self, msg, **kw):
        pass

    def add_observer(self, obs):
        pass

    def remove_observer(self, obs):
        pass

    def handle_receive_message(self):
        pass

    def stop_receive_message(self):
        pass


_INIT = {"w": np.zeros(2, np.float32)}


@pytest.mark.parametrize("make", [
    lambda: FedAvgServer(_INIT, 1, 1, comm=_NullComm()),
    lambda: SecureFedAvgServer(_INIT, 1, 1, comm=_NullComm()),
    lambda: FedAvgClientProc(1, 1, _toy_train(1), comm=_NullComm()),
    lambda: SecureFedAvgClientProc(1, 1, _toy_train(1), comm=_NullComm()),
    lambda: survivor_weighted_mean([_INIT], [1.0]),
], ids=["server", "secure_server", "silo", "secure_silo", "mean"])
def test_default_device_is_the_card(make):
    """Without ``device``, the servers, the silos and the survivor mean run
    on ``cuda``: with no card they refuse, never falling back to the
    CPU."""
    if torch.cuda.is_available():
        make()
    else:
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            make()


def test_stale_round_upload_rejected_unit():
    """Handler-level: a wrong-round upload and a duplicate never enter
    the aggregate; an undecodable frame and a non-finite upload are
    dropped, the latter counted."""
    server = FedAvgServer({"w": np.zeros(2, np.float32)}, 5, 3,
                          comm=_NullComm(), device="cpu")
    server.register_message_receive_handlers()
    for c in (1, 2, 3):
        server._on_register(M.Message(M.MSG_TYPE_C2S_REGISTER, c, 0))
    assert server._started and server.round_idx == 0

    def upload(c, round_tag, value, n):
        msg = M.Message(M.MSG_TYPE_C2S_SEND_MODEL, c, 0)
        msg.add(M.ARG_MODEL_PARAMS, value if isinstance(value, dict)
                else {"w": np.full(2, value, np.float32)})
        msg.add(M.ARG_NUM_SAMPLES, float(n))
        msg.add(M.ARG_ROUND_IDX, round_tag)
        server._on_model(msg)

    upload(1, 0, 1.0, 10.0)
    upload(1, 0, 99.0, 10.0)   # duplicate
    upload(2, 3, 99.0, 10.0)   # another round
    upload(2, 0, {"__nidt_codec__": 9, "body": np.zeros(3, np.uint8)},
           10.0)               # undecodable
    assert server.round_idx == 0 and len(server._updates) == 1
    upload(3, 0, float("nan"), 10.0)  # non-finite: rejected, reported
    assert server.byz_stats["nonfinite_rejected"] == 1
    upload(2, 0, 3.0, 30.0)    # completes the round
    assert server.round_idx == 1
    assert server.history[0]["survivors"] == [1, 2]
    np.testing.assert_allclose(server.params["w"],
                               np.full(2, 2.5, np.float32), rtol=1e-6)


def test_heartbeat_flags_killed_client_within_bound():
    num_clients, rounds = 2, 2
    hb_timeout = 0.5
    bp = _base_port()
    init = {"w": np.zeros(2, np.float32)}
    server = FedAvgServer(init, rounds, num_clients, base_port=bp,
                          quorum=1, heartbeat_timeout=hb_timeout, device="cpu")
    live = _make_client(1, num_clients, bp, hb=0.1)
    zombie = SocketCommManager(2, num_clients + 1, base_port=bp)
    threads = [threading.Thread(target=m.run, daemon=True)
               for m in (server, live)]
    for t in threads:
        t.start()
    zombie.send_message(M.Message(M.MSG_TYPE_C2S_REGISTER, 2, 0))
    for _ in range(3):
        zombie.send_message(M.Message(M.MSG_TYPE_C2S_HEARTBEAT, 2, 0))
        time.sleep(0.05)
    t_silent = time.monotonic()
    deadline = t_silent + 10 * hb_timeout
    while time.monotonic() < deadline:
        if 2 in server.suspect_clients():
            break
        time.sleep(0.02)
    t_flag = time.monotonic()
    assert 2 in server.suspect_clients()
    assert t_flag - t_silent <= 6 * hb_timeout
    assert server._done.wait(timeout=30)
    for e in server.history:
        assert e["survivors"] == [1]
    zombie.stop_receive_message()
    for t in threads:
        t.join(timeout=15)


def test_late_rejoin_via_reregister():
    num_clients, rounds = 2, 8
    bp = _base_port()
    init = {"w": np.zeros(2, np.float32)}
    server = FedAvgServer(init, rounds, num_clients, base_port=bp,
                          round_deadline=0.5, quorum=1, device="cpu")

    def slow_train(params, round_idx):
        time.sleep(0.3)
        return _toy_train(1)(params, round_idx)

    c1 = _make_client(1, num_clients, bp, train=slow_train)
    c2 = _make_client(2, num_clients, bp, spec="crash:2@1", seed=0)
    threads = [threading.Thread(target=m.run, daemon=True)
               for m in (server, c1, c2)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if any(e.get("survivors") == [1] for e in server.history):
            break
        time.sleep(0.05)
    assert any(e.get("survivors") == [1] for e in server.history)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:  # the crashed listener's port
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as probe:
            probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                probe.bind(("0.0.0.0", bp + 2))
                break
            except OSError:
                time.sleep(0.05)
    c2b = _make_client(2, num_clients, bp)
    t2b = threading.Thread(target=c2b.run, daemon=True)
    t2b.start()
    assert server._done.wait(timeout=60)
    assert any(e.get("survivors") == [1, 2]
               for e in server.history[1:]), server.history
    for t in threads + [t2b]:
        t.join(timeout=15)


def test_faulty_comm_wraps_broker_transport():
    from neuroimagedisttraining_tpu_torch.distributed.broker import (
        BrokerCommManager, MessageBroker,
    )

    num_clients, rounds = 2, 2
    broker = MessageBroker()
    init = {"w": np.zeros(2, np.float32)}
    server = FedAvgServer(
        init, rounds, num_clients,
        comm=BrokerCommManager("127.0.0.1", broker.port, client_id=0,
                               client_num=num_clients), device="cpu")
    sched = FaultSchedule(parse_fault_spec("dup:1.0"), seed=3)
    clients = []
    for c in (1, 2):
        inner = BrokerCommManager("127.0.0.1", broker.port, client_id=c,
                                  client_num=num_clients)
        clients.append(FedAvgClientProc(
            c, num_clients, _toy_train(c),
            comm=FaultyCommManager(inner, sched, c), device="cpu"))
    for t in _run(server, clients, 60):
        t.join(timeout=15)
    assert len(server.history) == rounds
    want = _replay_rounds(init, [[1, 2]] * rounds)
    np.testing.assert_array_equal(server.params["w"], want["w"])
    broker.stop()


def test_quarantine_strikes_and_ef_reset():
    """``--quarantine_rounds``: a silo whose update norms are outliers
    (100x the others') two rounds running is quarantined (its uploads dropped, the round
    completes without it) and its first sync after the window carries
    ``ARG_EF_RESET``."""
    sent = []

    class Rec(_NullComm):
        def send_message(self, msg, **kw):
            sent.append(msg)

    server = FedAvgServer({"w": np.zeros(4, np.float32)}, 6, 4, comm=Rec(),
                          quarantine_rounds=1, outlier_threshold=2,
                          device="cpu")
    server.register_message_receive_handlers()
    for c in (1, 2, 3, 4):
        server._on_register(M.Message(M.MSG_TYPE_C2S_REGISTER, c, 0))

    def round_of(r, bad=4, skip=()):
        for c in (1, 2, 3, 4):
            if c in skip:
                continue
            v = 100.0 if c == bad else 0.1 + 0.01 * c
            msg = M.Message(M.MSG_TYPE_C2S_SEND_MODEL, c, 0)
            msg.add(M.ARG_MODEL_PARAMS, {"w": server.params["w"]
                                         + np.float32(v)})
            msg.add(M.ARG_NUM_SAMPLES, 10.0)
            msg.add(M.ARG_ROUND_IDX, r)
            server._on_model(msg)

    round_of(0)
    round_of(1)  # the second strike: quarantined from round 2
    assert server.byz_stats["quarantines"] == [
        {"client": 4, "from_round": 2, "until_round": 3}]
    assert server.round_idx == 2
    round_of(2)  # silo 4's upload dropped; the others complete the round
    assert server.round_idx == 3 and server.history[2]["survivors"] == [
        1, 2, 3]
    resets = [m for m in sent if m.get(M.ARG_EF_RESET)]
    assert [(m.receiver_id, m.get(M.ARG_ROUND_IDX)) for m in resets] == [
        (4, 3)]


# ------------------------------------------------------- the secure server

def test_secure_server_requires_all_clients_without_quorum():
    num_clients = 3
    bp = _base_port()
    server = SecureFedAvgServer({"w": np.zeros(2, np.float32)}, 1,
                                num_clients, base_port=bp, device="cpu")
    clients = [SecureFedAvgClientProc(c, num_clients, _toy_train(c),
                                      n_shares=3, mpc_seed=c, base_port=bp,
                                      device="cpu")
               for c in (1, 2)]  # silo 3 never starts
    threads = [threading.Thread(target=m.run, daemon=True)
               for m in [server] + clients]
    for t in threads:
        t.start()
    assert not server._done.wait(timeout=3.0)
    assert len(server.history) == 0
    for m in [server] + clients:
        m.com_manager.stop_receive_message()
    for t in threads:
        t.join(timeout=15)


def test_secure_server_quorum_dropout_reweighted():
    num_clients, rounds, lr = 3, 3, 0.5
    bp = _base_port()
    server = SecureFedAvgServer({"w": np.zeros(2, np.float32)}, rounds,
                                num_clients, base_port=bp,
                                round_deadline=1.5, quorum=2, device="cpu")
    clients = []
    for c in (1, 2, 3):
        comm = SocketCommManager(c, num_clients + 1, base_port=bp)
        if c == 3:
            comm = FaultyCommManager(
                comm, FaultSchedule(parse_fault_spec("crash:3@1"), 0), c)
        clients.append(SecureFedAvgClientProc(
            c, num_clients, _toy_train(c, lr), n_shares=3, mpc_seed=c,
            base_port=bp, comm=comm, device="cpu"))
    for t in _run(server, clients, 120):
        t.join(timeout=15)
    assert len(server.history) == rounds
    assert server.history[0]["survivors"] == [1, 2, 3]
    for e in server.history[1:]:
        assert e["survivors"] == [1, 2]
    params = {"w": np.zeros(2, np.float64)}
    for r, surv in enumerate([[1, 2, 3], [1, 2], [1, 2]]):
        outs = {c: _toy_train(c, lr)(params, r) for c in surv}
        w = np.asarray([outs[c][1] for c in sorted(outs)], np.float64)
        w = w / w.sum()
        params = {"w": sum(wi * np.asarray(outs[c][0]["w"], np.float64)
                           for wi, c in zip(w, sorted(outs)))}
    np.testing.assert_allclose(server.params["w"], params["w"], atol=1e-3)


def _phase_a(server, ns):
    server.register_message_receive_handlers()
    for c in ns:
        server._on_register(M.Message(M.MSG_TYPE_C2S_REGISTER, c, 0))
    for c, n in ns.items():
        msg = M.Message(M.MSG_TYPE_C2S_NUM_SAMPLES, c, 0)
        msg.add(M.ARG_NUM_SAMPLES, n)
        msg.add(M.ARG_ROUND_IDX, 0)
        server._on_num_samples(msg)
    assert server._phase == "B"


def test_secure_stale_share_upload_discarded_atomically():
    server = SecureFedAvgServer({"w": np.zeros(2, np.float32)}, 5, 2,
                                comm=_NullComm(), device="cpu")
    _phase_a(server, {1: 10.0, 2: 30.0})
    shares = {"w": np.arange(6, dtype=np.int64).reshape(3, 2)}

    def upload(tag):
        msg = M.Message(M.MSG_TYPE_C2S_SEND_MODEL, 1, 0)
        msg.add(M.ARG_MODEL_PARAMS, shares)
        msg.add(M.ARG_ROUND_IDX, tag)
        server._on_model(msg)

    upload(4)  # another round
    assert server._slot_acc is None and server._folded == set()
    upload(0)
    assert server._folded == {1}
    upload(0)  # a duplicate: no second fold
    np.testing.assert_array_equal(server._slot_acc["w"], shares["w"])


def test_secure_phase_b_dropout_rescale_unit():
    from neuroimagedisttraining_tpu_torch.ops import mpc

    server = SecureFedAvgServer({"w": np.zeros(2, np.float32)}, 5, 2,
                                comm=_NullComm(), round_deadline=60.0,
                                quorum=1, device="cpu")
    _phase_a(server, {1: 10.0, 2: 30.0})  # w_1 = 0.25, w_2 = 0.75
    x = np.asarray([1.5, -2.0], np.float64)
    shares = {"w": mpc.additive_shares(
        mpc.quantize(0.25 * x), 3, rng=np.random.default_rng(0))}
    up = M.Message(M.MSG_TYPE_C2S_SEND_MODEL, 1, 0)
    up.add(M.ARG_MODEL_PARAMS, shares)
    up.add(M.ARG_ROUND_IDX, 0)
    server._on_model(up)
    server._on_deadline(0, server._deadline_gen)
    if server._timer is not None:
        server._timer.cancel()
    assert server.round_idx == 1
    assert server.history[0]["survivors"] == [1]
    assert 2 in server.suspect_clients()
    np.testing.assert_allclose(server.params["w"], x, atol=1e-3)


def test_secure_quant_protocol_matches_host_fold():
    """``--secure_quant`` over the socket plane (field bits 32, 3 silos, 2
    rounds): the aggregate each round bit for bit the host protocol's
    ``quantized_weighted_mean`` of the same uploads."""
    from neuroimagedisttraining_tpu_torch.privacy import (
        QuantSpec, quantized_weighted_mean,
    )
    from neuroimagedisttraining_tpu_torch.privacy.secure_quant import (
        leaf_scales,
    )

    spec = QuantSpec.from_bits(32, 10, 3)
    bp = _base_port()
    init = {"w": np.zeros(3, np.float32)}
    server = SecureFedAvgServer(init, 2, 3, base_port=bp, quant_spec=spec,
                                device="cpu")
    clients = [SecureFedAvgClientProc(c, 3, _toy_train(c), n_shares=3,
                                      mpc_seed=c, base_port=bp,
                                      quant_spec=spec, device="cpu")
               for c in (1, 2, 3)]
    for t in _run(server, clients, 60):
        t.join(timeout=15)
    params = init
    for r in range(2):
        outs = [_toy_train(c)(params, r) for c in (1, 2, 3)]
        params = quantized_weighted_mean(
            [o[0] for o in outs], [o[1] for o in outs], spec,
            scales=leaf_scales(params))
    np.testing.assert_array_equal(server.params["w"], params["w"])


def test_byzantine_silos_attack_before_encoding():
    """``byz:`` value faults in the silo: a sign-flipped upload is the
    reference's ``attack_update`` of the same upload bit for bit, and a
    non-finite one is rejected by the server, whose round completes
    over the others."""
    import jax

    from neuroimagedisttraining_tpu.faults import adversary as radv
    from neuroimagedisttraining_tpu.faults import (
        FaultSchedule as RSchedule, parse_fault_spec as rparse,
    )

    spec, seed = "byz:2@0:sign_flip,byz:3@0:nonfinite", 5
    sched = FaultSchedule(parse_fault_spec(spec), seed)
    got = {}

    class Rec(_NullComm):
        def send_message(self, msg, **kw):
            got[msg.sender_id] = msg.get(M.ARG_MODEL_PARAMS)

    sync = M.Message(M.MSG_TYPE_S2C_SYNC_MODEL, 0, 0)
    sync.add(M.ARG_MODEL_PARAMS, {"w": np.linspace(-1, 1, 5)
                                  .astype(np.float32)})
    sync.add(M.ARG_ROUND_IDX, 0)
    for r in (1, 2, 3):
        silo = FedAvgClientProc(r, 3, _toy_train(r), comm=Rec(),
                                fault_schedule=sched, seed=seed, device="cpu")
        silo._on_sync(sync)
    honest = _toy_train(2)(sync.get(M.ARG_MODEL_PARAMS), 0)[0]
    want = radv.attack_update(RSchedule(rparse(spec), seed), seed, 0, 2,
                              honest, sync.get(M.ARG_MODEL_PARAMS))
    np.testing.assert_array_equal(got[2]["w"],
                                  np.asarray(jax.tree.map(np.asarray,
                                                          want)["w"]))
    np.testing.assert_array_equal(got[1]["w"], _toy_train(1)(
        sync.get(M.ARG_MODEL_PARAMS), 0)[0]["w"])
    assert np.isnan(got[3]["w"]).all()
    server = FedAvgServer({"w": sync.get(M.ARG_MODEL_PARAMS)["w"]}, 2, 3,
                          comm=_NullComm(), device="cpu")
    server.register_message_receive_handlers()
    for c in (1, 2, 3):
        server._on_register(M.Message(M.MSG_TYPE_C2S_REGISTER, c, 0))
    for c in (3, 1, 2):
        up = M.Message(M.MSG_TYPE_C2S_SEND_MODEL, c, 0)
        up.add(M.ARG_MODEL_PARAMS, got[c])
        up.add(M.ARG_NUM_SAMPLES, 10.0 * c)
        up.add(M.ARG_ROUND_IDX, 0)
        server._on_model(up)
    assert server.round_idx == 1
    assert server.history[0]["survivors"] == [1, 2]
    assert server.byz_stats["nonfinite_rejected"] == 1
