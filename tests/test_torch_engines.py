"""The engines' logic, held exactly: which client trains from which state,
at which learning rate, for how many epochs, with which proximal pull and
on which track; the sample-weighted aggregation, the personal scatter and
the round's loss. The trainer's ``local_train`` is replaced by a recorder
that returns a known function of its inputs, so nothing here depends on the
float32 trajectory of a real model (which the ``test_torch_fedavg`` and
``test_torch_ditto_local`` parity runs hold at their tolerances). Also the
engine registry and the CLI at 69^3 on the CPU."""

import json

import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu_torch.__main__ import main
from neuroimagedisttraining_tpu_torch.config import (
    DataConfig, ExperimentConfig, FedConfig, OptimConfig,
)
from neuroimagedisttraining_tpu_torch.core.optim import round_lr
from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
from neuroimagedisttraining_tpu_torch.data.federate import (
    build_federated_data,
)
from neuroimagedisttraining_tpu_torch.engines import ENGINES, create_engine
from neuroimagedisttraining_tpu_torch.models import create_model

SHAPE = (69, 69, 69)
CPU = torch.device("cpu")
# client 2 holds test rows but no training rows
TRAIN = {0: [0, 1, 2, 3, 4], 1: [5, 6, 7], 2: [], 3: [8, 9]}
TEST = {0: [10], 1: [11], 2: [10, 11], 3: [10]}


class Recorder:
    """Stands in for ``LocalTrainer.local_train``: records each call and
    returns ``params + lr * (epochs + n_valid / 8)`` (plus, under a pull,
    ``lamda * 1e-3``), BN stats ``+ n_valid``, and loss ``n_valid / 10``."""

    def __init__(self):
        self.calls = []

    def __call__(self, params, bstats, X, y, n_valid, lr, epochs,
                 batch_size, max_samples, mask=None, prox_lamda=None,
                 prox_ref=None, perms=None, batch_idx=None):
        self.calls.append(dict(params=params, bstats=bstats, n=int(n_valid),
                               lr=float(lr), epochs=epochs,
                               lamda=prox_lamda, ref=prox_ref, perms=perms))
        shift = float(lr) * (epochs + n_valid / 8) + (prox_lamda or 0) * 1e-3
        return ({k: v + shift for k, v in params.items()},
                {k: v + n_valid for k, v in bstats.items()},
                torch.tensor(n_valid / 10, dtype=torch.float32))


def _engine(name, **fed):
    rng = np.random.default_rng(0)
    X = rng.integers(0, 256, (12,) + SHAPE, dtype=np.uint8)
    y = rng.integers(0, 2, 12).astype(np.int8)
    data = build_federated_data(
        X, y, {c: np.asarray(v, dtype=np.int64) for c, v in TRAIN.items()},
        {c: np.asarray(v, dtype=np.int64) for c, v in TEST.items()}, CPU)
    cfg = ExperimentConfig(
        algorithm=name, data=DataConfig(synthetic_shape=SHAPE),
        optim=OptimConfig(batch_size=2, epochs=2),
        fed=FedConfig(**{"client_num_in_total": 4, "comm_round": 2,
                         "lamda": 0.25, "local_epochs": 3, **fed}))
    trainer = LocalTrainer(create_model("3dcnn", SHAPE), cfg.optim, CPU,
                           torch.Generator().manual_seed(0))
    tracks = []
    eng = create_engine(name, cfg, data, trainer,
                        perms_for=lambda r, c, n, track="global":
                        tracks.append((r, c, track)))
    rec = Recorder()
    trainer.local_train = rec
    return eng, rec, tracks


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _mean(states, weights):
    w = torch.tensor(weights, dtype=torch.float32)
    w = w / w.sum()
    return {k: sum(s[k] * wi for s, wi in zip(states, w)) for k in states[0]}


@pytest.mark.parametrize("name", ["fedavg", "fedprox"])
def test_fedavg_rounds_and_finetune(name):
    """Each round the sampled clients (2 of the first 3, the reference's
    ``np.random.seed(round)`` draw over ``real_clients``) train from the
    round's global model at ``round_lr(round)`` for ``epochs``; FedProx pulls
    toward that incoming model with ``lamda``. The new global model is the
    sample-weighted mean of the uploads. After the last round every client
    fine-tunes the aggregate at ``round_lr(-1)`` (``perms_for`` asked for
    round ``comm_round``)."""
    eng, rec, tracks = _engine(name, frac=0.5)
    res = eng.train()
    cfg = eng.cfg
    params, bstats = eng.init_global_state()
    calls = iter(rec.calls)
    for r in range(cfg.fed.comm_round):
        sampled = eng.client_sampling(r)
        assert len(sampled) == 2  # int(4 * 0.5) of range(real_clients)
        ups = []
        for c in sampled:
            call = next(calls)
            assert _equal(call["params"], params) and call["n"] == \
                len(TRAIN[c])
            assert call["lr"] == float(round_lr(cfg.optim, r, CPU))
            assert call["epochs"] == cfg.optim.epochs
            if name == "fedprox":
                assert call["lamda"] == cfg.fed.lamda
                assert _equal(call["ref"], params)
            else:
                assert call["lamda"] is None
            ups.append(call)
        shift = [u["lr"] * (u["epochs"] + u["n"] / 8)
                 + (u["lamda"] or 0) * 1e-3 for u in ups]
        want = _mean([{k: v + s for k, v in params.items()} for s in shift],
                     [len(TRAIN[c]) for c in sampled])
        params = want
        bstats = _mean([{k: v + len(TRAIN[c]) for k, v in bstats.items()}
                        for c in sampled], [len(TRAIN[c]) for c in sampled])
        assert res["history"][r]["train_loss"] == pytest.approx(
            sum(len(TRAIN[c]) ** 2 / 10 for c in sampled)
            / sum(len(TRAIN[c]) for c in sampled), rel=1e-6)
    for k, v in params.items():
        torch.testing.assert_close(res["params"][k], v, rtol=1e-6, atol=1e-7)
    for c in range(eng.num_clients):
        call = next(calls)
        torch.testing.assert_close(call["params"], res["params"], rtol=0,
                                   atol=0)
        assert call["lr"] == float(round_lr(cfg.optim, -1, CPU))
        assert call["lamda"] is None and call["epochs"] == cfg.optim.epochs
        assert call["n"] == len(TRAIN[c])
    assert next(calls, None) is None
    assert tracks[-4:] == [(2, c, "global") for c in range(4)]
    assert res["finetune_seconds"] >= 0 and len(res["round_seconds"]) == 2


def test_ditto_tracks():
    """Per sampled client, the global track from the round's global model
    for ``epochs`` and the personal track from the client's own model for
    ``local_epochs`` with a fresh pull toward the round's incoming global
    model (``perms_for`` asked with ``track="personal"``). The personal
    results replace the sampled clients' models, the others keep theirs.
    The reference samples among the first ``real_clients`` indices, so
    client 2 (no rows) is sampled: it weighs 0 and keeps its model."""
    eng, rec, tracks = _engine("ditto")
    res = eng.train()
    cfg = eng.cfg
    params, _ = eng.init_global_state()
    per = [dict(params) for _ in range(4)]
    calls = iter(rec.calls)
    for r in range(cfg.fed.comm_round):
        sampled = eng.client_sampling(r)
        assert list(sampled) == [0, 1, 2]  # range(real_clients)
        glob = [next(calls) for _ in sampled]
        pers = [next(calls) for _ in sampled]
        for c, g, p in zip(sampled, glob, pers):
            assert _equal(g["params"], params) and g["epochs"] == \
                cfg.optim.epochs and g["lamda"] is None
            assert _equal(p["params"], per[c])
            assert p["epochs"] == cfg.fed.local_epochs
            assert p["lamda"] == cfg.fed.lamda and _equal(p["ref"], params)
            assert p["lr"] == g["lr"] == float(round_lr(cfg.optim, r, CPU))
            shift = p["lr"] * (p["epochs"] + p["n"] / 8) + p["lamda"] * 1e-3
            per[c] = {k: v + shift for k, v in per[c].items()} if p["n"] \
                else per[c]
        shift = [g["lr"] * (g["epochs"] + g["n"] / 8) for g in glob]
        params = _mean([{k: v + s for k, v in params.items()}
                        for s in shift], [g["n"] for g in glob])
    assert next(calls, None) is None
    assert [t for t in tracks if t[2] == "personal"] == [
        (r, c, "personal") for r in range(2) for c in range(3)]
    for c in range(4):
        for k, v in per[c].items():
            torch.testing.assert_close(res["personal_params"][c][k], v,
                                       rtol=1e-6, atol=1e-7)


def test_local_trains_every_client_with_rows():
    """Every client with rows trains its own model every round for
    ``epochs``; the client without rows takes no step and weighs 0 in the
    round's sample-weighted loss."""
    eng, rec, _ = _engine("local")
    res = eng.train()
    params, _ = eng.init_global_state()
    per = [dict(params) for _ in range(4)]
    calls = iter(rec.calls)
    for r in range(eng.cfg.fed.comm_round):
        for c in (0, 1, 3):
            call = next(calls)
            assert _equal(call["params"], per[c]) and call["lamda"] is None
            per[c] = {k: v + call["lr"] * (call["epochs"] + call["n"] / 8)
                      for k, v in per[c].items()}
        assert res["history"][r]["train_loss"] == pytest.approx(
            (25 + 9 + 4) / 10 / 10, rel=1e-6)
    assert next(calls, None) is None
    for c in range(4):
        for k, v in per[c].items():
            torch.testing.assert_close(res["personal_params"][c][k], v,
                                       rtol=1e-6, atol=1e-7)


def test_personal_states_do_not_share_tensors():
    """``broadcast_states`` gives each client tensors of its own."""
    eng, _, _ = _engine("local")
    params, bstats = eng.init_global_state()
    pp, pb = eng.broadcast_states(params, bstats, 3)
    ptrs = [v.data_ptr() for st in pp + pb for v in st.values()]
    assert len(set(ptrs)) == len(ptrs)


def test_create_engine_names():
    """The reference's algorithm names that the port has, its spelling
    ``sailentgrads`` included; an unknown name raises ``ValueError``."""
    assert set(ENGINES) == {"fedavg", "fedprox", "salientgrads",
                            "sailentgrads", "ditto", "local"}
    with pytest.raises(ValueError, match="unknown algorithm"):
        create_engine("dispfl", None, None, None)


ARGV = ["--device", "cpu", "--synthetic_shape", "69", "69", "69",
        "--synthetic_num_subjects", "8", "--client_num_in_total", "4",
        "--comm_round", "1", "--batch_size", "4", "--epochs", "1",
        "--fused_update"]


@pytest.mark.parametrize("algorithm", ["fedavg", "fedprox", "ditto", "local"])
def test_cli_runs_each_engine(algorithm, capsys, monkeypatch):
    """The CLI on the CPU: its last line is one JSON object with the
    engine's metrics and no model state; ``mask_density`` is
    SalientGrads' alone."""
    monkeypatch.setenv("NIDT_FAST_STEM", "1")
    assert main(["--algorithm", algorithm, *ARGV]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "final_personal" in out and "history" in out
    assert "mask_density" not in out
    assert not {"params", "personal", "personal_params"} & set(out)


def test_cli_default_is_fedavg_and_cuda(monkeypatch):
    """``--algorithm`` defaults to fedavg and ``--device`` to cuda, which
    raises where there is no CUDA device (no fallback to the CPU)."""
    from neuroimagedisttraining_tpu_torch.__main__ import add_args
    import argparse

    args = add_args(argparse.ArgumentParser()).parse_args([])
    assert args.algorithm == "fedavg" and args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(ARGV[2:])
