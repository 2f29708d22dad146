"""The engines' logic, held exactly: which client trains from which state,
at which learning rate, for how many epochs, with which proximal pull and
on which track; the sample-weighted aggregation, the personal scatter and
the round's loss. The trainer's ``local_train`` is replaced by a recorder
that returns a known function of its inputs, so nothing here depends on the
float32 trajectory of a real model (which the ``test_torch_fedavg`` and
``test_torch_ditto_local`` parity runs hold at their tolerances), and the
engines run the tiny 3D model at 12x14x12 (the AlexNet at 69^3 goes
through every engine in the pair tests). Also the engine registry and the
CLI (FedAvg at 69^3) on the CPU."""

import json

import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu_torch.__main__ import main
from neuroimagedisttraining_tpu_torch.config import (
    DataConfig, ExperimentConfig, FedConfig, OptimConfig, SparsityConfig,
)
from neuroimagedisttraining_tpu_torch.core.optim import round_lr
from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
from neuroimagedisttraining_tpu_torch.data.federate import (
    build_federated_data,
)
from neuroimagedisttraining_tpu_torch.engines import ENGINES, create_engine
from neuroimagedisttraining_tpu_torch.models import create_model

#: the recorded engines' model and volume (their logic does not depend
#: on the model)
MODEL, SHAPE = "3dcnn_tiny", (12, 14, 12)
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
                 prox_ref=None, perms=None, batch_idx=None, momentum=None):
        self.calls.append(dict(params=params, bstats=bstats, n=int(n_valid),
                               lr=float(lr), epochs=epochs,
                               lamda=prox_lamda, ref=prox_ref, perms=perms,
                               mask=mask, momentum=momentum))
        shift = float(lr) * (epochs + n_valid / 8) + (prox_lamda or 0) * 1e-3
        return ({k: v + shift for k, v in params.items()},
                {k: v + n_valid for k, v in bstats.items()},
                torch.tensor(n_valid / 10, dtype=torch.float32))


def _engine(name, sparsity=None, epochs=2, **fed):
    rng = np.random.default_rng(0)
    X = rng.integers(0, 256, (12,) + SHAPE, dtype=np.uint8)
    y = rng.integers(0, 2, 12).astype(np.int8)
    data = build_federated_data(
        X, y, {c: np.asarray(v, dtype=np.int64) for c, v in TRAIN.items()},
        {c: np.asarray(v, dtype=np.int64) for c, v in TEST.items()}, CPU)
    cfg = ExperimentConfig(
        algorithm=name,
        data=DataConfig(dataset="synthetic", synthetic_shape=SHAPE),
        optim=OptimConfig(batch_size=2, epochs=epochs),
        fed=FedConfig(**{"client_num_in_total": 4, "comm_round": 2,
                         "lamda": 0.25, "local_epochs": 3, **fed}),
        sparsity=SparsityConfig(**(sparsity or {})))
    trainer = LocalTrainer(create_model(MODEL, SHAPE), cfg.optim, CPU,
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
    for ``epochs`` and then the personal track from the client's own model
    for ``local_epochs`` with a fresh pull toward the round's incoming
    global model (``perms_for`` asked with ``track="personal"``). The personal
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
        pairs = [(next(calls), next(calls)) for _ in sampled]
        glob, pers = [g for g, _ in pairs], [p for _, p in pairs]
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


# ---------- Sub-FedAvg ----------

#: thresholds under which every prune is accepted
ACCEPT_ALL = dict(dist_thresh=-1.0, dense_ratio=0.0, acc_thresh=-1.0)


@pytest.mark.parametrize("blocker", [None, "dist_thresh", "dense_ratio",
                                     "acc_thresh"])
def test_subavg_each_accept_condition_blocks(blocker):
    """With thresholds that accept everything, every sampled client with
    rows prunes; raising any one of the three thresholds to 1 (the mask
    distance, the density of the model entering the round, the pruned
    model's training accuracy: none of them passes 1) alone blocks every
    prune, and the personal masks stay all ones."""
    sp = dict(ACCEPT_ALL)
    if blocker:
        sp[blocker] = 1.0
    eng, rec, _ = _engine("subavg", sparsity=sp)
    res = eng.train()
    accepted = [h["prunes_accepted"] for h in res["history"]]
    if blocker is None:
        assert accepted == [2, 2]  # clients 0, 1 (client 2 has no rows)
        assert any(int((m[k] == 0).sum()) for m in res["mask_pers"][:2]
                   for k in m)
    else:
        assert accepted == [0, 0]
        assert all(torch.all(v == 1) for m in res["mask_pers"]
                   for v in m.values())


def test_subavg_one_epoch_never_prunes():
    """With one epoch the two candidate masks are the same one: the mask
    distance is 0 and no prune is accepted, whatever the thresholds (the
    reference's behavior); no tail call is made."""
    eng, rec, tracks = _engine("subavg", sparsity=ACCEPT_ALL | {
        "dist_thresh": 0.0}, epochs=1)
    res = eng.train()
    assert [h["prunes_accepted"] for h in res["history"]] == [0, 0]
    assert [h["mean_mask_dist"] for h in res["history"]] == [0.0, 0.0]
    assert all(call["epochs"] == 1 for call in rec.calls)
    assert {t[2] for t in tracks} == {"first"}


def test_subavg_round_tracks_and_overlap_average():
    """One round from personal masks with zeros: each sampled client trains
    ``w * mask`` for one epoch (``track="first"``) and the tail from that
    result (``track="tail"``), both under its old mask with one shared
    momentum dict. The new global weight is the sum of the uploads (the
    trained weights times m2) over the count of sampled clients with rows
    whose OLD mask keeps it, and the previous value where none does; BN
    stats the plain mean; the masks of the sampled clients with rows
    become their m2, client 2 (sampled, no rows) keeps its mask."""
    from neuroimagedisttraining_tpu_torch.ops.prune import fake_prune

    eng, rec, tracks = _engine("subavg", sparsity=ACCEPT_ALL)
    params, bstats = eng.init_global_state()
    gen = torch.Generator().manual_seed(1)
    masks = []
    for c in range(4):
        m = {k: (torch.rand(v.shape, generator=gen) < 0.7).float()
             if v.dim() >= 2 else torch.ones_like(v)
             for k, v in params.items()}
        m["f1.conv.weight"][0] = 0.0  # no client keeps these
        masks.append(m)
    sampled = np.array([0, 1, 2])
    new_p, new_b, new_masks, outs = eng.run_round(0, params, bstats, masks,
                                                  sampled)
    assert tracks == [(0, c, t) for c in (0, 1, 2)
                      for t in ("first", "tail")]
    ups, bs, m2s = [], [], []
    calls = iter(rec.calls)
    for c in sampled:
        first, tail = next(calls), next(calls)
        w = {k: v * masks[c][k] for k, v in params.items()}
        assert _equal(first["params"], w) and first["epochs"] == 1
        assert first["mask"] is masks[c] and tail["mask"] is masks[c]
        assert first["momentum"] is tail["momentum"] is not None
        assert tail["epochs"] == 1 and _equal(tail["params"], {
            k: v + first["lr"] * (1 + first["n"] / 8) for k, v in w.items()})
        shift = first["lr"] * (1 + first["n"] / 8)
        p2 = {k: v + 2 * shift for k, v in w.items()}
        m2 = fake_prune(0.1, p2, masks[c])
        if len(TRAIN[c]):
            ups.append({k: v * m2[k] for k, v in p2.items()})
            bs.append({k: v + 2 * len(TRAIN[c]) for k, v in bstats.items()})
            m2s.append((c, m2))
    assert next(calls, None) is None
    for k, old in params.items():
        count = sum(masks[c][k] for c in (0, 1))
        want = torch.where(count > 0, sum(u[k] for u in ups)
                           / torch.clamp(count, min=1.0), old)
        torch.testing.assert_close(new_p[k], want, rtol=1e-6, atol=1e-7)
    assert torch.equal(new_p["f1.conv.weight"][0], params["f1.conv.weight"][0])
    for k in bstats:
        torch.testing.assert_close(new_b[k], (bs[0][k] + bs[1][k]) / 2)
    for c, m2 in m2s:
        assert _equal(new_masks[c], m2)
    for c in (2, 3):
        assert new_masks[c] is masks[c]
    assert float(outs[2]) == 2.0  # accepted, over the clients with rows
    assert float(outs[3]) == sum(float(v.sum()) for _, m2 in m2s
                                 for v in m2.values())


# ---------- DisPFL ----------

def test_dispfl_consensus_formula():
    """The consensus against a loop over the graph's rows: per weight the
    neighbours' sum over the count of neighbours whose shared mask keeps
    it (0 where none does), times the client's own mask; BN stats the
    neighbours' mean. An inactive client's row is itself alone, so it
    keeps its own masked model and stats exactly."""
    eng, _, _ = _engine("dispfl")
    params, bstats = eng.init_global_state()
    gen = torch.Generator().manual_seed(2)

    def rand_masks():
        return [{k: (torch.rand(v.shape, generator=gen) < 0.5).float()
                 if v.dim() >= 2 else torch.ones_like(v)
                 for k, v in params.items()} for _ in range(4)]

    shared, local = rand_masks(), rand_masks()
    per_p = [{k: torch.randn(v.shape, generator=gen) for k, v in
              params.items()} for _ in range(4)]
    per_b = [{k: torch.rand(v.shape, generator=gen) for k, v in
              bstats.items()} for _ in range(4)]
    A = np.array([[1, 1, 0, 1], [0, 1, 0, 0], [1, 1, 1, 0], [0, 0, 0, 1]],
                 np.float32)
    w, b = eng.consensus(per_p, per_b, local, shared, A)
    for c in range(4):
        nb = np.flatnonzero(A[c])
        for k in params:
            count = sum(shared[j][k] for j in nb)
            total = sum(per_p[j][k] for j in nb)
            want = torch.where(count > 0, total / torch.clamp(count, min=1),
                               torch.zeros_like(total)) * local[c][k]
            torch.testing.assert_close(w[c][k], want, rtol=1e-6, atol=1e-7)
        for k in bstats:
            torch.testing.assert_close(
                b[c][k], sum(per_b[j][k] for j in nb) / len(nb))
    for k in params:  # client 1: itself alone
        assert torch.equal(w[1][k], per_p[1][k] * shared[1][k]
                           * local[1][k])
    for k in bstats:
        assert torch.equal(b[1][k], per_b[1][k])


def test_dispfl_inactive_client_trains_its_own_model():
    """Under ``--active 0.5`` (round 1: clients 0 and 2 of the 3 with rows
    inactive) every client trains every round, the padding one too; an
    inactive client starts round 1 from its own round-0 result under its
    round-0 and round-1 masks, and its own BN stats, exactly."""
    eng, rec, _ = _engine("dispfl", frac=0.5, active=0.5)
    eng.train()
    assert eng.active_draw(1).tolist() == [False, True, False, False]
    assert len(rec.calls) == 2 * 4
    for c in (0, 2):
        r0, r1 = rec.calls[c], rec.calls[4 + c]
        shift = r0["lr"] * (r0["epochs"] + r0["n"] / 8)
        for k, v in r0["params"].items():
            assert torch.equal(r1["params"][k],
                               (v + shift) * r0["mask"][k] * r1["mask"][k])
        for k, v in r0["bstats"].items():
            assert torch.equal(r1["bstats"][k], v + r0["n"])


@pytest.mark.parametrize("static", [False, True])
def test_dispfl_masks_shared_and_static(static, monkeypatch):
    """A round returns the masks it trained under as the next round's
    shared masks (before evolution) and the evolved ones as the local
    masks: each layer keeps its nonzero count. Every client runs one
    gradient probe a round on ``batch_size`` of its rows; ``--static``
    runs none and keeps the masks."""
    eng, rec, _ = _engine("dispfl", sparsity={"static": static})
    probes = []
    real = eng.trainer.eval_grad
    monkeypatch.setattr(eng.trainer, "eval_grad", lambda p, b, x, y: (
        probes.append(x.shape[0]), real(p, b, x, y))[1])
    params, bstats = eng.init_global_state()
    local, _ = eng.init_masks_all(params)
    per_p = [{k: v * m[k] for k, v in params.items()} for m in local]
    per_b = [dict(bstats) for _ in range(4)]
    A = eng.adjacency(0, eng.active_draw(0))
    _, _, new_local, new_shared, dist, _ = eng.run_round(
        0, per_p, per_b, local, [dict(m) for m in local], A)
    assert all(a is b for a, b in zip(new_shared, local))
    assert float(dist.sum()) == 0.0
    assert probes == ([] if static else [2] * 4)
    for c in range(4):
        for k, m in local[c].items():
            assert int(new_local[c][k].sum()) == int(m.sum()), k
        same = all(torch.equal(new_local[c][k], m)
                   for k, m in local[c].items())
        assert same == static


def test_collapsed_mask_is_reported(caplog):
    """``warn_if_masks_collapsed`` returns each real client's kept entries
    over the maskable leaves and warns, naming the client, where a mask
    kept none (its biases' ones do not count)."""
    eng, _, _ = _engine("subavg")
    params, _ = eng.init_global_state()
    masks = [{k: torch.ones_like(v) for k, v in params.items()}
             for _ in range(4)]
    masks[1] = {k: torch.zeros_like(v) if v.dim() >= 2 else v
                for k, v in masks[1].items()}
    with caplog.at_level("WARNING"):
        nnz = eng.warn_if_masks_collapsed(masks, 3)
    full = sum(v.numel() for v in params.values() if v.dim() >= 2)
    assert nnz.tolist() == [full, 0, full]  # real_clients: the first 3
    assert "round 3: clients [1] have an empty mask" in caplog.text


def test_personal_states_do_not_share_tensors():
    """``broadcast_states`` gives each client tensors of its own."""
    eng, _, _ = _engine("local")
    params, bstats = eng.init_global_state()
    pp, pb = eng.broadcast_states(params, bstats, 3)
    ptrs = [v.data_ptr() for st in pp + pb for v in st.values()]
    assert len(set(ptrs)) == len(ptrs)


def test_create_engine_names():
    """Exactly the reference's twelve algorithm names, its spellings
    ``sailentgrads`` and ``sub-fedavg`` included; a name neither package
    has raises ``ValueError``."""
    assert set(ENGINES) == {"fedavg", "fedprox", "salientgrads",
                            "sailentgrads", "ditto", "local", "subavg",
                            "sub-fedavg", "dispfl", "dpsgd", "fedfomo",
                            "turboaggregate"}
    assert ENGINES["sub-fedavg"] is ENGINES["subavg"]
    with pytest.raises(ValueError, match="unknown algorithm"):
        create_engine("fedbuff", None, None, None)


ARGV = ["--device", "cpu", "--dataset", "synthetic",
        "--synthetic_shape", "69", "69", "69",
        "--synthetic_num_subjects", "8", "--client_num_in_total", "4",
        "--comm_round", "1", "--batch_size", "4", "--epochs", "1",
        "--fused_update"]


#: the JAX package's own CLI recipe: the tiny 3D model at 12x14x12
TINY_ARGV = ["--device", "cpu", "--dataset", "synthetic",
             "--model", "3dcnn_tiny", "--synthetic_shape", "12", "14", "12",
             "--synthetic_num_subjects", "8", "--client_num_in_total", "4",
             "--comm_round", "1", "--batch_size", "4", "--epochs", "1",
             "--fused_update"]


@pytest.mark.parametrize("algorithm", ["fedavg", "fedprox", "ditto", "local",
                                       "subavg", "dispfl"])
def test_cli_runs_each_engine(algorithm, capsys, monkeypatch):
    """The CLI on the CPU: its last line is one JSON object with the
    engine's metrics and no model state or mask; ``mask_density`` is
    SalientGrads' alone. FedAvg drives the flagship model (``3DCNN`` at
    69^3 through the fast stem); the other engines run the tiny model,
    since each engine's numbers at 69^3 are held by its pair test."""
    monkeypatch.setenv("NIDT_FAST_STEM", "1")
    argv = ARGV if algorithm == "fedavg" else TINY_ARGV
    assert main(["--algorithm", algorithm, *argv]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "final_personal" in out and "history" in out
    assert "mask_density" not in out
    assert not {"params", "personal", "personal_params", "masks",
                "mask_pers"} & set(out)


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
        main(ARGV[4:])
