"""Every engine streamed against itself resident, on the CPU. A recording
trainer (its ``local_train``, ``evaluate`` and ``eval_grad``, and
SalientGrads' ``iter_snip_scores``, replaced by recorders that return a
known function of their inputs) must receive the same bytes, call for
call, whether the rows come from the resident stacks or from the streamed
chunks, at chunk sizes 1 and 3; every streamed fetch is one a walk serves
(the walk plan prefetches the next walk's first chunk, and none is
wasted). The recorded engines run the tiny 3D model at 12x14x12 (the
recorder runs no model, so nothing they check depends on it). One real
pair: streamed SalientGrads at 69^3 bit-equal to the resident run; the
CLI on an HDF5 cohort at 69^3 prints the same result resident and
streamed. FedFomo refuses to stream without a validation split, and
D-PSGD skips its every-100-rounds fine-tune under streaming."""

import hashlib
import logging

import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu_torch.config import (
    DataConfig, ExperimentConfig, FedConfig, OptimConfig, SparsityConfig,
)
from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
from neuroimagedisttraining_tpu_torch.data.federate import (
    build_federated_data,
)
from neuroimagedisttraining_tpu_torch.data.stream import StreamingFederation
from neuroimagedisttraining_tpu_torch.engines import create_engine
from neuroimagedisttraining_tpu_torch.engines import salientgrads as SG
from neuroimagedisttraining_tpu_torch.models import create_model

from torch_port_support import torch_threads

SHAPE = (69, 69, 69)
#: the recorded engines' model and volume
REC_MODEL, REC_SHAPE = "3dcnn_tiny", (12, 14, 12)
CPU = torch.device("cpu")
# client 2 holds test and validation rows but no training rows
TRAIN = {0: [0, 1, 2, 3, 4], 1: [5, 6, 7], 2: [], 3: [8, 9]}
TEST = {0: [10], 1: [11], 2: [10, 11], 3: [10]}
VAL = {0: [11], 1: [10], 2: [9], 3: [1]}
ENGINES = ["fedavg", "fedprox", "salientgrads", "ditto", "local", "subavg",
           "dispfl", "dpsgd", "fedfomo", "turboaggregate"]


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.contiguous().numpy().tobytes()).hexdigest()[:16]


class Recorder:
    """Records what reaches the trainer (the bytes of ``X`` and ``y``,
    ``n``, and a digest of the model it is given) and returns known
    functions of it."""

    def __init__(self, trainer):
        self.calls = []
        trainer.local_train = self.local_train
        trainer.evaluate = self.evaluate
        trainer.eval_grad = self.eval_grad

    def note(self, what, params, X, y, n):
        self.calls.append((what, _digest(X), _digest(y), int(n),
                           float(sum(v.double().sum() for v in
                                     params.values()))))

    @staticmethod
    def level(X):
        return float(X.to(torch.float32).mean()) / 256

    def local_train(self, params, bstats, X, y, n_valid, lr, epochs,
                    batch_size, max_samples, **kw):
        self.note("local_train", params, X, y, n_valid)
        shift = float(lr) * (epochs + n_valid / 8) + self.level(X) * 1e-3
        return ({k: v + shift for k, v in params.items()},
                {k: v + n_valid for k, v in bstats.items()},
                torch.tensor(n_valid / 10 + self.level(X),
                             dtype=torch.float32))

    def evaluate(self, params, bstats, X, y, valid, batch_size=32):
        self.note("evaluate", params, X, y, int(valid.sum()))
        v = valid.to(torch.float32)
        scores = X.reshape(X.shape[0], -1)[:, :64].to(torch.float32).mean(1)
        return {"test_correct": torch.sum((scores > 120) * v),
                "test_loss": torch.sum(scores * v) / 256,
                "test_total": torch.sum(v), "scores": scores - 120}

    def eval_grad(self, params, bstats, x, y):
        self.note("eval_grad", params, x, y, len(x))
        return {k: v * (1 + self.level(x)) for k, v in params.items()}

    def snip(self, trainer, params, bstats, X, y, n_valid, *a, **kw):
        self.note("iter_snip_scores", params, X, y, n_valid)
        return {k: torch.abs(v) * (1 + self.level(X))
                for k, v in params.items()}


def _cohort():
    rng = np.random.default_rng(0)
    X = rng.integers(0, 256, (12,) + REC_SHAPE, dtype=np.uint8)
    y = rng.integers(0, 2, 12).astype(np.int8)
    maps = [{c: np.asarray(v, np.int64) for c, v in m.items()}
            for m in (TRAIN, TEST, VAL)]
    return X, y, maps


def _cfg(name, chunk=0, **fed):
    return ExperimentConfig(
        algorithm=name, stream_chunk_clients=chunk,
        data=DataConfig(dataset="synthetic", synthetic_shape=REC_SHAPE),
        optim=OptimConfig(batch_size=2, epochs=2),
        fed=FedConfig(**{"client_num_in_total": 4, "comm_round": 2,
                         "frac": 0.75, "lamda": 0.25, "local_epochs": 1,
                         **fed}),
        sparsity=SparsityConfig(dist_thresh=-1.0, acc_thresh=-1.0,
                                dense_ratio=0.5))


def _run(name, chunk, monkeypatch, init_state=None, **fed):
    """The engine's ``train(init_state)`` on the recorder, resident
    (``chunk`` None) or streamed at ``chunk`` clients: ``(calls, engine,
    result)``."""
    X, y, (tr, te, va) = _cohort()
    cfg = _cfg(name, chunk or 0, **fed)
    trainer = LocalTrainer(create_model(REC_MODEL, REC_SHAPE), cfg.optim,
                           CPU, torch.Generator().manual_seed(0))
    rec = Recorder(trainer)
    monkeypatch.setattr(SG, "iter_snip_scores", rec.snip)
    val = va if name == "fedfomo" else None
    if chunk is None:
        eng = create_engine(name, cfg, build_federated_data(
            X, y, tr, te, CPU, val_map=val), trainer)
    else:
        stream = StreamingFederation(X, y, tr, te, val_map=val, device="cpu")
        eng = create_engine(name, cfg, None, trainer, stream=stream)
        take = stream._take
        stream.served = 0

        def counted(key):
            stream.served += 1
            return take(key)

        stream._take = counted
    result = eng.train(init_state=init_state)
    return rec.calls, eng, result


@pytest.mark.parametrize("name", ENGINES)
def test_streamed_engine_feeds_the_resident_bytes(name, monkeypatch):
    """Call for call the same bytes, counts and models, and the same
    history; every fetch is served to a walk (none is wasted)."""
    # the sparse engines sort every weight a client: one round of theirs
    # keeps the file's time down; the other engines cross a round boundary
    kw = {"comm_round": 1} if name in ("subavg", "dispfl") else {}
    with torch_threads(2):
        calls, _, res = _run(name, None, monkeypatch, **kw)
        assert {c[0] for c in calls} >= {"local_train", "evaluate"}
        for chunk in (1, 3):
            got, eng, sres = _run(name, chunk, monkeypatch, **kw)
            assert got == calls, chunk
            assert _untimed(sres["history"]) == _untimed(res["history"])
            eng.stream.sync()
            assert eng.stream.transfer_stats["fetches"] == eng.stream.served
            eng.stream.close()


def _untimed(history):
    return [{k: v for k, v in h.items() if not k.endswith("_seconds")}
            for h in history]


def test_fedfomo_streaming_needs_a_validation_split():
    X, y, (tr, te, _) = _cohort()
    cfg = _cfg("fedfomo")
    trainer = LocalTrainer(create_model(REC_MODEL, REC_SHAPE), cfg.optim,
                           CPU, torch.Generator().manual_seed(0))
    stream = StreamingFederation(X, y, tr, te, device="cpu")
    with pytest.raises(ValueError, match="FedFomo streaming requires a val"):
        create_engine("fedfomo", cfg, None, trainer, stream=stream)
    stream.close()


def test_dpsgd_skips_its_finetune_when_streamed(monkeypatch, caplog):
    """At ``comm_round 100`` the resident run fine-tunes every client from
    the global model after round 99 (``round_lr(-1)``); the streamed run
    makes every other call the same and logs the skip once. The state is
    two small leaves (the recorder runs no model), so 100 rounds are
    cheap."""
    gen = torch.Generator().manual_seed(3)
    small = ({"w": torch.randn(3, 4, generator=gen),
              "b": torch.randn(4, generator=gen)},
             {"mean": torch.randn(4, generator=gen)})
    with torch_threads(2), caplog.at_level(logging.INFO):
        kw = dict(comm_round=100, frequency_of_the_test=1000,
                  init_state=small)
        res, _, _ = _run("dpsgd", None, monkeypatch, **kw)
        caplog.clear()
        got, eng, _ = _run("dpsgd", 2, monkeypatch, **kw)
    # resident: 400 round steps, 8 evaluations after rounds 0 and 99, the
    # fine-tune's 4 steps and their 4 evaluations, the final 4
    assert len(res) == 400 + 16 + 8 + 4
    ft = res[416:424]
    assert [c[0] for c in ft] == ["local_train"] * 4 + ["evaluate"] * 4
    assert got == res[:416] + res[424:]
    skips = [r for r in caplog.records if "skipping the every-100" in
             r.getMessage()]
    assert len(skips) == 1
    eng.stream.close()


def test_streamed_salientgrads_is_bit_equal_to_resident(monkeypatch):
    """The real SalientGrads slice at 69^3 through the CLI's
    ``build_experiment`` (``--fused_update``, ``NIDT_FAST_STEM=1``; the
    plain paths on the CPU), 2 rounds, resident and streamed a client a
    chunk: the same mask, final weights, personal models and metrics, bit
    for bit."""
    import argparse

    from neuroimagedisttraining_tpu_torch.__main__ import (
        add_args, build_experiment, config_from_args,
    )

    monkeypatch.setenv("NIDT_FAST_STEM", "1")
    argv = ["--algorithm", "salientgrads", "--dataset", "synthetic",
            "--synthetic_shape", "69", "69", "69",
            "--synthetic_num_subjects", "16", "--client_num_in_total", "4",
            "--comm_round", "2", "--batch_size", "4", "--epochs", "1",
            "--frac", "0.75", "--fused_update", "--stream_chunk_clients",
            "1"]
    cfg = config_from_args(add_args(argparse.ArgumentParser())
                           .parse_args(argv))
    with torch_threads(2):
        res_eng, _ = build_experiment(cfg, "cpu")
        res = res_eng.train()
        st_eng, _ = build_experiment(cfg, "cpu", streaming=True)
        st = st_eng.train()
        st_eng.stream.close()

    def bits(a, b):
        return a.keys() == b.keys() and all(
            torch.equal(a[k], b[k]) for k in a)

    assert bits(res["masks"], st["masks"])
    assert bits(res["params"], st["params"])
    assert bits(res["batch_stats"], st["batch_stats"])
    assert all(bits(a, b) for a, b in zip(res["per_params"],
                                          st["per_params"]))
    assert _untimed(res["history"]) == _untimed(st["history"])
    assert res["final_global"] == st["final_global"]
    assert res["final_personal"] == st["final_personal"]
    assert st_eng.stream.transfer_stats["fetches"] > 0


def test_cli_on_an_hdf5_cohort_resident_and_streamed(tmp_path, capsys,
                                                     monkeypatch):
    """``--dataset abcd_h5`` through the CLI's ``main``, resident and
    ``--streaming`` (2 clients a chunk): the same printed result, and the
    streamed run closes its HDF5 file."""
    import json

    import h5py

    from neuroimagedisttraining_tpu_torch.__main__ import main
    from neuroimagedisttraining_tpu_torch.data.synthetic import (
        write_synthetic_hdf5,
    )

    path = str(tmp_path / "cohort.h5")
    write_synthetic_hdf5(path, num_subjects=10, shape=SHAPE, num_sites=4,
                         seed=0)
    monkeypatch.setenv("NIDT_FAST_STEM", "1")
    argv = ["--dataset", "abcd_h5", "--data_dir", path, "--device", "cpu",
            "--client_num_in_total", "4", "--comm_round", "1",
            "--batch_size", "4", "--epochs", "1", "--frac", "0.75"]
    outs = []
    with torch_threads(2):
        for extra in ([], ["--streaming", "--stream_chunk_clients", "2"]):
            assert main(argv + extra) == 0
            out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            outs.append({k: v for k, v in out.items()
                         if not k.endswith("_seconds")})
    assert outs[0] == outs[1] and len(outs[0]["history"]) == 1
    with h5py.File(path, "r+"):  # no handle left open by the runs
        pass
