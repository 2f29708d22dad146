"""Every engine of the port runs every model of its 3D zoo: the CLI on the
CPU (plain kernel versions, ``--fused_update`` and ``NIDT_FAST_STEM=1``),
one round of 4 site clients, for each of the reference's 12 algorithm
names and each model beside the flagship (test_torch_engines.py runs the
flagship): the GroupNorm model's empty ``batch_stats`` through every
aggregation, ResNet3D's and the deeper model's (logits, aux) outputs and
31 and 28 leaves, the regression model's squeezed logits, Tiny3DCNN's one
dropout. The reference's two alias names (``sailentgrads``, ``sub-fedavg``)
build through the CLI to their engine's class, which its own case trains.
Each run must end in finite losses and metrics; engine logic and
parity are held elsewhere (test_torch_engines.py, the engine-pair files,
test_torch_zoo.py)."""

import argparse
import json
import math

import pytest

from neuroimagedisttraining_tpu_torch.__main__ import (
    add_args, build_experiment, config_from_args, main,
)
from neuroimagedisttraining_tpu_torch.engines import ENGINES

from torch_port_support import torch_threads

#: each model at the smallest volume it takes (the AlexNet family needs
#: 69^3 for its stem and three stride-3 pools)
MODELS = {"3dcnn_gn": (69, 69, 69), "3dcnn_deeper": (69, 69, 69),
          "3dcnn_regression": (69, 69, 69), "resnet3d": (29, 29, 29),
          "3dcnn_tiny": (12, 14, 12)}
#: the flags an engine needs beyond the shared ones (as chip_smoke.py's)
EXTRA = {"dispfl": ["--frac", "0.5"], "dpsgd": ["--frac", "0.5"],
         "fedfomo": ["--frac", "0.5", "--val_fraction", "0.2"],
         "turboaggregate": ["--frac", "0.75"],
         "subavg": ["--dist_thresh", "0", "--acc_thresh", "0"],
         "sub-fedavg": ["--dist_thresh", "0", "--acc_thresh", "0"]}


#: the reference's alias names and the engine each resolves to
ALIASES = {"sailentgrads": "salientgrads", "sub-fedavg": "subavg"}


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("algorithm", sorted(ENGINES))
def test_engine_runs_model(algorithm, model, capsys, monkeypatch):
    """Each engine class trains each model once through the CLI; an alias
    name parses and builds through the CLI to the very engine class of the
    name it stands for (whose case ran the model), with its flags, and is
    not trained again."""
    monkeypatch.setenv("NIDT_FAST_STEM", "1")
    shape = MODELS[model]
    argv = ["--algorithm", algorithm, "--model", model, "--device", "cpu",
            "--dataset", "synthetic", "--synthetic_shape", *map(str, shape),
            "--synthetic_num_subjects", "10", "--client_num_in_total", "4",
            "--comm_round", "1", "--batch_size", "2", "--epochs", "1",
            "--fused_update", *EXTRA.get(algorithm, [])]
    if algorithm in ALIASES:
        args = add_args(argparse.ArgumentParser()).parse_args(argv)
        engine, _ = build_experiment(config_from_args(args), "cpu")
        assert type(engine) is ENGINES[ALIASES[algorithm]]
        assert engine.cfg.algorithm == algorithm
        assert engine.sample_shape == shape
        return
    with torch_threads(2):
        assert main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    final = out.get("final_personal") or out["final_global"]
    values = [h["train_loss"] for h in out["history"]] + [
        final[m] for m in ("acc", "loss", "auc")]
    assert all(math.isfinite(v) for v in values), values
