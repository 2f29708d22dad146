"""The port's experiment log file (``utils/logging.py``, the engines'
announcements, ``ExperimentConfig.to_json``) against the reference
package's.

- ``to_json`` equal to the reference's string for 3 configurations
  parsed by both CLIs from one command line.
- The port's CLI writes the config line first, then the partition and
  the engine's announcements (the wire-codec fallback of a K = 2 run).
- The reference's observable cases, read from the log file as the
  reference's tests read it: an empty mask's warning, the streaming and
  FedFomo fallbacks to one round a dispatch, a checkpoint's save and
  resume.
- A second logger of one identity does not duplicate lines; ``console=
  False`` writes nothing to stdout, the default echoes each line.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu import __main__ as RMAIN
from neuroimagedisttraining_tpu_torch import __main__ as PMAIN
from neuroimagedisttraining_tpu_torch.utils.logging import ExperimentLogger

from torch_port_support import torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (12, 14, 12)
TINY = ["--dataset", "synthetic", "--model", "3dcnn_tiny",
        "--synthetic_shape", "12", "14", "12", "--synthetic_num_subjects",
        "16", "--client_num_in_total", "4", "--batch_size", "4", "--epochs",
        "1"]


def _cfgs(argv):
    ref = RMAIN.config_from_args(
        RMAIN.add_args(argparse.ArgumentParser()).parse_args(argv))
    port = PMAIN.config_from_args(
        PMAIN.add_args(argparse.ArgumentParser()).parse_args(argv))
    return ref, port


@pytest.mark.parametrize("argv", [
    ["--log_dir", "LOG"],
    ["--log_dir", "/tmp/x", "--algorithm", "salientgrads", "--model",
     "3dcnn_tiny", "--frac", "0.5", "--dense_ratio", "0.3", "--tag", "t1",
     "--rounds_per_dispatch", "4", "--wire_codec", "delta+quant"],
    ["--log_dir", "L", "--algorithm", "dispfl", "--precision", "bf16_mixed",
     "--mesh_shape", "2", "2", "--fault_spec", "crash:3@1",
     "--defense_type", "weak_dp", "--checkpoint_dir", "ck",
     "--checkpoint_every", "2", "--health_stats"],
])
def test_to_json_equals_reference(argv):
    ref, port = _cfgs(argv)
    assert port.to_json() == ref.to_json()
    assert port.identity() == ref.identity()
    # a port-only field shows where it is set
    assert "virtual_devices" in dataclasses.replace(
        port, virtual_devices=2).to_json()


def test_cli_log_starts_with_the_config_line(tmp_path):
    argv = [*TINY, "--comm_round", "2", "--rounds_per_dispatch", "2",
            "--wire_codec", "delta+quant", "--log_dir", str(tmp_path)]
    out = subprocess.run(
        [sys.executable, "-m", "neuroimagedisttraining_tpu_torch", *argv,
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    ref, _ = _cfgs(argv)
    (log,) = (tmp_path / "synthetic").glob("*.log")
    assert log.name == ref.identity() + ".log"
    lines = log.read_text().splitlines()
    assert lines[0] == "config: " + ref.to_json()
    text = "\n".join(lines)
    assert "dispatching one round at a time" in text
    assert "wire_codec" in text
    assert any(ln.startswith("partition: ") for ln in lines)
    assert "round 1 metrics:" in text
    # the console echo: each line once on stdout, the result JSON last
    assert out.stdout.count("config: ") == 1
    assert json.loads(out.stdout.splitlines()[-1])["history"]


def _engine(tmp_path, name, K=1, streamed=False, val_fraction=0.0,
            top=None, **fed):
    from neuroimagedisttraining_tpu_torch.config import (
        DataConfig, ExperimentConfig, FedConfig, OptimConfig,
    )

    f = dict(client_num_in_total=4, comm_round=1, frequency_of_the_test=1,
             rounds_per_dispatch=K)
    f.update(fed)
    cfg = ExperimentConfig(
        model="3dcnn_tiny", algorithm=name, log_dir=str(tmp_path),
        tag=f"{name}_k{K}", data=DataConfig(
            dataset="synthetic", synthetic_shape=SHAPE,
            synthetic_num_subjects=32, val_fraction=val_fraction),
        optim=OptimConfig(batch_size=4), fed=FedConfig(**f),
        stream_chunk_clients=2, **(top or {}))
    with torch_threads(2):
        eng, _ = PMAIN.build_experiment(cfg, "cpu", streaming=streamed)
    return eng


def _log_text(eng) -> str:
    with open(eng.log.log_path) as f:
        return f.read()


def test_warn_if_masks_collapsed_flags_empty_mask(tmp_path):
    eng = _engine(tmp_path, "fedavg")
    ones = {k: torch.ones_like(p)
            for k, p in eng.trainer.model.named_parameters()}
    masks = [ones, ones, {k: torch.zeros_like(v) for k, v in ones.items()},
             ones]
    nnz = eng.warn_if_masks_collapsed(masks, round_idx=3)
    assert nnz[2] == 0 and (nnz[[0, 1, 3]] > 0).all()
    text = _log_text(eng)
    assert "EMPTY mask" in text and "[2]" in text


def test_streaming_falls_back_with_logged_reason(tmp_path):
    eng = _engine(tmp_path, "salientgrads", K=4, streamed=True)
    try:
        text = _log_text(eng)
    finally:
        eng.stream.close()
    assert "dispatching one round at a time" in text
    assert "streaming" in text


def test_fedfomo_falls_back_with_logged_reason(tmp_path):
    eng = _engine(tmp_path, "fedfomo", K=4, val_fraction=0.25)
    assert "dispatching one round at a time" in _log_text(eng)


def test_checkpoint_save_and_resume_lines(tmp_path):
    top = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    with torch_threads(2):
        _engine(tmp_path, "fedavg", comm_round=2, top=top).train()
        # the same identity: its lines follow the first run's in the file
        eng = _engine(tmp_path, "fedavg", comm_round=2, top=top)
        eng.train()
    text = _log_text(eng)
    assert "checkpoint saved: round 0" in text
    assert "checkpoint saved: round 1" in text
    assert "resuming from checkpoint: round 2" in text


def test_second_logger_does_not_duplicate(tmp_path):
    a = ExperimentLogger(str(tmp_path), "ds", "ident", console=False)
    a.info("first %d", 1)
    b = ExperimentLogger(str(tmp_path), "ds", "ident", console=False)
    b.info("second")
    a.warning("third")
    b.metrics(0, loss=np.float32(0.5))
    b.close()
    assert open(b.log_path).read().splitlines() == [
        "first 1", "second", "third", "round 0 metrics: {'loss': 0.5}"]


def test_console_echo(tmp_path, capsys):
    ExperimentLogger(str(tmp_path), "ds", "quiet", console=False).info("q")
    assert capsys.readouterr().out == ""
    loud = ExperimentLogger(str(tmp_path), "ds", "loud")
    loud.info("echo %s", "me")
    loud.close()
    assert capsys.readouterr().out == "echo me\n"
