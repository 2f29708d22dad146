"""The dispatch-boundary profiler of the port (``obs/compute.py``) against
the reference package's.

- The boundary math: the same arms, dispatches and clock give the
  reference's MFU, sustained TFLOP/s, gauges and ``/healthz`` block,
  exactly (host float arithmetic).
- The peak table by device kind and precision (the vendor's H100 figures)
  and its overrides (``NIDT_PEAK_FLOPS``, ``--peak_flops``); a CPU engine
  publishes TFLOP/s without a peak, and MFU with one given.
- Captures count in ``nidt_compiles_total`` as ``RoundProgram.built``
  does; graph replays and rounds land in ``nidt_dispatch_ms``.
- The FLOP counter on ``3dcnn_tiny``: its count of one training step is
  ``FlopCounterMode``'s, the analytic count is the reference's, and their
  ratio (0.78 on this model: the backward skips the first convolution's
  input gradient, which the analytic 3x convention counts) is recorded.
"""

import argparse

import pytest
import torch

from neuroimagedisttraining_tpu.obs import compute as jcompute
from neuroimagedisttraining_tpu.obs import metrics as jmetrics
from neuroimagedisttraining_tpu_torch.obs import compute as pcompute
from neuroimagedisttraining_tpu_torch.obs import metrics as pmetrics
from neuroimagedisttraining_tpu_torch.obs import names as N
from torch_port_support import torch_threads


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _drive(mod, metrics_mod, clock, monkeypatch):
    monkeypatch.setattr(mod.time, "monotonic", clock)
    metrics_mod.REGISTRY.reset()
    prof = mod.ComputeProfiler()
    out = []
    prof.arm_model("fedavg", 2.5e12, peak_flops=1e14)
    out.append(prof.boundary("fedavg"))  # an empty window
    prof.note_dispatch("fedavg", "round", 0.02, rounds=1, phase="compile")
    prof.note_dispatch("fedavg", "window", 0.003, rounds=3)
    prof.note_dispatch("other", "round", 0.5, rounds=7)
    clock.t += 0.8
    out.append(prof.boundary("fedavg"))
    out.append(prof.boundary("other"))
    prof.note_compile("fedavg", "step")
    prof.note_compile("fedavg", "step", recompile=True)
    prof.set_peak_flops(5e13)
    prof.arm_model("fedavg", 1e12)
    prof.note_dispatch("fedavg", "round", 0.001, rounds=2)
    clock.t += 0.25
    out.append(prof.boundary("fedavg"))
    snap = metrics_mod.REGISTRY.snapshot()
    keep = (N.MFU, N.SUSTAINED_TFLOPS, N.RECOMPILES_TOTAL, N.DISPATCH_MS)
    return out, prof.health(), {k: snap[k]["values"] for k in keep}


def test_boundary_math_matches_the_reference(monkeypatch):
    j = _drive(jcompute, jmetrics, Clock(), monkeypatch)
    p = _drive(pcompute, pmetrics, Clock(), monkeypatch)
    assert p == j
    mfus = p[0]
    assert mfus[0] is None and mfus[2] is None
    assert mfus[1] == pytest.approx(4 * 2.5e12 / 0.8 / 1e14)
    assert mfus[3] == pytest.approx(2 * 1e12 / 0.25 / 5e13)
    assert p[1]["last_sustained_tflops"] == pytest.approx(8.0)
    assert p[1]["compiles"] == 2 and p[1]["recompiles"] == 1


def _samples(mod, metrics_mod, clock, monkeypatch):
    """A boundary's sample, then ``clear_samples`` and the next boundary,
    each read through ``snapshot``."""
    monkeypatch.setattr(mod.time, "monotonic", clock)
    metrics_mod.REGISTRY.reset()
    prof = mod.ComputeProfiler()
    prof.arm_model("fedavg", 2.5e12, peak_flops=1e14)
    prof.note_compile("fedavg", "step")
    prof.note_dispatch("fedavg", "round", 0.02, rounds=2, phase="compile")
    clock.t += 0.5
    prof.boundary("fedavg")
    out = [prof.snapshot()]
    prof.clear_samples()
    out.append(prof.snapshot())
    prof.note_dispatch("fedavg", "round", 0.01, rounds=1)
    clock.t += 0.25
    prof.boundary("fedavg")
    out.append(prof.snapshot())
    return out


def test_clear_samples_and_snapshot_match_the_reference(monkeypatch):
    """``clear_samples`` drops the last MFU and TFLOP/s samples and keeps
    the arm and the counts; ``snapshot`` is ``health`` without the
    dispatch's age: both as the reference's."""
    p = _samples(pcompute, pmetrics, Clock(), monkeypatch)
    j = _samples(jcompute, jmetrics, Clock(), monkeypatch)
    assert p == j
    first, cleared, after = p
    assert "last_dispatch_age_s" not in first
    assert first["last_mfu"] == pytest.approx(2 * 2.5e12 / 0.5 / 1e14)
    assert cleared["last_mfu"] is None
    assert cleared["last_sustained_tflops"] is None
    assert {k: v for k, v in cleared.items() if not k.startswith("last_")} \
        == {k: v for k, v in first.items() if not k.startswith("last_")}
    assert after["last_mfu"] == pytest.approx(2.5e12 / 0.25 / 1e14)
    assert after["armed_engine"] == "fedavg" and after["compiles"] == 1


def test_peak_table_and_overrides(monkeypatch):
    monkeypatch.delenv("NIDT_PEAK_FLOPS", raising=False)
    est = pcompute.peak_flops_estimate
    assert est("fp32", "NVIDIA H100 80GB HBM3") == 66.9e12
    assert est("bf16_mixed", "NVIDIA H100 80GB HBM3") == 989.4e12
    assert est("fp32", "NVIDIA H100 PCIe") == 51.2e12
    assert est("fp32", "NVIDIA H100 80GB HBM3", cards=4) == 4 * 66.9e12
    assert est("fp32", "cpu") == 0.0
    assert est("fp16", "NVIDIA H100 80GB HBM3") == 0.0
    monkeypatch.setenv("NIDT_PEAK_FLOPS", "1.5e12")
    assert est("fp32", "cpu") == 1.5e12
    monkeypatch.setenv("NIDT_PEAK_FLOPS", "lots")
    assert est("bf16_mixed", "NVIDIA H100 80GB HBM3") == 989.4e12
    prof = pcompute.ComputeProfiler()
    prof.set_peak_flops(3e13)
    prof.arm_model("e", 1.0, precision="bf16_mixed",
                   device_name="NVIDIA H100 80GB HBM3")
    assert prof.health()["peak_flops"] == 3e13  # --peak_flops sticks
    prof.set_peak_flops(0)
    assert prof.health()["peak_flops"] == 3e13


def _engine(*extra: str):
    from neuroimagedisttraining_tpu_torch.__main__ import (
        add_args, build_experiment, config_from_args,
    )

    argv = ["--algorithm", "fedavg", "--device", "cpu", "--dataset",
            "synthetic", "--model", "3dcnn_tiny", "--synthetic_shape", "12",
            "14", "12", "--synthetic_num_subjects", "32",
            "--client_num_in_total", "4", "--comm_round", "3",
            "--batch_size", "4", "--epochs", "1", *extra]
    cfg = config_from_args(add_args(argparse.ArgumentParser())
                           .parse_args(argv))
    return build_experiment(cfg, "cpu")[0]


@pytest.mark.parametrize("peak", ["", "2e10"])
def test_engine_publishes_throughput_and_captures(monkeypatch, peak):
    if peak:
        monkeypatch.setenv("NIDT_PEAK_FLOPS", peak)
    else:
        monkeypatch.delenv("NIDT_PEAK_FLOPS", raising=False)
    pmetrics.REGISTRY.reset()
    pcompute.PROFILER.reset()
    eng = _engine("--rounds_per_dispatch", "2", "--frequency_of_the_test",
                  "2")
    with torch_threads(2):
        eng.train()
    h = pcompute.PROFILER.health()
    snap = pmetrics.REGISTRY.snapshot()
    assert h["armed_engine"] == "fedavg"
    assert h["last_sustained_tflops"] > 0
    assert (h["last_mfu"] is not None) == bool(peak)
    assert (N.MFU in snap) == bool(peak)
    assert pcompute.compiles_total("fedavg") == eng.program.built >= 1
    progs = {c["labels"]["program"]
             for c in snap[N.DISPATCH_MS]["values"]}
    assert progs == {"round", "window", "step"}
    assert snap[N.ENGINE_ROUND]["values"][0]["value"] == 2


def test_flop_counter_against_the_analytic_count():
    from torch.utils.flop_counter import FlopCounterMode

    from neuroimagedisttraining_tpu.config import OptimConfig as JOptim
    from neuroimagedisttraining_tpu.core.trainer import (
        LocalTrainer as JTrainer,
    )
    from neuroimagedisttraining_tpu.models import create_model as jmodel

    eng = _engine()
    p, b = eng.init_global_state()
    rows = next(iter(eng.client_rows([0])))[1]
    x, y = rows.X[:4], rows.y[:4]
    pmetrics.REGISTRY.reset()
    with torch_threads(2):
        out = pcompute.analyze_train_step(eng.trainer, p, b, x, y)
        counter = FlopCounterMode(display=False)
        with counter:
            eng.trainer.loss_and_grad(p, b, x, y)
    assert out["counter_flops"] == counter.get_total_flops() > 0
    jtr = JTrainer(jmodel("3dcnn_tiny", num_classes=1), JOptim(),
                   num_classes=1)
    ref = jcompute.analytic_sample_flops(jtr, (12, 14, 12)) * 4
    assert out["analytic_flops"] == ref
    assert out["parity_ratio"] == pytest.approx(
        out["counter_flops"] / out["analytic_flops"], abs=1e-4)
    assert 0.7 < out["parity_ratio"] < 0.85
    snap = pmetrics.REGISTRY.snapshot()
    assert snap[N.FLOPS_PARITY_RATIO]["values"][0]["value"] == \
        pytest.approx(out["parity_ratio"], abs=1e-4)
    assert out["peak_bytes"] is None  # no card: no device memory
