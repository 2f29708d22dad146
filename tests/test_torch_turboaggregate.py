"""TurboAggregate and its share stage: the port against the reference
package.

- ``ops/mpc.py`` (host, numpy) and ``ops/mpc_device.py`` (torch): the
  quantization, its inverse and the secure sum equal to the reference's
  bit for bit (host against its numpy ``secure_sum``, device against its
  jitted ``secure_sum_device``), on random inputs, at the edge of the
  field and on NaN and infinities, whatever masks either side draws; the
  server's intermediates never equal a client's quantized update.
- The whole run: both engines on the same federation, initial weights,
  permutations and dropout keep-masks (Tiny3DCNN at 12x14x12:
  test_torch_flagship_engines.py holds the engine against the reference
  on the flagship model at 69^3; batch 3, 1 epoch, 2 rounds over 4
  clients, ``--frac 0.75`` so 3 clients a round,
  then FedAvg's fine-tune), the reference's share stage on its device
  backend and the port's on each ``mpc_backend`` (the two reference
  backends differ by at most one fixed-point unit a client, far inside
  the tolerance): states at ``TRAJECTORY``, train losses at
  ``LOSS_RTOL``.
- The port's TurboAggregate round against its FedAvg round from the same
  inputs: the aggregates differ by the fixed-point rounding alone, at most
  ``2^-17`` a client and parameter.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.ops import mpc as JM
from neuroimagedisttraining_tpu.ops import mpc_device as JD
from neuroimagedisttraining_tpu_torch.config import (
    DataConfig, ExperimentConfig, FedConfig, OptimConfig,
)
from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
from neuroimagedisttraining_tpu_torch.data.federate import (
    build_federated_data,
)
from neuroimagedisttraining_tpu_torch.engines import create_engine
from neuroimagedisttraining_tpu_torch.models import create_model
from neuroimagedisttraining_tpu_torch.ops import _cuda
from neuroimagedisttraining_tpu_torch.ops import mpc as PM
from neuroimagedisttraining_tpu_torch.ops import mpc_device as PD

from torch_port_support import (
    LOSS_RTOL, TRAJECTORY, assert_metrics_close, assert_state_close,
    TINY_MODEL, TINY_SHAPE, four_client_federation, run_engine_pair,
    torch_threads,
)

P = PM.P_DEFAULT
OPTIM = dict(batch_size=3, epochs=1, fused_update=True)
FED = dict(client_num_in_total=4, frac=0.75, comm_round=2,
           frequency_of_the_test=1)


def _inputs(kind: str, shape=(5, 257)) -> np.ndarray:
    """float32 client stacks: Gaussian updates, values at and past the
    field's edge (|x| 2^16 near and beyond p / 2, ties at half units), or
    with NaN and infinities."""
    rng = np.random.default_rng(len(kind))
    x = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    if kind == "edge":
        x[0, :8] = [16383.0, -16383.0, 16384.0, -16384.0, 1e9, -1e9,
                    np.float32(2 ** 14 - 2 ** -16), -2.0 ** 14]
        x[1, :6] = np.asarray([0.5, 1.5, 2.5, -0.5, -1.5, 3.5]) / 2 ** 16
    elif kind == "nonfinite":
        x[0, :3] = [np.nan, np.inf, -np.inf]
        x[2, 5] = np.nan
    return x


@pytest.mark.parametrize("kind", ["gaussian", "edge", "nonfinite"])
def test_quantize_dequantize_bit_equal(kind):
    """Device: ``quantize_device`` and ``dequantize_device`` equal the
    reference's residues and floats. Host: ``quantize`` and ``dequantize``
    equal the reference's numpy functions (finite inputs: the host path
    takes no NaN)."""
    x = _inputs(kind)
    q_ref = np.asarray(JD.quantize_device(jnp.asarray(x))).astype(np.int64)
    q = PD.quantize_device(torch.from_numpy(x))
    assert q.dtype == torch.int64
    np.testing.assert_array_equal(q.numpy(), q_ref)
    assert (q_ref >= 0).all() and (q_ref < P).all()
    d_ref = np.asarray(JD.dequantize_device(jnp.asarray(q_ref, jnp.uint32)))
    d = PD.dequantize_device(q).numpy()
    np.testing.assert_array_equal(d.view(np.int32), d_ref.view(np.int32))
    if kind != "nonfinite":
        xh = x.astype(np.float64)
        np.testing.assert_array_equal(PM.quantize(xh), JM.quantize(xh))
        np.testing.assert_array_equal(PM.dequantize(PM.quantize(xh)),
                                      JM.dequantize(JM.quantize(xh)))


@pytest.mark.parametrize("kind", ["gaussian", "edge", "nonfinite"])
@pytest.mark.parametrize("n_shares", [2, 3, 5])
def test_secure_sum_bit_equal(kind, n_shares):
    """The aggregate does not depend on the masks: the port's device sum
    (its own generator) equals the reference's jitted ``secure_sum_device``
    (its own key) bit for bit, and the port's host ``secure_sum`` equals
    the reference's (different numpy generators), for 2, 3 and 5 shares."""
    x = _inputs(kind)
    ref = np.asarray(jax.jit(lambda s, k: JD.secure_sum_device(
        s, k, n_shares))(jnp.asarray(x), jax.random.key(n_shares)))
    got = PD.secure_sum_device(torch.from_numpy(x),
                               torch.Generator().manual_seed(99), n_shares)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  ref.view(np.int32))
    if kind != "nonfinite":
        ref_h = JM.secure_sum(x, n_shares, rng=np.random.default_rng(1))
        got_h = PM.secure_sum(x, n_shares, rng=np.random.default_rng(2))
        np.testing.assert_array_equal(got_h, ref_h)
    if kind == "gaussian":
        # inside the field's range host and device agree within one
        # fixed-point unit a client (float64 against float32 rounding of
        # x * 2^16); past its edge the device saturates, the host wraps
        np.testing.assert_allclose(got.numpy(), got_h,
                                   atol=x.shape[0] * 2.0 ** -16)


def test_server_intermediates_are_masked():
    """The slot invariant of the reference's own tests: host, every slot
    accumulator after every client (3 slots x 4 clients) equals no client's
    quantized update; device, no slot total equals a client's quantized
    update or the plain quantized sum; both sums equal the plain sum within
    one fixed-point unit a client."""
    rng = np.random.default_rng(7)
    stack = (rng.normal(size=(4, 64)) * 0.5).astype(np.float32)
    qs = [PM.quantize(x) for x in stack]
    trace = []
    got = PM.secure_sum(stack, n_shares=3, rng=np.random.default_rng(7),
                        trace=trace)
    assert len(trace) == 12
    assert not any(np.array_equal(t, q) for t in trace for q in qs)
    np.testing.assert_allclose(got, stack.sum(0), atol=4 * 2.0 ** -16)
    out, slots = PD.secure_sum_device(torch.from_numpy(stack),
                                      torch.Generator().manual_seed(3), 3,
                                      return_slots=True)
    qd = [PD.quantize_device(torch.from_numpy(x)).numpy() for x in stack]
    q_sum = np.mod(np.sum(qd, 0), P)
    for slot in slots.numpy():
        assert not any(np.array_equal(slot, q) for q in qd)
        assert not np.array_equal(slot, q_sum)
    np.testing.assert_allclose(out.numpy(), stack.sum(0),
                               atol=4 * 2.0 ** -16)


def test_secure_sum_device_refuses_one_share():
    with pytest.raises(ValueError, match="n_shares >= 2"):
        PD.secure_sum_device(torch.zeros(2, 3), torch.Generator(), 1)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``(reference result, port results by mpc_backend, reference engine,
    port engines by mpc_backend, initial state)``: the port's host run is
    its device run's engine again, on the same inputs, with the host
    backend."""
    mp = pytest.MonkeyPatch()
    mp.setenv("NIDT_FAST_STEM", "1")
    try:
        with torch_threads(2):
            before = sum(_cuda.counts().values())
            jres, pres, jeng, peng, init = run_engine_pair(
                "turboaggregate", four_client_federation(TINY_SHAPE), OPTIM,
                dict(FED, mpc_backend="device"),
                tmp_path_factory.mktemp("turbo"), shape=TINY_SHAPE,
                model=TINY_MODEL)
            cfg = dataclasses.replace(peng.cfg, fed=dataclasses.replace(
                peng.cfg.fed, mpc_backend="host"))
            host = type(peng)(cfg, peng.data, peng.trainer,
                              perms_for=peng.perms_for)
            pres_host = host.train(init_state=init)
            assert sum(_cuda.counts().values()) == before
            yield (jres, {"device": pres, "host": pres_host}, jeng,
                   {"device": peng, "host": host}, init)
    finally:
        mp.undo()


@pytest.mark.parametrize("backend", ["device", "host"])
def test_engine_pair_matches(run, backend):
    """The global model and every client's fine-tuned model at
    ``TRAJECTORY``; per round the train loss at ``LOSS_RTOL`` and the
    global evaluation's accuracy equal; the final evaluations; one share
    stage a round."""
    jres, pres, jeng, peng, (init_p, _) = run
    pres, peng = pres[backend], peng[backend]
    assert_state_close(pres["params"], pres["batch_stats"], jres["params"],
                       jres["batch_stats"], init_p, **TRAJECTORY)
    for c in range(jeng.num_clients):
        client = lambda t: jax.tree.map(lambda x: np.asarray(x)[c], t)
        assert_state_close(pres["personal"]["params"][c],
                           pres["personal"]["batch_stats"][c],
                           client(jres["personal"].params),
                           client(jres["personal"].batch_stats), init_p,
                           **TRAJECTORY)
    assert len(pres["history"]) == len(jres["history"]) == 2
    for got, ref in zip(pres["history"], jres["history"]):
        assert got["round"] == ref["round"]
        assert got["train_loss"] == pytest.approx(ref["train_loss"],
                                                  rel=LOSS_RTOL)
        assert got["acc"] == ref["acc"]
    assert_metrics_close(pres["final_global"], jres["final_global"])
    assert_metrics_close(pres["final_personal"], jres["final_personal"])
    assert peng.mpc_calls == FED["comm_round"]


def _port_engine(name: str, backend: str = "device"):
    X, y, train, test = four_client_federation()
    data = build_federated_data(X, y, train, test, torch.device("cpu"))
    cfg = ExperimentConfig(
        algorithm=name,
        data=DataConfig(dataset="synthetic", synthetic_shape=(69, 69, 69)),
        optim=OptimConfig(batch_size=3, epochs=1),
        fed=FedConfig(**dict(FED, mpc_backend=backend)))
    trainer = LocalTrainer(create_model("3dcnn", (69, 69, 69)), cfg.optim,
                           torch.device("cpu"),
                           torch.Generator().manual_seed(5))
    return create_engine(name, cfg, data, trainer)


@pytest.mark.parametrize("backend", ["device", "host"])
def test_round_equals_fedavg_within_fixed_point(backend):
    """From the same model, sampled clients and trainer draws, the port's
    TurboAggregate round and its FedAvg round give BN stats, loss and bad
    count bit for bit, and parameters within ``S * 2^-17`` (S = 3 clients
    each rounded to ``2^-16``) plus the float32 rounding of the plain sum;
    the share stage moved some parameter off the plain sum."""
    with torch_threads(2):
        outs = []
        for name in ("fedavg", "turboaggregate"):
            eng = _port_engine(name, backend)
            params, bstats = eng.init_global_state()
            sampled = eng.client_sampling(0)
            outs.append(eng.run_round(0, params, bstats, sampled))
    (pf, bf, lf, nf), (pt, bt, lt, nt) = outs
    S = len(sampled)
    assert S == 3
    for k, v in bf.items():
        assert torch.equal(bt[k], v), k
    assert torch.equal(lt, lf) and torch.equal(nt, nf)
    moved = 0
    for k, v in pf.items():
        err = (pt[k] - v).abs()
        assert float(err.max()) <= S * 2.0 ** -17 + 2e-7 * float(
            v.abs().max()), k
        moved += int((err > 0).sum())
    assert moved > 0


def test_cli_runs(capsys, monkeypatch):
    """The CLI on the CPU at 69^3 with the share stage on the host
    (``--mpc_backend host``; the device stage is the default): its last
    line is one JSON object with the run's history and no model state."""
    import json

    from neuroimagedisttraining_tpu_torch.__main__ import main

    monkeypatch.setenv("NIDT_FAST_STEM", "1")
    with torch_threads(2):
        assert main(["--algorithm", "turboaggregate", "--mpc_backend",
                     "host", "--frac", "0.75", "--device", "cpu",
                     "--dataset", "synthetic",
                     "--synthetic_shape", "69", "69", "69",
                     "--synthetic_num_subjects", "8", "--client_num_in_total",
                     "4", "--comm_round", "1", "--batch_size", "4",
                     "--epochs", "1", "--fused_update"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["history"]) == 1 and "final_global" in out
    assert not {"params", "personal", "batch_stats"} & set(out)
