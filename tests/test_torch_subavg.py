"""Sub-FedAvg end to end: the reference package's engine and the port's on
the same federation, initial weights, dropout keep-masks and epoch
permutations (the first epoch's from each client's round key, the tail's
from the rng the reference's first ``local_train`` call leaves behind),
with both switches of the flagship path on (``--fused_update``,
``NIDT_FAST_STEM=1``; on the CPU both sides take their plain paths).
AlexNet3D at 69^3, batch 3 (one step an epoch), 2 epochs (so the two candidate masks differ
and prunes are accepted: ``dist_thresh`` and ``acc_thresh`` 0), 2 rounds
of 3 of 4 clients.

The runs take several SGD steps, so states are held at
``torch_port_support.TRAJECTORY``; the personal masks are compared entry by
entry, the share of differing entries bounded; the prune decisions taken
on the reference's own trained weights are compared exactly
(test_torch_prune_masks.py holds the ops bit for bit). Momentum carries
across the split of the first epoch from the tail: the same run with fresh
momentum in the tail leaves the tolerance."""

import jax
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.ops import prune as JP
from neuroimagedisttraining_tpu_torch.ops import _cuda
from neuroimagedisttraining_tpu_torch.ops import prune as PP
from neuroimagedisttraining_tpu_torch.weights import (
    masks_from_flax, params_from_flax,
)

from torch_port_support import (
    EVAL_LOSS_RTOL, LOSS_RTOL, TRAJECTORY, assert_metrics_close,
    assert_state_close, four_client_federation, run_engine_pair,
    torch_threads,
)

OPTIM = dict(batch_size=3, epochs=2, fused_update=True)
FED = dict(client_num_in_total=4, frac=0.75, comm_round=2,
           frequency_of_the_test=1)
SPARSITY = dict(dist_thresh=0.0, acc_thresh=0.0)
#: the share of personal-mask entries allowed to differ between the two
#: runs: a weight whose |w| sits within the runs' trajectory difference of
#: a layer's prune threshold lands on either side of it (measured on this
#: run: 2.0e-4 of the entries, 2000 of 10.2 M, after two rounds).
MASK_DIFF_SHARE = 1e-3
#: the train loss of a round after the first: a flipped entry is 0 on one
#: side and a weight of about the prune threshold on the other, so the next
#: round starts from models that differ there (measured: 3.6e-3 relative)
LATER_LOSS_RTOL = 2e-2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``(reference result, port result, reference engine, port engine,
    initial state)``."""
    mp = pytest.MonkeyPatch()
    mp.setenv("NIDT_FAST_STEM", "1")
    try:
        with torch_threads(2):
            before = sum(_cuda.counts().values())
            out = run_engine_pair("subavg", four_client_federation(),
                                  OPTIM, FED,
                                  tmp_path_factory.mktemp("subavg"),
                                  sparsity=SPARSITY)
            # CPU tensors: plain paths only, no kernel launched
            assert sum(_cuda.counts().values()) == before
            yield out
    finally:
        mp.undo()


def _client(tree, c):
    return jax.tree.map(lambda x: np.asarray(x)[c], tree)


def _ref_masks(jres, num_clients):
    return [masks_from_flax(_client(jres["mask_pers"], c))
            for c in range(num_clients)]


def _on_agreeing_entries(pres, jres, num_clients):
    """The port's global weights with every entry where some client's
    personal mask differs between the runs set to the reference's value:
    there one side pruned a weight the other kept, and the two differ by
    that weight itself."""
    agree = {k: torch.stack([pres["mask_pers"][c][k] == m[k] for c, m in
                             enumerate(_ref_masks(jres, num_clients))]
                            ).all(0) for k in pres["params"]}
    ref_p, _ = params_from_flax(jax.tree.map(np.asarray, jres["params"]), {})
    return {k: torch.where(agree[k], v, ref_p[k])
            for k, v in pres["params"].items()}


def test_global_state_matches(run):
    """The aggregated weights on the entries where every client's mask
    agrees between the runs, and the BN stats, at ``TRAJECTORY``."""
    jres, pres, jeng, _, (init_p, _) = run
    assert_state_close(_on_agreeing_entries(pres, jres, jeng.num_clients),
                       pres["batch_stats"], jres["params"],
                       jres["batch_stats"], init_p, **TRAJECTORY)


def test_personal_masks_match(run):
    """Every client's personal mask entry by entry: at most
    ``MASK_DIFF_SHARE`` of the maskable entries differ, and the masks'
    densities agree to that share."""
    jres, pres, jeng, _, _ = run
    total = diff = 0
    for c, ref in enumerate(_ref_masks(jres, jeng.num_clients)):
        for k, v in ref.items():
            diff += int((pres["mask_pers"][c][k] != v).sum())
            total += v.numel()
    assert diff <= MASK_DIFF_SHARE * total, (diff, total)
    np.testing.assert_allclose(pres["client_densities"],
                               np.asarray(jres["client_densities"]),
                               rtol=0, atol=MASK_DIFF_SHARE)


def test_history_and_stat_info_match(run):
    """Per evaluated round: the train loss (the first round's rtol 1e-4,
    later ones ``LATER_LOSS_RTOL``), the personal accuracy and the
    accepted prunes equal, the mean mask distance within
    ``MASK_DIFF_SHARE``. ``stat_info``: the communicated parameters within
    the masks' differing share, the FLOPs and accuracies equal; the
    personal evaluation (``assert_metrics_close``)."""
    jres, pres, jeng, peng, _ = run
    assert len(pres["history"]) == len(jres["history"]) == 2
    for got, ref in zip(pres["history"], jres["history"]):
        assert set(got) == set(ref)
        assert got["round"] == ref["round"]
        rtol = LOSS_RTOL if got["round"] == 0 else LATER_LOSS_RTOL
        assert got["train_loss"] == pytest.approx(ref["train_loss"],
                                                  rel=rtol)
        assert got["personal_acc"] == ref["personal_acc"]
        assert got["prunes_accepted"] == ref["prunes_accepted"] == 3
        assert abs(got["mean_mask_dist"] - ref["mean_mask_dist"]) \
            <= MASK_DIFF_SHARE
    assert_metrics_close(pres["final_personal"], jres["final_personal"],
                         EVAL_LOSS_RTOL)
    assert set(jres) <= set(pres)
    assert peng.stat_info["sum_training_flops"] == \
        jeng.stat_info["sum_training_flops"]
    assert peng.stat_info["sum_comm_params"] == pytest.approx(
        jeng.stat_info["sum_comm_params"], rel=MASK_DIFF_SHARE)
    assert peng.stat_info["person_test_acc"] == pytest.approx(
        jeng.stat_info["person_test_acc"], abs=1e-9)


def test_prune_decisions_on_reference_weights(run):
    """The reference's final global weights under each client's reference
    mask: the port's ``fake_prune`` candidate, ``mask_distance_mean`` and
    ``density_all_leaves`` on them equal the reference's exactly."""
    jres, _, jeng, _, _ = run
    params = jax.tree.map(np.asarray, jres["params"])
    p_port, _ = params_from_flax(params, {})
    for c in range(jeng.num_clients):
        jm = _client(jres["mask_pers"], c)
        ref = jax.tree.map(np.asarray, jax.jit(JP.fake_prune, static_argnums=0)(
            0.1, params, jm))
        got = PP.fake_prune(0.1, p_port, masks_from_flax(jm))
        for k, v in masks_from_flax(ref).items():
            assert torch.equal(got[k], v), (c, k)
        assert float(PP.mask_distance_mean(got, masks_from_flax(jm))) == \
            float(JP.mask_distance_mean(ref, jm))
        w = {k: v * masks_from_flax(jm)[k] for k, v in p_port.items()}
        jw = jax.tree.map(lambda a, b: a * b, params, jm)
        assert float(PP.density_all_leaves(w)) == \
            float(JP.density_all_leaves(jw))


def test_momentum_carries_across_the_split(run, monkeypatch):
    """The port's tail epochs continue the first epoch's momentum buffers:
    its run is within ``TRAJECTORY`` of the reference (above), and the
    same run with fresh momentum buffers for the tail is not."""
    from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer

    jres, _, jeng, peng, (init_p, _) = run
    real = LocalTrainer.local_train

    def fresh(self, *a, momentum=None, **kw):
        return real(self, *a, **kw)

    monkeypatch.setenv("NIDT_FAST_STEM", "1")
    monkeypatch.setattr(LocalTrainer, "local_train", fresh)
    with torch_threads(2):
        pres = peng.rerun()
    with pytest.raises(AssertionError):
        assert_state_close(_on_agreeing_entries(pres, jres,
                                                jeng.num_clients),
                           None, jres["params"], None, init_p, **TRAJECTORY)
