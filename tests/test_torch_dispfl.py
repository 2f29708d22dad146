"""DisPFL end to end: the reference package's engine and the port's on the
same federation, initial weights, dropout keep-masks, epoch permutations,
initial masks (the reference's draw, passed in) and gradient-probe rows
(replayed from the rng the reference's ``local_train`` leaves behind), with
both switches of the flagship path on (``--fused_update``,
``NIDT_FAST_STEM=1``; on the CPU both sides take their plain paths).
Tiny3DCNN at 12x14x12 (test_torch_flagship_engines.py holds the engine
against the reference on the flagship model at 69^3), batch 3 (one step
an epoch), 1 epoch, 2 rounds over 4 clients with 2 random neighbours
each (``--frac 0.5``) and activity 0.75 (client 1 inactive in round 0,
client 0 in round 1), ERK masks at dense ratio 0.5, ``--save_masks``.

The runs take several SGD steps, so states are held at
``torch_port_support.TRAJECTORY``. Fire ranks |w| and regrow |grad|, so an
entry within the runs' difference of a layer's cut lands on either side:
the masks are compared entry by entry and the share that differs is
bounded, and the weights are compared where no client's support (the
round's mask before evolution) differs, since elsewhere one side holds 0
or mixed a neighbour's weight the other did not (test_torch_prune_masks.py
holds fire and regrow bit for bit on the same inputs). The probe's
gradient on the reference's trained weights is held at the one-step
tolerance, and the mask decisions on them are compared exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.ops import masks as JM
from neuroimagedisttraining_tpu_torch.ops import _cuda
from neuroimagedisttraining_tpu_torch.ops import masks as PM
from neuroimagedisttraining_tpu_torch.weights import (
    masks_from_flax, params_from_flax,
)

from torch_port_support import (
    EVAL_LOSS_RTOL, LOSS_RTOL, TRAJECTORY, assert_metrics_close,
    TINY_MODEL, TINY_SHAPE, assert_state_close, four_client_federation,
    run_engine_pair,
    torch_threads,
)

OPTIM = dict(batch_size=3, epochs=1, fused_update=True)
FED = dict(client_num_in_total=4, frac=0.5, comm_round=2,
           frequency_of_the_test=1, active=0.75)
SPARSITY = dict(dense_ratio=0.5, save_masks=True)
#: the share of maskable entries allowed to differ between the two runs'
#: final masks: fire and regrow cut each layer by rank, and an entry whose
#: |w| or |grad| lies within the runs' trajectory difference of the cut
#: lands on either side. Measured on this run: 4.0e-3 (40620 of 10.2 M
#: entries), nearly all from the last round's evolution; the masks its
#: training ran under differ in 54 entries.
MASK_DIFF_SHARE = 1e-2
#: the train loss of a round after the first: a client's mixed model sums
#: its neighbours' weights over their masks, so a flipped entry moves the
#: next round's start
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
            out = run_engine_pair("dispfl",
                                  four_client_federation(TINY_SHAPE),
                                  OPTIM, FED,
                                  tmp_path_factory.mktemp("dispfl"),
                                  sparsity=SPARSITY, shape=TINY_SHAPE,
                                  model=TINY_MODEL)
            # CPU tensors: plain paths only, no kernel launched
            assert sum(_cuda.counts().values()) == before
            yield out
    finally:
        mp.undo()


def _client(tree, c):
    return jax.tree.map(lambda x: np.asarray(x)[c], tree)


def _ref_masks(jres, num_clients):
    return [masks_from_flax(_client(jres["masks"], c))
            for c in range(num_clients)]


def test_masks_match(run):
    """Every client's final mask entry by entry: at most
    ``MASK_DIFF_SHARE`` of the maskable entries differ; each layer's
    nonzero count equals the reference's (fire and regrow keep it)."""
    jres, pres, jeng, _, _ = run
    total = diff = 0
    for c, ref in enumerate(_ref_masks(jres, jeng.num_clients)):
        for k, v in ref.items():
            got = pres["masks"][c][k]
            diff += int((got != v).sum())
            total += v.numel()
            assert int(got.sum()) == int(v.sum()), (c, k)
    assert diff <= MASK_DIFF_SHARE * total, (diff, total)


def test_personal_states_match(run):
    """Each client's personal weights at ``TRAJECTORY`` on the entries
    where every client's support agrees between the runs (measured: all
    but 54)."""
    jres, pres, jeng, _, (init_p, _) = run
    C = jeng.num_clients
    refs = [params_from_flax(_client(jres["personal_params"], c), {})[0]
            for c in range(C)]
    flipped = {k: torch.stack([(pres["personal_params"][c][k] != 0)
                               != (refs[c][k] != 0) for c in range(C)]
                              ).any(0) for k in refs[0]}
    assert sum(int(v.sum()) for v in flipped.values()) <= 200
    for c in range(C):
        got = {k: torch.where(flipped[k], refs[c][k], v)
               for k, v in pres["personal_params"][c].items()}
        assert_state_close(got, None, _client(jres["personal_params"], c),
                           None, init_p, **TRAJECTORY)


def test_history_metrics_and_stat_info_match(run):
    """Per evaluated round: the train loss (the first round's rtol 1e-4,
    later ones ``LATER_LOSS_RTOL``), the personal accuracy equal and the
    mask change within ``MASK_DIFF_SHARE`` of the clients' entries. The
    personal evaluation (``assert_metrics_close``); ``w_spa``; the
    ``stat_info`` comm and FLOPs equal, the Hamming matrix within the
    masks' share, the saved final masks those of the result."""
    jres, pres, jeng, peng, _ = run
    n_mask = sum(v.numel() for v in _ref_masks(jres, 1)[0].values())
    assert len(pres["history"]) == len(jres["history"]) == 2
    for got, ref in zip(pres["history"], jres["history"]):
        assert set(got) == set(ref)
        assert got["round"] == ref["round"]
        rtol = LOSS_RTOL if got["round"] == 0 else LATER_LOSS_RTOL
        assert got["train_loss"] == pytest.approx(ref["train_loss"],
                                                  rel=rtol)
        assert got["personal_acc"] == ref["personal_acc"]
        assert abs(got["mask_change"] - ref["mask_change"]) <= \
            MASK_DIFF_SHARE * n_mask * jeng.num_clients
    assert pres["history"][1]["mask_change"] > 0
    assert_metrics_close(pres["final_personal"], jres["final_personal"],
                         EVAL_LOSS_RTOL)
    assert set(jres) <= set(pres)
    assert pres["w_spa"] == list(jres["w_spa"])
    for k in ("sum_comm_params", "sum_training_flops"):
        assert peng.stat_info[k] == jeng.stat_info[k], k
    assert peng.stat_info["person_test_acc"] == pytest.approx(
        jeng.stat_info["person_test_acc"], abs=1e-9)
    np.testing.assert_allclose(pres["mask_dis_matrix"],
                               np.asarray(jres["mask_dis_matrix"]),
                               rtol=0, atol=2 * MASK_DIFF_SHARE * n_mask)
    saved = peng.stat_info["final_masks"]
    for c in range(peng.num_clients):
        ref = masks_from_flax(_client(jax.tree.map(
            lambda m: np.asarray(m, np.float32),
            jeng.stat_info["final_masks"]), c))
        for k, v in pres["masks"][c].items():
            assert saved[k][c].dtype == bool
            assert np.array_equal(saved[k][c], v.numpy() > 0), k
            assert saved[k][c].shape == tuple(ref[k].shape), k


def test_probe_and_mask_decisions_on_reference_state(run):
    """On each client's final reference weights (with the initial BN stats)
    and its first 3 training rows: the port's ``eval_grad`` (evaluation
    mode, through ``ops/stemconv.py``) within 1e-3 of each leaf's largest
    entry of the reference's (the one-step tolerance of
    test_torch_modules.py), and on the reference's gradient the port's
    ``fire_mask`` and ``regrow_mask`` (round 1 of 2) equal the
    reference's bit for bit."""
    jres, _, jeng, peng, (_, init_b) = run
    jb = jeng.init_global_state().batch_stats

    @jax.jit
    def ref(m, p, g):
        fired, k = JM.fire_mask(m, p, jnp.float32(1), 2)
        return fired, k, JM.regrow_mask(fired, k, g)

    jgrad = jax.jit(jeng.trainer.eval_grad)
    for c in range(jeng.num_clients):
        jp = _client(jres["personal_params"], c)
        jm = _client(jres["masks"], c)
        jg = jgrad(jp, jb, jnp.asarray(np.asarray(jeng.data.X_train)[c, :3]),
                   jnp.asarray(np.asarray(jeng.data.y_train)[c, :3]))
        p_port, _ = params_from_flax(jp, {})
        g_ref, _ = params_from_flax(jax.tree.map(np.asarray, jg), {})
        with torch_threads(2):
            g_port = peng.trainer.eval_grad(p_port, init_b,
                                            peng.data.X_train[c][:3],
                                            peng.data.y_train[c][:3])
        for k, v in g_ref.items():
            np.testing.assert_allclose(
                g_port[k].numpy(), v.numpy(), rtol=0,
                atol=1e-3 * float(v.abs().max()) + 1e-12, err_msg=k)
        j_fired, _, j_grown = ref(jm, jp, jg)
        fired, k = PM.fire_mask(masks_from_flax(jm), p_port, 1, 2)
        grown = PM.regrow_mask(fired, k, g_ref)
        for name, v in masks_from_flax(jax.tree.map(np.asarray,
                                                    j_fired)).items():
            assert torch.equal(fired[name], v), (c, name)
        for name, v in masks_from_flax(jax.tree.map(np.asarray,
                                                    j_grown)).items():
            assert torch.equal(grown[name], v), (c, name)
