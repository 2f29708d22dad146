"""The SalientGrads slice end to end: the reference package's engine and
the port's, on the same cohort, initial weights, epoch permutations,
IterSNIP batch rows and dropout keep-masks, with both switches of the
flagship path on (``--fused_update``, ``NIDT_FAST_STEM=1``; on the CPU both
sides take their plain paths). AlexNet3D at 69^3 (the smallest volume that
survives its three pools), 2 site clients, batch 2, 1 round of 1 epoch.

Phase 1 is compared on its own: fp32 gradients that agree to ~1e-4 can
rank a few weights at the threshold differently, and one flipped stem
weight moves the next phase's loss by far more than rounding does. Phase 2
therefore runs the port under the reference's mask (as a resumed run
would), so the round, the aggregate and the metrics are held at the
rounding level."""

import jax
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.config import (
    DataConfig as JData, ExperimentConfig as JExp, FedConfig as JFed,
    OptimConfig as JOptim, SparsityConfig as JSparsity,
)
from neuroimagedisttraining_tpu.core.trainer import (
    LocalTrainer as JTrainer, epoch_perms_for,
)
from neuroimagedisttraining_tpu.data.federate import federate_cohort as jfed
from neuroimagedisttraining_tpu.data.synthetic import generate_synthetic_abcd
from neuroimagedisttraining_tpu.engines import create_engine
from neuroimagedisttraining_tpu.models import create_model as jmodel
from neuroimagedisttraining_tpu.ops.snip import iter_snip_batch_indices
from neuroimagedisttraining_tpu.utils.logging import ExperimentLogger
from neuroimagedisttraining_tpu_torch.config import (
    DataConfig, ExperimentConfig, FedConfig, OptimConfig, SparsityConfig,
)
from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
from neuroimagedisttraining_tpu_torch.data.federate import federate_cohort
from neuroimagedisttraining_tpu_torch.engines.salientgrads import (
    SalientGradsEngine,
)
from neuroimagedisttraining_tpu_torch.models import create_model
from neuroimagedisttraining_tpu_torch.ops import _cuda
from neuroimagedisttraining_tpu_torch.ops.masks import is_weight_kernel
from neuroimagedisttraining_tpu_torch.weights import (
    masks_from_flax, params_from_flax,
)

from torch_port_support import (
    dropout_masks, evaluate_in_one_chunk, fixed_dropout, torch_threads,
)

SHAPE = (69, 69, 69)
CPU = torch.device("cpu")
OPTIM = dict(batch_size=2, epochs=1, fused_update=True)
FED = dict(client_num_in_total=2, comm_round=1, frequency_of_the_test=1)
SPARSITY = dict(dense_ratio=0.5, itersnip_iterations=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both engines' ``train()`` results plus the port engine."""
    mp = pytest.MonkeyPatch()
    mp.setenv("NIDT_FAST_STEM", "1")
    try:
        with torch_threads(2):
            yield _run_both(tmp_path_factory.mktemp("sg"))
    finally:
        mp.undo()


def _run_both(tmp):
    cohort = generate_synthetic_abcd(num_subjects=12, shape=SHAPE,
                                     num_sites=2, seed=0)
    jcfg = JExp(model="3dcnn", num_classes=1, algorithm="salientgrads",
                data=JData(dataset="synthetic", partition_method="site"),
                optim=JOptim(**OPTIM), fed=JFed(**FED),
                sparsity=JSparsity(**SPARSITY), log_dir=str(tmp))
    fed, _ = jfed(cohort, partition_method="site", mesh=None)
    jtrainer = JTrainer(jmodel("3dcnn", num_classes=1, remat=False),
                        jcfg.optim, num_classes=1)
    evaluate_in_one_chunk(jtrainer)
    jeng = create_engine("salientgrads", jcfg, fed, jtrainer, mesh=None,
                         logger=ExperimentLogger(str(tmp), "synthetic",
                                                 jcfg.identity(),
                                                 console=False))
    gs = jeng.init_global_state()
    n = np.asarray(fed.n_train)
    nmax = int(fed.X_train.shape[1])
    # the reference's own draws, taken from the rngs its engine derives
    snip_rngs = jeng.per_client_rngs(-1, np.arange(len(n)))
    snip_idx = {c: np.asarray(iter_snip_batch_indices(
        snip_rngs[c], 1, OPTIM["batch_size"], int(n[c])))
        for c in range(len(n))}
    sampled = jeng.client_sampling(0)
    rngs = jeng.per_client_rngs(0, sampled)
    perms = {int(c): np.asarray(epoch_perms_for(rngs[i], OPTIM["epochs"],
                                                nmax, int(n[c])))
             for i, c in enumerate(sampled)}
    flat = 128  # 69^3 leaves one position after the three pools
    jmasks, pmasks = dropout_masks(OPTIM["batch_size"], flat, seed=1)
    with fixed_dropout(jmasks):
        jres = jeng.train()

    pcfg = ExperimentConfig(
        model="3DCNN", num_classes=1, algorithm="salientgrads",
        data=DataConfig(dataset="synthetic", synthetic_shape=SHAPE),
        optim=OptimConfig(**OPTIM),
        fed=FedConfig(**FED), sparsity=SparsityConfig(**SPARSITY))
    pfed, _ = federate_cohort(cohort, CPU)
    trainer = LocalTrainer(create_model("3dcnn", SHAPE), pcfg.optim, CPU,
                           torch.Generator().manual_seed(0),
                           dropout_masks=pmasks)
    peng = SalientGradsEngine(
        pcfg, pfed, trainer,
        perms_for=lambda r, c, n_: torch.from_numpy(perms[c].copy()),
        snip_idx_for=lambda c, n_: torch.from_numpy(snip_idx[c].copy()))
    init = params_from_flax(jax.tree.map(np.asarray, gs.params),
                            jax.tree.map(np.asarray, gs.batch_stats))
    before = dict(_cuda.counts())
    pres = peng.train(init_state=init, masks=masks_from_flax(
        jax.tree.map(np.asarray, jres["masks"])))
    pmasks, pthr = peng.generate_global_mask(*init)
    assert _cuda.counts() == before  # CPU run: plain paths, no launches
    return jres, pres, (pmasks, pthr), peng, init, jeng


def test_global_mask_matches(runs):
    """Phase 1: the same density and the same mask, except at entries whose
    normalized score lies within 1e-3 (relative) of the threshold, where
    the two sides' fp32 saliencies (each within ~1e-4 of the other, see
    test_torch_modules) may rank them differently; at most 1e-4 of the
    maskable weights."""
    jres, _, (pmasks, pthr), peng, init, _ = runs
    ref = masks_from_flax(jax.tree.map(np.asarray, jres["masks"]))
    scores = peng.mean_scores(*init)
    norm = sum(float(s.double().sum()) for k, s in scores.items()
               if is_weight_kernel(k, s))
    thr = float(pthr)
    n_diff = kept = total = 0
    for k, m in ref.items():
        if not is_weight_kernel(k, m):
            assert torch.all(pmasks[k] == 1) and torch.all(m == 1), k
            continue
        total += m.numel()
        kept += int(pmasks[k].sum())
        diff = pmasks[k] != m
        n_diff += int(diff.sum())
        near = (scores[k].double() / norm)[diff]
        assert torch.all((near - thr).abs() <= 1e-3 * thr), k
    assert n_diff <= 1e-4 * total
    assert kept / total == pytest.approx(jres["mask_density"], abs=1e-5)


def test_round_loss_and_global_params_match(runs):
    """Phase 2 under the reference's mask: the round's sample-weighted
    loss (rtol 1e-5); the aggregated global model, every weight within
    2e-4 of the largest weight change of the round (the gradients agree to
    ~1e-4 relative, so the weights agree to that fraction of how far the
    round moved them), pruned weights exactly 0; its BN stats rtol 5e-4
    (the stem's E[x^2] - E[x]^2, as in test_torch_modules)."""
    jres, pres, _, _, (init_p, _), _ = runs
    assert pres["history"][0]["train_loss"] == pytest.approx(
        jres["history"][0]["train_loss"], rel=1e-5)
    ref_p, ref_b = params_from_flax(jax.tree.map(np.asarray, jres["params"]),
                                    jax.tree.map(np.asarray,
                                                 jres["batch_stats"]))
    moved = max(float((v - init_p[k]).abs().max()) for k, v in ref_p.items())
    for k, v in ref_p.items():
        got = pres["params"][k]
        np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=0,
                                   atol=2e-4 * moved, err_msg=k)
        assert torch.all(got[pres["masks"][k] == 0] == 0), k
    for k, v in ref_b.items():
        np.testing.assert_allclose(pres["batch_stats"][k].numpy(),
                                   v.numpy(), rtol=5e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("which", ["final_global", "final_personal"])
def test_eval_metrics_match(runs, which):
    """Global and personal evaluation: accuracy and AUC equal (a few test
    rows whose logits sit far from 0 against the rounding drift), loss
    rtol 1e-4."""
    jres, pres, _, _, _, _ = runs
    ref, got = jres[which], pres[which]
    assert got["acc"] == pytest.approx(ref["acc"], abs=1e-9)
    assert got["acc_pooled"] == pytest.approx(ref["acc_pooled"], abs=1e-9)
    assert got["auc"] == pytest.approx(ref["auc"], abs=1e-9)
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-4)


def test_stat_info_matches(runs):
    """The reference's accounting under the same mask: mask density,
    training FLOPs (per sample under the mask's densities, times the
    round's samples and epochs) and communicated parameters (the mask's
    nonzero count per sampled client) equal; the evaluation accuracies
    within 1e-9; no non-finite upload on either side."""
    _, _, _, peng, _, jeng = runs
    ref, got = jeng.stat_info, peng.stat_info
    for k in ("mask_density", "sum_training_flops", "sum_comm_params",
              "nonfinite_uploads"):
        assert got[k] == ref[k], k
    assert got["sum_training_flops"] > 0 and got["sum_comm_params"] > 0
    for k in ("global_test_acc", "person_test_acc"):
        assert got[k] == pytest.approx(ref[k], abs=1e-9), k
