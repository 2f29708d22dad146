"""The round's health stats, the rules and the gate of the port against
the reference package's.

- ``health_update_stats`` and ``mask_health_stats`` on the same numpy
  stacks as the reference's, at rtol 1e-6 (float32 sums of products in
  another order; cosines at atol 1e-6, their scale being 1).
- Health armed is bit-equal to disarmed, and K = 4 armed to K = 1 armed
  (the same stats, round by round).
- The rule engine (comparators, windows, debounce, NaN, histogram p99,
  manifests, the built-in set) gives the reference's edges and verdicts
  on the same snapshots, exactly.
- A ``sign_flip`` client fires the same divergence rule in the same
  rounds as the reference on the same federation, initial weights,
  permutations and dropout, while a clean twin stays green.
- The snapshots that the smoke's rule runs printed on the card give the
  same edges and verdicts in both packages' rule engines, and the ones
  the card's rules gave.
- ``--health_gate`` through the CLI: exit 1 on a failed gate, 0 on a clean
  run, the verdict written.
"""

import argparse
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu.engines import program as jprogram
from neuroimagedisttraining_tpu.obs import metrics as jmetrics
from neuroimagedisttraining_tpu.obs import rules as jrules
from neuroimagedisttraining_tpu_torch.engines import program as pprogram
from neuroimagedisttraining_tpu_torch.obs import metrics as pmetrics
from neuroimagedisttraining_tpu_torch.obs import names as N
from neuroimagedisttraining_tpu_torch.obs import rules as prules
from torch_port_support import run_engine_pair, torch_threads

BYZ = "byz:1@0:sign_flip,byz:1@1:sign_flip"


def _stacks(C: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}
    ref = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()}
    ups = {k: (ref[k][None] + 0.1 * rng.standard_normal((C, *s))
               ).astype(np.float32) for k, s in shapes.items()}
    ups["a"][0] = 2 * ref["a"] - ups["a"][0]  # a flipped client
    w = rng.integers(1, 9, C).astype(np.float32)
    new = {k: np.einsum("c,c...->...", w / w.sum(), v).astype(np.float32)
           for k, v in ups.items()}
    return ref, ups, new, w


@pytest.mark.parametrize("C", [1, 2, 3, 4, 7])
def test_update_stats_match_the_reference(C):
    ref, ups, new, w = _stacks(C, seed=C)
    j = jprogram.health_update_stats(
        {"params": {k: jnp.asarray(v) for k, v in ups.items()}},
        {"params": {k: jnp.asarray(v) for k, v in ref.items()}},
        {k: jnp.asarray(v) for k, v in new.items()}, jnp.asarray(w))
    t = {k: torch.from_numpy(v) for k, v in ref.items()}
    p = pprogram.health_update_stats(
        [{k: torch.from_numpy(v[c]) for k, v in ups.items()}
         for c in range(C)], t,
        {k: torch.from_numpy(v) for k, v in new.items()},
        torch.from_numpy(w))
    assert set(p) == set(j)
    for k in j:
        atol = 1e-6 if "cos" in k else 0.0
        np.testing.assert_allclose(p[k].numpy(), np.asarray(j[k]),
                                   rtol=1e-6, atol=atol, err_msg=k)


@pytest.mark.parametrize("old", [False, True])
def test_mask_stats_match_the_reference(old):
    rng = np.random.default_rng(3)
    new = {"a": rng.random((3, 4, 5)) < 0.4, "b": rng.random((3, 7)) < 0.8}
    prev = {"a": rng.random((3, 4, 5)) < 0.4, "b": rng.random((3, 7)) < 0.8}
    j = jprogram.mask_health_stats(
        {k: jnp.asarray(v, jnp.float32) for k, v in new.items()},
        {k: jnp.asarray(v, jnp.float32) for k, v in prev.items()}
        if old else None)

    def per_client(m):
        return [{k: torch.from_numpy(v[c].astype(np.float32))
                 for k, v in m.items()} for c in range(3)]
    p = pprogram.mask_health_stats(per_client(new),
                                   per_client(prev) if old else None)
    for k in j:
        np.testing.assert_allclose(float(p[k]), float(j[k]), rtol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# armed against disarmed, windows
# ---------------------------------------------------------------------------


def _run(algorithm: str, *extra: str):
    from neuroimagedisttraining_tpu_torch.__main__ import (
        add_args, build_experiment, config_from_args,
    )

    argv = ["--algorithm", algorithm, "--device", "cpu", "--dataset",
            "synthetic", "--model", "3dcnn_tiny", "--synthetic_shape", "12",
            "14", "12", "--synthetic_num_subjects", "32",
            "--client_num_in_total", "4", "--comm_round", "5",
            "--batch_size", "4", "--epochs", "1",
            "--frequency_of_the_test", "4", *extra]
    cfg = config_from_args(add_args(argparse.ArgumentParser())
                           .parse_args(argv))
    eng, _ = build_experiment(cfg, "cpu")
    with torch_threads(2):
        return eng, eng.train()


def _models(res):
    out = []
    for k in ("params", "batch_stats", "per_params", "per_bstats",
              "mask_pers"):
        v = res.get(k)
        if v is not None:
            out += v if isinstance(v, list) else [v]
    return out


@pytest.mark.parametrize("algorithm", ["fedavg", "salientgrads", "subavg"])
def test_armed_is_bit_equal_and_windows_keep_the_stats(algorithm):
    extra = (("--epochs", "2", "--dist_thresh", "0", "--acc_thresh", "0")
             if algorithm == "subavg" else ())
    _, off = _run(algorithm, *extra)
    e1, on = _run(algorithm, *extra, "--health_stats")
    e4, on4 = _run(algorithm, *extra, "--health_stats",
                   "--rounds_per_dispatch", "4")
    for res in (on, on4):
        for x, y in zip(_models(off), _models(res)):
            assert all(torch.equal(x[k], y[k]) for k in x)
        assert [h["train_loss"] for h in res["history"]] == \
            [h["train_loss"] for h in off["history"]]
    assert sorted(e1._last_health_rows) == list(range(5))
    assert e1._last_health_rows == e4._last_health_rows
    row = e1._last_health_rows[0]
    if algorithm == "salientgrads":
        assert row["h_mask_overlap"] == 1.0
        assert row["h_mask_density"] == pytest.approx(0.5, abs=0.02)
    assert len(row["h_up_norms"]) == len(e1.client_sampling(0))


# ---------------------------------------------------------------------------
# the rule engine on the same snapshots
# ---------------------------------------------------------------------------


def _snap(metric, kind, cells):
    return {metric: {"kind": kind, "help": "", "values": [
        {"labels": lb, "value": v} for lb, v in cells]}}


def _hist(values, buckets=(1.0, 5.0, 10.0, 20.0)):
    counts = {str(b) if b != int(b) else str(int(b)): 0 for b in buckets}
    inf = 0
    for v in values:
        for b in buckets:
            if v <= b:
                counts[str(b) if b != int(b) else str(int(b))] += 1
                break
        else:
            inf += 1
    return {"count": len(values), "sum": float(sum(values)),
            "buckets": {**counts, "+Inf": inf}}


SNAPSHOTS = [
    {**_snap(N.HEALTH_COSINE_MIN, "gauge", [({"engine": "fedavg"}, 0.3)]),
     **_snap(N.HEALTH_DIVERGENCE, "gauge", [({"engine": "fedavg"}, 60.0)])},
    {**_snap(N.HEALTH_COSINE_MIN, "gauge", [({"engine": "fedavg"}, -0.6)]),
     **_snap(N.HEALTH_DIVERGENCE, "gauge", [({"engine": "fedavg"}, 70.0)]),
     **_snap(N.ASYNC_STALENESS, "histogram",
             [({}, _hist([1, 2, 19, 19, 19]))])},
    {**_snap(N.HEALTH_COSINE_MIN, "gauge", [({"engine": "fedavg"},
                                              float("nan"))]),
     **_snap(N.HEALTH_UPDATE_NORM_MED, "gauge", [({"engine": "x"}, 0.0),
                                                 ({"engine": "y"}, 1.0)]),
     **_snap(N.ASYNC_STALENESS, "histogram", [({}, _hist([30, 30]))])},
    {**_snap(N.HEALTH_UPDATE_NORM_MED, "gauge", [({"engine": "x"}, 0.0)]),
     **_snap(N.DP_EPSILON, "gauge", [({"source": "dp"}, 9.0)]),
     **_snap(N.DP_EPSILON_PER_ROUND, "gauge", [({"source": "dp"}, 2.0)])},
    {**_snap(N.HEALTH_UPDATE_NORM_MED, "gauge", [({"engine": "x"}, 0.0)]),
     **_snap(N.BYZ_QUARANTINES, "counter", [({}, 3.0)]),
     **_snap(N.DP_EPSILON_PER_ROUND, "gauge", [({"source": "dp"}, 2.0)])},
    {**_snap(N.BYZ_QUARANTINES, "counter", [({}, 5.0)]),
     **_snap(N.DP_EPSILON_PER_ROUND, "gauge", [({"source": "dp"}, 2.0)])},
]

MANIFEST = [
    {"name": "cos-low-mean", "metric": N.HEALTH_COSINE_MIN, "op": "<=",
     "threshold": 0.0, "window": "mean", "n": 2, "severity": "warn"},
    {"name": "median-any", "metric": N.HEALTH_UPDATE_NORM_MED, "op": "==",
     "threshold": 0.0, "agg": "min", "for_rounds": 2,
     "severity": "critical", "labels": {"engine": "x"}},
    {"name": "eps-max", "metric": N.DP_EPSILON_PER_ROUND, "op": ">=",
     "threshold": 2.0, "window": "max", "n": 3},
    {"name": "quarantine-delta", "metric": N.BYZ_QUARANTINES, "op": ">",
     "threshold": 1.0, "window": "delta", "n": 2},
    {"name": "stale-sum", "metric": N.ASYNC_STALENESS, "op": "!=",
     "threshold": 0.0, "agg": "sum", "window": "min", "n": 2},
    {"name": "client-divergence", "metric": N.HEALTH_COSINE_MIN, "op": "<",
     "threshold": -0.1, "severity": "warn"},
]


def _strip(doc):
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k != "description"}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


@pytest.mark.parametrize("manifest", [False, True])
def test_rule_engine_matches_the_reference(tmp_path, manifest):
    path = ""
    if manifest:
        path = str(tmp_path / "rules.json")
        with open(path, "w") as f:
            json.dump(MANIFEST, f)
    engines = []
    for mod in (jrules, prules):
        eng = mod.configure(manifest_path=path, dp_epsilon_budget=10.0,
                            comm_round=5, max_staleness=20)
        mod.disarm()
        engines.append(eng)
    j, p = engines
    assert [_strip(r.__dict__) for r in p.rules] == \
        [_strip(r.__dict__) for r in j.rules]
    safe = pmetrics._json_safe  # NaN != NaN: the canonical spelling
    for r, snap in enumerate(SNAPSHOTS):
        assert safe(p.observe(r, snap)) == safe(j.observe(r, snap)), r
        assert p.health_block() == j.health_block()
    assert p.observe(2, SNAPSHOTS[0]) == []  # a round already evaluated
    assert _strip(p.verdict()) == _strip(j.verdict())
    assert p.verdict()["alerts_total"] > 0


def test_manifest_refusals_match(tmp_path):
    bad = [[{"name": "x", "metric": "nidt_nope", "op": ">", "threshold": 1}],
           [{"name": "x", "metric": N.MFU, "op": "~", "threshold": 1}],
           [{"name": "x", "metric": N.MFU, "op": ">", "threshold": 1,
             "window": "delta", "n": 1}],
           [{"name": "x", "metric": N.MFU, "op": ">"}],
           [{"name": "x", "metric": N.MFU, "op": ">", "threshold": 1,
             "colour": "red"}],
           [{"name": "x", "metric": N.MFU, "op": ">", "threshold": 1,
             "action": "reboot"}],
           {"not": "a list"}]
    for i, doc in enumerate(bad):
        path = tmp_path / f"{i}.json"
        path.write_text(json.dumps(doc))
        errs = []
        for mod in (jrules, prules):
            with pytest.raises(ValueError) as e:
                mod.configure(manifest_path=str(path))
            errs.append(str(e.value))
        assert errs[0] == errs[1].replace("neuroimagedisttraining_tpu_torch",
                                          "neuroimagedisttraining_tpu")


# ---------------------------------------------------------------------------
# a sign-flipping client against the reference, a clean twin
# ---------------------------------------------------------------------------


def _cohort_maps():
    from neuroimagedisttraining_tpu.data.synthetic import (
        generate_synthetic_abcd,
    )
    from neuroimagedisttraining_tpu_torch.data.federate import (
        federation_maps,
    )

    c = generate_synthetic_abcd(num_subjects=64, shape=(12, 14, 12),
                                num_sites=4, seed=0)
    train_map, test_map, _, _ = federation_maps(c["site"])
    return c["X"], c["y"], train_map, test_map


def run_rules_pair(tmp_path, fault_spec: str, actions: str = "off",
                   comm_round: int = 3):
    """The reference's and the port's FedAvg on the same federation,
    weights, permutations and dropout, with health stats, the built-in
    rules and the action bus at ``actions`` armed in both packages:
    ``(reference verdict, port verdict, reference engine, port engine)``
    (the verdicts with the action logs)."""
    from neuroimagedisttraining_tpu.obs import actions as jactions
    from neuroimagedisttraining_tpu_torch.obs import actions as pactions

    jmetrics.REGISTRY.reset()
    pmetrics.REGISTRY.reset()
    jr, pr = jrules.configure(), prules.configure()
    jb, pb = jactions.configure(actions), pactions.configure(actions)
    fed = dict(client_num_in_total=4, comm_round=comm_round,
               frequency_of_the_test=1, fault_spec=fault_spec)
    try:
        with torch_threads(2):
            _, _, jeng, peng, _ = run_engine_pair(
                "fedavg", _cohort_maps(),
                dict(lr=1e-3, batch_size=8, epochs=1), fed, tmp_path,
                shape=(12, 14, 12), model="3dcnn_tiny",
                exp={"health_stats": True},
                setup=lambda j, p: p._register_reflexes())
    finally:
        for mod in (jrules, prules, jactions, pactions):
            mod.disarm()
    jv, pv = jr.verdict(), pr.verdict()
    jv["actions"], pv["actions"] = jb.actions_block(), pb.actions_block()
    return jv, pv, jeng, peng


def _edges(verdict):
    return [(e["kind"], e["rule"], e["round"]) for e in verdict["timeline"]]


def test_sign_flip_fires_the_reference_rules_and_a_clean_twin_is_green(
        tmp_path):
    jv, pv, jeng, peng = run_rules_pair(tmp_path / "byz", BYZ)
    assert _edges(pv) == _edges(jv)
    assert ("alert", "client-divergence", 0) in _edges(pv)
    assert pv["worst_status"] == jv["worst_status"] == "critical"
    for r in sorted(jeng._last_health_rows):
        j, p = jeng._last_health_rows[r], peng._last_health_rows[r]
        assert np.argmin(np.asarray(j["h_cos"])) == np.argmin(p["h_cos"])
        assert p["h_cos_min"] == pytest.approx(float(j["h_cos_min"]),
                                               abs=5e-2)
    jv, pv, _, _ = run_rules_pair(tmp_path / "clean", "")
    assert pv["worst_status"] == jv["worst_status"] == "ok"
    assert _edges(pv) == _edges(jv) == []


# ---------------------------------------------------------------------------
# the card's snapshots through both rule engines
# ---------------------------------------------------------------------------

# What the rules read at each boundary of two 3-round FedAvg runs on the
# flagship slice (``chip_smoke.py --ops``, NVIDIA H100 80GB HBM3 at 700 W):
# (cosine min, dispersion, update norm median, MFU of the fedavg and
# salientgrads cells, recompiles). ``sign_flip``: ``byz:1@1:sign_flip``;
# ``scale``: ``byz:1@1:scale:100``, rolled back to round 0 at round 1.
CARD_SNAPSHOTS = {
    "sign_flip": [
        (0.14710356295108795, 1.0000003576278687, 0.1000005453824997,
         (0.07738551318872036, 0.07628940241000119), 1.0),
        (-0.06561817228794098, 1.0000016689300537, 0.09980034828186035,
         (0.07935774590292961, 0.07628940241000119), 1.0),
        (-0.16316328942775726, 1.0000041723251343, 0.09960076212882996,
         (0.07528686085625196, 0.07628940241000119), 1.0)],
    "scale": [
        (0.14710356295108795, 1.0000003576278687, 0.1000005453824997,
         (0.0742571011398629, 0.07628940241000119), 1.0),
        (0.011455169878900051, 99.999755859375, 0.09980045258998871,
         (0.07464995118958175, 0.07628940241000119), 1.0),
        (0.043274544179439545, 100.00041961669922, 0.09960078448057175,
         (0.07411208971122886, 0.07628940241000119), 2.0)],
}
#: the edges the card's rules gave: the built-in manifest on the sign
#: flip (its cosine stays above -0.2, its dispersion at 1: the update
#: norms are clipped alike), and the smoke's rollback rule on the scale
CARD_EDGES = {"sign_flip": [],
              "scale": [("alert", "update-norm-blowup-1", 1)]}


def _card_snapshot(cos, disp, med, mfu, recompiles) -> dict:
    def gauge(*cells):
        return {"kind": "gauge", "values": [
            {"labels": {"engine": e}, "value": v} for e, v in cells]}
    return {N.HEALTH_COSINE_MIN: gauge(("fedavg", cos)),
            N.HEALTH_DIVERGENCE: gauge(("fedavg", disp)),
            N.HEALTH_UPDATE_NORM_MED: gauge(("fedavg", med)),
            N.MFU: gauge(("fedavg", mfu[0]), ("salientgrads", mfu[1])),
            N.RECOMPILES_TOTAL: {"kind": "counter", "values": [
                {"labels": {"engine": "fedavg", "program": "step"},
                 "value": recompiles}]}}


@pytest.mark.parametrize("run", sorted(CARD_SNAPSHOTS))
def test_card_snapshots_give_the_reference_verdicts(run):
    import dataclasses

    verdicts = []
    for mod in (jrules, prules):
        rules = mod.builtin_rules(comm_round=3)
        if run == "scale":  # the smoke's rollback rule
            blowup = next(r for r in rules if r.name == "update-norm-blowup")
            rules = [dataclasses.replace(blowup, name="update-norm-blowup-1",
                                         threshold=10.0, for_rounds=1)]
        eng = mod.RuleEngine(rules)
        for r, row in enumerate(CARD_SNAPSHOTS[run]):
            eng.observe(r, _card_snapshot(*row))
        verdicts.append(eng.verdict())
    j, p = verdicts
    assert _strip(p) == _strip(j)
    assert _edges(p) == _edges(j) == CARD_EDGES[run]


# ---------------------------------------------------------------------------
# --health_gate end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault_spec,code", [(BYZ, 1), ("", 0)])
def test_health_gate_through_the_cli(tmp_path, capsys, fault_spec, code):
    from neuroimagedisttraining_tpu_torch.__main__ import main

    argv = ["--algorithm", "fedavg", "--device", "cpu", "--dataset",
            "synthetic", "--model", "3dcnn_tiny", "--synthetic_shape", "12",
            "14", "12", "--synthetic_num_subjects", "64",
            "--client_num_in_total", "4", "--comm_round", "2",
            "--batch_size", "8", "--epochs", "1", "--lr", "0.001",
            "--health_stats", "--health_gate", "--log_dir", str(tmp_path)]
    if fault_spec:
        argv += ["--fault_spec", fault_spec]
    with torch_threads(2):
        assert main(argv) == code
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    verdict = json.load(open(out["health_verdict_path"]))
    assert out["health"]["worst_status"] == verdict["worst_status"]
    assert (verdict["worst_status"] == "ok") == (code == 0)
    assert verdict["actions"]["mode"] == "dry_run"
    stats = list((tmp_path / "synthetic").glob("*.stats.json"))
    assert len(stats) == 1 and "sum_training_flops" in json.load(
        open(stats[0]))


def test_pytree_helpers_match_the_reference():
    """The state algebra health and rollback use (``utils/pytree.py``)
    against the reference's on the same arrays: rtol 1e-6 for the float32
    reductions, exact otherwise."""
    from neuroimagedisttraining_tpu.utils import pytree as jpt
    from neuroimagedisttraining_tpu_torch.utils import pytree as ppt

    ref, ups, new, w = _stacks(5, seed=11)
    ja = {k: jnp.asarray(v) for k, v in ref.items()}
    jb = {k: jnp.asarray(v) for k, v in new.items()}
    pa = {k: torch.from_numpy(v) for k, v in ref.items()}
    pb = {k: torch.from_numpy(v) for k, v in new.items()}
    np.testing.assert_allclose(float(ppt.tree_norm(pa)),
                               float(jpt.tree_norm(ja)), rtol=1e-6)
    np.testing.assert_allclose(float(ppt.tree_dot(pa, pb)),
                               float(jpt.tree_dot(ja, jb)), rtol=1e-6)
    for k, v in ppt.tree_sub(pa, pb).items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(jpt.tree_sub(ja, jb)[k]))
    js = {k: jnp.asarray(v) for k, v in ups.items()}
    ps = ppt.tree_stack([{k: torch.from_numpy(v[c]) for k, v in ups.items()}
                         for c in range(5)])
    idx = np.array([3, 0])
    for k, v in ppt.tree_stack_index(ps, torch.from_numpy(idx)).items():
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(jpt.tree_stack_index(js, idx)[k]))
    jm = jpt.tree_weighted_mean(js, jnp.asarray(w))
    for k, v in ppt.tree_weighted_mean(ps, torch.from_numpy(w)).items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jm[k]), rtol=1e-6,
                                   atol=1e-7)
    tree = {"params": {"f0": {"conv": {"kernel": ref["a"]}}}}
    assert ppt.tree_by_name(tree, "params/f0/conv/kernel") is \
        jpt.tree_by_name(tree, "params/f0/conv/kernel")
    assert ppt.tree_by_name(pa, "a") is pa["a"]
    clone = ppt.tree_clone(pa)
    pa["a"].add_(1.0)
    assert not torch.equal(clone["a"], pa["a"])
