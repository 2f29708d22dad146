"""The reflex plane of the port (``obs/actions.py``, the engines'
handlers, the elastic mesh) against the reference package's.

- The bus's modes (off, dry_run, on), its containment of every failure
  and its bounded log: the reference's log entries, exactly, on the same
  calls.
- On the same seeded sign-flip schedule (``byz:1@0,1:sign_flip``), the
  same federation, weights, permutations and dropout, with the built-in
  rules and ``--actions on``: the port's action log is the reference's
  (actions, rules, rounds, statuses, the quarantined client and its
  window; the cosine within 5e-2, the runs' float32 trajectories being
  held at ``TRAJECTORY``), and the dry-run twin changes nothing.
- Escalation walks the reference's ladder; a rollback restores the pin bit
  for bit and zeroes the codec's error feedback; no pin outside
  ``--actions on``.
- Preemption, held to the port's own contract (the reference's own
  preempt test fails on the CPU): ``preempt:2@2`` on a 4-entry mesh with
  a checkpoint every round is bit for bit a fresh run resumed from round
  1's checkpoint on a 2-entry mesh; without checkpoints the run goes on
  from the live state. As in the reference, only the FedAvg family takes
  ``preempt:``: Local and Ditto runs with the spec are bit for bit the
  runs without it, on the mesh they started with.
"""

import argparse
import json
import shutil

import pytest
import torch

from neuroimagedisttraining_tpu.obs import actions as jactions
from neuroimagedisttraining_tpu.obs import flight as jflight
from neuroimagedisttraining_tpu_torch.obs import actions as pactions
from neuroimagedisttraining_tpu_torch.obs import flight as pflight
from test_torch_health import BYZ, run_rules_pair
from torch_port_support import torch_threads


def _bus_script(mod):
    """The same dispatches on a bus of each package; the logs."""
    logs = {}
    for mode in mod.MODES:
        bus = mod.ActionBus(mode, log_cap=3)
        bus.register("quarantine_silo", lambda **kw: {"client": 2})
        bus.register("escalate_defense",
                     lambda **kw: {"status": "skipped", "reason": "top"})

        def boom(**kw):
            raise RuntimeError("handler failed")
        bus.register("freeze_rollback", boom)
        bus.on_alert("quarantine_silo", rule="client-divergence",
                     severity="critical", round_idx=1, value=-0.5)
        bus.on_alert("escalate_defense", rule="r", round_idx=2)
        bus.on_alert("freeze_rollback", rule="r", round_idx=3, value=60.0)
        bus.on_alert("adapt_buffer", rule="staleness-runaway", round_idx=4)
        bus.record_action("shrink_mesh", rule="device-loss", round_idx=5,
                          detail={"devices_after": 2})
        with pytest.raises(ValueError):
            bus.register("reboot", lambda **kw: None)
        logs[mode] = bus.actions_block()
    with pytest.raises(ValueError):
        mod.ActionBus("sometimes")
    return logs


def test_bus_modes_and_log_match_the_reference():
    j, p = _bus_script(jactions), _bus_script(pactions)
    assert p == j
    assert p["off"]["log"][-1]["action"] == "shrink_mesh"
    on = {e["action"]: e for e in p["on"]["log"]}
    assert on["adapt_buffer"]["status"] == "unhandled"
    assert on["freeze_rollback"]["status"] == "error"
    assert p["on"]["total"] == 5 and p["on"]["evicted"] == 2
    assert all(e["status"] == "dry_run" for e in p["dry_run"]["log"][:2])


def test_module_level_bus_unarmed_is_a_no_op():
    pactions.disarm()
    assert pactions.on_alert("quarantine_silo", rule="r") is None
    assert pactions.record_action("shrink_mesh", rule="r") is None
    assert pactions.actions_block() == {"mode": "unarmed"}
    pactions.register("quarantine_silo", lambda **kw: None)


def _logs(verdict):
    return verdict["actions"]["log"]


def _close(a, b, tol=5e-2):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], tol)
                                            for k in a)
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= tol
    return a == b


def test_chaos_log_matches_the_reference(tmp_path):
    jflight.clear()
    pflight.clear()
    jv, pv, jeng, peng = run_rules_pair(tmp_path, BYZ, actions="on")
    jl, pl = _logs(jv), _logs(pv)
    assert jl and len(pl) == len(jl)
    for a, b in zip(pl, jl):
        assert _close(a, b), (a, b)
    q = [e for e in pl if e["action"] == "quarantine_silo"
         and e["status"] == "applied"]
    assert q and q[0]["rule"] == "client-divergence"
    off, start = q[0]["detail"]["client"], q[0]["detail"]["from_round"]
    assert peng._is_quarantined(off, start)
    assert off not in list(peng._sampled_by_round[start])
    assert peng._quarantine_windows == jeng._quarantine_windows
    assert peng.active_defense() == jeng.active_defense()
    kinds = [e["kind"] for e in pflight.events()]
    assert "alert" in kinds and "action" in kinds


def test_dry_run_observes_without_acting(tmp_path):
    jv, pv, _, peng = run_rules_pair(tmp_path, BYZ, actions="dry_run",
                                     comm_round=2)
    assert [e["status"] for e in _logs(pv)] == \
        [e["status"] for e in _logs(jv)]
    assert _logs(pv) and all(e["status"] == "dry_run" for e in _logs(pv))
    assert peng._quarantine_windows == {}
    assert peng._healthy_pin is None
    assert all(len(s) == 4 for s in peng._sampled_by_round.values())


def _engine(tmp_path, *extra: str):
    from neuroimagedisttraining_tpu_torch.__main__ import (
        add_args, build_experiment, config_from_args,
    )

    argv = ["--algorithm", "fedavg", "--device", "cpu", "--dataset",
            "synthetic", "--model", "3dcnn_tiny", "--synthetic_shape", "12",
            "14", "12", "--synthetic_num_subjects", "32",
            "--client_num_in_total", "4", "--batch_size", "4", "--epochs",
            "1", "--log_dir", str(tmp_path), *extra]
    cfg = config_from_args(add_args(argparse.ArgumentParser())
                           .parse_args(argv))
    return build_experiment(cfg, "cpu")[0]


def test_escalation_walks_the_ladder(tmp_path):
    try:
        bus = pactions.configure("on")
        eng = _engine(tmp_path, "--frac", "1.0", "--comm_round", "2")
        eng._register_reflexes()
        prog = eng.program
        e = bus.on_alert("escalate_defense", rule="defense-escalation",
                         round_idx=0)
        assert e["status"] == "applied"
        assert e["detail"] == {"from": "none", "to": "norm_diff_clipping"}
        assert eng.active_defense() == "norm_diff_clipping"
        assert eng.program is not prog  # planned again
        e = bus.on_alert("escalate_defense", rule="r", round_idx=1)
        assert e["detail"] == {"from": "norm_diff_clipping",
                               "to": "trimmed_mean"}
        assert eng.cfg.fed.defense_type == "none"
        e = bus.on_alert("escalate_defense", rule="r", round_idx=2)
        assert e["status"] == "skipped"
        assert "top rung" in e["detail"]["reason"]
        with torch_threads(2):
            res = eng.train()  # the escalated tail trains
        assert all(torch.isfinite(v).all() for v in res["params"].values())
    finally:
        pactions.disarm()
    try:
        bus = pactions.configure("on")
        eng = _engine(tmp_path, "--defense_type", "weak_dp")
        eng._register_reflexes()
        e = bus.on_alert("escalate_defense", rule="r", round_idx=0)
        assert e["status"] == "skipped"
        assert "outside the escalation ladder" in e["detail"]["reason"]
    finally:
        pactions.disarm()


def test_rollback_restores_the_pin_bit_for_bit(tmp_path):
    pflight.clear()
    try:
        bus = pactions.configure("on")
        eng = _engine(tmp_path)
        eng._register_reflexes()
        e = bus.on_alert("freeze_rollback", rule="update-norm-blowup",
                         round_idx=0)
        assert e["status"] == "skipped" and eng._pending_rollback is None
        good_p = {"w": torch.arange(4.0)}
        good_b = {"m": torch.ones(3)}
        eng._reflex_boundary(3, good_p, good_b)
        assert eng._healthy_pin["round"] == 3
        good_p["w"].add_(1.0)  # the pin owns copies
        assert torch.equal(eng._healthy_pin["params"]["w"],
                           torch.arange(4.0))
        e = bus.on_alert("freeze_rollback", rule="update-norm-blowup",
                         round_idx=5, value=80.0)
        assert e["status"] == "applied" and e["detail"]["pin_round"] == 3
        eng._wire_ef = {1: {"w": torch.full((4,), 7.0)}}
        p, b = eng._reflex_boundary(5, {"w": torch.full((4,), float("nan"))},
                                    {"m": torch.zeros(3)})
        assert torch.equal(p["w"], torch.arange(4.0))
        assert torch.equal(b["m"], torch.ones(3))
        assert p["w"].data_ptr() != eng._healthy_pin["params"]["w"]\
            .data_ptr()
        assert eng._wire_ef == {}
        rb = [ev for ev in pflight.events() if ev["kind"] == "rollback"]
        assert [(r["rule"], r["pin_round"]) for r in rb] == \
            [("update-norm-blowup", 3)]
    finally:
        pactions.disarm()


def test_rollback_in_a_run_restores_and_trains_on(tmp_path):
    """A rollback dispatched at round 1's boundary: round 1's model is
    replaced by round 0's pin, the step graphs are dropped and captured
    again, and round 2 trains from the pin as a fresh engine does."""
    try:
        bus = pactions.configure("on")
        eng = _engine(tmp_path, "--comm_round", "3")
        pub = eng.publish_stat_info
        seen = {}

        def alert(r):
            pub(r)
            if r == 1:
                bus.on_alert("freeze_rollback", rule="r", round_idx=1)
        eng.publish_stat_info = alert
        reflex = eng.reflex_carry

        def keep(r, carry):
            out = reflex(r, carry)
            seen[r] = (carry, out, eng.trainer.generator.get_state())
            return out
        eng.reflex_carry = keep
        with torch_threads(2):
            eng.train()
    finally:
        pactions.disarm()
    pin = seen[0][1]
    for a, b in zip(seen[1][1][:2], pin[:2]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert eng.program.built == 2  # captured again after the drop
    other = _engine(tmp_path, "--comm_round", "3")
    other.trainer.generator.set_state(seen[1][2])
    with torch_threads(2):
        c2, _ = other.window_round(pin, 2, other.client_sampling(2))
    for a, b in zip(seen[2][0][:2], c2[:2]):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_no_pin_outside_actions_on(tmp_path):
    try:
        pactions.configure("dry_run")
        eng = _engine(tmp_path)
        eng._reflex_boundary(0, {"w": torch.zeros(2)}, {})
        assert eng._healthy_pin is None
    finally:
        pactions.disarm()


def test_preempt_resumes_as_a_fresh_run_on_the_smaller_mesh(tmp_path):
    ca, cb = tmp_path / "a", tmp_path / "b"
    common = ("--comm_round", "4", "--checkpoint_every", "1")
    try:
        bus = pactions.configure("dry_run")
        a = _engine(tmp_path, *common, "--virtual_devices", "4",
                    "--client_mesh", "4", "--fault_spec", "preempt:2@2",
                    "--checkpoint_dir", str(ca))
        with torch_threads(2):
            res_a = a.train()
        shrinks = [e for e in bus.actions_block()["log"]
                   if e["action"] == "shrink_mesh"]
    finally:
        pactions.disarm()
    assert a.mesh.devices.size == 2 and a.cfg.fed.client_mesh == 2
    assert [e["status"] for e in shrinks] == ["applied"]
    assert shrinks[0]["rule"] == "device-loss"
    assert shrinks[0]["detail"] == {"devices_before": 4, "devices_after": 2,
                                    "scheduled_round": 2, "resume_round": 2}
    cb.mkdir()
    shutil.copy(ca / "ckpt_00000001.msgpack", cb)
    b = _engine(tmp_path, *common, "--virtual_devices", "2",
                "--client_mesh", "2", "--checkpoint_dir", str(cb))
    with torch_threads(2):
        res_b = b.train()
    for k in ("params", "batch_stats"):
        assert all(torch.equal(res_a[k][n], res_b[k][n]) for n in res_a[k])
    for x, y in zip(res_a["personal"]["params"],
                    res_b["personal"]["params"]):
        assert all(torch.equal(x[n], y[n]) for n in x)
    tail = [json.dumps(h, sort_keys=True) for h in res_a["history"]
            if h["round"] >= 2]
    assert tail == [json.dumps(h, sort_keys=True) for h in res_b["history"]
                    if h["round"] >= 2]
    assert [h["round"] for h in res_a["history"]] == [0, 1, 2, 3]


def test_preempt_without_checkpoints_goes_on_live(tmp_path):
    try:
        bus = pactions.configure("dry_run")
        eng = _engine(tmp_path, "--comm_round", "2", "--virtual_devices",
                      "4", "--client_mesh", "4", "--fault_spec",
                      "preempt:2@1")
        with torch_threads(2):
            res = eng.train()
        (e,) = [x for x in bus.actions_block()["log"]
                if x["action"] == "shrink_mesh"]
    finally:
        pactions.disarm()
    assert eng.mesh.devices.size == 2
    assert e["status"] == "applied" and e["detail"]["resume_round"] == 1
    assert all(torch.isfinite(v).all() for v in res["params"].values())
    assert [h["round"] for h in res["history"]] == [0, 1]


@pytest.mark.parametrize("algorithm", ["local", "ditto"])
def test_preempt_is_ignored_outside_the_fedavg_family(tmp_path, algorithm):
    mesh = ("--algorithm", algorithm, "--comm_round", "2",
            "--virtual_devices", "4", "--client_mesh", "4")
    try:
        bus = pactions.configure("dry_run")
        a = _engine(tmp_path, *mesh, "--fault_spec", "preempt:2@1")
        with torch_threads(2):
            res_a = a.train()
        log = bus.actions_block()["log"]
    finally:
        pactions.disarm()
    b = _engine(tmp_path, *mesh)
    with torch_threads(2):
        res_b = b.train()
    assert not a.takes_preempt and log == []
    assert a.mesh.devices.size == 4 and a.cfg.fed.client_mesh == 4
    for k in ("personal_params", "personal_batch_stats"):
        for x, y in zip(res_a[k], res_b[k]):
            assert all(torch.equal(x[n], y[n]) for n in x)
    assert json.dumps(res_a["history"], sort_keys=True) == \
        json.dumps(res_b["history"], sort_keys=True)
