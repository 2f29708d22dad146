"""The port's telemetry host modules (``obs/``, ``utils/profiling.py``,
``utils/logging.py``'s registry) against the reference package's, fed
the same inputs: the span schema and nesting, the registry's exposition
text, the histogram buckets, the JSONL sink, the flight dump, a live
scrape of ``/metrics`` and ``/healthz``, and ``failure_context``.
Everything here is host arithmetic and text: compared exactly, apart from
wall-clock fields (``t``, ``t_mono``, ``t_wall``, ``ts``, ``dur``, pids and
thread ids), which are checked for type and order only.
"""

import json
import logging
import threading
import urllib.request

import pytest

from neuroimagedisttraining_tpu.obs import flight as jflight
from neuroimagedisttraining_tpu.obs import metrics as jmetrics
from neuroimagedisttraining_tpu.obs import trace as jtrace
from neuroimagedisttraining_tpu.utils import profiling as jprofiling
from neuroimagedisttraining_tpu_torch.obs import flight as pflight
from neuroimagedisttraining_tpu_torch.obs import metrics as pmetrics
from neuroimagedisttraining_tpu_torch.obs import names as pnames
from neuroimagedisttraining_tpu_torch.obs import trace as ptrace
from neuroimagedisttraining_tpu_torch.obs.http import MetricsServer
from neuroimagedisttraining_tpu_torch.utils import profiling as pprofiling

CLOCKS = ("t", "t_mono", "t_wall", "ts", "dur", "pid", "tid")


def _unclocked(obj):
    if isinstance(obj, dict):
        return {k: _unclocked(v) for k, v in obj.items() if k not in CLOCKS}
    if isinstance(obj, list):
        return [_unclocked(v) for v in obj]
    return obj


def _fill(mod) -> "object":
    """The same metric operations on a fresh registry of ``mod``."""
    reg = mod.MetricsRegistry()
    c = reg.counter("nidt_test_total", "a counter", labelnames=("rank",))
    c.inc(rank="0")
    c.labels(rank="1").inc(2.5)
    g = reg.gauge("nidt_test_gauge", "a gauge")
    g.set(3.0)
    g2 = reg.gauge("nidt_test_nan", "odd values", labelnames=("k",))
    g2.labels(k="nan").set(float("nan"))
    g2.labels(k="inf").set(float("inf"))
    g2.labels(k='q"\n').set(-float("inf"))
    h = reg.histogram("nidt_test_hist", "a histogram", labelnames=("e",),
                      buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.5, 5.0, 50.0, 1.0):
        h.labels(e="x").observe(v)
    reg.histogram("nidt_test_default", "default buckets").observe(0.3)
    return reg


def test_registry_exposition_snapshot_and_buckets():
    j, p = _fill(jmetrics), _fill(pmetrics)
    assert p.prometheus_text() == j.prometheus_text()
    # NaN != NaN: compared in the sink's canonical spelling
    assert pmetrics._json_safe(p.snapshot()) == \
        jmetrics._json_safe(j.snapshot())
    cell = p.snapshot()["nidt_test_hist"]["values"][0]["value"]
    assert cell["buckets"] == {"0.1": 2, "1": 2, "10": 1, "+Inf": 1}
    assert cell["count"] == 6 and cell["sum"] == pytest.approx(56.65)
    assert pmetrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS


def test_registry_refusals_match():
    for mod in (jmetrics, pmetrics):
        reg = mod.MetricsRegistry()
        reg.counter("nidt_x", labelnames=("a",))
        with pytest.raises(ValueError):
            reg.gauge("nidt_x")
        with pytest.raises(ValueError):
            reg.counter("nidt_x", labelnames=("b",))
        with pytest.raises(ValueError):
            reg.counter("nidt_x", labelnames=("a",)).inc(-1, a="1")
        reg.disable()
        reg.counter("nidt_x", labelnames=("a",)).inc(a="1")
        assert reg.snapshot()["nidt_x"]["values"] == []


def test_jsonl_sink_matches(tmp_path):
    recs = []
    for mod, name in ((jmetrics, "j"), (pmetrics, "p")):
        reg = _fill(mod)
        path = tmp_path / f"{name}.jsonl"
        reg.dump_jsonl(str(path), round=3, seq=1, engine="fedavg")
        reg.dump_jsonl(str(path), round=4, seq=2, engine="fedavg")
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        assert all(isinstance(r["t"], float) for r in lines)
        recs.append(_unclocked(lines))
    assert recs[0] == recs[1]
    gauge = recs[1][0]["metrics"]["nidt_test_nan"]["values"]
    assert {v["labels"]["k"]: v["value"] for v in gauge} == {
        "nan": "NaN", "inf": "+Inf", 'q"\n': "-Inf"}


def _spans(mod):
    t = mod.SpanTracer()
    t.arm(None, tags={"seed": 1})
    with t.span("window", round=1, rounds=4):
        with t.span("round", round=1):
            t.instant("mark", k=2)
        with t.span("flush", round=4):
            pass
    with t.span("eval"):
        pass
    t.disarm()
    with t.span("after"):
        pass
    return t.events()


def test_span_schema_and_nesting():
    j, p = _spans(jtrace), _spans(ptrace)
    assert _unclocked(p) == _unclocked(j)
    assert [e["name"] for e in p] == ["mark", "round", "flush", "window",
                                      "eval"]
    by = {e["name"]: e for e in p if e["ph"] == "X"}
    for child in ("round", "flush"):
        assert by["window"]["ts"] <= by[child]["ts"]
        assert by[child]["ts"] + by[child]["dur"] <= \
            by["window"]["ts"] + by["window"]["dur"]
    for e in p:
        assert set(e) == set(next(x for x in j if x["name"] == e["name"]))
        assert e["args"]["seed"] == 1


def test_trace_dump_is_chrome_json(tmp_path):
    t = ptrace.SpanTracer()
    t.arm(str(tmp_path / "trace.json"))
    with t.span("round", round=0):
        pass
    out = t.dump()
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert out == str(tmp_path / "trace.json")
    assert doc["displayTimeUnit"] == "ms"
    assert [e["name"] for e in doc["traceEvents"]] == ["round"]
    assert t.dump(str(tmp_path / "no" / "dir" / "x.json")) is not None


def test_annotated_span_runs_without_a_card():
    """Under an armed annotation a span opens a ``record_function`` range
    (and an NVTX range where a card is present)."""
    t = ptrace.SpanTracer()
    t.arm(None, annotate=True)
    with t.span("round"):
        with pprofiling.annotate("inner"):
            pass
    assert [e["name"] for e in t.events()] == ["round"]


def _flight(mod, path):
    f = mod.FlightRecorder(capacity=3, path=str(path))
    for i in range(5):
        f.record("alert", rule=f"r{i}", round=i, value=0.5 * i)
    return f


def test_flight_dump_matches(tmp_path):
    docs = []
    for mod, name in ((jflight, "j"), (pflight, "p")):
        f = _flight(mod, tmp_path / f"{name}.flight.json")
        assert f.evicted == 2 and f.capacity == 3
        assert f.dump(reason="test") == str(tmp_path / f"{name}.flight.json")
        docs.append(json.loads((tmp_path / f"{name}.flight.json")
                               .read_text()))
    assert _unclocked(docs[1]) == _unclocked(docs[0])
    assert docs[1]["evicted"] == 2
    assert [e["round"] for e in docs[1]["events"]] == [2, 3, 4]


def test_live_scrape_of_metrics_and_healthz():
    reg = _fill(pmetrics)
    srv = MetricsServer(0, registry=reg, host="127.0.0.1",
                        health_probe=lambda: {"health": {"status": "ok"}})
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
            text = r.read().decode()
            assert r.headers["Content-Type"].startswith("text/plain")
        assert text == reg.prometheus_text()
        with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
            health = json.loads(r.read())
        assert health["ok"] is True and health["health"] == {"status": "ok"}
        assert health["uptime_s"] >= 0
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=5)
    finally:
        srv.close()


def test_healthz_probe_error_is_503():
    def bad():
        raise RuntimeError("probe")

    srv = MetricsServer(0, host="127.0.0.1", health_probe=bad)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz",
                                   timeout=5)
        assert e.value.code == 503
    finally:
        srv.close()


@pytest.mark.parametrize("which", ["ref", "port"])
def test_failure_context_dumps_and_tears_down(tmp_path, which):
    prof, fl = ((jprofiling, jflight) if which == "ref"
                else (pprofiling, pflight))
    path = tmp_path / "x.flight.json"
    fl.configure(path=str(path))
    fl.clear()
    fl.record("action", action="freeze_rollback", round=2)
    torn = []
    try:
        with pytest.raises(ValueError, match="boom"):
            with prof.failure_context(logging.getLogger("t"),
                                      teardown=lambda: torn.append(1),
                                      name="run"):
                raise ValueError("boom")
    finally:
        fl.configure(path="")
    doc = json.loads(path.read_text())
    assert torn == [1]
    assert doc["reason"] == "failure_context: run"
    assert [e["kind"] for e in doc["events"]] == ["action", "failure"]
    assert doc["events"][-1]["error"] == "ValueError: boom"


def test_experiment_log_publishes_to_the_registry(tmp_path):
    from neuroimagedisttraining_tpu.utils.logging import (
        ExperimentLogger as JLogger,
    )
    from neuroimagedisttraining_tpu_torch.utils.logging import (
        ExperimentLogger as PLogger,
    )

    vals = dict(train_loss=0.5, acc=1.0, personal={"acc": 0.25, "n": 3})
    snaps = []
    for cls, mod, tag in ((JLogger, jmetrics, "j"), (PLogger, pmetrics, "p")):
        mod.REGISTRY.reset()
        kw = {"console": False} if cls is JLogger else {}
        cls(str(tmp_path), "synthetic", "id" + tag, **kw).metrics(7, **vals)
        snaps.append({k: v for k, v in mod.REGISTRY.snapshot().items()
                      if k in (pnames.EXP_METRIC, pnames.EXP_ROUND)})
    assert snaps[0] == snaps[1]
    cells = {c["labels"]["key"]: c["value"]
             for c in snaps[1][pnames.EXP_METRIC]["values"]}
    assert cells == {"train_loss": 0.5, "acc": 1.0, "personal_acc": 0.25,
                     "personal_n": 3.0}


def test_names_table_is_the_reference_table():
    from neuroimagedisttraining_tpu.obs import names as jnames

    assert pnames.DECLARED == jnames.DECLARED


def test_registry_is_thread_safe():
    reg = pmetrics.MetricsRegistry()
    c = reg.counter("nidt_threads_total")

    def work():
        for _ in range(2000):
            c.inc()
    ts = [threading.Thread(target=work) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert c.get() == 8000.0
