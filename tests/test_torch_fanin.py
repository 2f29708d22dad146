"""The port's telemetry fan-in (``obs/fanin.py``) and the incremental reads
it ships (``FlightRecorder.events_from``, ``SpanTracer.events_from``)
against the reference package's: the clock-offset estimator, per-worker
paths, the merged Prometheus exposition (worker labels, one TYPE block a
name, cumulative histograms, staleness gauges across a dead worker) equal
to the reference's byte for byte on the same payloads, the merged view
over HTTP, the merged Chrome trace (clock rebase, process metadata, drop
accounting), the merged flight dump (worker provenance), the shipper's
rate limit and watermarks, ``linked_flow_ids`` and the two histograms.
Host code only: compared exactly.
"""

import json
import re
import urllib.request

import pytest

from neuroimagedisttraining_tpu.obs import fanin as jfanin
from neuroimagedisttraining_tpu.obs import flight as jflight
from neuroimagedisttraining_tpu.obs import metrics as jmetrics
from neuroimagedisttraining_tpu.obs import trace as jtrace
from neuroimagedisttraining_tpu_torch.obs import fanin as pfanin
from neuroimagedisttraining_tpu_torch.obs import flight as pflight
from neuroimagedisttraining_tpu_torch.obs import metrics as pmetrics
from neuroimagedisttraining_tpu_torch.obs import trace as ptrace
from neuroimagedisttraining_tpu_torch.obs.fanin import (
    TelemetryFanIn,
    WorkerObsShipper,
    estimate_clock_offset,
    linked_flow_ids,
    suffixed_path,
)
from neuroimagedisttraining_tpu_torch.obs.flight import FlightRecorder
from neuroimagedisttraining_tpu_torch.obs.http import MetricsServer
from neuroimagedisttraining_tpu_torch.obs.metrics import MetricsRegistry
from neuroimagedisttraining_tpu_torch.obs.trace import SpanTracer

_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? "
    r"(-?\d+(\.\d+)?([eE][+-]?\d+)?|\+Inf|-Inf|NaN)$")

#: each package's (fanin, flight, metrics, trace) modules
PKGS = {"jax": (jfanin, jflight, jmetrics, jtrace),
        "port": (pfanin, pflight, pmetrics, ptrace)}


# ------------------------------------------------ clock handshake, paths


@pytest.mark.parametrize("frac", [0.0, 0.25, 0.5, 0.9, 1.0])
def test_clock_offset_recovered_within_rtt_bound(frac):
    """A known worker-vs-root skew is recovered within rtt/2 wherever the
    worker read its clock inside the round trip, as the reference's."""
    true_offset, t0, rtt = 5_000_000, 1_000_000_000, 2_000_000
    t_worker = t0 + int(frac * rtt) + true_offset
    off, err = estimate_clock_offset(t0, t_worker, t0 + rtt)
    assert err == rtt // 2 and abs(off - true_offset) <= err
    assert (off, err) == jfanin.estimate_clock_offset(t0, t_worker, t0 + rtt)
    assert estimate_clock_offset(100, 350, 100) == (250, 0)


def test_suffixed_path_inserts_before_extension():
    for path, wid in (("out/trace.json", 0), ("flight", 3), ("", 1)):
        assert suffixed_path(path, wid) == jfanin.suffixed_path(path, wid)
    assert suffixed_path("out/trace.json", 0) == "out/trace.w0.json"
    assert suffixed_path("flight", 3) == "flight.w3"


# ------------------------------------------------ merged exposition


def _worker_payload(pkg, wid):
    fanin, flight, metrics, trace = PKGS[pkg]
    reg = metrics.MetricsRegistry()
    reg.counter("nidt_w_uploads_total", "uploads",
                labelnames=("outcome",)).inc(10 + wid, outcome="accepted")
    reg.histogram("nidt_w_lat_ms", "latency",
                  buckets=(1.0, 5.0)).observe(2.0)
    t = trace.SpanTracer()
    t.arm(tags={"worker": wid})
    with t.span("w_span"):
        pass
    fl = flight.FlightRecorder(capacity=16)
    fl.record("dropped_stale", client=1, worker=wid)
    return fanin.WorkerObsShipper(registry=reg, tracer=t,
                                  flight=fl).payload(force=True)


def _fanin(pkg, payloads=None):
    fanin, flight, metrics, trace = PKGS[pkg]
    root_reg = metrics.MetricsRegistry()
    root_reg.gauge("nidt_root_round").set(4)
    root_t = trace.SpanTracer()
    root_t.arm()
    with root_t.span("aggregate", version=1):
        pass
    root_fl = flight.FlightRecorder(capacity=16)
    root_fl.record("aggregate", version=1)
    fi = fanin.TelemetryFanIn(registry=root_reg, tracer=root_t,
                              flight=root_fl)
    for wid in (0, 1):
        fi.register_worker(wid)
        fi.ingest(wid, payloads[wid] if payloads else
                  _worker_payload(pkg, wid))
    return fi


def test_merged_exposition_labels_types_and_staleness():
    fi = _fanin("port")
    fi.mark_dead(1)  # the snapshot stays, the staleness gauge reads it
    text = fi.prometheus_text()
    for line in text.strip().splitlines():
        assert line.startswith("#") or _SAMPLE_RE.match(line), line
    names = [ln.split()[2] for ln in text.splitlines()
             if ln.startswith("# TYPE")]
    assert names and len(names) == len(set(names))
    assert re.search(r'nidt_w_uploads_total\{[^}]*worker="0"[^}]*\} 10',
                     text)
    assert re.search(r'nidt_w_uploads_total\{[^}]*worker="1"[^}]*\} 11',
                     text)
    assert "nidt_root_round 4" in text
    # cumulative, worker-labeled (the bound appended after the labels)
    assert 'nidt_w_lat_ms_bucket{worker="0",le="5"} 1' in text
    assert 'nidt_w_lat_ms_bucket{worker="0",le="1"} 0' in text
    assert re.search(r'nidt_obs_worker_snapshot_age_s\{worker="0"\} ',
                     text)
    assert 'nidt_obs_worker_alive{worker="0"} 1' in text
    assert 'nidt_obs_worker_alive{worker="1"} 0' in text


def test_merged_exposition_equals_reference(monkeypatch):
    """Both packages' fan-ins, fed the same worker payloads over root
    registries filled the same way, render the same exposition byte for
    byte (the snapshot ages under one frozen clock); each package's
    shipper packs the same snapshot."""
    port_payloads = {w: _worker_payload("port", w) for w in (0, 1)}
    jax_payloads = {w: _worker_payload("jax", w) for w in (0, 1)}
    for w in (0, 1):
        assert port_payloads[w]["metrics"] == jax_payloads[w]["metrics"]
        assert ([e["kind"] for e in port_payloads[w]["flight"]]
                == [e["kind"] for e in jax_payloads[w]["flight"]])
    clock = [1000.0]
    monkeypatch.setattr(pfanin.time, "monotonic", lambda: clock[0])
    monkeypatch.setattr(jfanin.time, "monotonic", lambda: clock[0])
    fis = {pkg: _fanin(pkg, port_payloads) for pkg in PKGS}
    for fi in fis.values():
        fi.mark_dead(1)
    clock[0] += 2.5
    texts = {pkg: fi.prometheus_text() for pkg, fi in fis.items()}
    assert texts["port"] == texts["jax"]
    assert 'nidt_obs_worker_snapshot_age_s{worker="1"} 2.5' in texts["port"]
    assert fis["port"].summary() == fis["jax"].summary()
    assert (fis["port"].merged_snapshot().keys()
            == fis["jax"].merged_snapshot().keys())


def test_merged_view_serves_over_http():
    fi = _fanin("port")
    srv = MetricsServer(0, registry=fi.metrics_view())
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=30
        ).read().decode()
        assert 'worker="0"' in body and 'worker="1"' in body
    finally:
        srv.close()


# ------------------------------------------------ merged trace and flight


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_merged_trace_rebases_worker_timelines(pkg):
    """A worker span at 100 us past its epoch (7 ms after the root's, the
    worker's clock 2 ms ahead) lands at 100 + 7000 - 2000 us on the root's
    timeline, in both packages."""
    fanin, flight, metrics, trace = PKGS[pkg]
    root_t = trace.SpanTracer()
    root_t.arm()
    with root_t.span("root_span"):
        pass
    fi = fanin.TelemetryFanIn(registry=metrics.MetricsRegistry(),
                              tracer=root_t, flight=flight.FlightRecorder())
    fi.register_worker(0)
    t0 = 10_000
    fi.note_clock(0, t0, t0 + 2_000_000, t0)  # rtt 0: exact
    fi.ingest(0, {
        "metrics": None, "pid": 4242, "epoch_ns": root_t.epoch_ns + 7_000_000,
        "spans": [{"name": "w_span", "ph": "X", "ts": 100.0, "dur": 5.0,
                   "pid": 4242, "tid": 1, "args": {}}],
        "spans_dropped": 0, "flight": [], "t_wall": 0.0})
    doc = fi.merged_trace_doc()
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    evs = doc["traceEvents"]
    w = next(e for e in evs if e["name"] == "w_span")
    assert w["ts"] == pytest.approx(100.0 + 5000.0)
    names = {e["args"]["name"] for e in evs if e["ph"] == "M"}
    assert names == {"ingest-root", "ingest-worker-0"}
    assert any(e["name"] == "root_span" for e in evs)


def test_merged_trace_dump_and_drop_accounting(tmp_path):
    fi = _fanin("port")
    fi.ingest(0, {"metrics": None, "spans": [], "spans_dropped": 3,
                  "flight": [], "t_wall": 0.0})
    out = fi.dump_trace(str(tmp_path / "merged.json"))
    doc = json.load(open(out))
    assert doc["nidtDroppedEvents"] == 3
    assert any(e.get("ph") == "X" for e in doc["traceEvents"])
    assert fi.dump_trace("") is None


def test_merged_flight_carries_worker_provenance(tmp_path):
    fi = _fanin("port")
    doc = fi.merged_flight_doc(reason="test")
    assert {e["proc"] for e in doc["events"]} == {"root", "worker0",
                                                  "worker1"}
    w_ev = next(e for e in doc["events"] if e["proc"] == "worker0")
    assert w_ev["worker"] == 0 and w_ev["kind"] == "dropped_stale"
    walls = [e.get("t_wall", 0.0) for e in doc["events"]]
    assert walls == sorted(walls)
    out = fi.dump_flight(str(tmp_path / "merged_flight.json"),
                         reason="test")
    got = json.load(open(out))
    assert got["workers"]["1"]["alive"] is True
    assert got["workers"] == _fanin("jax").merged_flight_doc()["workers"]


# ------------------------------------------------ shipper and watermarks


def test_shipper_ships_only_new_events_and_rate_limits():
    t = SpanTracer()
    t.arm()
    fl = FlightRecorder(capacity=8)
    sh = WorkerObsShipper(interval_s=3600.0, registry=MetricsRegistry(),
                          tracer=t, flight=fl)
    with t.span("a"):
        pass
    fl.record("x", i=1)
    p1 = sh.payload(force=True)
    assert [e["name"] for e in p1["spans"]] == ["a"]
    assert [e["i"] for e in p1["flight"]] == [1]
    assert sh.payload() is None  # the rate limit
    p2 = sh.payload(force=True)
    assert p2["spans"] == [] and p2["flight"] == []
    with t.span("b"):
        pass
    fl.record("y", i=2)
    p3 = sh.payload(force=True)
    assert [e["name"] for e in p3["spans"]] == ["b"]
    assert [e["i"] for e in p3["flight"]] == [2]
    assert set(p3) == set(_worker_payload("jax", 0))


def test_shipper_caps_span_chunk():
    t = SpanTracer()
    t.arm()
    for _ in range(5):
        with t.span("s"):
            pass
    sh = WorkerObsShipper(registry=MetricsRegistry(), tracer=t,
                          flight=FlightRecorder(), span_chunk_max=3)
    p = sh.payload(force=True)
    assert len(p["spans"]) == 3 and p["spans_dropped"] == 2


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_flight_events_from_watermark(pkg):
    fl = PKGS[pkg][1].FlightRecorder(capacity=3)
    for i in range(5):
        fl.record("e", i=i)
    evs, mark = fl.events_from(0)
    # the ring evicted 0 and 1
    assert [e["i"] for e in evs] == [2, 3, 4] and mark == 5
    assert fl.events_from(mark) == ([], 5)
    fl.record("e", i=5)
    assert [e["i"] for e in fl.events_from(mark)[0]] == [5]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_span_events_from_watermark(pkg):
    """The span buffer's read is by list index, and ``arm()`` clears the
    buffer (a shipper resets its watermark when it re-arms)."""
    t = PKGS[pkg][3].SpanTracer()
    t.arm()
    for name in ("a", "b"):
        with t.span(name):
            pass
    evs, mark = t.events_from(0)
    assert [e["name"] for e in evs] == ["a", "b"] and mark == 2
    assert t.events_from(mark) == ([], 2)
    with t.span("c"):
        pass
    evs, mark = t.events_from(mark)
    assert [e["name"] for e in evs] == ["c"] and mark == 3
    t.arm()
    assert t.events_from(0) == ([], 0)


def test_linked_flow_ids_groups_phases():
    evs = [{"ph": "s", "id": 1}, {"ph": "t", "id": 1},
           {"ph": "f", "id": 1}, {"ph": "s", "id": 2},
           {"ph": "X", "name": "slice"}]
    flows = linked_flow_ids(evs)
    assert flows == jfanin.linked_flow_ids(evs)
    assert flows["linked"] == {1} and flows["s"] == {1, 2}


# ------------------------------------------------ the two histograms


def test_stage_and_rtt_histograms_register_and_observe():
    texts = {}
    for pkg, (fanin, _, metrics, _) in PKGS.items():
        reg = metrics.MetricsRegistry()
        fanin.rtt_histogram(reg).observe(42.0)
        h = fanin.stage_histogram(reg)
        for stage, ms in (("queue", 0.07), ("decode", 3.0), ("fold", 0.4)):
            h.labels(stage=stage).observe(ms)
        # idempotent registration
        assert fanin.stage_histogram(reg) is h
        texts[pkg] = reg.prometheus_text()
        snap = reg.snapshot()
        cell = snap["nidt_client_rtt_ms"]["values"][0]["value"]
        assert cell["count"] == 1 and cell["buckets"]["50"] == 1
        assert {v["labels"]["stage"] for v in
                snap["nidt_upload_stage_ms"]["values"]} == {
            "queue", "decode", "fold"}
    assert texts["port"] == texts["jax"]
