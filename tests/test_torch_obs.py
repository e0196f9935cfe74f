"""The port's telemetry subsystem (``repro_torch.obs``): metrics registry,
span tracing + Chrome-trace export, sinks, the facade, the memory probe and
the report CLI. Every case of ``tests/test_obs.py`` held on the port, plus,
against the JAX package's ``repro.obs`` (pure Python there too):

  * the same ``inc`` / ``set`` / ``observe`` calls through both registries
    give equal ``snapshot()`` and identical ``prometheus_text()``;
  * both ``render`` functions give identical text for the reference's
    test artifact and for a JSONL the port's ``run_training`` wrote;
  * the reference's ``check_telemetry_jsonl`` accepts the port's JSONL.
"""
import json
import math

import numpy as np
import pytest
import torch

from benchmarks.check_schemas import check_telemetry_jsonl
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs.report import render as jrender
from repro_torch.launch import train as ttrain
from repro_torch.obs import (
    DEFAULT_BYTES_BUCKETS,
    NULL,
    InMemorySink,
    JSONLSink,
    MemoryProbe,
    MetricsRegistry,
    PrometheusTextfileSink,
    Telemetry,
    Tracer,
    chrome_trace_doc,
    device_memory_stats,
    live_array_bytes,
    load_chrome_trace,
    make_telemetry,
    write_chrome_trace,
)
from repro_torch.obs.report import main as report_main
from repro_torch.obs.report import render
from repro_torch.obs.telemetry import _NULL_INSTRUMENT, _NULL_SPAN, _jsonable

from port_reference import unoptimized_reference  # noqa: F401 (autouse)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_counter_gauge_basics():
    reg = MetricsRegistry()
    c = reg.counter("c")
    c.inc()
    c.add(4)
    g = reg.gauge("g")
    g.set(2.5)
    snap = reg.snapshot()
    assert snap["counters"]["c"] == 5
    assert snap["gauges"]["g"] == 2.5


def test_registry_get_or_create_returns_same_instrument():
    reg = MetricsRegistry()
    assert reg.counter("x") is reg.counter("x")
    assert reg.gauge("y") is reg.gauge("y")
    assert reg.histogram("h") is reg.histogram("h")


def test_never_set_gauge_omitted_from_snapshot():
    reg = MetricsRegistry()
    reg.gauge("unset")
    assert "unset" not in reg.snapshot()["gauges"]


def test_histogram_count_sum_min_max_exact():
    reg = MetricsRegistry()
    h = reg.histogram("lat")
    for v in (0.01, 0.02, 0.03, 0.5):
        h.observe(v)
    s = h.snapshot()
    assert s["count"] == 4
    assert s["min"] == 0.01 and s["max"] == 0.5
    assert abs(s["sum"] - 0.56) < 1e-12
    assert abs(s["mean"] - 0.14) < 1e-12


def test_histogram_percentiles_ordered_and_bounded():
    reg = MetricsRegistry()
    h = reg.histogram("lat")
    for v in [0.001 * (i + 1) for i in range(200)]:
        h.observe(v)
    s = h.snapshot()
    assert s["min"] <= s["p50"] <= s["p95"] <= s["p99"] <= s["max"]
    # interpolated p50 lands near the true median (bucket resolution)
    assert 0.05 <= s["p50"] <= 0.2


def test_histogram_empty_snapshot():
    reg = MetricsRegistry()
    s = reg.histogram("empty").snapshot()
    assert s["count"] == 0 and s["p50"] is None
    assert math.isnan(reg.histogram("empty").percentile(0.5))


def test_prometheus_text_exposition():
    reg = MetricsRegistry()
    reg.counter("fl.rounds").add(3)
    reg.gauge("fl.loss").set(0.5)
    reg.histogram("fl.round_seconds").observe(0.1)
    text = reg.prometheus_text()
    assert "fl_rounds 3" in text
    assert "fl_loss 0.5" in text
    assert "fl_round_seconds_count 1" in text
    assert 'le="+Inf"' in text


def _drive(reg):
    """One fixed sequence of calls: counters, gauges (one never set),
    histograms on the default, the bytes and custom buckets, with values
    on edges, inside buckets and in the overflow bucket."""
    rng = np.random.default_rng(0)
    reg.counter("fl.rounds").inc()
    reg.counter("fl.rounds").add(2)
    reg.counter("fl.bytes-up").add(41556.0)
    reg.gauge("fl.loss").set(np.float32(0.693))
    reg.gauge("never.set")
    reg.gauge("serve.in_flight").set(3)
    lat = reg.histogram("serve.ttft_s")
    for v in np.concatenate([rng.exponential(0.05, 40), [1e-4, 2.5, 500.0]]):
        lat.observe(float(v))
    nb = reg.histogram("frames", DEFAULT_BYTES_BUCKETS)
    for v in (64, 211, 41556, 1013250784, 2 ** 40):
        nb.observe(v)
    st = reg.histogram("fl.async.staleness", buckets=(0, 1, 2, 4, 8))
    for v in (0, 0, 1, 2, 3, 9):
        st.observe(v)
    reg.histogram("empty")


def test_registry_matches_reference_registry():
    ours, ref = MetricsRegistry(), JMetricsRegistry()
    _drive(ours)
    _drive(ref)
    assert ours.snapshot() == ref.snapshot()
    assert ours.prometheus_text() == ref.prometheus_text()


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def test_tracer_nesting_and_chrome_doc(tmp_path):
    tr = Tracer()
    with tr.span("outer", round=1):
        with tr.span("inner"):
            pass
    assert [s.name for s in tr.spans] == ["inner", "outer"]
    assert tr.spans[0].depth == 1 and tr.spans[1].depth == 0

    doc = chrome_trace_doc(tr.spans, process_name="test")
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"outer", "inner"}
    for e in xs:
        assert e["dur"] >= 0 and isinstance(e["ts"], (int, float))

    path = tmp_path / "trace.json"
    write_chrome_trace(str(path), tr.spans, process_name="test")
    loaded = load_chrome_trace(str(path))
    assert {e["name"] for e in loaded["traceEvents"]
            if e["ph"] == "X"} == {"outer", "inner"}


def test_span_records_on_exception():
    tr = Tracer()
    with pytest.raises(ValueError):
        with tr.span("failing"):
            raise ValueError("boom")
    assert [s.name for s in tr.spans] == ["failing"]


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------

def test_jsonl_sink_one_object_per_line(tmp_path):
    path = tmp_path / "run.jsonl"
    sink = JSONLSink(str(path))
    sink.emit({"kind": "a", "n": 1})
    sink.emit({"kind": "b", "n": 2})
    # flushed per event: readable before close (a crashed run's log loads)
    assert len(path.read_text().splitlines()) == 2
    sink.close()
    lines = path.read_text().strip().splitlines()
    assert [json.loads(ln)["kind"] for ln in lines] == ["a", "b"]


def test_in_memory_sink_by_kind():
    sink = InMemorySink()
    sink.emit({"kind": "round", "n": 0})
    sink.emit({"kind": "round", "n": 1})
    sink.emit({"kind": "eval"})
    assert len(sink.by_kind("round")) == 2
    assert len(sink.events) == 3


def test_prometheus_textfile_sink(tmp_path):
    path = tmp_path / "metrics.prom"
    tel = Telemetry(run_id="t", sinks=[PrometheusTextfileSink(str(path))])
    tel.counter("serve.requests").add(7)
    tel.close()
    assert "serve_requests 7" in path.read_text()


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------

def test_make_telemetry_without_sinks_is_null():
    assert make_telemetry() is NULL
    assert not NULL.enabled
    tel = make_telemetry(in_memory=True, run_id="m", workload="train")
    assert tel.enabled and tel.sinks[0].by_kind("run_meta")[0]["workload"] == "train"


def test_null_telemetry_is_allocation_free():
    # disabled instruments and spans are preallocated module singletons —
    # the hot loop holds the same object no matter how often it asks
    assert NULL.counter("a") is NULL.counter("b") is _NULL_INSTRUMENT
    assert NULL.gauge("a") is NULL.histogram("b") is _NULL_INSTRUMENT
    assert NULL.span("s", x=1) is NULL.span("t") is _NULL_SPAN
    with NULL.span("s"):
        pass
    NULL.event("anything", x=1)
    NULL.close()


def test_event_envelope_and_jsonable_coercion():
    sink = InMemorySink()
    tel = Telemetry(run_id="r1", sinks=[sink])
    tel.event("round", loss=np.float32(0.5), n=np.int64(3),
              arr=np.arange(2), nested={"x": np.float64(1.0)})
    ev = sink.by_kind("round")[0]
    assert ev["run_id"] == "r1" and "ts" in ev
    assert ev["loss"] == 0.5 and ev["n"] == 3
    assert ev["arr"] == [0, 1] and ev["nested"]["x"] == 1.0
    json.dumps(ev)   # strictly JSON-serializable


def test_jsonable_torch_tensors():
    """The counterpart of the reference's jax-scalar case: a 0-d tensor
    through ``.item()``, any other through ``.tolist()``, bf16 included."""
    assert _jsonable(torch.tensor(2.0)) == 2.0
    assert _jsonable(torch.tensor(5, dtype=torch.int32)) == 5
    assert _jsonable(torch.tensor(1.5, dtype=torch.bfloat16)) == 1.5
    assert _jsonable(torch.tensor([0.5, 2.0], dtype=torch.bfloat16)) == [0.5, 2.0]
    assert _jsonable({"j": torch.arange(3).reshape(3, 1)}) == {"j": [[0], [1], [2]]}
    assert _jsonable(torch.tensor(True)) is True
    json.dumps(_jsonable({"a": torch.ones(2, 2)}))


def test_close_emits_metrics_snapshot_and_is_idempotent():
    sink = InMemorySink()
    tel = Telemetry(run_id="r", sinks=[sink])
    tel.counter("c").inc()
    tel.close()
    tel.close()
    metrics = sink.by_kind("metrics")
    assert len(metrics) == 1
    assert metrics[0]["metrics"]["counters"]["c"] == 1


def test_workload_stamps_run_meta():
    sink = InMemorySink()
    Telemetry(run_id="r", sinks=[sink], workload="serve")
    assert sink.by_kind("run_meta")[0]["workload"] == "serve"


# ---------------------------------------------------------------------------
# report CLI + JSONL validator
# ---------------------------------------------------------------------------

# the reference's test artifact (tests/test_obs.py)
REFERENCE_ARTIFACT = [
    {"ts": 1.0, "run_id": "r", "kind": "run_meta", "workload": "train"},
    {"ts": 1.1, "run_id": "r", "kind": "round", "round": 0, "loss": 0.9,
     "bytes_up": 100, "bytes_down": 50, "survivors": 3, "cohort": 4,
     "stragglers": 1},
    {"ts": 1.2, "run_id": "r", "kind": "eval", "round": 0, "acc": 0.75},
    {"ts": 1.3, "run_id": "r", "kind": "request", "request_id": "q0",
     "adapter_id": 1, "prompt_len": 8, "gen_tokens": 4, "ttft_s": 0.1,
     "latency_s": 0.2, "tok_per_sec": 20.0},
    {"ts": 1.4, "run_id": "r", "kind": "memory", "label": "post",
     "live_bytes": 1024},
    {"ts": 1.5, "run_id": "r", "kind": "metrics", "metrics": {
        "counters": {"adapter_cache.hits": 1,
                     "adapter_cache.misses": 1},
        "gauges": {"serve.decode_tok_per_sec": 33.3},
        "histograms": {}}},
]


def _write_jsonl(path, events):
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")


@pytest.fixture(scope="module")
def port_run_jsonl(tmp_path_factory):
    """A JSONL the port's ``run_training`` wrote: reduced roberta, 2
    in-process rounds, eval every round."""
    path = str(tmp_path_factory.mktemp("obs") / "train.jsonl")
    tel = make_telemetry(jsonl=path, run_id="train-spry-0", workload="train")
    ttrain.run_training(rounds=2, clients_per_round=2, total_clients=6,
                        batch_size=4, k_perturbations=2, eval_every=1,
                        device="cpu", telemetry=tel, log=lambda *a: None)
    tel.close()
    return path


def test_report_renders_round_and_serving_sections(tmp_path):
    path = tmp_path / "run.jsonl"
    _write_jsonl(path, REFERENCE_ARTIFACT)
    out = render(str(path))
    assert "== rounds ==" in out and "bytes_up_total=100" in out
    assert "== serving ==" in out and "q0" in out
    assert "33.3 tok/s" in out
    assert "hit rate 0.500" in out
    assert "== memory ==" in out
    assert "0.75" in out   # eval acc joined onto the round row


@pytest.mark.parametrize("which", ["reference_artifact", "port_run_training"])
def test_report_renders_as_reference(tmp_path, port_run_jsonl, which):
    if which == "reference_artifact":
        path = str(tmp_path / "run.jsonl")
        _write_jsonl(path, REFERENCE_ARTIFACT)
    else:
        path = port_run_jsonl
    assert render(path) == jrender(path)


def test_report_cli_prints_rounds_and_memory(port_run_jsonl, capsys):
    assert report_main([port_run_jsonl]) == 0
    out = capsys.readouterr().out
    assert "== rounds ==" in out and "rounds: 2" in out
    assert "== memory ==" in out and "post_round_1" in out and "end_of_run" in out


def test_report_rejects_bad_jsonl(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text('{"ok": 1}\nnot json\n')
    with pytest.raises(ValueError):
        render(str(path))


def test_check_telemetry_jsonl_validator(tmp_path):
    good = tmp_path / "good.jsonl"
    _write_jsonl(good, [
        {"ts": 1.0, "run_id": "r", "kind": "round"},
        {"ts": 1.1, "run_id": "r", "kind": "metrics"},
    ])
    assert check_telemetry_jsonl(str(good),
                                 expect_kinds=("round", "metrics")) == []
    assert check_telemetry_jsonl(str(good), expect_kinds=("request",))

    bad = tmp_path / "bad.jsonl"
    _write_jsonl(bad, [{"kind": "round"}])   # missing ts/run_id envelope
    assert check_telemetry_jsonl(str(bad))

    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert check_telemetry_jsonl(str(empty))


def test_reference_validator_accepts_port_jsonl(port_run_jsonl):
    assert check_telemetry_jsonl(port_run_jsonl, expect_kinds=(
        "run_meta", "round", "eval", "memory", "personalized_eval",
        "metrics")) == []


# ---------------------------------------------------------------------------
# memory probe
# ---------------------------------------------------------------------------

def test_memory_probe_emits_events():
    sink = InMemorySink()
    tel = Telemetry(run_id="m", sinks=[sink])
    MemoryProbe(tel).sample("here", modeled_bytes=123)
    ev = sink.by_kind("memory")[0]
    assert ev["label"] == "here"
    assert ev["modeled_peak_bytes"] == 123
    assert ev["live_bytes"] >= 0
    assert tel.metrics_snapshot()["gauges"]["mem.modeled_peak_bytes"] == 123


def test_live_bytes_count_distinct_storages_on_the_cpu():
    """Without CUDA: the distinct storages of the live tensors (a view adds
    nothing), no device stats, as the reference's CPU backend."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: live bytes come from the allocator")
    before = live_array_bytes()
    x = torch.empty(1 << 20, dtype=torch.float32)
    views = [x[:10], x.view(1024, 1024)]
    grown = live_array_bytes() - before
    assert grown >= 4 << 20 and grown < 2 * (4 << 20)
    del x, views
    assert live_array_bytes() - before < 4 << 20
    assert device_memory_stats() == {}
    sink = InMemorySink()
    MemoryProbe(Telemetry(run_id="m", sinks=[sink])).sample("cpu")
    assert "device_stats" not in sink.events[-1]
