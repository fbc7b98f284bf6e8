"""The port's observability modules against the JAX package's, on the CPU.

The port keeps its own copies of `obs/clock.py`, `obs/propagation.py`,
`obs/tracing.py`, `obs/shard.py`, `obs/registry.py` and
`obs/exporter.py`, and of `runtime/spans.py`. What crosses a process
boundary must be the reference's exactly, since the JAX package's
scheduler reads it:

- traceparents and RPC metadata round-trip between the two packages in
  both directions, and through a trainer's environment;
- `render_prometheus` gives byte-identical text for the same sequence of
  `inc` / `set_gauge` / `observe` calls (values drawn from a numpy seed),
  histograms and label escaping included, and `snapshot` and
  `histogram_stats` agree;
- `Tracer.export_chrome_trace` gives the same events under one injected
  clock (span identities compared by structure: ids are random);
- a port `ShardSpanWriter` shard is read by the reference's `load_shard`
  and `discover_shards` and merged by its `merge_directory` beside a
  reference scheduler shard, parent links intact;
- the port's `ObsHttpServer` on port 0 answers `/metrics` (the
  reference server's bytes for the same registry) and `/healthz`;
- `Observability.phase`, the `SWTPU_OBS=0` switch and `runtime/spans`.

The iterator's spans are held against the reference's in
`tests/test_torch_lease_iterator.py`, the daemon's and dispatcher's in
the traced loopback of `tests/test_torch_worker.py`.
"""
import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from shockwave_tpu.obs import Observability as RefObservability
from shockwave_tpu.obs import names as ref_names
from shockwave_tpu.obs import propagation as ref_propagation
from shockwave_tpu.obs import shard as ref_shard
from shockwave_tpu.obs.exporter import ObsHttpServer as RefObsHttpServer
from shockwave_tpu.obs.merge import merge_directory, parent_chain, spans_by_id
from shockwave_tpu.obs.registry import MetricsRegistry as RefRegistry
from shockwave_tpu.obs.tracing import Tracer as RefTracer
from shockwave_tpu_torch import obs as port_obs
from shockwave_tpu_torch.obs import names, propagation, shard
from shockwave_tpu_torch.obs.exporter import ObsHttpServer
from shockwave_tpu_torch.obs.registry import MetricsRegistry
from shockwave_tpu_torch.obs.tracing import Tracer
from shockwave_tpu_torch.runtime import spans


class FakeClock:
    """One injected clock: each read advances it by a fixed tick."""

    def __init__(self, start=1000.0, tick=0.125):
        self.now, self.tick = start, tick

    def __call__(self):
        self.now += self.tick
        return self.now


# ---------------------------------------------------------------------------
# Names.
# ---------------------------------------------------------------------------

def test_every_port_name_is_the_references():
    """Each spec the port declares has the reference's name, kind, help,
    labels and buckets; each span name, key and env name its value."""
    specs = names.all_metric_specs()
    assert specs
    for spec in specs:
        ref = next(r for r in ref_names.all_metric_specs() if r.name == spec.name)
        assert dataclasses.astuple(spec) == dataclasses.astuple(ref)
    constants = [n for n in dir(names) if n.isupper() and not isinstance(
        getattr(names, n), names.MetricSpec)]
    assert {"SPAN_RUNJOB", "SPAN_LAUNCH", "SPAN_DONE_REPORT", "SPAN_TRAINER",
            "SPAN_CKPT_LOAD", "SPAN_CKPT_SAVE", "SPAN_PROFILE_MEASURE",
            "TRACEPARENT_ENV", "SHARD_DIR_ENV", "TRACEPARENT_METADATA_KEY",
            "TRACE_SENDTS_METADATA_KEY"} <= set(constants)
    for name in constants:
        assert getattr(names, name) == getattr(ref_names, name), name
    assert names.shard_filename("worker", 12) == ref_names.shard_filename("worker", 12)


# ---------------------------------------------------------------------------
# Propagation.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make,read", [(propagation, ref_propagation),
                                       (ref_propagation, propagation)],
                         ids=["port_to_reference", "reference_to_port"])
def test_traceparent_and_metadata_round_trip(make, read):
    ctx = make.new_root_context()
    child = make.child_context(ctx)
    assert child.trace_id == ctx.trace_id and child.span_id != ctx.span_id
    text = make.format_traceparent(child)
    assert text == read.format_traceparent(read.SpanContext(child.trace_id, child.span_id))
    parsed = read.parse_traceparent(text)
    assert (parsed.trace_id, parsed.span_id) == (child.trace_id, child.span_id)

    metadata = make.rpc_metadata(child, send_ts=1234.5)
    got, send_ts = read.from_rpc_metadata(metadata)
    assert (got.trace_id, got.span_id, send_ts) == (child.trace_id, child.span_id, 1234.5)
    assert make.rpc_metadata(None) == () == read.rpc_metadata(None)

    env = make.to_environ(child, {})
    got = read.from_environ(env)
    assert (got.trace_id, got.span_id) == (child.trace_id, child.span_id)


@pytest.mark.parametrize("value", [None, "", "garbage", "00-xyz-abc-01",
                                   "01-" + "a" * 32 + "-" + "b" * 16 + "-01",
                                   " 00-" + "A" * 32 + "-" + "B" * 16 + "-01 "])
def test_malformed_traceparents_parse_alike(value):
    ours, ref = propagation.parse_traceparent(value), ref_propagation.parse_traceparent(value)
    assert (ours is None) == (ref is None)
    if ours is not None:
        assert (ours.trace_id, ours.span_id) == (ref.trace_id, ref.span_id)
    meta = [(names.TRACEPARENT_METADATA_KEY, value or ""),
            (names.TRACE_SENDTS_METADATA_KEY, "not-a-float")]
    ours, ref = propagation.from_rpc_metadata(meta), ref_propagation.from_rpc_metadata(meta)
    assert (ours[0] is None) == (ref[0] is None) and ours[1] is None and ref[1] is None


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

def record(registry, spec_source, seed):
    """The same seeded sequence of inc / set_gauge / observe calls."""
    rng = np.random.RandomState(seed)
    methods = ["RunJob", "Done", 'a"b\\c\nd']
    for _ in range(60):
        which = rng.randint(5)
        if which == 0:
            registry.inc(spec_source.WORKER_JOBS_DISPATCHED_TOTAL)
        elif which == 1:
            registry.inc(spec_source.RPC_RETRIES_TOTAL, float(rng.randint(1, 4)),
                         method=methods[rng.randint(3)])
        elif which == 2:
            registry.set_gauge(spec_source.WORKER_LAST_DISPATCH_TIMESTAMP,
                               float(rng.uniform(1e9, 2e9)))
        elif which == 3:
            registry.observe(spec_source.PROFILE_MEASURE_SECONDS,
                             float(rng.lognormal(0.0, 3.0)),
                             family=["LM", "ResNet-18"][rng.randint(2)])
        else:
            registry.observe(spec_source.ROUND_PHASE_SECONDS, float(rng.choice(
                [0.0005, 0.001, 2.5, 300.0, 301.0, rng.uniform(0, 400)])),
                phase="solve")
    registry.set_gauge(spec_source.TRACE_SHARD_SPANS, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_prometheus_is_the_references(seed):
    ours, ref = MetricsRegistry(), RefRegistry()
    record(ours, names, seed)
    record(ref, ref_names, seed)
    assert ours.render_prometheus() == ref.render_prometheus()
    assert ours.snapshot() == ref.snapshot()
    for family in ("LM", "ResNet-18", "never"):
        assert (ours.histogram_stats(names.PROFILE_MEASURE_SECONDS, family=family)
                == ref.histogram_stats(ref_names.PROFILE_MEASURE_SECONDS, family=family))


def test_timed_and_a_disabled_registry():
    clock = FakeClock(tick=0.25)
    ours = MetricsRegistry(clock=clock)
    with ours.timed(names.PROFILE_MEASURE_SECONDS, family="LM"):
        pass
    assert ours.histogram_stats(names.PROFILE_MEASURE_SECONDS, family="LM") == (1, 0.25)
    off = MetricsRegistry(enabled=False)
    record(off, names, 0)
    assert off.render_prometheus() == "\n" and off.snapshot() == {}
    with pytest.raises(ValueError, match="not a counter"):
        ours.inc(names.PROFILE_MEASURE_SECONDS, family="LM")
    with pytest.raises(ValueError, match="labels"):
        ours.observe(names.PROFILE_MEASURE_SECONDS, 1.0)


# ---------------------------------------------------------------------------
# Tracer.
# ---------------------------------------------------------------------------

def trace_session(tracer_cls, propagation_module, clock, remote):
    """Nested spans, a remote parent, a record_span and a span on another
    thread, all on one injected clock."""
    tracer = tracer_cls(clock=clock)
    parent = propagation_module.SpanContext(*remote)
    with tracer.span("round", round=1) as root:
        with tracer.span("solve", round=1):
            pass
        tracer.record_span("window", ts=5.0, dur=2.5, parent=root, jobs=[1, 2])
    with tracer.span("runjob", parent=parent, worker=0):
        with tracer.span("inner"):
            pass
    return tracer


def normalised(events):
    """Chrome-trace events with ids replaced by their structure: each
    span's parent by the parent's name (or the remote id), trace ids by
    their order of appearance."""
    by_id = {e["args"]["span_id"]: e["name"] for e in events}
    traces = {}
    out = []
    for e in events:
        args = dict(e["args"])
        trace = traces.setdefault(args.pop("trace_id"), len(traces))
        args.pop("span_id")
        parent = args.pop("parent_id", None)
        out.append((e["name"], e["ph"], e["cat"], e["ts"], e["dur"], e["pid"],
                    json.dumps(args, sort_keys=True), trace, by_id.get(parent, parent)))
    return out


def test_export_chrome_trace_is_the_references(tmp_path):
    remote = ("c" * 32, "d" * 16)
    paths = {}
    for name, tracer_cls, prop in (("ours", Tracer, propagation),
                                   ("ref", RefTracer, ref_propagation)):
        tracer = trace_session(tracer_cls, prop, FakeClock(), remote)
        paths[name] = tracer.export_chrome_trace(str(tmp_path / name / "trace.json"))
    traces = {}
    for name, path in paths.items():
        with open(path) as f:
            traces[name] = json.load(f)
    assert traces["ours"]["displayTimeUnit"] == traces["ref"]["displayTimeUnit"] == "ms"
    ours, ref = (normalised(traces[n]["traceEvents"]) for n in ("ours", "ref"))
    assert ours == ref
    # The remote parent's id rides through.
    assert ("runjob", remote[1]) in {(e[0], e[-1]) for e in ours}


def test_a_disabled_tracer_records_nothing():
    tracer = Tracer(enabled=False)
    with tracer.span("x") as ctx:
        assert ctx is None
    assert tracer.record_span("y", 0.0, 1.0) is None and tracer.events() == []


# ---------------------------------------------------------------------------
# Shards and the reference's merge.
# ---------------------------------------------------------------------------

def test_port_shards_merge_into_the_references_fleet_trace(tmp_path):
    """A reference scheduler shard and a port worker shard whose runjob
    span hangs off the scheduler's RPC span through RPC metadata (with a
    send stamp) and whose launch span the trainer continues through the
    environment: the reference's discover_shards / load_shard read the
    port's files, and merge_directory fuses them into one chain."""
    directory = str(tmp_path / "trace")
    sched_obs = RefObservability(clock=FakeClock(start=2000.0), enabled=True)
    with sched_obs.span("round", round=3):
        with sched_obs.span("runjob-rpc", worker=0) as rpc_ctx:
            metadata = ref_propagation.rpc_metadata(rpc_ctx, send_ts=2000.5)
    ref_shard.export_tracer_shard(directory, "scheduler", sched_obs.tracer, host="h0", pid=1)

    registry = MetricsRegistry()

    class Obs:
        inc, set_gauge = registry.inc, registry.set_gauge

    worker = shard.ShardSpanWriter(directory, role="worker", clock=FakeClock(start=2010.0),
                                   obs=Obs, host="h1", pid=2)
    parent, send_ts = propagation.from_rpc_metadata(metadata)
    with worker.span(names.SPAN_RUNJOB, parent=parent, send_ts=send_ts, round=3) as ctx:
        launch = worker.open_span(names.SPAN_LAUNCH, parent=ctx, job=7)
        env = spans.export_trace_env({}, launch.context, directory)
        worker.close_span(launch, steps=5, returncode=0)
    with worker.span(names.SPAN_DONE_REPORT, parent=ctx, jobs=[7]):
        pass
    assert worker.flush() == os.path.join(directory, names.shard_filename("worker", 2))
    assert registry.value(names.TRACE_SHARD_FLUSHES_TOTAL) == 1
    assert registry.value(names.TRACE_SHARD_SPANS) == 3

    trainer = shard.ShardSpanWriter(directory, role="trainer", clock=FakeClock(start=2011.0),
                                    host="h1", pid=3)
    assert env[names.SHARD_DIR_ENV] == directory
    span = trainer.open_span(names.SPAN_TRAINER, parent=propagation.from_environ(env), job=7)
    with trainer.span(names.SPAN_CKPT_SAVE, parent=span.context, job=7):
        pass
    trainer.close_span(span, steps=5, done=True)
    trainer.flush()

    paths = ref_shard.discover_shards(directory)
    assert [os.path.basename(p) for p in paths] == [
        "spans-scheduler-1.json", "spans-trainer-3.json", "spans-worker-2.json"]
    loaded = ref_shard.load_shard(paths[2])
    assert (loaded["schema"], loaded["role"], loaded["pid"], loaded["host"]) == (
        ref_shard.SHARD_SCHEMA, "worker", 2, "h1")
    assert [s["name"] for s in loaded["spans"]] == ["launch", "runjob", "done-report"]

    summary = merge_directory(directory)
    assert summary["shards"] == 3 and summary["spans"] == 7
    with open(summary["out"]) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    index = spans_by_id(events)
    save = next(e for e in events if e["name"] == "ckpt-save")
    chain = parent_chain(index, save)
    assert [e["name"] for e in chain] == ["ckpt-save", "trainer", "launch", "runjob",
                                         "runjob-rpc", "round"]
    assert [e["args"]["role"] for e in chain] == ["trainer"] * 2 + ["worker"] * 2 + [
        "scheduler"] * 2
    done = next(e for e in events if e["name"] == "done-report")
    assert index[done["args"]["parent_id"]]["name"] == "runjob"


def test_runtime_spans_shard_is_opt_in(tmp_path, monkeypatch):
    monkeypatch.setattr(spans, "_SHARD", None)
    monkeypatch.delenv(names.SHARD_DIR_ENV, raising=False)
    assert spans.trace_dir_from_env() is None
    assert spans.shard_from_env("trainer") is None and spans.get_shard() is None
    assert spans.export_trace_env({}, None, None) == {}
    spans.flush()  # no shard: nothing to do
    monkeypatch.setenv(names.SHARD_DIR_ENV, str(tmp_path / "a"))
    first = spans.shard_from_env("trainer")
    assert first is spans.get_shard() and first.role == "trainer"
    # One shard per process: another directory keeps the first.
    assert spans.init_process_shard(str(tmp_path / "b"), "worker") is first
    with first.span(names.SPAN_CKPT_LOAD, job=1):
        pass
    spans.flush()
    assert os.listdir(tmp_path / "a") == [names.shard_filename("trainer", os.getpid())]
    assert not (tmp_path / "b").exists()


# ---------------------------------------------------------------------------
# The exporter.
# ---------------------------------------------------------------------------

def get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_obs_http_server_answers_metrics_and_healthz():
    ours, ref = MetricsRegistry(), RefRegistry()
    record(ours, names, 4)
    record(ref, ref_names, 4)
    health = {"worker_type": "h100", "worker_ids": [0]}
    servers = [ObsHttpServer(ours, health_fn=lambda: health).start(),
               RefObsHttpServer(ref, health_fn=lambda: health).start()]
    failing = ObsHttpServer(ours, health_fn=lambda: 1 / 0).start()
    bare = ObsHttpServer(ours).start()
    try:
        answers = [{path: get(s.port, path) for path in ("/metrics", "/healthz",
                                                          "/history.json", "/nope")}
                   for s in servers]
        assert answers[0] == answers[1]
        status, content_type, body = answers[0]["/metrics"]
        assert status == 200 and content_type == "text/plain; version=0.0.4; charset=utf-8"
        assert body.decode() == ours.render_prometheus()
        status, content_type, body = answers[0]["/healthz"]
        assert status == 200 and content_type == "application/json"
        assert json.loads(body) == dict(health, status="ok")
        assert answers[0]["/history.json"][0] == 404 and answers[0]["/nope"][0] == 404
        status, _, body = get(failing.port, "/healthz")
        assert status == 500 and json.loads(body)["error"].startswith("ZeroDivisionError")
        assert json.loads(get(bare.port, "/healthz")[2]) == {"status": "ok"}
    finally:
        for server in servers + [failing, bare]:
            server.stop()


# ---------------------------------------------------------------------------
# Observability.
# ---------------------------------------------------------------------------

def test_phase_is_the_references():
    out = {}
    for name, cls in (("ours", port_obs.Observability), ("ref", RefObservability)):
        obs = cls(clock=FakeClock(), enabled=True)
        with obs.phase("solve", round=2):
            with obs.span("inner"):
                pass
        out[name] = (obs.registry.render_prometheus(),
                     [(e["name"], e["ts"], e["dur"], e["args"]) for e in obs.tracer.events()])
    assert out["ours"] == out["ref"]


@pytest.mark.parametrize("value,enabled", [(None, True), ("1", True), ("0", False),
                                           ("", False)])
def test_the_swtpu_obs_switch(value, enabled, monkeypatch):
    if value is None:
        monkeypatch.delenv("SWTPU_OBS", raising=False)
    else:
        monkeypatch.setenv("SWTPU_OBS", value)
    obs = port_obs.Observability()
    assert port_obs.obs_enabled_by_env() is enabled and obs.enabled is enabled
    obs.inc(names.WORKER_JOBS_DISPATCHED_TOTAL)
    with obs.phase("solve") as ctx:
        assert (ctx is not None) is enabled
    assert obs.registry.value(names.WORKER_JOBS_DISPATCHED_TOTAL) == (1.0 if enabled else 0.0)
    assert len(obs.tracer.events()) == (1 if enabled else 0)


def test_get_observability_is_one_per_process():
    seen = []
    threads = [threading.Thread(target=lambda: seen.append(port_obs.get_observability()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len({id(o) for o in seen}) == 1 and seen[0] is port_obs.get_observability()
