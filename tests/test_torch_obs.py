"""The port's obs host spine held against the JAX package.

``obs/context.py``, ``registry.py``, ``trace.py``, ``flight_recorder.py``
and ``watchdog.py`` are copies (the port's span enters
``torch.profiler.record_function`` where the JAX span enters
``jax.profiler.TraceAnnotation``). The same operation sequences go through
both packages' classes and give equal results: registry snapshots,
nearest-rank percentiles, exported snapshots and bridged JSONL records;
the context's binding, nesting and id decoding; span records bar their
timestamps and thread ids, stage counts and Perfetto flows; flight-recorder
dumps bar time and host; the watchdog's stall verdicts under an injected
clock and ``find_stragglers``. The wiring is held on the port's replay
loop: a healthy run's watchdog stays silent, its registry gauges equal its
JSONL records, its result carries ``trace_stage_counts``, and a profiled
window's trace holds the spans as ``record_function`` ranges.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has jax but no flax
  import jax  # noqa: F401
  from tensor2robot_tpu.obs import context as jax_context
  from tensor2robot_tpu.obs import flight_recorder as jax_flight
  from tensor2robot_tpu.obs import registry as jax_registry
  from tensor2robot_tpu.obs import trace as jax_trace
  from tensor2robot_tpu.obs import watchdog as jax_watchdog
  from tensor2robot_tpu.utils import metric_writer as jax_metric_writer
except ImportError:
  jax = None

from tensor2robot_tpu_torch.bin import run_qtopt_replay  # noqa: E402
from tensor2robot_tpu_torch.obs import context  # noqa: E402
from tensor2robot_tpu_torch.obs import flight_recorder  # noqa: E402
from tensor2robot_tpu_torch.obs import registry  # noqa: E402
from tensor2robot_tpu_torch.obs import trace  # noqa: E402
from tensor2robot_tpu_torch.obs import watchdog  # noqa: E402
from tensor2robot_tpu_torch.replay import loop, smoke  # noqa: E402
from tensor2robot_tpu_torch.utils import metric_writer  # noqa: E402
from tensor2robot_tpu_torch.utils import optimizers  # noqa: E402

# The span fields that depend on the clock or the thread.
_CLOCK_KEYS = ("ts_s", "dur_s", "tid")


@pytest.fixture
def needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


# --- the registry -------------------------------------------------------------


def _registry_ops(lib):
  reg = lib.MetricRegistry()
  rng = np.random.default_rng(0)
  reg.counter("serving/requests").inc(5)
  reg.counter("serving/requests").inc()
  reg.gauge("replay/fill").set(0.75)
  reg.set_gauges({"replay/a": 1.5, "replay/b": None, "replay/c": -2})
  hist = reg.histogram("serving/latency_ms")
  for value in rng.exponential(3.0, 517):
    hist.record(float(value))
  small = reg.histogram("h")
  small._samples = type(small._samples)(maxlen=8)
  for value in range(100):
    small.record(value)
  return reg


class TestMetricRegistry:

  def test_snapshot_equals_jax_on_the_same_ops(self, needs_jax):
    theirs, ours = _registry_ops(jax_registry), _registry_ops(registry)
    assert ours.snapshot() == theirs.snapshot()
    assert list(ours.names()) == list(theirs.names())
    names = ["replay/a", "serving/latency_ms"]
    assert ours.snapshot(names=names) == theirs.snapshot(names=names)
    assert ours.histogram("h").snapshot() == theirs.histogram("h").snapshot()

  @pytest.mark.parametrize("n", [1, 2, 7, 100, 1001])
  def test_nearest_rank_equals_jax(self, needs_jax, n):
    ordered = sorted(np.random.default_rng(n).random(n).tolist())
    for pct in (0, 1, 50, 90, 99, 99.9, 100):
      assert (registry._nearest_rank(ordered, pct)
              == jax_registry._nearest_rank(ordered, pct))

  def test_typed_names_collide_loudly(self):
    reg = registry.MetricRegistry()
    reg.counter("x").inc()
    with pytest.raises(TypeError, match="one name, one type"):
      reg.gauge("x")

  def test_export_snapshot_equals_jax(self, needs_jax, tmp_path):
    payloads = []
    for lib, name in ((jax_registry, "jax"), (registry, "port")):
      path = _registry_ops(lib).export_snapshot(str(tmp_path / name),
                                                host="h0")
      with open(path) as f:
        payloads.append(json.load(f))
    assert payloads[0] == payloads[1]
    assert payloads[1]["schema"] == "t2r-registry-1"

  def test_bridge_records_equal_jax(self, needs_jax, tmp_path):
    records = []
    for lib, writer_lib, name in (
        (jax_registry, jax_metric_writer, "jax"),
        (registry, metric_writer, "port")):
      reg = _registry_ops(lib)
      with writer_lib.MetricWriter(str(tmp_path / name)) as writer:
        reg.flush_to(writer, step=7, names=["replay/a", "replay/c"])
        reg.flush_to(writer, step=8, prefix="p/")
      with open(tmp_path / name / "metrics.jsonl") as f:
        records.append([{k: v for k, v in json.loads(line).items()
                         if k != "wall_time"} for line in f])
    assert records[0] == records[1]
    assert records[1][0] == {"step": 7, "host": records[1][0]["host"],
                             "pid": os.getpid(), "replay/a": 1.5,
                             "replay/c": -2.0}

  def test_process_registry_is_one_instance(self):
    assert registry.get_registry() is registry.get_registry()


# --- correlation context ---------------------------------------------------


class TestCorrelationContext:

  def test_ids_are_host_pid_seq(self, needs_jax):
    ours, theirs = context.new_request_id(), jax_context.new_request_id()
    assert ours.rsplit("-", 1)[0] == theirs.rsplit("-", 1)[0]
    assert f"-{os.getpid()}-" in ours
    assert context.new_request_id() != ours

  def test_bind_nesting_equals_jax(self, needs_jax):
    seen = []
    for lib in (jax_context, context):
      trail = [lib.context_attrs()]
      with lib.bind(request_id="r1"):
        trail.append(lib.context_attrs())
        with lib.bind(step_id=7):
          trail.append(lib.context_attrs())
          with lib.bind(request_ids="a,b", request_id="r2"):
            trail.append((lib.context_attrs(), lib.current_request_id(),
                          lib.current_step_id()))
          trail.append(lib.context_attrs())
        trail.append(lib.context_attrs())
      trail.append((lib.context_attrs(), lib.current_request_id()))
      seen.append(trail)
    assert seen[0] == seen[1]
    assert seen[1][2] == {"request_id": "r1", "step_id": 7}

  def test_decoding_equals_jax(self, needs_jax):
    cases = [{"request_id": "a"}, {"request_ids": "a,b,c"},
             {"request_id": "a", "request_ids": "a,b"}, {},
             {"request_ids": ",x,,y"}]
    for record in cases:
      assert (list(context.span_request_ids(record))
              == list(jax_context.span_request_ids(record)))
    for ids in (["a", None, "b"], [], [None], ["x"]):
      assert context.join_ids(ids) == jax_context.join_ids(ids)

  def test_bind_does_not_cross_threads(self):
    seen = []
    with context.bind(request_id="main"):
      thread = threading.Thread(
          target=lambda: seen.append(context.current_request_id()))
      thread.start()
      thread.join()
    assert seen == [None]


# --- spans -------------------------------------------------------------------


def _span_sequence(trace_lib, context_lib):
  """A fixed sequence: nesting, attrs, bound ids and their overrides, a
  listener and a batch flush."""
  tracer = trace_lib.Tracer()
  heard = []
  tracer.add_listener(lambda record: heard.append(record["name"]))
  with tracer.span("learn/outer", k=3):
    with tracer.span("learn/inner"):
      pass
  with context_lib.bind(request_id="req-a", step_id=3):
    with tracer.span("serve/enqueue"):
      pass
    with tracer.span("serve/enqueue", request_id="req-b"):
      pass
  with context_lib.bind(request_ids="req-a,req-b,req-lonely"):
    with tracer.span("serve/flush", batch=3):
      with tracer.span("act/cem_policy", envs=3):
        pass
  with tracer.span("extend/drain"):
    pass
  with tracer.span("replay/eval"):
    pass
  return tracer, heard


def _strip(records):
  return [{k: v for k, v in r.items() if k not in _CLOCK_KEYS}
          for r in records]


class TestTracer:

  def test_span_records_equal_jax(self, needs_jax):
    theirs, heard_j = _span_sequence(jax_trace, jax_context)
    ours, heard_p = _span_sequence(trace, context)
    assert _strip(ours.spans()) == _strip(theirs.spans())
    assert ours.stage_counts() == theirs.stage_counts() == {
        "learn": 2, "serve": 3, "act": 1, "extend": 1, "replay": 1}
    assert heard_p == heard_j
    assert ours.total_spans == theirs.total_spans == 8

  def test_flows_equal_jax(self, needs_jax, tmp_path):
    exported = []
    for (trace_lib, context_lib), name in (
        ((jax_trace, jax_context), "jax"), ((trace, context), "port")):
      tracer, _ = _span_sequence(trace_lib, context_lib)
      with open(tracer.export_chrome_trace(str(tmp_path / name))) as f:
        exported.append(json.load(f)["traceEvents"])
    flows = [[{k: v for k, v in e.items() if k not in ("ts", "tid")}
              for e in events if e.get("cat") == "request"]
             for events in exported]
    assert flows[0] == flows[1]
    # req-a and req-b link enqueue -> flush -> the nested span; req-lonely
    # the flush and the nested span.
    assert [e["ph"] for e in flows[1]] == ["s", "t", "f"] * 2 + ["s", "f"]
    assert sorted({e["name"] for e in flows[1]}) == [
        "request req-a", "request req-b", "request req-lonely"]
    spans = [[{k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
              for e in events if e["ph"] == "X"] for events in exported]
    assert spans[0] == spans[1]
    assert exported[1][0]["ph"] == "M"
    assert "epoch_wall_s" in exported[1][0]["args"]

  def test_ring_bounded_and_threads_nest_apart(self):
    tracer = trace.Tracer(max_spans=10)

    def worker(i):
      for _ in range(50):
        with tracer.span(f"act/t{i}"):
          pass

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
      t.start()
    for t in threads:
      t.join()
    assert len(tracer.spans()) == 10 and tracer.total_spans == 200
    assert all(s["depth"] == 0 for s in tracer.spans())

  def test_record_function_only_inside_a_window(self, tmp_path):
    """Outside a window a span enters no record_function; the guarded
    window turns the ranges on for its length and off after."""
    from tensor2robot_tpu_torch.utils import profiling
    tracer = trace.get_tracer()
    assert not tracer.annotate_devices
    with trace.span("learn/outside"):
      pass
    assert profiling.start_trace(str(tmp_path), device="cpu")
    assert tracer.annotate_devices
    with trace.span("learn/inside"):
      torch.ones(4).sum()
    profiling.stop_trace()
    assert not tracer.annotate_devices
    (path,) = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    with open(path) as f:
      names = {e.get("name") for e in json.load(f)["traceEvents"]
               if e.get("cat") == "user_annotation"}
    assert "learn/inside" in names and "learn/outside" not in names


# --- the flight recorder -----------------------------------------------------


def _recorder_ops(flight_lib, trace_lib, directory):
  recorder = flight_lib.FlightRecorder(capacity=16, dump_dir=directory,
                                       min_dump_interval_s=0.0)
  tracer = trace_lib.Tracer()
  recorder.attach(tracer)
  for i in range(30):
    recorder.record("event", f"e{i}", index=i, blob=np.float32(i) / 3)
  with tracer.span("serve/flush", batch=4, odd=np.int64(2)):
    pass
  recorder.detach(tracer)
  recorder.detach(tracer)  # idempotent
  with tracer.span("serve/after"):
    pass
  return recorder


class TestFlightRecorder:

  def test_dump_payload_equals_jax_bar_time_and_host(self, needs_jax,
                                                     tmp_path):
    payloads = []
    for flight_lib, trace_lib, name in (
        (jax_flight, jax_trace, "jax"), (flight_recorder, trace, "port")):
      recorder = _recorder_ops(flight_lib, trace_lib, str(tmp_path / name))
      path = recorder.trigger("slo_breach", slo_class="batch",
                              request_id="req-1", shed_reason="capacity")
      assert os.path.basename(path).startswith("flightrec-")
      with open(path) as f:
        payload = json.load(f)
      for key in ("dumped_at", "host"):
        payload.pop(key)
      for event in payload["events"]:
        for key in ("t_s", "wall_time", "ts_s", "dur_s", "tid"):
          event.pop(key, None)
      payloads.append(payload)
      assert recorder.dumps_written == 1
    assert payloads[0] == payloads[1]
    assert payloads[1]["schema"] == "t2r-flightrec-1"
    assert payloads[1]["request_id"] == "req-1"
    assert payloads[1]["events_total"] == 32
    assert len(payloads[1]["events"]) == 16

  def test_rate_limit_and_ring_only_equal_jax(self, needs_jax, tmp_path):
    counts = []
    for flight_lib in (jax_flight, flight_recorder):
      limited = flight_lib.FlightRecorder(dump_dir=str(tmp_path / "x"),
                                          min_dump_interval_s=60.0)
      ring_only = flight_lib.FlightRecorder()
      counts.append((
          limited.trigger("breach") is not None,
          limited.trigger("breach") is None,
          limited.dumps_written, limited.dumps_suppressed,
          ring_only.trigger("nowhere") is None,
          ring_only.dump("nowhere") is None,
          ring_only.events()[-1]["kind"]))
    assert counts[0] == counts[1] == (True, True, 1, 1, True, True,
                                      "trigger")

  def test_process_recorder_listens_to_the_process_tracer(self):
    recorder = flight_recorder.get_recorder()
    with trace.span("serve/probe"):
      pass
    assert recorder.events()[-1]["name"] == "serve/probe"


# --- the watchdog ----------------------------------------------------------


def _watchdog_verdicts(watchdog_lib, flight_lib, registry_lib, directory):
  """A scripted clock: beats, idles and busies at fixed times, checked at
  fixed times; returns the events, the counters and the recorder's
  triggers."""
  reg = registry_lib.MetricRegistry()
  recorder = flight_lib.FlightRecorder(dump_dir=directory,
                                       min_dump_interval_s=0.0)
  stalls = []
  dog = watchdog_lib.Watchdog(default_deadline_s=2.0, recorder=recorder,
                              registry=reg, on_stall=stalls.append)
  learner = dog.register("replay/learner")
  batcher = dog.register("serve/batcher", deadline_s=5.0)
  twin = dog.register("replay/learner")
  verdicts = []

  def at(t):
    verdicts.append([dict(e) for e in dog.check_once(now=100.0 + t)])

  def beat(heartbeat, t):
    heartbeat.beat()
    heartbeat._last_beat = 100.0 + t

  beat(learner, 0.0)
  at(1.0)
  at(2.5)   # the learner stalls; the idle batcher and twin never do
  at(3.0)   # one episode, one event
  beat(learner, 3.5)
  at(3.6)   # recovered
  batcher.busy()
  batcher._last_beat = 104.0
  beat(learner, 7.0)
  at(8.0)
  at(9.5)   # the learner stalls again, the busy batcher at its 5 s
  batcher.idle()
  at(10.0)  # idle clears the batcher
  dog.unregister(twin)
  dog.unregister(twin)
  at(20.0)  # nothing new: the learner's episode goes on
  events = [dict(e) for e in dog.events]
  triggers = [e for e in recorder.events() if e["kind"] != "span"]
  for event in triggers:
    event.pop("t_s")
    event.pop("wall_time")
  return (verdicts, events, reg.snapshot(), stalls, triggers,
          dog.stall_count, twin.name,
          sorted(dog.snapshot()["components"]))


class TestWatchdog:

  def test_verdicts_equal_jax_under_an_injected_clock(self, needs_jax,
                                                      tmp_path):
    theirs = _watchdog_verdicts(jax_watchdog, jax_flight, jax_registry,
                                str(tmp_path / "jax"))
    ours = _watchdog_verdicts(watchdog, flight_recorder, registry,
                              str(tmp_path / "port"))
    assert ours == theirs
    verdicts, _, counters, _, _, stall_count, twin, names = ours
    assert [len(v) for v in verdicts] == [0, 1, 0, 0, 0, 2, 0, 0]
    assert counters == {"watchdog/stalls": 3,
                        "watchdog/stall/replay/learner": 2,
                        "watchdog/stall/serve/batcher": 1}
    assert stall_count == 3 and twin == "replay/learner#2"
    assert names == ["replay/learner", "serve/batcher"]

  @pytest.mark.parametrize("rates, fraction", [
      ({"a:1": 100.0, "b:2": 96.0, "c:3": 10.0}, 0.5),
      ({"a:1": 100.0, "b:2": None}, 0.5),
      ({"a:1": 5.0}, 0.5),
      ({"h0:1": 3.0, "h1:2": 2.9, "h2:3": 1.4, "h3:4": 0.0}, 0.6),
  ])
  def test_stragglers_equal_jax(self, needs_jax, rates, fraction):
    assert (watchdog.find_stragglers(rates, fraction)
            == jax_watchdog.find_stragglers(rates, fraction))

  def test_scaled_deadline_follows_the_core_gate(self, monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    assert watchdog.scaled_deadline(1.0) == 4.0
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    assert watchdog.scaled_deadline(1.0) == 1.0

  def test_monitor_thread_stops_with_its_owner(self):
    dog = watchdog.Watchdog(poll_s=0.01)
    with dog:
      thread = dog._thread
      assert thread.is_alive()
    assert not thread.is_alive() and dog._thread is None


# --- the wiring through the replay loop ---------------------------------------


class _SeenWatchdog(watchdog.Watchdog):
  """A watchdog that keeps every heartbeat registered with it."""

  def __init__(self, **kwargs):
    super().__init__(**kwargs)
    self.seen = []

  def register(self, name, deadline_s=None):
    heartbeat = super().register(name, deadline_s)
    self.seen.append(heartbeat)
    return heartbeat


@pytest.fixture(scope="module")
def healthy_run(tmp_path_factory):
  """A healthy host-path run (TinyQ, 16 steps) under a started monitor,
  with a profile window over steps 8-12."""
  root = tmp_path_factory.mktemp("obs_loop")
  dump_dir = str(root / "dumps")
  dog = _SeenWatchdog(
      poll_s=0.1, default_deadline_s=watchdog.scaled_deadline(30.0),
      recorder=flight_recorder.FlightRecorder(dump_dir=dump_dir),
      registry=registry.MetricRegistry())
  logdir = str(root / "logs")
  config = dataclasses.replace(
      run_qtopt_replay.build_config(smoke=True, seed=3), capacity=256,
      min_fill=64, eval_every=8, log_every=8, profile_window=(8, 12))
  model = smoke.TinyQCriticModel(
      image_size=config.image_size, action_size=config.action_size,
      optimizer_fn=optimizers.create_adam_optimizer(config.learning_rate))
  trace.get_tracer().clear()
  with dog:
    results = loop.ReplayTrainLoop(config, logdir, model=model,
                                   watchdog=dog, device="cpu").run(16)
  return results, dog, logdir, dump_dir


class TestReplayLoopWiring:

  def test_healthy_run_is_silent(self, healthy_run):
    results, dog, _, dump_dir = healthy_run
    assert results["steps"] == 16
    assert dog.events == [] and dog.stall_count == 0
    assert not os.path.exists(dump_dir)
    assert dog.snapshot()["components"] == {}
    beats = {}
    for heartbeat in dog.seen:
      beats[heartbeat.name.split("#")[0]] = (
          beats.get(heartbeat.name.split("#")[0], 0) + heartbeat.beats)
    assert beats["replay/learner"] == 16
    assert beats["replay/feeder"] >= 16
    assert beats["act/collector"] > 0

  def test_stage_counts_cover_the_loop(self, healthy_run):
    counts = healthy_run[0]["obs"]["trace_stage_counts"]
    assert {"act", "extend", "learn", "replay"} <= set(counts)
    assert counts["learn"] == 16 and counts["replay"] == 2

  def test_registry_gauges_equal_the_jsonl_records(self, healthy_run):
    _, _, logdir, _ = healthy_run
    last = {}
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
      for line in f:
        record = json.loads(line)
        for key in ("step", "wall_time", "host", "pid"):
          record.pop(key)
        last.update(record)
    assert "replay/train_loss" in last and "health/grad_norm" in last
    gauges = registry.get_registry().snapshot(names=last)
    assert gauges == last

  def test_profile_window_holds_the_spans(self, healthy_run):
    _, _, logdir, _ = healthy_run
    (name,) = os.listdir(os.path.join(logdir, "profile"))
    with open(os.path.join(logdir, "profile", name)) as f:
      ranges = {e["name"] for e in json.load(f)["traceEvents"]
                if e.get("cat") == "user_annotation"}
    assert {"act/cem_policy", "extend/drain", "learn/train_step"} <= ranges
    assert not trace.get_tracer().annotate_devices
