"""Observability: the host spine and the training-health sentinel.

Counterpart of ``tensor2robot_tpu/obs``'s host spine:

- ``context``: request and step correlation ids carried in contextvars;
- ``registry``: the process-wide typed metric registry (counters, gauges,
  bounded histograms) with one bridge into ``utils.metric_writer``;
- ``trace``: host spans, ``torch.profiler.record_function`` ranges while
  a guarded profiler window is open, Chrome-trace export with request
  flows;
- ``flight_recorder``: a bounded ring of recent spans and events, dumped
  atomically on a trigger;
- ``watchdog``: heartbeats for every loop thread, stall escalation and
  straggler detection;
- ``health``: the training-health sentinel, escalating through the
  registry and the recorder, and the fleet's Q-drift report;
- ``ledger``: the executable ledger (build counts, dispatches, their time
  and FLOPs a program; the replay loop's ``obs.attribution``) and the
  shared exactly-once assertion.

Fault injection, the fleet aggregator and the benches wait for
``ROADMAP.md``'s flagship item 15c.
"""

from tensor2robot_tpu_torch.obs.context import (
    bind,
    current_request_id,
    new_request_id,
)
from tensor2robot_tpu_torch.obs.flight_recorder import (
    FlightRecorder,
    get_recorder,
)
from tensor2robot_tpu_torch.obs.health import q_drift_report
from tensor2robot_tpu_torch.obs.ledger import (
    ExecutableLedger,
    check_compile_ledger,
)
from tensor2robot_tpu_torch.obs.registry import MetricRegistry, get_registry
from tensor2robot_tpu_torch.obs.trace import (
    Tracer,
    get_tracer,
    set_device_annotations,
    span,
)
from tensor2robot_tpu_torch.obs.watchdog import (
    Watchdog,
    find_stragglers,
    get_watchdog,
)

__all__ = [
    "ExecutableLedger",
    "FlightRecorder",
    "MetricRegistry",
    "Tracer",
    "Watchdog",
    "bind",
    "check_compile_ledger",
    "current_request_id",
    "find_stragglers",
    "get_recorder",
    "get_registry",
    "get_tracer",
    "get_watchdog",
    "new_request_id",
    "q_drift_report",
    "set_device_annotations",
    "span",
]
