"""Request-scoped correlation ids.

Counterpart of ``tensor2robot_tpu/obs/context.py``, the same code: a fleet
request crosses threads (the client that enqueued it, the dispatcher that
flushed it, the device call), and these ids join its spans into one
timeline.

- ``new_request_id()`` mints a fleet-unique ``<host>-<pid>-<seq>`` id at
  ingress (``FleetServer.submit``, a bare ``MicroBatcher.submit``);
- ``bind(request_id=, request_ids=, step_id=)`` carries ids in
  ``contextvars``; every ``obs.trace`` span completed while bound carries
  them as attrs (explicit span attrs win);
- a ``ContextVar`` does not cross threads, so the batcher's dispatcher
  re-binds a flush's ids itself: ``serve/flush`` spans carry the batch's
  ids as one comma-joined ``request_ids`` attr (``join_ids``), which
  ``span_request_ids`` decodes and ``Tracer.export_chrome_trace`` turns
  into Perfetto flows.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import socket
from typing import Dict, Iterable, Optional

# `request_id`: one client request end to end; `request_ids`: the
# batch-side form a flush binds; `step_id`: one loop step.
_REQUEST_ID: contextvars.ContextVar = contextvars.ContextVar(
    "t2r_request_id", default=None)
_REQUEST_IDS: contextvars.ContextVar = contextvars.ContextVar(
    "t2r_request_ids", default=None)
_STEP_ID: contextvars.ContextVar = contextvars.ContextVar(
    "t2r_step_id", default=None)

_SEQ = itertools.count()
# The pid is read at each mint, so a fork cannot reuse its parent's ids.
_HOST = socket.gethostname().split(".", 1)[0]


def new_request_id() -> str:
  """Mints one fleet-unique request id: ``<host>-<pid>-<seq>``."""
  return f"{_HOST}-{os.getpid()}-{next(_SEQ)}"


def current_request_id() -> Optional[str]:
  return _REQUEST_ID.get()


def current_step_id() -> Optional[int]:
  return _STEP_ID.get()


def context_attrs() -> Dict[str, object]:
  """The bound correlation attrs (empty when nothing is bound): the
  tracer's read at each span's end."""
  request_id = _REQUEST_ID.get()
  request_ids = _REQUEST_IDS.get()
  step_id = _STEP_ID.get()
  if request_id is None and request_ids is None and step_id is None:
    return {}
  attrs: Dict[str, object] = {}
  if request_id is not None:
    attrs["request_id"] = request_id
  if request_ids is not None:
    attrs["request_ids"] = request_ids
  if step_id is not None:
    attrs["step_id"] = step_id
  return attrs


@contextlib.contextmanager
def bind(request_id: Optional[str] = None,
         request_ids: Optional[str] = None,
         step_id: Optional[int] = None):
  """Binds the given ids for the ``with`` block; the fields not given keep
  their values, so a nested ``step_id`` keeps an enclosing
  ``request_id``."""
  tokens = []
  try:
    if request_id is not None:
      tokens.append((_REQUEST_ID, _REQUEST_ID.set(request_id)))
    if request_ids is not None:
      tokens.append((_REQUEST_IDS, _REQUEST_IDS.set(request_ids)))
    if step_id is not None:
      tokens.append((_STEP_ID, _STEP_ID.set(int(step_id))))
    yield
  finally:
    for var, token in reversed(tokens):
      var.reset(token)


def join_ids(ids: Iterable[Optional[str]]) -> str:
  """The batch encoding: comma-joined, Nones dropped (span attrs stay JSON
  scalars; the trace exporter splits on ",")."""
  return ",".join(i for i in ids if i)


def span_request_ids(record: dict) -> Iterable[str]:
  """Every request id a completed span record carries: its
  ``request_id``, then each of its ``request_ids``."""
  single = record.get("request_id")
  if single:
    yield single
  many = record.get("request_ids")
  if many:
    for part in str(many).split(","):
      if part and part != single:
        yield part
