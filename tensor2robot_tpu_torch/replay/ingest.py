"""Episode -> transition ingestion with backpressure and min-fill gating.

Counterpart of ``tensor2robot_tpu/replay/ingest.py``, kept as a copy
(numpy only; the JAX package's ``replay/__init__`` pulls in JAX) that
gives the same bits and counters on the same inputs.

Backpressure: the collector threads and the train thread run at
independent rates, so the hand-off is a BOUNDED queue with a drop-OLDEST
policy — when training stalls, collectors keep running and the queue sheds
the stalest experience first, which is exactly the experience a fresher
policy has already outgrown. Every shed transition is counted: drop_rate
is a first-class loop metric, because silent shedding looks identical to a
healthy loop until the learning curve flattens.

Min-fill gating: training before the buffer holds a minimum diversity of
experience overfits the first few episodes and poisons the priority
distribution; `ReplayFeeder.ready()` gates the first train step on a
configured fill.

Every shed row is also counted into the metric registry
(``replay/transition_queue_dropped``), and sustained overflow (every one of
``overflow_dump_threshold`` consecutive puts shed rows: the consumer is
wedged, not momentarily slow) is a flight-recorder trigger.
"""

from __future__ import annotations

import inspect
import threading
from collections import deque
from typing import Deque, Dict, List, Mapping, Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch.obs import flight_recorder as flight_lib
from tensor2robot_tpu_torch.obs import registry as registry_lib
from tensor2robot_tpu_torch.replay.ring_buffer import ReplayBuffer

# The loop's canonical transition keys (single-step Bellman form).
TRANSITION_KEYS = ("image", "action", "reward", "done", "next_image")


def episode_to_transitions(
    episode: Mapping[str, np.ndarray]) -> List[Dict[str, np.ndarray]]:
  """One episode dict → per-step transition dicts.

  Args:
    episode: {"images": (T+1, H, W, C) observations s_0..s_T,
      "actions": (T, A), "rewards": (T,), "dones": (T,)}. The final
      observation closes the last transition's next_image, mirroring
      the reference's episode_to_transitions stream layout (which
      carried T-aligned streams; the +1 here is the Bellman next-state
      the supervised BC pipeline never needed).

  Returns:
    T dicts keyed by TRANSITION_KEYS.
  """
  images = np.asarray(episode["images"])
  actions = np.asarray(episode["actions"])
  rewards = np.asarray(episode["rewards"], np.float32)
  dones = np.asarray(episode["dones"], np.float32)
  t = len(actions)
  if not (len(images) == t + 1 and len(rewards) == t and len(dones) == t):
    raise ValueError(
        f"Episode streams disagree on length: images={len(images)} "
        f"(need T+1) actions={len(actions)} rewards={len(rewards)} "
        f"dones={len(dones)}")
  return [{
      "image": images[i],
      "action": actions[i],
      "reward": rewards[i],
      "done": dones[i],
      "next_image": images[i + 1],
  } for i in range(t)]


def _chunk_rows(chunk: Mapping[str, np.ndarray]) -> int:
  return next(iter(chunk.values())).shape[0]


class TransitionQueue:
  """Bounded thread-safe transition queue, drop-oldest on overflow.

  Storage is CHUNKED: items in the deque are stacked batches
  of 1..n transitions, so a vectorized actor's per-step fleet batch
  enters as ONE append (no per-row Python churn) and ``drain_batch``
  can hand a single producer chunk straight through without re-stacking.
  Capacity, the drop-oldest policy, and every counter are denominated
  in TRANSITIONS (rows), never chunks: a vector put that overflows
  sheds exactly as many rows as a sequence of scalar puts would, and
  counts each one — drop-oldest slices partial chunks rather than
  rounding the shed to chunk boundaries.

  Counters (all monotonic, read via stats()):
    enqueued: transitions accepted from collectors.
    dropped:  transitions shed by the drop-oldest policy.
    dequeued: transitions drained toward the buffer.

  Provenance: every chunk carries a string label naming its
  producer lineage ("synthetic" collectors vs. "served" fleet traffic);
  labels travel with the rows through drop-oldest slicing and
  ``drain_batch_with_provenance`` hands the buffer a per-row label
  array, so the replay ring's mix accounting is exact even when a drain
  spans chunks from both worlds.
  """

  def __init__(self, capacity: int, *,
               registry: Optional[registry_lib.MetricRegistry] = None,
               flight_recorder: Optional[flight_lib.FlightRecorder] = None,
               overflow_dump_threshold: int = 8):
    if capacity < 1:
      raise ValueError(f"capacity must be >= 1, got {capacity}")
    self.capacity = capacity
    self._items: Deque[Tuple[Dict[str, np.ndarray], str]] = deque()
    self._rows = 0
    self._lock = threading.Lock()
    self.enqueued = 0
    self.dropped = 0
    self.dequeued = 0
    # The process singletons unless the owner passes its own.
    self._registry = registry or registry_lib.get_registry()
    self._dropped_counter = self._registry.counter(
        "replay/transition_queue_dropped")
    self._recorder = flight_recorder or flight_lib.get_recorder()
    self._overflow_dump_threshold = overflow_dump_threshold
    self._overflow_streak = 0

  def put_episode(self, episode: Mapping[str, np.ndarray],
                  provenance: str = "synthetic") -> int:
    """Flattens an episode and enqueues its transitions; returns count."""
    transitions = episode_to_transitions(episode)
    if not transitions:
      return 0
    self.put_batch({key: np.stack([t[key] for t in transitions])
                    for key in TRANSITION_KEYS}, provenance=provenance)
    return len(transitions)

  def put(self, transition: Dict[str, np.ndarray],
          provenance: str = "synthetic") -> None:
    """Enqueues one transition (drop-oldest when full)."""
    self.put_batch({key: np.asarray(value)[None]
                    for key, value in transition.items()},
                   provenance=provenance)

  def put_batch(self, batch: Mapping[str, np.ndarray],
                provenance: str = "synthetic") -> int:
    """Enqueues n stacked transitions as ONE chunk; returns n.

    The vectorized actor's fixed-chunk producer call: one fleet step's
    (n, ...) arrays enter in a single lock hold. Overflow sheds the
    OLDEST rows first — slicing the head chunk when the overflow lands
    mid-chunk — and `dropped` counts every shed ROW (a dropped batch of
    k transitions is k drops, not 1: the drop_rate health metric pages
    on transitions, so batch-granular counting would understate
    shedding by the chunk size). A put larger than capacity keeps only
    the batch's newest `capacity` rows (its own head is the oldest
    experience in sight).

    Ownership transfers with the call: the queue stores the caller's
    arrays WITHOUT copying (that zero-copy hand-through to the buffer's
    extend is the point of chunked storage), so producers must build
    fresh arrays per put — mutating a staging buffer after put_batch
    would silently rewrite queued transitions.
    """
    chunk = {key: np.asarray(value) for key, value in batch.items()}
    provenance = str(provenance)
    sizes = {value.shape[0] for value in chunk.values()}
    if len(sizes) != 1:
      raise ValueError(f"inconsistent chunk leading dims: {sizes}")
    n = sizes.pop()
    if n == 0:
      return 0
    shed = 0
    with self._lock:
      self.enqueued += n
      if n >= self.capacity:
        shed = self._rows + (n - self.capacity)
        self._items.clear()
        self._items.append((
            {key: value[n - self.capacity:]
             for key, value in chunk.items()}, provenance))
        self._rows = self.capacity
        self.dropped += shed
      else:
        overflow = self._rows + n - self.capacity
        if overflow > 0:
          _, shed = self._pop_rows_locked(overflow)
          self.dropped += shed
        self._items.append((chunk, provenance))
        self._rows += n
    # Outside the lock: the sustained-overflow trigger writes a file, and
    # producers must never wait behind a dump.
    self._note_shedding(shed)
    return n

  def _note_shedding(self, shed: int) -> None:
    if shed <= 0:
      self._overflow_streak = 0
      return
    self._dropped_counter.inc(shed)
    self._overflow_streak += 1
    if self._overflow_streak >= self._overflow_dump_threshold:
      self._recorder.trigger(
          "transition_queue_sustained_overflow",
          consecutive_overflow_puts=self._overflow_streak,
          dropped_total=self.dropped,
          pending=self._rows,
          capacity=self.capacity)
      self._overflow_streak = 0

  def _pop_rows_locked(self, limit: int):
    """Pops up to `limit` rows of chunks off the head (sliced when the
    limit lands mid-chunk); caller holds the lock and advances the
    matching counter — `dequeued` for drains, `dropped` for shedding —
    by the returned row count. Returns ((chunk, provenance) pairs,
    rows_popped)."""
    taken: List[Tuple[Dict[str, np.ndarray], str]] = []
    popped = 0
    while popped < limit and self._items:
      head, provenance = self._items[0]
      rows = _chunk_rows(head)
      need = limit - popped
      if rows <= need:
        self._items.popleft()
        taken.append((head, provenance))
      else:
        taken.append(({key: value[:need] for key, value in head.items()},
                      provenance))
        self._items[0] = ({key: value[need:]
                           for key, value in head.items()}, provenance)
        rows = need
      self._rows -= rows
      popped += rows
    return taken, popped

  def drain(self, max_items: Optional[int] = None
            ) -> List[Dict[str, np.ndarray]]:
    """Pops up to max_items (default: all) as per-transition dicts,
    FIFO order (chunks are unstacked into row views outside the lock)."""
    with self._lock:
      pairs, popped = self._pop_rows_locked(
          self._rows if max_items is None else max_items)
      self.dequeued += popped
    return [{key: value[i] for key, value in chunk.items()}
            for chunk, _ in pairs for i in range(_chunk_rows(chunk))]

  def drain_batch(self, max_items: Optional[int] = None
                  ) -> Optional[Dict[str, np.ndarray]]:
    """Pops up to max_items and stacks them into ONE batch per key.

    The buffer-extend path used to copy every leaf twice: drain() built
    per-transition dicts, then the feeder's per-item appends copied each
    leaf again into storage. This emits a single
    stacked array per key — one concatenate, and ZERO copies when the
    drain catches exactly one producer chunk (the vectorized actor's
    steady state: its fleet batch passes straight through to
    ReplayBuffer.extend). Only the pop runs under the lock; the
    concatenation works on the popped chunks outside it, so concurrent
    put() is never blocked behind the copy.

    Returns None when the queue is empty (the per-step drain's common
    case, kept allocation-free).
    """
    batch, _ = self.drain_batch_with_provenance(max_items)
    return batch

  def drain_batch_with_provenance(
      self, max_items: Optional[int] = None
  ) -> Tuple[Optional[Dict[str, np.ndarray]], Optional[np.ndarray]]:
    """``drain_batch`` plus a per-row provenance label array.

    Returns (batch, labels): labels[i] names the producer lineage of
    batch row i ("synthetic" | "served" | ...), built from the chunk
    tags outside the lock. (None, None) when the queue is empty.
    """
    with self._lock:
      pairs, popped = self._pop_rows_locked(
          self._rows if max_items is None else max_items)
      self.dequeued += popped
    if not pairs:
      return None, None
    if len(pairs) == 1:
      chunk, provenance = pairs[0]
      return chunk, np.full(_chunk_rows(chunk), provenance)
    labels = np.concatenate([
        np.full(_chunk_rows(chunk), provenance)
        for chunk, provenance in pairs])
    return {key: np.concatenate([chunk[key] for chunk, _ in pairs])
            for key in pairs[0][0]}, labels

  def restore_counters(self, enqueued: int, dropped: int,
                       dequeued: int) -> None:
    """Re-seats the monotonic accounting after a crash-resume
    Contents are deliberately NOT restored: transitions in
    flight at the crash are lost by design (drop-oldest semantics — a
    fresher policy has outgrown them anyway), but the ingest ledger
    must stay monotonic across the restart or the drop_rate health
    metric silently resets."""
    with self._lock:
      self.enqueued = int(enqueued)
      self.dropped = int(dropped)
      self.dequeued = int(dequeued)

  def __len__(self) -> int:
    with self._lock:
      return self._rows

  def stats(self) -> Dict[str, int]:
    with self._lock:
      return {
          "enqueued": self.enqueued,
          "dropped": self.dropped,
          "dequeued": self.dequeued,
          "pending": self._rows,
      }


class ReplayFeeder:
  """Queue → buffer pump with min-fill gating.

  The train loop calls `drain()` once per step (cheap when empty) and
  gates its first optimizer step on `ready()`. Validation happens at
  the buffer door, so a malformed collector payload surfaces here with
  a spec key, not inside compiled code.
  """

  def __init__(self, queue: TransitionQueue, buffer: ReplayBuffer,
               min_fill: int):
    if min_fill < 1:
      raise ValueError(f"min_fill must be >= 1, got {min_fill}")
    if min_fill > buffer.capacity:
      raise ValueError(
          f"min_fill {min_fill} exceeds buffer capacity "
          f"{buffer.capacity}: the gate would never open")
    self.queue = queue
    self.buffer = buffer
    self.min_fill = min_fill
    # The host rings keep per-provenance ingest counts; the device ring's
    # extend takes no provenance, so the hand-off is detected once here.
    self._extend_takes_provenance = "provenance" in inspect.signature(
        buffer.extend).parameters

  def drain(self) -> int:
    """Moves every pending transition into the buffer; returns count.

    One stacked batch through buffer.extend (single concatenate per
    key + one vectorized ring write) instead of per-item appends; the
    same call feeds the device-resident ring, whose extend writes fixed
    chunks to the card.
    """
    return self.put(*self.take())

  def take(self):
    """(batch, provenance labels) of every pending transition, taken off
    the queue; (None, None) when it is empty. ``drain`` is ``put`` of
    it; the replay loop over a mesh hands it from the primary rank to the
    others between the two."""
    return self.queue.drain_batch_with_provenance()

  def put(self, batch, labels) -> int:
    """Extends the buffer with a ``take``'s batch; returns its rows."""
    if batch is None:
      return 0
    if self._extend_takes_provenance:
      return self.buffer.extend(batch, provenance=labels)
    return self.buffer.extend(batch)

  def ready(self) -> bool:
    """True once the buffer holds min_fill transitions (latching —
    the ring never shrinks, so once open the gate stays open)."""
    return self.buffer.size >= self.min_fill

  def metrics(self) -> Dict[str, float]:
    """Feeder/queue health block (metric_writer-ready)."""
    stats = self.queue.stats()
    enqueued = max(stats["enqueued"], 1)
    return {
        "replay/ingest_enqueued": float(stats["enqueued"]),
        "replay/ingest_dropped": float(stats["dropped"]),
        "replay/ingest_pending": float(stats["pending"]),
        "replay/drop_rate": stats["dropped"] / enqueued,
        "replay/min_fill_ready": float(self.ready()),
    }
