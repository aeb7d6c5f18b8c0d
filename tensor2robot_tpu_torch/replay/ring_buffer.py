"""ReplayBuffer: fixed-shape in-memory ring over spec-validated transitions.

Counterpart of ``tensor2robot_tpu/replay/ring_buffer.py``, kept as a copy
(numpy only; the JAX package's ``replay/__init__`` pulls in JAX) that
gives the same bits on the same seeds: the same slots, sampled indices,
priorities, metrics and ``state_dict`` arrays. It validates against the
port's own ``specs``.

  - Storage is PREALLOCATED numpy, one array per flat spec key — append
    is an O(1) slot write with wraparound, and capacity is an honest
    bound (no hidden growth).
  - Every transition is validated against a `TensorSpecStruct` at the
    door (shape + dtype), so a malformed collector payload fails at
    ingest with a key name, never as a shape error inside a train step.
  - `sample()` ALWAYS returns `sample_batch_size` transitions — with
    replacement when underfilled — so every consumer sees one shape.
  - Sampling is seeded (one generator owned by the buffer) and either
    uniform or prioritized: TD-error-proportional via replay/sum_tree
    with the standard (|td| + eps)^alpha shaping; fresh appends get the
    current max priority so new experience is seen at least once before
    its TD error exists.

Thread-safety: one lock guards append/sample/priority state. Collectors
append from worker threads while the train thread samples; the lock is
held only for numpy slot writes/gathers, never across device work.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import numpy as np

from tensor2robot_tpu_torch.replay.sum_tree import SumTree
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts


@dataclass
class SampleInfo:
  """Bookkeeping riding along with a sampled batch.

  indices: buffer slots of the batch (feed back to update_priorities).
  staleness: per-item age in APPENDS (append_count at sample time minus
    append_count when the slot was written) — the replay-health metric
    the loop exports; rises when collection stalls behind training.
  probabilities: per-item sampling probability (importance-weight hook;
    uniform batches carry 1/size). ALWAYS float32, the dtype of the
    device-resident ring (``replay/device_buffer.py``), so the two are
    interchangeable downstream.
  """
  indices: np.ndarray
  staleness: np.ndarray
  probabilities: np.ndarray


class ReplayBuffer:
  """Sharded in-memory ring of spec-validated transitions."""

  def __init__(
      self,
      transition_spec: ts.SpecStructure,
      capacity: int,
      sample_batch_size: int,
      seed: int = 0,
      prioritized: bool = False,
      priority_exponent: float = 0.6,
      min_priority: float = 1e-3,
  ):
    """Args:
      transition_spec: flat-or-nested spec structure; one storage array
        is preallocated per flat key.
      capacity: ring size in transitions.
      sample_batch_size: THE batch shape every sample() emits — fixed at
        construction so consumers compile once.
      seed: the buffer's single RNG seed (sampling determinism).
      prioritized: TD-proportional sampling via a sum tree; False =
        seeded uniform.
      priority_exponent: alpha in p = (|td| + min_priority)^alpha;
        0 recovers uniform-with-tree.
      min_priority: epsilon floor so zero-TD transitions stay reachable.
    """
    if capacity < 1:
      raise ValueError(f"capacity must be >= 1, got {capacity}")
    if sample_batch_size < 1:
      raise ValueError(
          f"sample_batch_size must be >= 1, got {sample_batch_size}")
    self._spec = ts.flatten_spec_structure(transition_spec)
    if not list(self._spec.keys()):
      raise ValueError("transition_spec has no leaves")
    self.capacity = capacity
    self.sample_batch_size = sample_batch_size
    self._storage: Dict[str, np.ndarray] = {
        key: np.zeros((capacity,) + spec.shape, np.dtype(spec.dtype))
        for key, spec in self._spec.items()
    }
    self._rng = np.random.default_rng(seed)
    self._lock = threading.Lock()
    self._next = 0
    self._size = 0
    self._append_count = 0
    # Provenance ledger: monotonic per-lineage ingest counts
    # ("synthetic" collectors vs. "served" fleet traffic). Counts
    # INGESTED transitions, not retained ones — the flywheel's mix
    # accounting is about what the learner has consumed, and a ring
    # overwrite doesn't un-consume the overwritten row.
    self._provenance: Dict[str, int] = {}
    # Append index at which each slot was last written (staleness).
    self._written_at = np.zeros(capacity, np.int64)
    self._prioritized = prioritized
    self._alpha = priority_exponent
    self._min_priority = min_priority
    self._tree = SumTree(capacity) if prioritized else None
    self._max_priority = 1.0

  # --- writes --------------------------------------------------------------

  def append(self, transition: Mapping[str, np.ndarray],
             provenance: str = "synthetic") -> int:
    """Validates + writes one transition; returns the slot. O(1)."""
    arrays = self._validate(transition, batched=False)
    with self._lock:
      slot = self._next
      for key, array in arrays.items():
        self._storage[key][slot] = array
      self._written_at[slot] = self._append_count
      self._append_count += 1
      self._provenance[provenance] = (
          self._provenance.get(provenance, 0) + 1)
      self._next = (self._next + 1) % self.capacity
      self._size = min(self._size + 1, self.capacity)
      if self._tree is not None:
        # Max-priority insert: unseen experience outranks everything
        # until its first TD error arrives via update_priorities.
        self._tree.set(slot, self._max_priority)
    return slot

  def extend(self, transitions: Mapping[str, np.ndarray],
             provenance="synthetic") -> int:
    """Appends a batch (leading axis on every leaf); returns count.

    ONE vectorized slot write per key. Exactly equivalent to n sequential
    appends, including
    bursts larger than capacity: modular positions repeat and numpy
    fancy-store keeps the LAST write per slot, which is precisely the
    survivor a one-by-one wraparound leaves.

    ``provenance`` is either one label for the whole batch or a per-row
    label sequence (the TransitionQueue's drain emits the latter when a
    drain spans chunks from different producers); either way
    the per-lineage ledger advances by exactly the ingested row counts.
    """
    arrays = self._validate(transitions, batched=True)
    n = next(iter(arrays.values())).shape[0]
    if n == 0:
      return 0
    counts = _provenance_counts(provenance, n)
    with self._lock:
      for label, rows in counts.items():
        self._provenance[label] = self._provenance.get(label, 0) + rows
      positions = (self._next + np.arange(n)) % self.capacity
      for key, array in arrays.items():
        self._storage[key][positions] = array
      self._written_at[positions] = self._append_count + np.arange(n)
      self._append_count += n
      self._next = (self._next + n) % self.capacity
      self._size = min(self._size + n, self.capacity)
      if self._tree is not None:
        # Max-priority insert for every fresh slot (append() parity).
        self._tree.set(positions, self._max_priority)
    return n

  # --- reads ---------------------------------------------------------------

  def sample(self) -> Tuple[ts.TensorSpecStruct, SampleInfo]:
    """One fixed-shape batch + its SampleInfo.

    Underfilled buffers sample with replacement over the filled prefix
    (min-fill gating in replay/ingest keeps the loop from training on
    those, but the shape contract holds regardless).
    """
    with self._lock:
      if self._size == 0:
        raise ValueError("cannot sample from an empty ReplayBuffer")
      n = self.sample_batch_size
      if self._tree is not None and self._tree.total > 0:
        indices = self._tree.sample(self._rng.random(n))
        # Float-edge descents can exit on a zero-mass leaf (and the
        # tree's out-of-range clamp lands on capacity-1, an UNWRITTEN
        # slot while the ring is underfilled): remap any zero-priority
        # pick onto the filled prefix instead of emitting the zeroed
        # storage init as a transition.
        zero = self._tree.get(indices) <= 0.0
        probabilities = self._tree.get(indices) / self._tree.total
        if zero.any():
          indices = np.asarray(indices).copy()
          indices[zero] = self._rng.integers(0, self._size,
                                             int(zero.sum()))
          # Remapped picks were drawn UNIFORMLY over the filled prefix
          # — report that probability, not the landing slot's priority,
          # or importance weights correct for the wrong distribution.
          probabilities = probabilities.copy()
          probabilities[zero] = 1.0 / self._size
      else:
        indices = self._rng.integers(0, self._size, n)
        probabilities = np.full(n, 1.0 / self._size)
      batch = ts.TensorSpecStruct({
          key: array[indices].copy()
          for key, array in self._storage.items()
      })
      staleness = self._append_count - self._written_at[indices]
    # float32 at the boundary: the device-resident ring computes
    # probabilities in float32. Tree math stays float64 inside.
    return batch, SampleInfo(indices=np.asarray(indices, np.int64),
                             staleness=np.asarray(staleness, np.int64),
                             probabilities=np.asarray(probabilities,
                                                      np.float32))

  def update_priorities(self, indices, td_errors) -> None:
    """TD-error-proportional priority refresh for sampled slots.

    TD errors are normalized to float32 at this boundary (the
    device-resident ring's dtype), so identical inputs give bit-identical
    priorities on both paths.
    """
    if self._tree is None:
      return
    td = np.abs(np.asarray(td_errors, np.float32)).reshape(-1)
    priorities = ((td + np.float32(self._min_priority))
                  ** np.float32(self._alpha))
    with self._lock:
      self._tree.set(np.asarray(indices, np.int64).reshape(-1),
                     priorities)
      self._max_priority = max(self._max_priority,
                               float(priorities.max(initial=0.0)))

  # --- checkpoint state (learner crash-resume) ------------------------------

  def state_dict(self) -> Tuple[Dict[str, np.ndarray], Dict]:
    """(arrays, meta): everything needed to rebuild this ring bit-exactly
    — storage, write cursor/size/append bookkeeping, priorities (the
    sum tree rebuilds from its leaves), and the sampling rng's full
    bit-generator state, so a restored buffer's sample() stream
    CONTINUES the saved one (the resume-equals-uninterrupted parity
    bar depends on exactly this)."""
    with self._lock:
      arrays = {f"storage/{key}": array.copy()
                for key, array in self._storage.items()}
      arrays["written_at"] = self._written_at.copy()
      if self._tree is not None:
        arrays["priorities"] = self._tree.leaves(self.capacity)
      meta = {
          "capacity": self.capacity,
          "sample_batch_size": self.sample_batch_size,
          "prioritized": self._prioritized,
          "next": self._next,
          "size": self._size,
          "append_count": self._append_count,
          "max_priority": self._max_priority,
          "rng_state": self._rng.bit_generator.state,
          # Mix accounting rides the checkpoint: a resumed
          # flywheel's served/synthetic ledger continues bit-exactly.
          "provenance": {k: int(v)
                         for k, v in sorted(self._provenance.items())},
      }
    return arrays, meta

  def load_state_dict(self, arrays: Dict[str, np.ndarray],
                      meta: Dict) -> None:
    """Inverse of state_dict into THIS buffer (same spec/capacity/batch
    — a drifted geometry refuses with the mismatch named, because a
    silently reshaped ring would recompile every fixed-shape
    consumer)."""
    ours = {"capacity": self.capacity,
            "sample_batch_size": self.sample_batch_size,
            "prioritized": bool(self._prioritized)}
    for field, value in ours.items():
      saved = bool(meta[field]) if field == "prioritized" else meta[field]
      if saved != value:
        raise ValueError(
            f"checkpointed buffer {field}={meta[field]} does not match "
            f"this buffer's {value}; resume needs an identically "
            "configured ring")
    with self._lock:
      for key, array in self._storage.items():
        saved = np.asarray(arrays[f"storage/{key}"])
        if saved.shape != array.shape or saved.dtype != array.dtype:
          raise ValueError(
              f"checkpointed storage {key!r} is {saved.dtype}"
              f"{saved.shape}, ring expects {array.dtype}{array.shape}")
        array[...] = saved
      self._written_at[...] = np.asarray(arrays["written_at"], np.int64)
      self._next = int(meta["next"])
      self._size = int(meta["size"])
      self._append_count = int(meta["append_count"])
      self._max_priority = float(meta["max_priority"])
      # Checkpoints from before the provenance ledger carry no block:
      # restore an empty ledger rather than refusing the resume.
      self._provenance = {str(k): int(v)
                          for k, v in meta.get("provenance", {}).items()}
      self._rng.bit_generator.state = meta["rng_state"]
      if self._tree is not None:
        leaves = np.asarray(arrays["priorities"], np.float64)
        self._tree.set(np.arange(self.capacity, dtype=np.int64), leaves)

  # --- health metrics ------------------------------------------------------

  @property
  def size(self) -> int:
    return self._size

  @property
  def append_count(self) -> int:
    return self._append_count

  def provenance_counts(self) -> Dict[str, int]:
    """{lineage: transitions ingested} — monotonic."""
    with self._lock:
      return dict(self._provenance)

  @property
  def fill_fraction(self) -> float:
    return self._size / self.capacity

  def priority_entropy(self) -> float:
    """Normalized entropy (0..1) of the sampling distribution.

    1.0 = uniform (also reported for uniform buffers); falling entropy
    means priority mass is concentrating on few transitions — the
    overfit-to-outliers failure mode prioritized replay must be watched
    for, hence a first-class loop metric.
    """
    with self._lock:
      if self._size <= 1:
        return 1.0
      if self._tree is None:
        return 1.0
      leaves = self._tree.leaves(self._size)
    total = leaves.sum()
    if total <= 0:
      return 1.0
    p = leaves / total
    p = p[p > 0]
    return float(-(p * np.log(p)).sum() / np.log(self._size))

  def metrics(self) -> Dict[str, float]:
    """The buffer's scalar health block (metric_writer-ready)."""
    out = {
        "replay/fill_fraction": self.fill_fraction,
        "replay/size": float(self._size),
        "replay/append_count": float(self._append_count),
        "replay/priority_entropy": self.priority_entropy(),
    }
    for label, count in self.provenance_counts().items():
      out[f"replay/provenance/{label}"] = float(count)
    return out

  # --- validation ----------------------------------------------------------

  def _validate(self, transition: Mapping[str, np.ndarray],
                batched: bool) -> Dict[str, np.ndarray]:
    """Spec-driven door check: exact keys, shapes, castable dtypes."""
    return _validate_against_spec(self._spec, transition, batched)


class ShardedReplayBuffer:
  """N independent ReplayBuffer shards behind one buffer interface.

  The distributed-replay shape of the reference's QT-Opt log buffer:
  many collector processes append without contending on one lock, and
  sampling gathers a FIXED per-shard quota so the emitted batch shape
  never changes. Here the shards are in-process (threaded collectors);
  the interface — striped append, quota sampling, global slot ids for
  priority updates — is the one a cross-host implementation keeps.

  Sharding rules:
    - append() stripes round-robin (one atomic counter, no hot shard);
    - sample() draws sample_batch_size / num_shards from EVERY shard
      and concatenates, so one stalled collector shows up as rising
      staleness in its stripe, never as a shape change;
    - global index = shard * shard_capacity + local slot, so
      update_priorities routes back without a lookup table.
  """

  def __init__(self, transition_spec, capacity: int,
               sample_batch_size: int, num_shards: int = 2,
               seed: int = 0, **buffer_kwargs):
    if num_shards < 1:
      raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if capacity % num_shards:
      raise ValueError(
          f"capacity {capacity} not divisible by num_shards {num_shards}")
    if sample_batch_size % num_shards:
      raise ValueError(
          f"sample_batch_size {sample_batch_size} not divisible by "
          f"num_shards {num_shards}")
    self.num_shards = num_shards
    self.capacity = capacity
    self.sample_batch_size = sample_batch_size
    self._shard_capacity = capacity // num_shards
    self._quota = sample_batch_size // num_shards
    # Distinct per-shard seeds: identical streams would correlate the
    # stripes' samples.
    self._shards = [
        ReplayBuffer(transition_spec, self._shard_capacity,
                     self._quota, seed=seed + 1000 * i, **buffer_kwargs)
        for i in range(num_shards)
    ]
    self._spec = self._shards[0]._spec
    self._lock = threading.Lock()
    self._stripe = 0

  def append(self, transition: Mapping[str, np.ndarray],
             provenance: str = "synthetic") -> int:
    with self._lock:
      shard = self._stripe
      self._stripe = (self._stripe + 1) % self.num_shards
    slot = self._shards[shard].append(transition, provenance=provenance)
    return shard * self._shard_capacity + slot

  def extend(self, transitions: Mapping[str, np.ndarray],
             provenance="synthetic") -> int:
    # Validate the WHOLE batch first (mismatched leading dims fail here
    # with a named key), so a bad payload can never partially stripe
    # into the shards before raising. Rows then stripe round-robin in
    # ONE grouped vectorized write per shard — identical final state to
    # n sequential appends (within a shard, row order is preserved, so
    # slots and shard-local append indices match the one-by-one path).
    # Per-row provenance labels stripe under the same masks,
    # so each shard's lineage ledger counts exactly its own rows and the
    # checkpointed per-shard ledgers sum to the global mix.
    arrays = _validate_against_spec(self._spec, transitions, batched=True)
    n = next(iter(arrays.values())).shape[0]
    if n == 0:
      return 0
    labels = (None if isinstance(provenance, str)
              else np.asarray(provenance))
    if labels is not None and labels.shape[0] != n:
      raise ValueError(
          f"provenance labels {labels.shape[0]} != batch rows {n}")
    with self._lock:
      start = self._stripe
      self._stripe = (self._stripe + n) % self.num_shards
    shard_of = (start + np.arange(n)) % self.num_shards
    for i, shard in enumerate(self._shards):
      mask = shard_of == i
      if mask.any():
        shard.extend(
            {key: array[mask] for key, array in arrays.items()},
            provenance=provenance if labels is None else labels[mask])
    return n

  def sample(self) -> Tuple[ts.TensorSpecStruct, SampleInfo]:
    parts = [shard.sample() for shard in self._shards]
    keys = list(dict(parts[0][0]).keys())
    batch = ts.TensorSpecStruct({
        key: np.concatenate([dict(b)[key] for b, _ in parts])
        for key in keys
    })
    info = SampleInfo(
        indices=np.concatenate([
            info.indices + i * self._shard_capacity
            for i, (_, info) in enumerate(parts)]),
        # Shards count only their own (1/N of global, round-robin)
        # appends; scale to GLOBAL appends so the staleness metric is
        # invariant to num_shards instead of shrinking N-fold.
        staleness=np.concatenate(
            [info.staleness * self.num_shards for _, info in parts]),
        probabilities=np.concatenate(
            # Uniform-over-shards mixture: each stripe contributes its
            # quota, so the global probability is the shard's / N.
            [info.probabilities / self.num_shards for _, info in parts]),
    )
    return batch, info

  def update_priorities(self, indices, td_errors) -> None:
    indices = np.asarray(indices, np.int64).reshape(-1)
    td = np.asarray(td_errors, np.float32).reshape(-1)
    shard_of = indices // self._shard_capacity
    local = indices % self._shard_capacity
    for i, shard in enumerate(self._shards):
      mask = shard_of == i
      if mask.any():
        shard.update_priorities(local[mask], td[mask])

  def state_dict(self) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Per-shard state under 'shard<i>/' key prefixes + the stripe
    cursor (checkpoint/resume, same contract as ReplayBuffer's)."""
    arrays: Dict[str, np.ndarray] = {}
    shard_metas = []
    for i, shard in enumerate(self._shards):
      shard_arrays, shard_meta = shard.state_dict()
      arrays.update({f"shard{i}/{key}": value
                     for key, value in shard_arrays.items()})
      shard_metas.append(shard_meta)
    with self._lock:
      stripe = self._stripe
    return arrays, {"num_shards": self.num_shards, "stripe": stripe,
                    "shards": shard_metas}

  def load_state_dict(self, arrays: Dict[str, np.ndarray],
                      meta: Dict) -> None:
    if meta["num_shards"] != self.num_shards:
      raise ValueError(
          f"checkpointed num_shards={meta['num_shards']} does not "
          f"match this buffer's {self.num_shards}")
    for i, shard in enumerate(self._shards):
      prefix = f"shard{i}/"
      shard.load_state_dict(
          {key[len(prefix):]: value for key, value in arrays.items()
           if key.startswith(prefix)},
          meta["shards"][i])
    with self._lock:
      self._stripe = int(meta["stripe"])

  @property
  def size(self) -> int:
    return sum(shard.size for shard in self._shards)

  @property
  def append_count(self) -> int:
    return sum(shard.append_count for shard in self._shards)

  def provenance_counts(self) -> Dict[str, int]:
    """Global {lineage: count}: the sum of the shards' ledgers (each
    shard checkpoints its own, so resume is bit-exact per stripe)."""
    totals: Dict[str, int] = {}
    for shard in self._shards:
      for label, count in shard.provenance_counts().items():
        totals[label] = totals.get(label, 0) + count
    return totals

  @property
  def fill_fraction(self) -> float:
    return self.size / self.capacity

  def priority_entropy(self) -> float:
    """Mean of per-shard normalized entropies (each already 0..1)."""
    return float(np.mean(
        [shard.priority_entropy() for shard in self._shards]))

  def metrics(self) -> Dict[str, float]:
    out = {
        "replay/fill_fraction": self.fill_fraction,
        "replay/size": float(self.size),
        "replay/append_count": float(self.append_count),
        "replay/priority_entropy": self.priority_entropy(),
    }
    for label, count in self.provenance_counts().items():
      out[f"replay/provenance/{label}"] = float(count)
    return out


def _provenance_counts(provenance, n: int) -> Dict[str, int]:
  """One whole-batch label or a per-row label sequence → {label: rows}.

  A per-row sequence must cover the batch exactly — a silent broadcast
  or truncation would corrupt the mix ledger it exists to keep.
  """
  if isinstance(provenance, str):
    return {provenance: n}
  labels = np.asarray(provenance)
  if labels.shape[0] != n:
    raise ValueError(
        f"provenance labels {labels.shape[0]} != batch rows {n}")
  unique, counts = np.unique(labels, return_counts=True)
  return {str(label): int(count)
          for label, count in zip(unique, counts)}


def _validate_against_spec(spec_struct, transition: Mapping[str, np.ndarray],
                           batched: bool) -> Dict[str, np.ndarray]:
  """Spec-driven door check: exact keys, shapes, castable dtypes."""
  flat = (dict(transition.items()) if isinstance(
      transition, ts.TensorSpecStruct)
          else dict(ts.TensorSpecStruct(transition).items()))
  missing = [k for k in spec_struct if k not in flat]
  extra = [k for k in flat if k not in spec_struct]
  if missing or extra:
    raise ValueError(
        f"transition keys disagree with spec: missing={missing} "
        f"extra={extra}")
  out = {}
  batch = None
  for key, spec in spec_struct.items():
    array = np.asarray(flat[key])
    expected = spec.shape
    got = array.shape[1:] if batched else array.shape
    if tuple(got) != tuple(expected):
      raise ValueError(
          f"{key}: shape {tuple(array.shape)} does not match spec "
          f"{tuple(expected)}{' (+ leading batch)' if batched else ''}")
    if batched:
      if batch is None:
        batch = array.shape[0]
      elif array.shape[0] != batch:
        raise ValueError(
            f"{key}: leading batch {array.shape[0]} != {batch}")
    if not np.can_cast(array.dtype, spec.dtype, casting="same_kind"):
      raise ValueError(
          f"{key}: dtype {array.dtype} not same-kind castable to "
          f"spec {np.dtype(spec.dtype)}")
    out[key] = array.astype(spec.dtype, copy=False)
  return out
