"""Device-resident replay and the megastep learner.

Counterpart of ``tensor2robot_tpu/replay/device_buffer.py``. The host
path (``learner_bench.host_learner_step``) pays a host sample, a copy to
the card, ~1,000 eager launches and a priority write-back on the host for
every optimizer step. Here the learner's whole hot path stays on the
card:

- ``DeviceReplayBuffer``: the replay ring as tensors on the buffer's
  device (``DeviceReplayState``: storage per flat spec key, ``written_at``,
  the scalar bookkeeping and the sum tree), with the ring functions
  ``extend_fn`` / ``sample_fn`` / ``update_priorities_fn`` /
  ``priority_entropy_fn``. They change the state's tensors in place, the
  port's stand-in for the JAX package's donation: a CUDA graph only sees
  tensors that keep their storage. The host surface (``extend`` staged in
  fixed ``ingest_chunk`` quanta, ``sample``, ``update_priorities``, the
  metrics) is the JAX buffer's, so ``ReplayFeeder`` drains into either
  ring. The sum tree is a float32 tensor in the complete-binary-heap
  layout of ``sum_tree.SumTree``; every update recomputes all parents level
  by level (the JAX sums, bit for bit), and sampling is the same
  root-to-leaf descent.
- ``make_learn_iteration_fn``: one sample -> CEM-Bellman label -> train
  -> TD -> reprioritize iteration, through the port's shared target body
  (``bellman.make_bellman_targets_fn``) and ``Trainer.train_step``.
- ``MegastepLearner``: K iterations a dispatch and one readback of the
  metrics. On the card they run as one CUDA graph of the K iterations,
  captured once after one eager dispatch on a side stream and replayed
  once a dispatch; on the CPU the same body runs eagerly.

**The draws.** JAX draws the ring's ``randint`` and ``uniform`` from
``fold_in(key(seed), outer * K + inner)`` with threefry inside its
program; threefry and Philox cannot agree. The port follows
``replay/bellman.py``'s rule: the host draws them with numpy, from
``np.random.default_rng((seed, outer * K + inner))`` (``sample_draws``;
the host knows ``size``, since only the host extends), and each state's
CEM noise from ``cem.seeded_noise`` on the JAX package's uint32 label-seed
counter. A dispatch's draws reach the card in one host-to-device copy into
the graph's input buffer. ``sample(draws=)`` and the learn iteration take
the JAX package's own draws in the parity tests.

**Scoring tiers.** ``MegastepLearner(precision=)`` runs the label
stage's CEM at the tier (``research/qtopt/cem.py``), its casts inside the
captured graph over the target net's float32 tensors; the train step, the
TD errors and the priorities stay float32.

**The ledger.** ``DeviceReplayBuffer(ledger=)`` registers each ring
function at its first use (``device_extend``, ``device_sample``,
``device_update_priorities_n<N>``, shapes ``{capacity, chunk, batch}``)
and records each host call's seconds: ``sample`` through its readback,
``extend`` and ``update_priorities`` their launches only, a lower bound
(they fire and forget). ``MegastepLearner(ledger=)`` registers
``megastep`` at each build (shapes ``{inner_steps, batch}``, the scoring
tier, the FLOPs of a dispatch: K times those of the first learn
iteration of one eager dispatch, the graphed path's warm-up or the eager
path's first) and records each dispatch from its launch through the
metrics readback, its one wait.

**Over a mesh of ranks.** ``DeviceReplayBuffer(mesh=)`` splits the ring
over the mesh's data axis (``parallel.mesh.ring_sharding``): each rank
holds ``capacity / dp`` rows of the storage and of ``written_at``, a
contiguous block of the global slots, while the cursors, the sum tree and
``max_priority`` stay whole on every rank and change alike, from the same
global draws. An extend writes the rows of the global chunk that fall in
this rank's block (``extend_fn(local_rows=True)`` first gathers a chunk
whose rows the ranks hold in blocks, the Anakin fleet's); a sample draws
global slots, each rank reads the rows it owns, and one ``all_gather``
of their bytes gives every rank the whole batch. The learn iteration then
keeps this rank's block of it (``constrain_batch``), trains data parallel
through the trainer's mesh, and gathers the TD errors so every rank
writes the same priorities. A mesh of more than one rank runs the
megastep eagerly: gloo's collectives run on the host, outside any CUDA
graph (``trainer.check_graphable``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from tensor2robot_tpu_torch import Device, resolve_device
from tensor2robot_tpu_torch.obs import health as health_lib
from tensor2robot_tpu_torch.obs import trace as trace_lib
from tensor2robot_tpu_torch.ops import graph_launches
from tensor2robot_tpu_torch.parallel import collectives, distributed
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.replay.bellman import (
    TargetNetwork,
    make_bellman_targets_fn,
    q_value_from_logits,
)
from tensor2robot_tpu_torch.replay.ring_buffer import (
    SampleInfo,
    _validate_against_spec,
)
from tensor2robot_tpu_torch.research.qtopt import cem
from tensor2robot_tpu_torch.specs import tensorspec_utils as ts
from tensor2robot_tpu_torch.train import trainer as trainer_lib

_SCALARS = ("next_slot", "size", "append_count", "max_priority")


@dataclasses.dataclass
class DeviceReplayState:
  """The replay ring as tensors on one device, changed in place.

  storage: one (capacity, *spec.shape) tensor per flat spec key.
  written_at: (capacity,) int64, the append index that last wrote each
    slot (the staleness metric).
  next_slot / size / append_count: 0-d int64 ring bookkeeping.
  tree: (2 * n_leaves,) float32 sum tree (heap layout, root at [1]); a
    (2,) zero placeholder for a uniform ring.
  max_priority: 0-d float32; fresh appends enter the tree at it.
  """
  storage: Dict[str, torch.Tensor]
  written_at: torch.Tensor
  next_slot: torch.Tensor
  size: torch.Tensor
  append_count: torch.Tensor
  tree: torch.Tensor
  max_priority: torch.Tensor

  def arrays(self) -> Dict[str, np.ndarray]:
    """Host copies of every tensor, keyed as a checkpoint stores them."""
    out = {f"storage/{key}": value.cpu().numpy()
           for key, value in self.storage.items()}
    for name in ("written_at", "tree") + _SCALARS:
      out[name] = getattr(self, name).cpu().numpy()
    return out


# --- the sum tree on a float32 tensor ----------------------------------------


def tree_refresh_parents(tree: torch.Tensor, depth: int) -> torch.Tensor:
  """Recomputes every internal node from its children, bottom-up, in
  place: one pairwise add a level (the JAX sums, bit for bit)."""
  for level in range(depth - 1, -1, -1):
    start = 1 << level
    children = tree[2 * start:4 * start]
    torch.add(children[0::2], children[1::2], out=tree[start:2 * start])
  return tree


def tree_set(tree: torch.Tensor, indices: torch.Tensor,
             values: torch.Tensor, depth: int, n_leaves: int
             ) -> torch.Tensor:
  """Sets leaf weights and refreshes every parent, in place. Duplicate
  indices must carry equal values; the TD path reduces them first
  (``tree_set_segment_max``)."""
  tree[n_leaves + indices] = values.float()
  return tree_refresh_parents(tree, depth)


def tree_set_segment_max(tree: torch.Tensor, indices: torch.Tensor,
                         values: torch.Tensor, depth: int, n_leaves: int,
                         capacity: int) -> torch.Tensor:
  """``tree_set`` where a slot drawn twice takes the max of its values.

  Sampling with replacement can draw one slot twice in a batch, each draw
  with its own label and TD. Max is commutative, so the atomics of
  ``scatter_reduce`` leave the same leaf in any order; no sum decides a
  leaf (the touched mask is a scatter of ones)."""
  values = values.float()
  reduced = torch.zeros(capacity, dtype=torch.float32,
                        device=tree.device).scatter_reduce_(
                            0, indices, values, "amax", include_self=False)
  touched = torch.zeros(capacity, dtype=torch.float32,
                        device=tree.device).scatter_(
                            0, indices, torch.ones_like(values)) > 0
  leaves = tree[n_leaves:n_leaves + capacity]
  leaves.copy_(torch.where(touched, reduced, leaves))
  return tree_refresh_parents(tree, depth)


def tree_sample(tree: torch.Tensor, uniforms: torch.Tensor, depth: int,
                n_leaves: int, capacity: int) -> torch.Tensor:
  """Proportional sample by the root-to-leaf descent, `depth` gathers;
  the float edge clamps onto ``capacity - 1``. Zero-mass picks are the
  caller's to remap, as ``ReplayBuffer.sample`` remaps them."""
  mass = uniforms.float() * tree[1]
  pos = torch.ones(uniforms.shape, dtype=torch.int64, device=tree.device)
  for _ in range(depth):
    left = 2 * pos
    left_mass = tree[left]
    go_right = mass >= left_mass
    mass = torch.where(go_right, mass - left_mass, mass)
    pos = torch.where(go_right, left + 1, left)
  return torch.clamp_max(pos - n_leaves, capacity - 1)


def sample_draws(seed: int, counter: int, n: int, size: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
  """One sample's draws from ``np.random.default_rng((seed, counter))``:
  (n,) uniform slot indices over the filled prefix (the uniform ring's
  pick and the prioritized ring's zero-mass remap) and (n,) float32
  uniforms in [0, 1) (the prioritized descent's)."""
  rng = np.random.default_rng((seed, counter))
  return (rng.integers(0, max(size, 1), n),
          rng.random(n, dtype=np.float32))


class DeviceReplayBuffer:
  """Host handle of a device-resident replay ring.

  The constructor contract of ``ReplayBuffer`` (flat-spec storage, honest
  capacity, one sample batch shape, (|td| + eps)^alpha priorities) with
  the state on `device`. Host ``extend`` stages transitions and writes
  them in fixed ``ingest_chunk`` quanta, so the ring's extend sees one
  shape; ``compile_counts`` counts each ring function's first use under
  the JAX package's names (``device_extend``, ``device_sample``,
  ``device_update_priorities_n<N>``). The host keeps its own count of
  ``size``, ``next_slot`` and ``append_count`` (only the host extends), so
  reading them never waits on the card.

  Args:
    mesh / data_axis: a ``parallel.mesh.Mesh`` of ranks whose `data_axis`
      splits the ring's capacity (see the module's docstring). Every rank
      makes the same calls: host extends with the same rows, samples and
      priority updates in the same order.
    shard_capacity: False keeps the whole ring on every rank of the mesh
      (correct, and dp times the memory); the default splits it and
      refuses a capacity the axis does not divide.
    ledger: an ``obs.ledger.ExecutableLedger`` each ring function
      registers into at its first use; each host call records its seconds
      (``extend`` and ``update_priorities`` their launches only, a lower
      bound: they do not wait for the card).
    device: where the ring lives; the GPU unless 'cpu' is asked for.
  """

  def __init__(
      self,
      transition_spec: ts.SpecStructure,
      capacity: int,
      sample_batch_size: int,
      seed: int = 0,
      prioritized: bool = False,
      priority_exponent: float = 0.6,
      min_priority: float = 1e-3,
      ingest_chunk: int = 64,
      mesh=None,
      data_axis: str = "data",
      shard_capacity: bool = True,
      ledger=None,
      device: Device = None,
  ):
    if capacity < 1:
      raise ValueError(f"capacity must be >= 1, got {capacity}")
    if sample_batch_size < 1:
      raise ValueError(
          f"sample_batch_size must be >= 1, got {sample_batch_size}")
    self._spec = ts.flatten_spec_structure(transition_spec)
    if not list(self._spec.keys()):
      raise ValueError("transition_spec has no leaves")
    axis_size = mesh.shape[data_axis] if mesh is not None else 1
    if shard_capacity and axis_size > 1 and capacity % axis_size:
      raise ValueError(
          f"capacity {capacity} is not divisible by the {data_axis!r} "
          f"mesh axis size ({axis_size} devices), so the ring cannot "
          f"capacity-shard and would silently replicate the full "
          f"storage on every device. Use the nearest divisible "
          f"capacity ({mesh_lib.nearest_multiples(capacity, axis_size)}), "
          "or pass shard_capacity=False for a "
          "deliberately replicated ring.")
    if mesh_lib.is_distributed(mesh) and mesh.is_virtual:
      raise ValueError(f"{mesh} has no process groups on this process; "
                       "initialize the ranks before building the ring.")
    self.mesh = mesh
    self.data_axis = data_axis
    self.shard_capacity = bool(shard_capacity and axis_size > 1)
    self._group = mesh.group(data_axis) if axis_size > 1 else None
    # This rank's block of the global slots: [first, first + rows).
    self.rows = capacity // axis_size if self.shard_capacity else capacity
    self._first = (mesh.axis_index(data_axis) * self.rows
                   if self.shard_capacity else 0)
    self.device = resolve_device(device)
    self.capacity = capacity
    self.sample_batch_size = sample_batch_size
    self.ingest_chunk = min(ingest_chunk, capacity)
    self.prioritized = prioritized
    self._alpha = priority_exponent
    self._min_priority = min_priority
    self._depth = max(1, int(np.ceil(np.log2(capacity))))
    self._n_leaves = 1 << self._depth
    self._seed = seed
    self._lock = threading.Lock()
    self._pending: Dict[str, list] = {key: [] for key in self._spec}
    self._pending_count = 0
    self._sample_calls = 0
    self._next = self._size = self._appended = 0
    # ring function -> first uses; tests assert every value is 1.
    self.compile_counts: Dict[str, int] = {}
    self._fns: Dict[str, Callable] = {}
    self._ledger = ledger
    self._state = self._init_state()

  def _init_state(self) -> DeviceReplayState:
    dev = self.device

    def scalar(dtype, value=0):
      return torch.full((), value, dtype=dtype, device=dev)

    return DeviceReplayState(
        storage={key: torch.zeros(
            (self.rows,) + tuple(spec.shape), device=dev,
            dtype=torch.from_numpy(np.empty(0, np.dtype(spec.dtype))).dtype)
                 for key, spec in self._spec.items()},
        written_at=torch.zeros(self.rows, dtype=torch.int64, device=dev),
        next_slot=scalar(torch.int64),
        size=scalar(torch.int64),
        append_count=scalar(torch.int64),
        tree=torch.zeros(2 * self._n_leaves if self.prioritized else 2,
                         dtype=torch.float32, device=dev),
        max_priority=scalar(torch.float32, 1.0))

  @property
  def state(self) -> DeviceReplayState:
    """The ring's tensors (the megastep reads and writes them in place);
    over a capacity-sharded mesh, this rank's block of the storage and
    ``written_at``."""
    return self._state

  def state_shardings(self) -> Dict[str, mesh_lib.NamedSharding]:
    """{``DeviceReplayState.arrays`` key: sharding} of a capacity-sharded
    ring: the storage and ``written_at`` split over the data axis
    (``ring_sharding``), the scalars and the tree whole on every rank (the
    tree's heap layout has no capacity-aligned axis to split)."""
    whole = mesh_lib.replicated_sharding(self.mesh)
    rows = mesh_lib.ring_sharding(self.mesh, self.data_axis)
    out = {f"storage/{key}": rows for key in self._spec}
    out["written_at"] = rows
    out.update({name: whole for name in ("tree",) + _SCALARS})
    return out

  def load_state(self, state: DeviceReplayState) -> None:
    """Copies `state` (tensors or arrays of the whole ring) into the
    ring's own tensors, so a captured graph keeps reading them; over a
    capacity-sharded mesh each rank takes its block
    (``distributed.global_put``). The host counts follow."""
    flat = {f"storage/{key}": value for key, value in state.storage.items()}
    flat.update({name: getattr(state, name)
                 for name in ("written_at", "tree") + _SCALARS})
    with self._lock, torch.no_grad():
      if self._pending_count:
        raise RuntimeError(
            f"load_state with {self._pending_count} host rows staged")
      if self.shard_capacity:
        flat = distributed.global_put(flat, self.state_shardings(),
                                      device=self.device)
      ours = self._state
      for key, value in flat.items():
        value = torch.as_tensor(value)
        if key.startswith("storage/"):
          ours.storage[key[len("storage/"):]].copy_(value)
        else:
          getattr(ours, key).copy_(value)
      self._next = int(ours.next_slot)
      self._size = int(ours.size)
      self._appended = int(ours.append_count)

  def checkpoint_arrays(self) -> Dict[str, np.ndarray]:
    """Host copies of the whole ring, keyed as ``DeviceReplayState.arrays``
    (a checkpoint's layout): over a capacity-sharded mesh every rank
    gathers the storage and ``written_at`` (a collective)."""
    state = self._state
    if not self.shard_capacity:
      return state.arrays()
    out = {}
    for key, value in state.storage.items():
      out[f"storage/{key}"] = collectives.all_gather(
          value, self._group, 0).cpu().numpy()
    out["written_at"] = collectives.all_gather(
        state.written_at, self._group, 0).cpu().numpy()
    for name in ("tree",) + _SCALARS:
      out[name] = getattr(state, name).cpu().numpy()
    return out

  @staticmethod
  def state_from_arrays(arrays: Mapping[str, np.ndarray]
                        ) -> DeviceReplayState:
    """Inverse of ``DeviceReplayState.arrays``."""
    prefix = "storage/"
    return DeviceReplayState(
        storage={key[len(prefix):]: np.asarray(value)
                 for key, value in arrays.items() if key.startswith(prefix)},
        **{name: np.asarray(arrays[name])
           for name in ("written_at", "tree") + _SCALARS})

  # --- the ring functions (in place; the megastep runs them in its graph) --

  def _fn(self, name: str, build: Callable[[], Callable]) -> Callable:
    if name not in self._fns:
      self._fns[name] = build()
      self.compile_counts[name] = self.compile_counts.get(name, 0) + 1
      if self._ledger is not None:
        self._ledger.register(
            name, device=self.device,
            shapes={"capacity": self.capacity, "chunk": self.ingest_chunk,
                    "batch": self.sample_batch_size})
    return self._fns[name]

  def _record(self, name: str, start: float) -> None:
    if self._ledger is not None:
      self._ledger.record_dispatch(name, time.perf_counter() - start)

  def extend_fn(self, local_rows: bool = False) -> Callable:
    """(state, {key: (chunk, *shape) tensor}) -> state: one fixed-chunk
    ring write with wraparound; fresh slots enter the tree at the current
    max priority. The chunk is at most the capacity, so its positions are
    distinct. Over a capacity-sharded mesh each rank writes the rows whose
    slots it holds; with `local_rows` the batch is this rank's block of
    the chunk along the data axis, gathered first."""
    capacity, chunk = self.capacity, self.ingest_chunk
    prioritized, depth, n_leaves = (self.prioritized, self._depth,
                                    self._n_leaves)
    offsets = torch.arange(chunk, dtype=torch.int64, device=self.device)
    group, first, rows = self._group, self._first, self.rows
    sharded = self.shard_capacity

    def extend(state: DeviceReplayState, batch) -> DeviceReplayState:
      if local_rows:
        batch = {key: collectives.all_gather(value, group, 0)
                 for key, value in batch.items()}
      positions = (state.next_slot + offsets) % capacity
      written = state.append_count + offsets
      slots = positions
      if sharded:
        local = positions - first
        keep = ((local >= 0) & (local < rows)).nonzero().squeeze(1)
        slots, written = local[keep], written[keep]
      for key, storage in state.storage.items():
        values = batch[key].to(storage.dtype)
        storage.index_copy_(0, slots, values[keep] if sharded else values)
      state.written_at.index_copy_(0, slots, written)
      if prioritized:
        tree_set(state.tree, positions, state.max_priority.expand(chunk),
                 depth, n_leaves)
      state.next_slot.copy_((state.next_slot + chunk) % capacity)
      state.size.copy_(torch.clamp_max(state.size + chunk, capacity))
      state.append_count.add_(chunk)
      return state

    return extend

  def sample_fn(self) -> Callable:
    """(state, uniform_idx (n,), uniforms (n,)) -> (batch, indices,
    probabilities, staleness) at THE sample batch shape.

    A prioritized pick that lands on zero mass (a float-edge descent, or
    an unwritten slot while the ring fills) is remapped to the uniform
    draw over the filled prefix and reports that probability, as
    ``ReplayBuffer.sample`` does. Probabilities are float32."""
    n, capacity = self.sample_batch_size, self.capacity
    prioritized, depth, n_leaves = (self.prioritized, self._depth,
                                    self._n_leaves)
    read_rows = self._rows_fn()

    def sample(state: DeviceReplayState, uniform_idx: torch.Tensor,
               uniforms: torch.Tensor):
      size = torch.clamp_min(state.size, 1).float()
      if prioritized:
        idx = tree_sample(state.tree, uniforms, depth, n_leaves, capacity)
        leaf = state.tree[n_leaves + idx]
        total = torch.clamp_min(state.tree[1], 1e-30)
        zero = leaf <= 0.0
        indices = torch.where(zero, uniform_idx, idx)
        probabilities = torch.where(zero, 1.0 / size, leaf / total)
      else:
        indices = uniform_idx
        probabilities = torch.ones(n, dtype=torch.float32,
                                   device=size.device) / size
      batch, written_at = read_rows(state, indices)
      staleness = state.append_count - written_at
      return batch, indices, probabilities, staleness

    return sample

  def _rows_fn(self) -> Callable:
    """(state, global slots (n,)) -> ({key: rows}, written_at rows), whole
    on every rank. Over a capacity-sharded mesh each rank reads the rows
    it holds (zeros elsewhere), packs them as bytes, and one all_gather
    lets every rank take each row from its owner."""
    if not self.shard_capacity:
      return lambda state, indices: (
          {key: storage[indices] for key, storage in state.storage.items()},
          state.written_at[indices])
    group, first, rows = self._group, self._first, self.rows

    def read(state: DeviceReplayState, indices: torch.Tensor):
      n = len(indices)
      local = indices - first
      owned = (local >= 0) & (local < rows)
      safe = torch.where(owned, local, 0)
      parts = {key: storage[safe] for key, storage in state.storage.items()}
      parts["written_at"] = state.written_at[safe]
      columns = [value.reshape(n, -1).view(torch.uint8)
                 for value in parts.values()]
      packed = torch.where(owned[:, None], torch.cat(columns, dim=1), 0)
      every = collectives.all_gather(packed[None], group, 0)
      picked = every[torch.div(indices, rows, rounding_mode="floor"),
                     torch.arange(n, device=indices.device)]
      out, offset = {}, 0
      for (key, value), column in zip(parts.items(), columns):
        width = column.shape[1]
        out[key] = picked[:, offset:offset + width].contiguous().view(
            value.dtype).reshape(value.shape)
        offset += width
      written_at = out.pop("written_at")
      return out, written_at

    return read

  def update_priorities_fn(self) -> Callable:
    """(state, indices, td_errors) -> state: the (|td| + eps)^alpha
    refresh, float32, duplicates reduced by max
    (``tree_set_segment_max``); a no-op for a uniform ring."""
    if not self.prioritized:
      return lambda state, indices, td_errors: state
    alpha, eps = self._alpha, self._min_priority
    depth, n_leaves, capacity = self._depth, self._n_leaves, self.capacity

    def update(state: DeviceReplayState, indices: torch.Tensor,
               td_errors: torch.Tensor) -> DeviceReplayState:
      priorities = (torch.abs(td_errors.float()).reshape(-1) + eps) ** alpha
      tree_set_segment_max(state.tree, indices.reshape(-1), priorities,
                           depth, n_leaves, capacity)
      state.max_priority.copy_(torch.maximum(state.max_priority,
                                             priorities.max()))
      return state

    return update

  def priority_entropy_fn(self) -> Callable:
    """(state) -> 0-d float32 normalised priority entropy, on the device
    (the megastep's health summary); 1.0 for a uniform ring and for sizes
    of at most 1, as ``priority_entropy``."""
    if not self.prioritized:
      return lambda state: torch.ones((), dtype=torch.float32,
                                      device=state.tree.device)
    n_leaves, capacity = self._n_leaves, self.capacity
    slots = torch.arange(capacity, device=self.device)

    def entropy(state: DeviceReplayState) -> torch.Tensor:
      leaves = state.tree[n_leaves:n_leaves + capacity]
      size = torch.clamp_min(state.size, 1)
      weights = torch.where(slots < size, leaves, 0.0)
      p = weights / torch.clamp_min(weights.sum(), 1e-30)
      ent = -torch.where(p > 0, p * torch.log(p), 0.0).sum()
      norm = torch.log(torch.clamp_min(size.float(), 2.0))
      return torch.where(size <= 1, 1.0, ent / norm)

    return entropy

  # --- the host surface (ReplayBuffer's) -------------------------------------

  def append(self, transition) -> int:
    """Validates and stages one transition; returns 1."""
    arrays = _validate_against_spec(self._spec, transition, batched=False)
    return self.extend({key: array[None] for key, array in arrays.items()},
                       _validated=True)

  def extend(self, transitions, _validated: bool = False) -> int:
    """Validates and stages a batch, writing every full chunk; returns the
    rows accepted (all: a partial chunk waits in ``pending``)."""
    arrays = (dict(transitions) if _validated else
              _validate_against_spec(self._spec, transitions, batched=True))
    n = next(iter(arrays.values())).shape[0]
    with self._lock:
      for key, array in arrays.items():
        self._pending[key].append(np.asarray(array))
      self._pending_count += n
      while self._pending_count >= self.ingest_chunk:
        self._flush_chunk_locked()
    return n

  def _flush_chunk_locked(self) -> None:
    chunk = self.ingest_chunk
    stacked = {}
    for key, parts in self._pending.items():
      merged = parts[0] if len(parts) == 1 else np.concatenate(parts)
      stacked[key] = torch.from_numpy(
          np.ascontiguousarray(merged[:chunk])).to(self.device)
      self._pending[key] = [merged[chunk:]] if merged.shape[0] > chunk \
          else []
    self._pending_count -= chunk
    self._write_chunk_locked(stacked)

  def _write_chunk_locked(self, chunk) -> None:
    with trace_lib.span("extend/device_chunk", chunk=self.ingest_chunk), \
        torch.no_grad():
      start = time.perf_counter()
      self._fn("device_extend", self.extend_fn)(self._state, chunk)
      self._record("device_extend", start)
    self._next = (self._next + self.ingest_chunk) % self.capacity
    self._size = min(self._size + self.ingest_chunk, self.capacity)
    self._appended += self.ingest_chunk

  def extend_device_chunk(self, chunk) -> int:
    """Writes one chunk already on the device (exactly ``ingest_chunk``
    rows per key) through the same extend; refuses while host rows are
    staged, which would reorder the ring."""
    chunk = dict(chunk)
    if set(chunk) != set(self._spec):
      raise ValueError(f"chunk keys {sorted(chunk)} != spec keys "
                       f"{sorted(self._spec)}")
    for key, array in chunk.items():
      expected = (self.ingest_chunk,) + tuple(self._spec[key].shape)
      if tuple(array.shape) != expected:
        raise ValueError(
            f"device chunk {key!r} has shape {tuple(array.shape)}, "
            f"expected {expected} (ingest_chunk={self.ingest_chunk})")
    with self._lock:
      if self._pending_count:
        raise RuntimeError(
            f"extend_device_chunk with {self._pending_count} host rows "
            "staged: writing out of order would scramble the ring. Use one "
            "ingest seam per buffer.")
      self._write_chunk_locked({key: torch.as_tensor(value).to(self.device)
                                for key, value in chunk.items()})
    return self.ingest_chunk

  def advance_host_counts(self, rows: int) -> None:
    """Moves the host's ``size``, ``next_slot`` and ``append_count`` on by
    `rows` that a caller wrote with ``extend_fn`` itself (the Anakin loop's
    graph), whole chunks only; refuses while host rows are staged."""
    if rows % self.ingest_chunk:
      raise ValueError(f"{rows} rows is not a whole number of "
                       f"{self.ingest_chunk}-row chunks")
    with self._lock:
      if self._pending_count:
        raise RuntimeError(
            f"advance_host_counts with {self._pending_count} host rows "
            "staged: writing out of order would scramble the ring")
      self._next = (self._next + rows) % self.capacity
      self._size = min(self._size + rows, self.capacity)
      self._appended += rows

  def sample(self, draws: Optional[Tuple[np.ndarray, np.ndarray]] = None
             ) -> Tuple[ts.TensorSpecStruct, SampleInfo]:
    """One fixed-shape batch and its SampleInfo, as host numpy.

    `draws`: (uniform_idx (n,), uniforms (n,)) to use in place of the
    buffer's own (``sample_draws`` keyed by its sample count)."""
    with self._lock:
      if self._size == 0:
        raise ValueError("cannot sample from an empty DeviceReplayBuffer")
      self._sample_calls += 1
      if draws is None:
        draws = sample_draws(self._seed, self._sample_calls,
                             self.sample_batch_size, self._size)
      uniform_idx = torch.tensor(np.asarray(draws[0], np.int64),
                                 device=self.device)
      uniforms = torch.tensor(np.asarray(draws[1], np.float32),
                              device=self.device)
      start = time.perf_counter()
      with torch.no_grad():
        batch, indices, probabilities, staleness = self._fn(
            "device_sample", self.sample_fn)(self._state, uniform_idx,
                                             uniforms)
      batch = {key: value.cpu().numpy() for key, value in batch.items()}
      info = SampleInfo(indices=indices.cpu().numpy(),
                        staleness=staleness.cpu().numpy(),
                        probabilities=probabilities.cpu().numpy())
      self._record("device_sample", start)
    return ts.TensorSpecStruct(batch), info

  def update_priorities(self, indices, td_errors) -> None:
    """The host surface of ``update_priorities_fn`` (one ring function per
    update length, as the JAX buffer builds one executable per length)."""
    if not self.prioritized:
      return
    indices = torch.as_tensor(np.asarray(indices, np.int64).reshape(-1),
                              device=self.device)
    td = torch.as_tensor(np.asarray(td_errors, np.float32).reshape(-1),
                         device=self.device)
    name = f"device_update_priorities_n{indices.shape[0]}"
    with self._lock, torch.no_grad():
      start = time.perf_counter()
      self._fn(name, self.update_priorities_fn)(self._state, indices, td)
      self._record(name, start)

  def priorities(self, indices) -> np.ndarray:
    """Leaf priorities at `indices`, host float32."""
    if not self.prioritized:
      raise ValueError("uniform DeviceReplayBuffer has no priorities")
    idx = np.asarray(indices, np.int64).reshape(-1)
    return self._state.tree.cpu().numpy()[self._n_leaves + idx]

  # --- health metrics (ReplayBuffer's) ---------------------------------------

  @property
  def size(self) -> int:
    return self._size

  @property
  def append_count(self) -> int:
    return self._appended

  @property
  def pending(self) -> int:
    """Host rows staged, not yet written (less than one chunk)."""
    with self._lock:
      return self._pending_count

  @property
  def fill_fraction(self) -> float:
    return self._size / self.capacity

  def priority_entropy(self) -> float:
    """Normalised entropy of the sampling distribution, on the host in
    float64 (1.0 for a uniform ring and for sizes of at most 1)."""
    size = self._size
    if not self.prioritized or size <= 1:
      return 1.0
    leaves = self._state.tree.cpu().numpy().astype(np.float64)[
        self._n_leaves:self._n_leaves + size]
    total = leaves.sum()
    if total <= 0:
      return 1.0
    p = leaves / total
    p = p[p > 0]
    return float(-(p * np.log(p)).sum() / np.log(size))

  def metrics(self) -> Dict[str, float]:
    return {
        "replay/fill_fraction": self.fill_fraction,
        "replay/size": float(self._size),
        "replay/append_count": float(self._appended),
        "replay/priority_entropy": self.priority_entropy(),
    }


def _ema_predict(model, state, features):
  """PREDICT outputs of the fresh EMA variables; over a mesh through the
  trainer's layout (a tensor-parallel rank holds blocks of them)."""
  layout = state.layout
  if layout is None:
    return model.predict_fn(state.variables(use_ema=True), features)
  with layout.forward_context(train=False):
    return model.predict_fn(layout.forward_variables(state, use_ema=True),
                            features)


def parameter_health(state) -> Tuple[torch.Tensor, torch.Tensor]:
  """(global L2 norm, non-finite count) of the parameters: a layout's
  sums over the axes that split them, when any does."""
  layout = state.layout
  if layout is not None and any(spec.axes() for spec in layout.specs.values()):
    norm, nonfinite = layout.parameter_health(state)
    return norm, nonfinite.float()
  return (health_lib.tree_global_norm(state.params),
          health_lib.tree_nonfinite_count(state.params).float())


def make_learn_iteration_fn(model, step_fn, sample, update_priorities,
                            targets_fn, target_key: str, clip_targets: bool,
                            constrain_batch=None, health_entropy_fn=None,
                            gather_rows=None):
  """One sample -> label -> train -> TD -> reprioritize iteration:

  (train_state, buffer_state, target_variables, (uniform_idx, uniforms),
  label_noise (B, iterations, N, A)) -> (train_state, buffer_state,
  metrics of 0-d tensors). The draws are the caller's; given them the
  body is deterministic, and it makes no host sync, so a CUDA graph can
  hold it. Labels come from `targets_fn` (``make_bellman_targets_fn``'s
  body) against the target net; the step is `step_fn` (``Trainer.
  train_step``); TD errors use the fresh EMA variables, as the JAX body
  does. `health_entropy_fn` (the ring's ``priority_entropy_fn``) adds the
  ``health.SUMMARY_KEYS``; `step_fn` must then add ``grad_norm`` and
  ``grads_nonfinite`` (``train_step(with_health=True)``).

  Over a mesh (``Trainer.shard_batch`` and ``gather_batch``):
  `constrain_batch` maps (the sampled global batch, its label noise) to
  this rank's block of both, so the labels, the train step and the TD
  forward run data parallel; `gather_rows` maps this rank's rows of a
  (rows, k) tensor to the global batch's, so every rank reduces the same
  TD errors and writes the same priorities.
  """

  def learn(train_state, buffer_state, target_variables, sample_draws,
            label_noise):
    with torch.no_grad():
      batch, indices, _, staleness = sample(buffer_state, *sample_draws)
      if constrain_batch is not None:
        batch, label_noise = constrain_batch((batch, label_noise))
      targets, q_next = targets_fn(target_variables, batch["next_image"],
                                   batch["reward"], batch["done"],
                                   label_noise)
    train_state, metrics = step_fn(
        train_state, {"image": batch["image"], "action": batch["action"]},
        {target_key: targets})
    outputs = _ema_predict(model, train_state,
                           {"image": batch["image"],
                            "action": batch["action"].float()})
    with torch.no_grad():
      q = q_value_from_logits(outputs["q_predicted"].reshape(-1),
                              clip_targets)
      if gather_rows is not None:
        q, targets, q_next = gather_rows(
            torch.stack([q, targets.float(), q_next.float()], 1)).unbind(1)
      td = torch.abs(q - targets)
      update_priorities(buffer_state, indices, td)
      age = staleness.float().mean()
      inner = {"loss": metrics["loss"].float(), "td_error": td.mean(),
               "q_next": q_next.mean(), "staleness": age}
      if health_entropy_fn is not None:
        param_norm, nonfinite_params = parameter_health(train_state)
        inner.update({
            "health/nonfinite_grads": metrics["grads_nonfinite"].float(),
            "health/nonfinite_params": nonfinite_params,
            "health/nonfinite_targets": (~torch.isfinite(targets)).sum(
                dtype=torch.float32),
            "health/grad_norm": metrics["grad_norm"].float(),
            "health/param_norm": param_norm,
            "health/td_mean": td.mean(),
            "health/td_max": td.max(),
            "health/q_mean": q.mean(),
            "health/q_max": q.max(),
            "health/priority_entropy": health_entropy_fn(buffer_state),
            "health/sample_age": age,
        })
    return train_state, buffer_state, inner

  return learn


class _MegastepGraph:
  """The K learn iterations captured in one CUDA graph over `draws`, the
  static (K, B, W) input buffer; ``metrics`` is the graph's output
  vector. ``holds`` says whether a train state still has the tensors the
  graph was captured on (a restore copies into them, so it does)."""

  def __init__(self, learner: "MegastepLearner", state, draws: torch.Tensor,
               stream: torch.cuda.Stream):
    self.graph = torch.cuda.CUDAGraph()
    state.opt_state.zero_grad(set_to_none=True)
    current = torch.cuda.current_stream(learner.device)
    stream.wait_stream(current)
    try:
      with graph_launches.capture(self.graph, stream) as self.tally:
        _, self.metrics = learner._iterations(state, draws)
    except RuntimeError as e:
      raise NotImplementedError(
          f"MegastepLearner cannot capture {type(learner._model).__name__}'s "
          f"learn iteration in a CUDA graph: {e}") from e
    current.wait_stream(stream)
    self._tensors = [t.data_ptr() for t in trainer_lib._state_tensors(state)]
    self._hyperparameters = trainer_lib._hyperparameters(state.opt_state)

  def holds(self, state) -> bool:
    return ([t.data_ptr() for t in trainer_lib._state_tensors(state)]
            == self._tensors
            and trainer_lib._hyperparameters(state.opt_state)
            == self._hyperparameters)

  def replay(self) -> torch.Tensor:
    self.graph.replay()
    graph_launches.replayed(self.tally)
    return self.metrics


def mesh_hooks(trainer) -> Dict[str, Callable]:
  """``make_learn_iteration_fn``'s mesh hooks for `trainer`: its
  ``shard_batch`` and ``gather_batch`` over a mesh, none on one rank."""
  if trainer.layout is None:
    return {}
  return {"constrain_batch": trainer.shard_batch,
          "gather_rows": trainer.gather_batch}


def check_ring_mesh(trainer, buffer) -> None:
  """A ring split over ranks must lie on the trainer's own mesh: its
  sample is a collective of the ranks that learn from it."""
  if mesh_lib.is_distributed(buffer.mesh) and buffer.mesh is not trainer.mesh:
    raise ValueError(
        f"the ring lies over {buffer.mesh}, the trainer over "
        f"{trainer.mesh}: build the ring with mesh=trainer.mesh")


class MegastepLearner(TargetNetwork):
  """K fused sample -> label -> train -> reprioritize iterations a
  dispatch, over a ``DeviceReplayBuffer``.

  ``step(state)`` runs K = ``inner_steps`` iterations and returns (state,
  host-float metrics): the last iteration's loss, TD, bootstrap Q and
  staleness, and with ``health`` the ``health.SUMMARY_KEYS``, the spike
  keys reduced by their max over the K iterations
  (``health.reduce_scanned_metrics``). The one readback of a dispatch is
  that metrics vector.

  On the card, the first dispatch runs eagerly on a side stream (it warms
  cuDNN, cuBLAS and the optimizer's state), then the K iterations are
  captured once in one CUDA graph over the draw buffer, and every later
  dispatch replays it once.
  ``graphs=False`` runs every dispatch eagerly (the bit-parity control).
  On the CPU every dispatch runs eagerly, and so does a trainer over a
  mesh of more than one rank (gloo's collectives run on the host, outside
  any capture): each rank runs the K iterations on its block of each
  sampled batch, over the ring the mesh splits (``buffer.mesh`` must be
  the trainer's). ``compile_counts["megastep"]``
  counts the builds: the capture on the graphed path, the body on the
  eager paths; it stays 1 for the learner's life. The target net is the
  graph's input, not a constant in it: ``refresh`` copies into its
  tensors (hard lag or polyak) and rebuilds nothing.

  The train state must live on the learner's device, its optimizer
  graphable (``trainer.check_graphable``: Adam needs ``capturable=True``).
  `precision` is the label stage's scoring tier. `ledger` (an
  ``obs.ledger.ExecutableLedger``) gets ``megastep`` at each build, with
  a dispatch's FLOPs (K times one eager iteration's, counted in the
  warm-up on the card), and each dispatch's host seconds from its launch
  through the metrics readback.
  """

  def __init__(
      self,
      model,
      trainer,
      buffer: DeviceReplayBuffer,
      action_size: int = 4,
      gamma: float = 0.9,
      num_samples: int = 32,
      num_elites: int = 4,
      iterations: int = 2,
      inner_steps: int = 10,
      seed: int = 0,
      polyak_tau: Optional[float] = None,
      ledger=None,
      precision: str = "f32",
      health: bool = False,
      graphs: bool = True,
  ):
    if inner_steps < 1:
      raise ValueError(f"inner_steps must be >= 1, got {inner_steps}")
    if trainer.device != buffer.device:
      raise ValueError(f"the trainer runs on {trainer.device}, the ring "
                       f"lives on {buffer.device}")
    if buffer.capacity >= 2 ** 24:
      raise ValueError(
          f"capacity {buffer.capacity} >= 2^24: slot draws ride the float32 "
          "draw buffer and must be exact")
    check_ring_mesh(trainer, buffer)
    # A cold target: the first refresh() is a hard copy. Over a mesh every
    # rank holds it whole (the full variables every rank gathers).
    super().__init__(polyak_tau=polyak_tau, device=trainer.device)
    self.precision = cem.validate_precision(precision)
    self._model = model
    self._trainer = trainer
    self._buffer = buffer
    self._action_size = action_size
    self._gamma = gamma
    self._num_samples = num_samples
    self._num_elites = num_elites
    self._iterations_cem = iterations
    self.inner_steps = inner_steps
    self._graphs = (graphs and self.device.type == "cuda"
                    and trainer.layout is None)
    self._seed = seed
    self._clip_targets = getattr(model, "loss_type",
                                 "cross_entropy") == "cross_entropy"
    self.health = bool(health)
    self.compile_counts: Dict[str, int] = {}
    self._ledger = ledger
    self._flops: Optional[float] = None  # one dispatch's, once counted
    self._unregistered = False  # a build the ledger has not seen yet
    self._learn = None
    self._keys: List[str] = []
    self._graph: Optional[_MegastepGraph] = None
    self._warmed = False
    self._side_stream = None
    self._outer = 0
    self._label_seed = 0
    batch = buffer.sample_batch_size
    # Each row of a dispatch's draws: [slot draw, uniform, CEM noise].
    self._noise_width = iterations * num_samples * action_size
    shape = (inner_steps, batch, 2 + self._noise_width)
    pin = self.device.type == "cuda"
    # Two host buffers: the next dispatch's CEM noise is drawn into one
    # while the card runs the dispatch copied from the other.
    self._host = [torch.empty(shape, dtype=torch.float32, pin_memory=pin)
                  for _ in range(2)]
    self._prefetched = None  # (host buffer, label seed) its noise holds
    self._draws = torch.empty(shape, dtype=torch.float32, device=self.device)

  # --- the target net and crash-resume ---------------------------------------

  def checkpoint_state(self):
    """The carried device state: the ring and the target net (the train
    state stays with the caller)."""
    return {"buffer": self._buffer.state, "target": self._target_variables}

  def checkpoint_arrays(self) -> Dict[str, Dict[str, np.ndarray]]:
    """Host copies of the whole ring, as a checkpoint holds it (over a
    capacity-sharded mesh every rank gathers: a collective)."""
    return {"buffer": self._buffer.checkpoint_arrays()}

  def checkpoint_meta(self) -> Dict[str, int]:
    """The host counters that drive the (outer, label seed) draws."""
    return {"outer": self._outer, "label_seed": self._label_seed,
            "refresh_count": self._refresh_count,
            "last_refresh_step": self.last_refresh_step}

  def restore_checkpoint_state(self, composite, meta) -> None:
    """Copies a restored composite into the ring's and the target's own
    tensors (a captured graph keeps reading them) and restores the
    counters, so the next dispatch continues the draws where the save
    cut them."""
    self._buffer.load_state(composite["buffer"])
    self._assign(composite["target"], polyak=False)
    self._outer = int(meta["outer"])
    self._label_seed = int(meta["label_seed"])
    self._refresh_count = int(meta["refresh_count"])
    self.last_refresh_step = int(meta["last_refresh_step"])

  # --- the learn body ---------------------------------------------------------

  def _build_learn(self):
    trainer = self._trainer
    buffer = self._buffer
    targets_fn = make_bellman_targets_fn(
        self._model, self._action_size, self._gamma, self._num_samples,
        self._num_elites, self._iterations_cem, self._clip_targets,
        precision=self.precision)
    health = self.health

    def step_fn(state, features, labels):
      return trainer.train_step(state, features, labels, with_health=health)

    return make_learn_iteration_fn(
        self._model, step_fn, buffer.sample_fn(),
        buffer.update_priorities_fn(), targets_fn,
        getattr(self._model, "target_key", "target_q"), self._clip_targets,
        health_entropy_fn=buffer.priority_entropy_fn() if health else None,
        **mesh_hooks(trainer))

  def _iterations(self, state, draws: torch.Tensor, count: bool = False):
    """One learn iteration for each row of `draws` (steps, B, W); returns
    the state and the metrics vector (``_keys`` order) reduced over them.
    With `count`, the first iteration's FLOPs times the rows (every
    iteration runs the same operations at the same shapes) become the
    dispatch's."""
    if self._learn is None:
      self._learn = self._build_learn()
    batch = self._buffer.sample_batch_size
    noise_shape = (batch, self._iterations_cem, self._num_samples,
                   self._action_size)
    per_step = []
    for i, row in enumerate(draws):
      with (FlopCounterMode(display=False) if count and i == 0
            else contextlib.nullcontext()) as flops:
        state, _, metrics = self._learn(
            state, self._buffer.state, self._target_variables,
            (row[:, 0].long(), row[:, 1]), row[:, 2:].reshape(noise_shape))
      if flops is not None:
        self._flops = len(draws) * flops.get_total_flops()
      per_step.append(metrics)
    self._keys = list(per_step[0])
    reduced = health_lib.reduce_scanned_metrics(
        {key: torch.stack([m[key] for m in per_step]) for key in self._keys})
    return state, torch.stack([reduced[key] for key in self._keys])

  # --- the draws ----------------------------------------------------------------

  def _fill_noise(self, slot: int, label_seed: int) -> None:
    k, batch = self.inner_steps, self._buffer.sample_batch_size
    seeds = (label_seed + np.arange(k * batch, dtype=np.uint64)) % (2 ** 32)
    noise = cem.seeded_noise(self._seed + 1, seeds, self._iterations_cem,
                             self._num_samples, self._action_size)
    self._host[slot].numpy()[:, :, 2:] = noise.reshape(k, batch, -1)
    self._prefetched = (slot, label_seed)

  def _stage_draws(self, slot: int) -> None:
    """This dispatch's draws into host buffer `slot`, then one copy to
    the card: the slot draws keyed (seed, outer * K + inner) at the host's
    ``size``, and the CEM noise of the next K * B label seeds."""
    if self._prefetched != (slot, self._label_seed):
      self._fill_noise(slot, self._label_seed)
    host = self._host[slot].numpy()
    k, batch = self.inner_steps, self._buffer.sample_batch_size
    size = self._buffer.size
    for i in range(k):
      idx, uniforms = sample_draws(self._seed, self._outer * k + i, batch,
                                   size)
      host[i, :, 0] = idx
      host[i, :, 1] = uniforms
    self._draws.copy_(self._host[slot], non_blocking=True)

  # --- dispatch -------------------------------------------------------------

  def _count_build(self) -> None:
    self.compile_counts["megastep"] = (
        self.compile_counts.get("megastep", 0) + 1)
    self._unregistered = True
    self._register()

  def _register(self) -> None:
    """Enters a build in the ledger once its dispatch's FLOPs are known
    (the eager path builds before its first dispatch counts them)."""
    if (self._ledger is None or not self._unregistered
        or self._flops is None):
      return
    self._unregistered = False
    self._ledger.register(
        "megastep", device=self.device, dtype=self.precision,
        shapes={"inner_steps": self.inner_steps,
                "batch": self._buffer.sample_batch_size},
        flops=self._flops)

  def _eager_dispatch(self, state) -> torch.Tensor:
    """The K iterations run eagerly; the first such dispatch with a ledger
    counts its FLOPs (outside any capture)."""
    count = self._ledger is not None and self._flops is None
    vector = self._iterations(state, self._draws, count=count)[1]
    if count:
      self._register()
    return vector

  def compiled(self, train_state):
    """Builds the dispatch program once and returns it: on the card the
    CUDA graph of the K iterations over `train_state`'s tensors
    (it needs the first dispatch, which runs eagerly, to have warmed
    them), elsewhere the learn body. ``compile_counts["megastep"]``
    counts the builds."""
    if not self._graphs:
      if self._learn is None:
        self._learn = self._build_learn()
        self._count_build()
      return self._learn
    if not self._warmed:
      raise RuntimeError("the megastep's graph is captured after one eager "
                         "dispatch: call step() first")
    if self._graph is None or not self._graph.holds(train_state):
      self._graph = _MegastepGraph(self, train_state, self._draws,
                                   self._side_stream)
      self._count_build()
    return self._graph

  def _dispatch(self, state) -> torch.Tensor:
    """K iterations on the staged draws; returns the metrics vector."""
    if not self._graphs:
      self.compiled(state)
      return self._eager_dispatch(state)
    trainer_lib.check_graphable(state.opt_state)
    if self._side_stream is None:
      self._side_stream = torch.cuda.Stream(self.device)
    current = torch.cuda.current_stream(self.device)
    if not self._warmed:
      self._side_stream.wait_stream(current)
      with torch.cuda.stream(self._side_stream):
        vector = self._eager_dispatch(state)
      current.wait_stream(self._side_stream)
      self._warmed = True
      return vector
    return self.compiled(state).replay()

  def step(self, state):
    """One dispatch: K optimizer steps. Returns (state, metrics) with the
    metrics as host floats (the dispatch's one readback)."""
    if self._target_variables is None:
      raise ValueError("call refresh(variables, step=0) before step()")
    slot = self._outer % 2
    with trace_lib.span("learn/megastep", k=self.inner_steps):
      self._stage_draws(slot)
      start = time.perf_counter()
      vector = self._dispatch(state)
    k, batch = self.inner_steps, self._buffer.sample_batch_size
    self._outer += 1
    self._label_seed = (self._label_seed + k * batch) % (2 ** 32)
    # While the card works: the next dispatch's CEM noise.
    self._fill_noise(1 - slot, self._label_seed)
    values = vector.cpu().tolist()
    if self._ledger is not None:
      self._ledger.record_dispatch("megastep", time.perf_counter() - start)
    state = dataclasses.replace(state, step=state.step + k)
    return state, dict(zip(self._keys, values))
