"""Named meshes over ranks, shardings, and the batch's split.

Counterpart of ``tensor2robot_tpu/parallel/mesh.py``. A JAX mesh lays
devices out on named axes; here a ``Mesh`` lays out ranks (one process
each, ``parallel/distributed.py``) the same way, row-major, ``data``
outermost by convention, and holds one process group an axis: the ranks
that differ only in their place on that axis. ``collectives.py`` runs over
those groups.

A mesh over more ranks than the process group has (or with no group at
all) is *virtual*: it has a shape, for spec inference and error messages,
but no groups. The tests build the JAX meshes' shapes this way.

``PartitionSpec`` is the port's own: one entry a tensor dimension, an axis
name or None, with JAX's equality (trailing Nones aside) so one rule table
reads the same in both packages. ``NamedSharding`` pairs it with a mesh.

The batch: every rank's input pipeline yields the same global batch (the
generators are seeded alike), and ``shard_batch`` keeps this rank's block
of the leading dim on the data axis. Its checks and messages are JAX's.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from tensor2robot_tpu_torch.parallel import distributed


class PartitionSpec:
  """One entry a tensor dimension: the mesh axis that splits it, or None.

  Equal to another spec, or to a tuple, when the entries agree once the
  trailing Nones are dropped (``P(None, None) == P()``, as in JAX). Not a
  tuple, so the port's tree maps treat it as a leaf."""

  __slots__ = ("_entries",)

  def __init__(self, *entries):
    for entry in entries:
      if isinstance(entry, (tuple, list)):
        raise NotImplementedError(
            f"PartitionSpec entry {entry!r}: one mesh axis a dimension; "
            "several axes on one dimension are not supported.")
      if entry is not None and not isinstance(entry, str):
        raise TypeError(f"PartitionSpec entries are axis names or None, "
                        f"got {entry!r}")
    self._entries = tuple(entries)

  def _trimmed(self) -> tuple:
    entries = list(self._entries)
    while entries and entries[-1] is None:
      entries.pop()
    return tuple(entries)

  def __iter__(self):
    return iter(self._entries)

  def __len__(self) -> int:
    return len(self._entries)

  def __getitem__(self, index):
    return self._entries[index]

  def __eq__(self, other) -> bool:
    if isinstance(other, PartitionSpec):
      return self._trimmed() == other._trimmed()
    if isinstance(other, tuple):
      return self._trimmed() == PartitionSpec(*other)._trimmed()
    return NotImplemented

  def __hash__(self) -> int:
    return hash(self._trimmed())

  def __repr__(self) -> str:
    return f"PartitionSpec{self._entries!r}"

  def at(self, dim: int) -> Optional[str]:
    """The entry of `dim`: None past the spec's end."""
    return self._entries[dim] if dim < len(self._entries) else None

  def axes(self) -> Tuple[str, ...]:
    """The axis names the spec uses."""
    return tuple(entry for entry in self._entries if entry is not None)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
  """A mesh and a spec (JAX's ``NamedSharding``)."""

  mesh: "Mesh"
  spec: PartitionSpec


class Mesh:
  """Ranks on named axes, row-major; one process group an axis."""

  def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
    self.devices = devices
    self.axis_names = tuple(axis_names)
    self.shape = collections.OrderedDict(
        zip(self.axis_names, devices.shape))
    self._groups: Dict[str, Any] = {}
    self.rank: Optional[int] = None
    if (distributed.is_initialized()
        and self.size <= distributed.process_count()):
      self._build_groups()

  @property
  def size(self) -> int:
    return int(self.devices.size)

  @property
  def is_virtual(self) -> bool:
    """True when the mesh has no process groups (no group, or not every
    one of its ranks in it)."""
    return self.rank is None and self.size > 1

  def _build_groups(self) -> None:
    """Every rank makes every group, in one order (``new_group`` is
    collective over the world)."""
    me = distributed.process_index()
    for axis_index, axis in enumerate(self.axis_names):
      lines = np.moveaxis(self.devices, axis_index, -1).reshape(
          -1, self.shape[axis])
      for line in lines:
        ranks = [int(r) for r in line]
        if ranks != sorted(ranks):
          # A group numbers its ranks in ascending order; the axis must too.
          raise NotImplementedError(
              f"Mesh axis {axis!r} lists ranks {ranks} out of order.")
        group = dist.new_group(ranks) if len(ranks) > 1 else None
        if me in ranks:
          self._groups[axis] = (group, ranks)
    if me in {int(r) for r in self.devices.flat}:
      self.rank = me

  def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
    """{axis: index} of `rank` (default this process's) on the mesh."""
    rank = self.rank if rank is None else rank
    if rank is None:
      if self.size == 1:
        return {axis: 0 for axis in self.axis_names}
      raise ValueError("This process holds no rank of the mesh.")
    where = np.argwhere(self.devices == rank)
    if not len(where):
      raise ValueError(f"Rank {rank} is not on the mesh.")
    return dict(zip(self.axis_names, (int(i) for i in where[0])))

  def axis_index(self, axis: str) -> int:
    return self.coords()[axis]

  def group(self, axis: str):
    """The process group of `axis` through this rank (None for an axis of
    size 1, which needs no collective)."""
    if self.shape[axis] == 1:
      return None
    if axis not in self._groups:
      raise ValueError(
          f"Mesh {dict(self.shape)} is virtual here: it has no process "
          "group for its axes (initialize the ranks first).")
    return self._groups[axis][0]

  def __repr__(self) -> str:
    return f"Mesh({dict(self.shape)})"


def create_mesh(axes: Optional[Mapping[str, int]] = None,
                devices: Optional[Sequence[int]] = None) -> Mesh:
  """A named mesh over ranks.

  Args:
    axes: ordered {axis_name: size}; at most one size may be -1 (fill with
      the remaining ranks). Default {"data": -1}: pure data parallelism.
    devices: the ranks to lay out, by default every rank of the process
      group (one, without a group).
  """
  if devices is None:
    devices = range(distributed.process_count())
  devices = list(devices)
  axes = collections.OrderedDict({"data": -1} if axes is None else axes)
  fill_axes = [name for name, size in axes.items() if size == -1]
  if len(fill_axes) > 1:
    raise ValueError(f"At most one axis may be -1, got {fill_axes}.")
  fixed = math.prod(size for size in axes.values() if size != -1)
  if len(devices) % fixed != 0:
    raise ValueError(
        f"Device count {len(devices)} not divisible by fixed axes {axes}.")
  if fill_axes:
    axes[fill_axes[0]] = len(devices) // fixed
  total = math.prod(axes.values())
  if total != len(devices):
    raise ValueError(
        f"Mesh axes {dict(axes)} require {total} devices, have"
        f" {len(devices)}.")
  return Mesh(np.asarray(devices).reshape(tuple(axes.values())),
              tuple(axes.keys()))


def batch_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
  """Batched arrays: the leading dim split over `axis`."""
  return NamedSharding(mesh, PartitionSpec(axis))


def mesh_devices(mesh: Mesh) -> list:
  """The mesh's ranks as a flat row-major list."""
  return [int(rank) for rank in mesh.devices.flat]


def nearest_multiples(value: int, divisor: int) -> str:
  """'8 or 16'-style fix suggestion for a size that must divide an axis."""
  lower = (value // divisor) * divisor
  return f"{lower} or {lower + divisor}" if lower else f"{divisor}"


def env_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
  """Per-shard env fleets: the fleet's leading dim split over `axis`."""
  return NamedSharding(mesh, PartitionSpec(axis))


def ring_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
  """Replay rings: the capacity-leading leaves split over `axis`."""
  return NamedSharding(mesh, PartitionSpec(axis))


def stacked_batch_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
  """K-stacked batches (loop axis, batch, ...): the batch dim split."""
  return NamedSharding(mesh, PartitionSpec(None, axis))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
  """Every rank holds the whole array."""
  return NamedSharding(mesh, PartitionSpec())


def local_batch_slice(global_batch_size: int) -> int:
  """Per-process batch size for a per-host input pipeline."""
  if global_batch_size % distributed.process_count() != 0:
    raise ValueError(
        f"Global batch {global_batch_size} not divisible by process count"
        f" {distributed.process_count()}.")
  return global_batch_size // distributed.process_count()


def block(size: int, parts: int, index: int) -> slice:
  """The `index`-th of `parts` equal blocks of a dimension of `size`."""
  step = size // parts
  return slice(index * step, (index + 1) * step)


def local_block(tensor, mesh: Mesh, spec: PartitionSpec):
  """This rank's block of a tensor every rank holds in full, as a view."""
  coords = mesh.coords()
  index = []
  for dim, axis in enumerate(spec):
    if axis is None:
      index.append(slice(None))
      continue
    parts = mesh.shape[axis]
    if tensor.shape[dim] % parts:
      raise ValueError(
          f"dim {dim} (size {tensor.shape[dim]}) does not divide over "
          f"{axis!r} of size {parts}")
    index.append(block(tensor.shape[dim], parts, coords[axis]))
  return tensor[tuple(index)]


def shard_batch(mesh: Mesh, batch: Any, axis: str = "data") -> Any:
  """This rank's block of a global batch: the leading dim of every batched
  leaf split over `axis`; scalar leaves pass as they are. Arrays stay
  arrays and tensors tensors (views). Raises for any batched leaf whose
  size the axis does not divide."""
  from tensor2robot_tpu_torch.utils.tree import tree_leaves, tree_map
  axis_size = mesh.shape[axis]
  for leaf in tree_leaves(batch):
    if np.ndim(leaf) >= 1 and np.shape(leaf)[0] % axis_size != 0:
      raise ValueError(
          f"Global batch size {np.shape(leaf)[0]} is not divisible by the "
          f"{axis!r} mesh axis ({axis_size} devices); choose a batch size "
          "that is a multiple of the data-parallel degree.")
  if axis_size == 1:
    return batch
  index = mesh.axis_index(axis)

  def take(leaf):
    if np.ndim(leaf) == 0:
      return leaf  # scalar riders are replicated
    return leaf[block(np.shape(leaf)[0], axis_size, index)]

  return tree_map(take, batch)


def is_distributed(mesh: Optional[Mesh]) -> bool:
  """True when `mesh` spans more than one rank."""
  return mesh is not None and mesh.size > 1
