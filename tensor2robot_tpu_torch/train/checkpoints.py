"""Checkpoints, resume and warm start, in the port's own format.

Counterpart of ``tensor2robot_tpu/train/checkpoints.py``'s
``CheckpointManager``, ``restore_params`` and ``merge_params``. The JAX
package writes orbax checkpoints, and orbax needs JAX, so the port keeps
its own layout under a run's ``checkpoints/`` directory:

    <directory>/<step>/state.pt   one save: torch.save of a dict of tensors

A save is written under a temporary name and then ``os.replace``d onto
its step, so a half-written save is never listed; the newest
``max_to_keep`` are kept. ``state.pt`` holds the step, the parameters, the
batch statistics, the EMA parameters, the optimizer's ``state_dict``
(Adam's moments and step count) and its learning-rate schedule's, and
loads with ``torch.load(weights_only=True)``.

Warm start reads parameters from a port run or step directory, or from a
``variables.npz`` (an export of either package), and merges them in flax
path space (``bridge.py``), so an ``assignment_map`` written for the JAX
package means the same here.

The replay loop's crash-resume checkpoints pair a step directory with a
**sidecar** beside it, ``<directory>/sidecar-<step>/``, in the JAX
package's layout byte for byte (``<name>.npz`` trees through
``export/variables_io``, flat arrays through ``np.savez``, ``meta.json``
with ``_trees``, ``_flats`` and ``step``), so either package reads the
other's sidecars.

Over a mesh of ranks (``train/mesh_layout.py``) a save gathers every
rank's blocks into this same layout on every rank, the primary writes it
and all ranks meet at a barrier; the payload carries the writer's
``mesh_geometry`` under ``mesh`` (a one-device save has no stamp). A restore onto a mesh refuses a stamp of
another geometry (``validate_restore_mesh``, JAX's message) and cuts each
rank's blocks from the whole tensors; a restore onto one device reads any
stamp, since the layout is whole. Warm start and npz interchange with JAX
are unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.export import export_utils, variables_io
from tensor2robot_tpu_torch.parallel import distributed
from tensor2robot_tpu_torch.train.train_state import TrainState
from tensor2robot_tpu_torch.utils import optimizers

_log = logging.getLogger(__name__)

STATE_FILE = "state.pt"
_TMP_PREFIX = ".tmp-"


def _to_cpu(tree: Any) -> Any:
  if isinstance(tree, torch.Tensor):
    return tree.detach().to("cpu", copy=True)
  if isinstance(tree, Mapping):
    return {key: _to_cpu(value) for key, value in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_to_cpu(value) for value in tree)
  return tree


def _copy_into(target: Dict[str, torch.Tensor],
               saved: Mapping[str, torch.Tensor], what: str) -> None:
  if set(target) != set(saved):
    raise KeyError(f"checkpoint {what} have keys {sorted(saved)}; the "
                   f"state has {sorted(target)}.")
  with torch.no_grad():
    for key, tensor in target.items():
      if tuple(saved[key].shape) != tuple(tensor.shape):
        raise ValueError(f"checkpoint {what} {key!r} has shape "
                         f"{tuple(saved[key].shape)}, the state "
                         f"{tuple(tensor.shape)}.")
      tensor.copy_(saved[key])


class CheckpointManager:
  """Saves and restores a run's TrainState under one directory."""

  def __init__(self, directory: str, max_to_keep: int = 5,
               save_interval_steps: int = 0):
    """Args mirror RunConfig(save_checkpoints_steps, keep_checkpoint_max).

    save_interval_steps == 0 means "only when save() is called".
    """
    self.directory = os.path.abspath(directory)
    self.max_to_keep = max_to_keep
    self.save_interval_steps = save_interval_steps
    os.makedirs(self.directory, exist_ok=True)

  def should_save(self, step: int, last_step: Optional[int] = None) -> bool:
    """True when `step` lands on (or, given the previous loop boundary
    `last_step`, has crossed) a save-interval multiple."""
    if self.save_interval_steps <= 0:
      return False
    if last_step is not None:
      return (step // self.save_interval_steps
              > last_step // self.save_interval_steps)
    return step % self.save_interval_steps == 0

  def save(self, step: int, state: TrainState, force: bool = False) -> bool:
    """Writes `state` as step `step` and returns True. Every call writes,
    as the JAX manager's does (the loop asks `should_save` first); `force`
    is kept for its callers."""
    del force
    final = os.path.join(self.directory, str(step))
    if os.path.exists(final):
      raise ValueError(f"checkpoint step {step} already exists at {final}")
    optimizer = state.opt_state
    schedule = getattr(optimizer, "lr_schedule", None)
    if state.layout is not None:
      whole = state.layout.full_payload(state)  # every rank gathers
    else:
      whole = {"params": state.params, "batch_stats": state.model_state,
               "ema_params": state.ema_params,
               "optimizer": optimizer.state_dict()}
    payload = {
        "step": int(step),
        **_to_cpu(whole),
        "schedule": None if schedule is None else schedule.state_dict(),
    }
    if state.layout is None or distributed.is_primary():
      self._write(step, payload)
    if state.layout is not None:
      distributed.sync_global_devices(f"checkpoint {step}")
    return True

  def _write(self, step: int, payload: dict) -> None:
    final = os.path.join(self.directory, str(step))
    tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{step}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    os.replace(tmp, final)
    if self.max_to_keep:
      for old in self.all_steps()[:-self.max_to_keep]:
        shutil.rmtree(os.path.join(self.directory, str(old)))

  def restore(self, state: TrainState,
              step: Optional[int] = None) -> TrainState:
    """Restores step `step` (default: the latest) into `state`, a fresh
    template from ``Trainer.create_train_state``: its tensors take the
    saved values, and its optimizer, built over those same parameter
    tensors, loads the saved moments, step count and schedule."""
    if step is None:
      step = self.latest_step()
    if step is None:
      raise FileNotFoundError(f"No checkpoint in {self.directory}")
    payload = torch.load(
        os.path.join(self.directory, str(step), STATE_FILE),
        map_location="cpu", weights_only=True)
    if state.layout is not None:
      validate_restore_mesh(payload.get("mesh"), state.layout.mesh)
      payload = state.layout.load_payload(state, payload)
    _copy_into(state.params, payload["params"], "params")
    _copy_into(state.model_state, payload["batch_stats"], "batch_stats")
    if (state.ema_params is None) != (payload["ema_params"] is None):
      raise ValueError("checkpoint and state disagree on keeping EMA "
                       "parameters (use_avg_model_params).")
    if state.ema_params is not None:
      _copy_into(state.ema_params, payload["ema_params"], "EMA params")
    optimizer = state.opt_state
    optimizers.load_state(optimizer, payload["optimizer"])
    schedule = getattr(optimizer, "lr_schedule", None)
    if (schedule is None) != (payload["schedule"] is None):
      raise ValueError("checkpoint and optimizer disagree on having a "
                       "learning-rate schedule.")
    if schedule is not None:
      schedule.load_state_dict(payload["schedule"])
    return dataclasses.replace(state, step=int(payload["step"]))

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

  def all_steps(self) -> List[int]:
    """The saved steps, oldest first. Temporary directories of saves in
    progress (or cut off) are not steps."""
    steps = []
    for name in os.listdir(self.directory):
      if name.isdigit() and os.path.isfile(
          os.path.join(self.directory, name, STATE_FILE)):
        steps.append(int(name))
    return sorted(steps)

  def reload(self) -> None:
    """Nothing to re-read: every call lists the directory afresh."""

  def wait(self) -> None:
    """Nothing to wait for: saves are synchronous."""

  def close(self) -> None:
    """Nothing to release."""


# --- mesh stamps -------------------------------------------------------------


def mesh_geometry(mesh) -> dict:
  """JSON-able geometry stamp of a mesh: ordered {axis: size} and the rank
  count (one device, no mesh: no axes, one device)."""
  if mesh is None:
    return {"axes": {}, "devices": 1}
  return {"axes": {str(name): int(size) for name, size in mesh.shape.items()},
          "devices": int(mesh.size)}


def validate_restore_mesh(saved: Optional[dict], mesh) -> None:
  """Refuses a resume whose mesh geometry differs from the writer's.

  `saved` is the checkpoint's ``mesh_geometry`` stamp (None, a pre-stamp
  checkpoint, passes). A mismatch raises with both geometries and the
  fix named, as the JAX package does."""
  if saved is None:
    return
  current = mesh_geometry(mesh)
  if saved == current:
    return
  saved_axes = dict(saved.get("axes", {}))
  fix = " x ".join(f"{name}={size}" for name, size in saved_axes.items())
  raise ValueError(
      f"resume mesh geometry mismatch: checkpoint was written on a mesh "
      f"of {saved}, this loop runs {current} — sharded state cannot be "
      f"re-laid-out across geometries on restore. Rebuild the loop with "
      f"a {fix or 'matching'} mesh (the writer's geometry), or start a "
      f"fresh run for the new mesh.")


# --- warm start ------------------------------------------------------------


def _is_orbax_dir(path: str) -> bool:
  names = set(os.listdir(path))
  if names & {"_CHECKPOINT_METADATA", "_METADATA", "default"}:
    return True
  return any(name.isdigit() and os.path.isdir(os.path.join(path, name))
             and not os.path.exists(os.path.join(path, name, STATE_FILE))
             for name in names)


def restore_params(checkpoint_path: str) -> Dict[str, Any]:
  """The `params` subtree (flax layout, nested dicts of CPU tensors) of a
  port run directory, its ``checkpoints`` directory or one step directory,
  or of a ``variables.npz`` (a file, or an export version directory that
  holds one). An orbax directory raises: the port reads no orbax."""
  path = os.path.abspath(checkpoint_path)
  npz = (path if path.endswith(".npz")
         else os.path.join(path, export_utils.VARIABLES_NPZ))
  if os.path.isfile(npz):
    return variables_io.load_variables(npz)["params"]
  if not os.path.isdir(path):
    raise FileNotFoundError(f"No checkpoint at {path}")
  state_file = os.path.join(path, STATE_FILE)
  if not os.path.isfile(state_file):
    run_checkpoints = os.path.join(path, "checkpoints")
    manager = CheckpointManager(run_checkpoints if os.path.isdir(
        run_checkpoints) else path)
    step = manager.latest_step()
    if step is None:
      if _is_orbax_dir(manager.directory):
        raise ValueError(
            f"{path} is an orbax checkpoint of the JAX package; orbax needs "
            "JAX, which the port does not import. Warm-start from an export "
            "of that run instead (its variables.npz).")
      raise FileNotFoundError(f"No checkpoint in {path}")
    state_file = os.path.join(manager.directory, str(step), STATE_FILE)
  payload = torch.load(state_file, map_location="cpu", weights_only=True)
  return bridge.state_dict_to_variables(payload["params"])["params"]


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
  flat = {}
  for key, value in tree.items():
    path = f"{prefix}/{key}" if prefix else str(key)
    if isinstance(value, Mapping):
      flat.update(_flatten(value, path))
    else:
      flat[path] = value
  return flat


def merge_params(target: Mapping[str, Any], restored: Mapping[str, Any],
                 assignment_map: Optional[dict] = None) -> Dict[str, Any]:
  """Copies into `target` every leaf whose path and shape match `restored`.

  Both are flax params trees (nested dicts; ``bridge.py`` gives the
  port's parameters in that layout), so paths are flax's: 'a/b/kernel'.

  Args:
    assignment_map: {source_prefix: target_prefix} over slash-joined
      param paths, in tf.train.init_from_checkpoint's direction:
      checkpoint name on the left, current-model name on the right (e.g.
      {"conv_tower": "scene_tower"} loads checkpoint leaves under
      conv_tower/... into the model's scene_tower/...). Longest matching
      target prefix wins; unmapped paths look up their own name. An entry
      that copies zero leaves logs a warning: a typo'd rename must not
      silently leave random init in place.
  """
  flat_restored = _flatten(restored)
  # Match against the TARGET side (map values), rewrite to the source.
  by_target = sorted(((t, s) for s, t in (assignment_map or {}).items()),
                     key=lambda kv: len(kv[0]), reverse=True)
  copied_per_entry = {source: 0 for source in (assignment_map or {})}

  def pick(key: str, leaf):
    lookup = key
    entry = None
    for target_prefix, source_prefix in by_target:
      if key == target_prefix or key.startswith(target_prefix + "/"):
        lookup = source_prefix + key[len(target_prefix):]
        entry = source_prefix
        break
    candidate = flat_restored.get(lookup)
    if candidate is not None and tuple(np.shape(candidate)) == tuple(
        leaf.shape):
      if entry is not None:
        copied_per_entry[entry] += 1
      return variables_io.to_tensor(candidate).to(leaf.dtype)
    return leaf

  def walk(tree: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    out = {}
    for key, value in tree.items():
      path = f"{prefix}/{key}" if prefix else str(key)
      out[key] = (walk(value, path) if isinstance(value, Mapping)
                  else pick(path, value))
    return out

  merged = walk(target, "")
  for source, count in copied_per_entry.items():
    if count == 0:
      _log.warning(
          "assignment_map entry %r -> %r copied ZERO leaves; check the "
          "prefixes against the checkpoint and model param names.",
          source, (assignment_map or {}).get(source))
  return merged


# --- the replay loop's sidecars and resume validation ------------------------
#
# A loop checkpoint is the step directory (``state.pt``) plus a sidecar
# holding what the train state does not: the lagged target net, the replay
# ring's whole state, the label-seed counter and the eval history. The
# sidecar is written after the step (tmp directory, then os.replace), so a
# present sidecar means a usable checkpoint, and a save cut between the two
# leaves a step without a sidecar, which validation rejects.

SIDECAR_PREFIX = "sidecar-"
SIDECAR_META = "meta.json"


def sidecar_dir(root: str, step: int) -> str:
  return os.path.join(os.path.abspath(root), f"{SIDECAR_PREFIX}{step}")


def save_sidecar(root: str, step: int, trees=None, flats=None,
                 meta: Optional[dict] = None) -> str:
  """Writes the sidecar for `step` atomically (tmp directory, then
  os.replace) and returns its path.

  Args:
    root: the checkpoint root (the CheckpointManager's directory).
    step: the optimizer step (the step directory's).
    trees: {name: nested {str: array or tensor} tree}; each lands as
      ``<name>.npz`` through ``export/variables_io`` (keys without "/").
      The target net goes here.
    flats: {name: flat {str: np.ndarray}}; each lands as a plain
      ``np.savez`` ``<name>.npz`` with the keys verbatim ("/" allowed).
      The replay ring's state goes here.
    meta: a JSON-able dict, written as ``meta.json`` with the npz
      manifests under ``_trees`` / ``_flats`` and the step.
  """
  trees = trees or {}
  flats = flats or {}
  overlap = set(trees) & set(flats)
  if overlap:
    raise ValueError(f"sidecar entry names collide: {sorted(overlap)}")
  final = sidecar_dir(root, step)
  tmp = final + ".tmp"
  if os.path.isdir(tmp):
    shutil.rmtree(tmp)
  os.makedirs(tmp, exist_ok=True)
  for name, tree in trees.items():
    variables_io.save_variables(os.path.join(tmp, f"{name}.npz"), tree)
  for name, flat in flats.items():
    with open(os.path.join(tmp, f"{name}.npz"), "wb") as f:
      np.savez(f, **{key: np.asarray(value) for key, value in flat.items()})
  meta = dict(meta or {})
  meta["_trees"] = sorted(trees)
  meta["_flats"] = sorted(flats)
  meta["step"] = int(step)
  with open(os.path.join(tmp, SIDECAR_META), "w") as f:
    json.dump(meta, f)
  if os.path.isdir(final):
    shutil.rmtree(final)
  os.replace(tmp, final)
  return final


def load_sidecar(root: str, step: int):
  """(trees, flats, meta) of `step`'s sidecar; trees come back as CPU
  tensors, flats as arrays. Raises with the defect named when the sidecar
  is missing or damaged; every npz entry is read in full, so a truncated
  write fails its zip CRC here."""
  directory = sidecar_dir(root, step)
  meta_path = os.path.join(directory, SIDECAR_META)
  if not os.path.isfile(meta_path):
    raise FileNotFoundError(f"sidecar meta missing at {meta_path}")
  with open(meta_path) as f:
    meta = json.load(f)
  trees = {name: variables_io.load_variables(
      os.path.join(directory, f"{name}.npz"))
      for name in meta.get("_trees", [])}
  flats = {}
  for name in meta.get("_flats", []):
    with np.load(os.path.join(directory, f"{name}.npz")) as data:
      flats[name] = {key: data[key] for key in data.files}
  return trees, flats, meta


def validate_checkpoint_dir(root: str, step: int,
                            require_sidecar: bool = True):
  """(ok, reason): is step `step` under `root` a complete checkpoint? Its
  ``<step>/state.pt`` must exist and load in full (``CheckpointManager.save``
  writes it under a temporary name and renames it whole), and its sidecar's
  meta must parse, every npz it names must read back, and its step must be
  `step`. Nothing is restored."""
  root = os.path.abspath(root)
  step_dir = os.path.join(root, str(step))
  if not os.path.isdir(step_dir):
    return False, f"step dir missing: {step_dir}"
  state_file = os.path.join(step_dir, STATE_FILE)
  if not os.path.isfile(state_file):
    return False, f"{STATE_FILE} missing in {step_dir}"
  try:
    torch.load(state_file, map_location="cpu", weights_only=True)
  except Exception as e:  # noqa: BLE001 — the reason names it
    return False, f"{STATE_FILE} unreadable: {type(e).__name__}: {e}"
  if not require_sidecar:
    return True, "ok"
  directory = sidecar_dir(root, step)
  if not os.path.isdir(directory):
    return False, f"sidecar missing: {directory}"
  try:
    _, _, meta = load_sidecar(root, step)
  except Exception as e:  # noqa: BLE001 — the reason names it
    return False, f"sidecar unreadable: {type(e).__name__}: {e}"
  if int(meta.get("step", -1)) != int(step):
    return False, f"sidecar step {meta.get('step')} != dir step {step}"
  return True, "ok"


def list_checkpoint_steps(root: str) -> List[int]:
  """Every numeric directory under `root`, ascending, with or without a
  ``state.pt`` (validation rejects an incomplete one and says why)."""
  root = os.path.abspath(root)
  if not os.path.isdir(root):
    return []
  return sorted(int(e) for e in os.listdir(root)
                if e.isdigit() and os.path.isdir(os.path.join(root, e)))


def latest_resumable_step(root: str, recorder=None) -> Optional[int]:
  """The newest step under `root` that validates; None when none does.
  Every newer step it skips is logged at warning level with its reason
  and, given a flight `recorder`, triggered there as
  ``checkpoint_rejected``: a resume never skips a damaged checkpoint
  silently."""
  for step in reversed(list_checkpoint_steps(root)):
    ok, reason = validate_checkpoint_dir(root, step)
    if ok:
      return step
    _log.warning("checkpoint step %d under %s rejected: %s", step, root,
                 reason)
    if recorder is not None:
      try:
        recorder.trigger("checkpoint_rejected", step=int(step),
                         detail=reason, root=root)
      except Exception:  # noqa: BLE001 — the warning above stands
        pass
  return None


def prune_sidecars(root: str, keep_steps) -> None:
  """Removes the sidecars whose step the manager's ``max_to_keep`` pruned
  (the manager owns step retention; sidecars follow it)."""
  root = os.path.abspath(root)
  if not os.path.isdir(root):
    return
  keep = {int(s) for s in keep_steps}
  for entry in os.listdir(root):
    if not entry.startswith(SIDECAR_PREFIX):
      continue
    suffix = entry[len(SIDECAR_PREFIX):].split(".")[0]
    if suffix.isdigit() and int(suffix) not in keep:
      shutil.rmtree(os.path.join(root, entry), ignore_errors=True)
