"""The synthetic grasping fleet as tensors on the device.

Counterpart of ``tensor2robot_tpu/research/qtopt/jax_grasping.py``
(``JaxGraspEnv`` -> ``DeviceGraspEnv``, ``JaxGraspState`` ->
``DeviceGraspState``). The Anakin loop (``replay/anakin.py``) keeps the
environment on the card beside acting, the replay ring and the learner,
so a control step needs no host round trip: ``step`` grasps fleet-wide,
auto-resets every terminal env and changes the state's tensors in place
(the port's stand-in for the JAX package's donation: a CUDA graph only
sees tensors that keep their storage).

The semantics oracle is the numpy pair ``VectorGraspEnv`` /
``GraspRetryEnv``: with the bank built from the collectors' seed stream,
images, targets, outcomes and the episode counts match it bit for bit
(``tests/test_torch_anakin.py``). Two scene sources:

- ``SceneBank``: scenes rendered once on the host by the oracle's own
  ``sample_scenes(1, seed)`` call, one row per seed of the stream
  ``base * 1_000_003 + counter``; resets take rows in env order from a
  monotonic cursor, wrapping modulo the bank.
- procedural (``bank=None``): each reset's target is uniform in
  [-0.8, 0.8]^2 and ``render_scenes`` rasterizes it on the device. The
  targets are host draws the caller passes in (the JAX package keys them
  by ``jax.random``; the port draws them with numpy, as every other draw
  of the loop: ``procedural_draws``).

**The rasterizer.** The oracle (``pose_env.draw_disc``) decides each
pixel by ``(xx - cx)**2 + (yy - cy)**2 <= r**2`` in float64. The JAX
package, without float64 on the TPU, rebuilds that decision from
compensated float32 pairs. The port runs the oracle's own arithmetic:
the pixel centre in the dtype numpy gives ``pose_to_pixel`` for a
float32 target (float32 under NumPy 2's promotion rules, float64 under
NumPy 1's), then the squared distance in float64, one operation a torch
op (no fused multiply-add), against the float64 ``r**2``. The checker
table and the arm disc never change, so the oracle's code renders them
once (``_base_image``) and only the target disc is decided on the
device.

**Over a mesh of ranks** (``state_shardings``, Podracer's per-core env
slices): each rank holds and steps its block of the fleet (images,
targets, attempts) while the scene cursor and the episode counts stay
whole on every rank, one global counter. A step over a mesh gathers the
fleet's terminal and success flags, so every rank assigns scenes from
the same global order and counts the same episodes: the one-rank fleet's
stream, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch import Device, resolve_device
from tensor2robot_tpu_torch.parallel import collectives, distributed
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.research.pose_env import pose_env
from tensor2robot_tpu_torch.research.qtopt.synthetic_grasping import (
    GRASP_RADIUS,
    sample_scenes,
)

# The dtype of ``pose_env.pose_to_pixel``'s centre for a float32 target:
# NumPy 2 keeps np.float32 + 1.0 in float32, NumPy 1 promoted to float64.
_CENTER_DTYPE = (torch.float64 if (np.float32(0.5) + 1.0).dtype == np.float64
                 else torch.float32)


def scene_seed_stream(base_seed: int, count: int,
                      start: int = 0) -> np.ndarray:
  """The collectors' scene seeds (``CollectorWorker._scene_seed``: seed =
  base * 1_000_003 + counter) as an int64 array: bank row j is the scene
  the numpy fleet's j-th reset draws."""
  return (base_seed * 1_000_003
          + np.arange(start, start + count, dtype=np.int64))


@dataclasses.dataclass
class SceneBank:
  """Oracle-rendered scenes on the device: uint8 (K, S, S, 3) images and
  float32 (K, 2) targets."""
  images: torch.Tensor
  targets: torch.Tensor

  @property
  def num_scenes(self) -> int:
    return self.images.shape[0]


def make_scene_bank(num_scenes: int, image_size: int = 64,
                    base_seed: int = 0, device: Device = None) -> SceneBank:
  """Renders `num_scenes` oracle scenes on the host, one
  ``sample_scenes(1, seed)`` a row over ``scene_seed_stream(base_seed)``
  (the call ``GraspRetryEnv.reset(seed)`` makes), then copies the bank to
  `device` once."""
  seeds = scene_seed_stream(base_seed, num_scenes)
  images = np.empty((len(seeds), image_size, image_size, 3), np.uint8)
  targets = np.empty((len(seeds), 2), np.float32)
  for i, seed in enumerate(seeds):
    image, target = sample_scenes(1, image_size=image_size, seed=int(seed),
                                  num_distractors=0, occlusion=False)
    images[i], targets[i] = image[0], target[0]
  device = resolve_device(device)
  return SceneBank(images=torch.from_numpy(images).to(device),
                   targets=torch.from_numpy(targets).to(device))


def procedural_draws(seed: int, tick: int, num_envs: int) -> np.ndarray:
  """(num_envs, 2) float32 reset targets uniform in [-0.8, 0.8], from
  ``np.random.default_rng((seed, tick))``."""
  rng = np.random.default_rng((seed, tick))
  return rng.uniform(-0.8, 0.8, (num_envs, 2)).astype(np.float32)


# --- the rasterizer --------------------------------------------------------


def _base_image(image_size: int) -> np.ndarray:
  """The scene less the target disc, rendered by the oracle's code: the
  checker shading as ``PoseEnv.render`` draws it (stride 8, +12 lift)
  and the arm disc through ``draw_disc``."""
  s = image_size
  image = np.empty((s, s, 3), np.uint8)
  image[:] = pose_env.TABLE_COLOR
  yy, xx = np.mgrid[0:s, 0:s]
  image[((yy // 8 + xx // 8) % 2).astype(bool)] = tuple(
      min(c + 12, 255) for c in pose_env.TABLE_COLOR)
  pose_env.draw_disc(image, (0.0, -0.95), radius=0.12,
                     color=pose_env.ARM_COLOR)
  return image


def _r2(radius: float, image_size: int) -> float:
  """``draw_disc``'s float64 threshold: r = radius / 2 * (S - 1), r**2."""
  r = radius / 2.0 * (image_size - 1)
  return r ** 2


def _pixel_centers(targets: torch.Tensor, image_size: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
  """``pose_to_pixel`` for each (N, 2) float32 target, in numpy's dtype,
  widened to float64 as ``draw_disc``'s grid subtraction widens it."""
  t = targets.to(_CENTER_DTYPE)
  px = (t[:, 0] + 1.0) / 2.0 * (image_size - 1)
  py = (1.0 - (t[:, 1] + 1.0) / 2.0) * (image_size - 1)
  return px.double(), py.double()


def make_render_fn(image_size: int, target_radius: float = 0.1,
                   device: Device = None):
  """(targets (N, 2) float32) -> uint8 (N, S, S, 3): the replay loop's
  scene (no distractors, no occluder: ``GraspRetryEnv``'s) on `device`,
  the oracle's images exactly."""
  s = image_size
  device = resolve_device(device)
  base = torch.from_numpy(_base_image(s)).to(device)
  r2 = _r2(target_radius, s)
  grid = torch.arange(s, dtype=torch.float64, device=device)
  color = torch.tensor(pose_env.TARGET_COLOR, dtype=torch.uint8,
                       device=device)

  def render(targets: torch.Tensor) -> torch.Tensor:
    cx, cy = _pixel_centers(targets.float(), s)
    dx = grid[None, None, :] - cx[:, None, None]
    dy = grid[None, :, None] - cy[:, None, None]
    mask = dx * dx + dy * dy <= r2
    return torch.where(mask[..., None], color, base)

  return render


# --- the env ---------------------------------------------------------------


@dataclasses.dataclass
class DeviceGraspState:
  """The fleet's episode state, tensors changed in place by ``step``
  (counterpart of ``JaxGraspState``).

  images: uint8 (N, S, S, 3), each env's scene: the observation, read
    before a step.
  targets: float32 (N, 2) object poses (scripted exploration reads them).
  attempts: int32 (N,) grasps in the current episode.
  next_scene: int32 0-d, the monotonic scene cursor (the collectors'
    shared seed counter).
  episodes / successes: int32 0-d fleet counts.
  """
  images: torch.Tensor
  targets: torch.Tensor
  attempts: torch.Tensor
  next_scene: torch.Tensor
  episodes: torch.Tensor
  successes: torch.Tensor

  _FIELDS = ("images", "targets", "attempts", "next_scene", "episodes",
             "successes")

  def arrays(self) -> Dict[str, np.ndarray]:
    """Host copies of every tensor, keyed by field (copies on the CPU
    too, where ``numpy()`` would share the tensor's memory)."""
    return {name: getattr(self, name).cpu().numpy().copy()
            for name in self._FIELDS}

  def load(self, arrays, shardings: Optional["DeviceGraspState"] = None
           ) -> None:
    """Copies field-keyed `arrays` (``arrays()``'s) into this state's own
    tensors; with `shardings` (``DeviceGraspEnv.state_shardings``) the
    arrays are the whole fleet's and each rank copies its part."""
    if shardings is not None:
      arrays = distributed.global_put(
          {name: arrays[name] for name in self._FIELDS},
          {name: getattr(shardings, name) for name in self._FIELDS})
    with torch.no_grad():
      for name in self._FIELDS:
        getattr(self, name).copy_(torch.as_tensor(arrays[name]))


class DeviceGraspEnv:
  """N grasping envs stepped in lockstep on one device (counterpart of
  ``JaxGraspEnv``).

  ``VectorGraspEnv``'s auto-reset semantics: rewards, dones and
  truncations describe the attempt before the reset, done mirrors
  success only (a truncation bootstraps), and every terminal env resets
  at once in env order, taking the cursor's next scene. A scene is
  static within its episode, so a transition's next image is its own
  scene.

  Args:
    num_envs / image_size / max_attempts / radius: the fleet.
    bank: a ``SceneBank`` on the same device (rows in cursor order,
      wrapping), or None for procedural scenes.
    device: where the state lives; the GPU unless 'cpu' is asked for.
  """

  def __init__(self, num_envs: int, image_size: int = 64,
               max_attempts: int = 4, radius: float = GRASP_RADIUS,
               bank: Optional[SceneBank] = None, device: Device = None):
    if num_envs < 1:
      raise ValueError(f"num_envs must be >= 1, got {num_envs}")
    if bank is not None and bank.images.shape[1] != image_size:
      raise ValueError(
          f"bank image size {bank.images.shape[1]} != env {image_size}")
    self.device = resolve_device(device)
    self.num_envs = num_envs
    self.image_size = image_size
    self.max_attempts = max_attempts
    self.radius = radius
    self.bank = bank
    self._render = make_render_fn(image_size, device=self.device)

  def _fresh_scenes(self, slots: torch.Tensor,
                    targets: Optional[torch.Tensor]):
    """(targets, images) of scenes for every env: bank rows at `slots`,
    or the procedural `targets` rendered."""
    if self.bank is not None:
      idx = slots.long() % self.bank.num_scenes
      return self.bank.targets[idx], self.bank.images[idx]
    if targets is None:
      raise ValueError("a procedural DeviceGraspEnv needs the reset "
                       "targets (procedural_draws)")
    targets = torch.as_tensor(targets).to(self.device, torch.float32)
    return targets, self._render(targets)

  def init_state(self, targets=None, mesh=None,
                 axis: str = "data") -> DeviceGraspState:
    """Every env reset once, scenes 0..N-1 in env order (the oracle fleet's
    ``reset([seed_fn() for _ in range(N)])``); procedural scenes take
    `targets`, (N, 2) draws. Over a `mesh`, this rank's part of that
    state (``state_shardings``)."""
    n, dev = self.num_envs, self.device
    targets, images = self._fresh_scenes(
        torch.arange(n, dtype=torch.int32, device=dev), targets)
    state = DeviceGraspState(
        images=images.clone(), targets=targets.clone(),
        attempts=torch.zeros(n, dtype=torch.int32, device=dev),
        next_scene=torch.full((), n, dtype=torch.int32, device=dev),
        episodes=torch.zeros((), dtype=torch.int32, device=dev),
        successes=torch.zeros((), dtype=torch.int32, device=dev))
    if not mesh_lib.is_distributed(mesh):
      return state
    shardings = self.state_shardings(mesh, axis)
    fields = DeviceGraspState._FIELDS
    placed = distributed.global_put(
        {name: getattr(state, name) for name in fields},
        {name: getattr(shardings, name) for name in fields}, device=dev)
    return DeviceGraspState(**placed)

  def state_shardings(self, mesh, axis: str = "data") -> DeviceGraspState:
    """The state's placement on `mesh`, field by field: the per-env
    fields (images, targets, attempts) split over `axis`
    (``parallel.mesh.env_sharding``), each rank owning num_envs /
    axis_size envs, while the cursor and the episode counts stay whole
    (one global seed-stream counter, the oracle's, so scenes are assigned
    as on one rank). Refuses a fleet the axis does not divide."""
    parts = mesh.shape[axis]
    if self.num_envs % parts:
      raise ValueError(
          f"env fleet width {self.num_envs} is not divisible by the "
          f"{axis!r} mesh axis size ({parts} devices)")
    fleet = mesh_lib.env_sharding(mesh, axis)
    whole = mesh_lib.replicated_sharding(mesh)
    return DeviceGraspState(images=fleet, targets=fleet, attempts=fleet,
                            next_scene=whole, episodes=whole,
                            successes=whole)

  def step_fn(self, mesh=None, axis: str = "data"):
    """(state, actions (N, A), reset targets (N, 2) or None) -> (state,
    (rewards, dones, truncated)), the state changed in place.

    The success test is ``grasp_success``'s float32 arithmetic, one torch
    op an operation (sqrt(dx*dx + dy*dy) < radius): no fused form, so the
    outcome at the boundary is the oracle's. Over a `mesh` the state,
    the actions and the reset targets are this rank's block of the fleet
    along `axis`, and the step gathers the fleet's terminal and success
    flags (a collective)."""
    max_attempts, radius = self.max_attempts, self.radius
    group = (mesh.group(axis)
             if mesh_lib.is_distributed(mesh) and mesh.shape[axis] > 1
             else None)
    first = (mesh.axis_index(axis) * (self.num_envs // mesh.shape[axis])
             if group is not None else 0)

    def step(state: DeviceGraspState, actions: torch.Tensor,
             reset_targets: Optional[torch.Tensor] = None):
      actions = actions.float()
      delta = actions[:, :2] - state.targets
      dx, dy = delta[:, 0], delta[:, 1]
      dist = torch.sqrt(dx * dx + dy * dy)
      success = dist < radius
      attempts = state.attempts + 1
      truncated = torch.logical_and(torch.logical_not(success),
                                    attempts >= max_attempts)
      terminal = torch.logical_or(success, truncated)
      term32 = terminal.to(torch.int32)
      wins = success.to(torch.int32)
      if group is not None:
        # The fleet's flags, so every rank orders and counts globally.
        fleet = collectives.all_gather(torch.stack([term32, wins]), group,
                                       1)
        every, wins = fleet[0], fleet[1]
      else:
        every = term32
      # Env-order scene assignment: env i's reset takes the cursor plus
      # the number of terminal envs before it, as the numpy fleet draws
      # seeds from its shared counter.
      order = (torch.cumsum(every, 0, dtype=torch.int32) - every)[
          first:first + len(term32)]
      slots = state.next_scene + order
      new_targets, new_images = self._fresh_scenes(slots, reset_targets)
      rewards = success.float()
      with torch.no_grad():
        state.images.copy_(torch.where(terminal[:, None, None, None],
                                       new_images, state.images))
        state.targets.copy_(torch.where(terminal[:, None], new_targets,
                                        state.targets))
        state.attempts.copy_(torch.where(terminal, 0, attempts))
        ends = every.sum(dtype=torch.int32)
        state.next_scene.add_(ends)
        state.episodes.add_(ends)
        state.successes.add_(wins.sum(dtype=torch.int32))
      return state, (rewards, rewards, truncated)

    return step

  def render_scenes(self, targets) -> torch.Tensor:
    """The device rasterizer for any (N, 2) targets (the procedural
    mode's observations)."""
    return self._render(torch.as_tensor(targets).to(self.device))
