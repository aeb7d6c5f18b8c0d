"""The port's device grasp env and Anakin loop against the JAX package and
the numpy oracle.

The env (``DeviceGraspEnv``) is held bit for bit against the numpy
``VectorGraspEnv`` and the JAX ``JaxGraspEnv``: images, targets, rewards,
dones, truncations and the episode counts over 20 lockstep steps at two
seeds, the truncation-bootstrap plan and the bank's rows. The rasterizer
gives the oracle's images and the JAX render exactly, at 12x12 and 64x64;
the procedural mode draws distinct scenes, the same scenes from the same
draws and fresh ones after terminals. The loop (``AnakinLoop``), TinyQ
through the weight bridge with the JAX package's own draws injected: a
collect-only dispatch gives the JAX env state and rewards bit for bit,
the ring's actions within 1e-5 and its tree within rtol 1e-6; one trained
period gives the JAX targets and TD errors within 1e-5, the loss within
1e-5 relative, and each side's update is Adam's rule on its own gradient.
Against itself, a dispatch of K steps equals its periods run one by one,
bit for bit, and 2 + 2 dispatches through the loop's checkpoint equal 4
straight. ``run_qtopt_replay --smoke --anakin`` meets the JAX smoke's bar.
The card tests hold the period's CUDA graph against eager periods.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has jax but no flax
  import jax
  import jax.numpy as jnp
  import optax
  from tensor2robot_tpu.export import export_utils as jax_export_utils
  from tensor2robot_tpu.obs import health as jax_health
  from tensor2robot_tpu.parallel import mesh as jax_mesh
  from tensor2robot_tpu.replay import anakin as jax_anakin
  from tensor2robot_tpu.replay import device_buffer as jax_db
  from tensor2robot_tpu.replay import loop as jax_loop
  from tensor2robot_tpu.replay import smoke as jax_smoke
  from tensor2robot_tpu.research.qtopt import jax_grasping as jg
  from tensor2robot_tpu.specs import tensorspec_utils as jax_ts
  from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
except ImportError:
  jax = None

from tensor2robot_tpu_torch import bridge  # noqa: E402
from tensor2robot_tpu_torch.bin import run_qtopt_replay  # noqa: E402
from tensor2robot_tpu_torch.obs import health  # noqa: E402
from tensor2robot_tpu_torch.obs.ledger import ExecutableLedger  # noqa: E402
from tensor2robot_tpu_torch.research.pose_env import pose_env  # noqa: E402
from tensor2robot_tpu_torch.replay import (  # noqa: E402
    anakin,
    anakin_bench,
    device_buffer,
    loop,
    smoke,
)
from tensor2robot_tpu_torch.research.qtopt import (  # noqa: E402
    device_grasping as dg,
)
from tensor2robot_tpu_torch.research.qtopt.synthetic_grasping import (  # noqa: E402,E501
    GraspRetryEnv,
    VectorGraspEnv,
    grasp_success,
)
from tensor2robot_tpu_torch.train.trainer import Trainer  # noqa: E402
from tensor2robot_tpu_torch.utils import optimizers  # noqa: E402

IMG = 12
LR = 1e-3
N_ENVS, BATCH, CAPACITY = 4, 8, 64
CEM = dict(num_samples=4, num_elites=2, iterations=2)
ACTION_ATOL = 1e-5
TREE_RTOL = 1e-6
TARGET_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-3
SMOKE_BAR = 0.30
# The JAX anakin_throughput block's keys (tensor2robot_tpu/replay/
# anakin_bench.py).
BENCH_KEYS = {"num_envs", "train_every", "inner_steps", "window_s",
              "trials", "dtype", "vector_fleet", "anakin", "speedup",
              "speedup_vs_collect_only", "compile_counts", "note"}


@pytest.fixture
def needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


def _seed_stream(base):
  """``CollectorWorker._scene_seed`` as a closure (the oracle's stream)."""
  counter = [0]

  def seed_fn():
    seed = base * 1_000_003 + counter[0]
    counter[0] += 1
    return seed

  return seed_fn


# --- the env -------------------------------------------------------------------


class TestDeviceGraspEnv:

  @pytest.mark.parametrize("seed", [0, 3])
  def test_lockstep_bit_identical_to_oracle_and_jax(self, needs_jax, seed):
    """Images and targets before every step, rewards, dones, truncations,
    the episode and success counts: the port, the numpy oracle and the JAX
    env agree bit for bit over 20 steps that cross at least 3 resets."""
    n, max_attempts = 4, 3
    bank = dg.make_scene_bank(96, image_size=IMG, base_seed=seed,
                              device="cpu")
    env = dg.DeviceGraspEnv(n, image_size=IMG, max_attempts=max_attempts,
                            radius=0.4, bank=bank, device="cpu")
    state = env.init_state()
    step = env.step_fn()
    jenv = jg.JaxGraspEnv(n, image_size=IMG, max_attempts=max_attempts,
                          radius=0.4, bank=jg.make_scene_bank(
                              96, image_size=IMG, base_seed=seed))
    jstate = jenv.init_state(jax.random.key(0))
    jstep = jax.jit(jenv.step_fn())
    venv = VectorGraspEnv(n, image_size=IMG, max_attempts=max_attempts,
                          radius=0.4)
    seeds = _seed_stream(seed)
    venv.reset([seeds() for _ in range(n)])
    rng = np.random.default_rng(seed + 100)
    boundaries = 0
    for t in range(20):
      for got in (state.images.numpy(), np.asarray(jstate.images)):
        np.testing.assert_array_equal(got, venv.images)
      for got in (state.targets.numpy(), np.asarray(jstate.targets)):
        np.testing.assert_array_equal(got, venv.targets)
      actions = rng.uniform(-1, 1, (n, 4)).astype(np.float32)
      want = venv.step(actions, seed_fn=seeds)
      _, got = step(state, torch.from_numpy(actions))
      jstate, jgot = jstep(jstate, jnp.asarray(actions), jax.random.key(t))
      for g, j, w in zip(got, jgot, want):
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(np.asarray(j), w)
      boundaries += int((want[1] > 0).sum() + want[2].sum())
    assert int(state.episodes) == int(jstate.episodes) == venv.episodes
    assert int(state.successes) == int(jstate.successes) == venv.successes
    assert int(state.next_scene) == int(jstate.next_scene)
    assert boundaries >= 3

  def test_truncation_bootstrap_boundary_transitions(self, needs_jax):
    """A success mid-budget (done 1, reset), a failed budget (truncation:
    done 0, reset), then a fresh scene's success: the Anakin transition
    recipe (the pre-step snapshot is the observation) gives the oracle's
    and the JAX env's transitions."""
    plan = (False, True, False, False, False, True)

    def hit_action(target, hit):
      action = np.full((1, 4), 0.9, np.float32)
      action[0, :2] = (target if hit
                       else np.where(target >= 0, -0.95, 0.95))
      return action

    env = dg.DeviceGraspEnv(1, image_size=IMG, max_attempts=3, radius=0.4,
                            bank=dg.make_scene_bank(64, image_size=IMG,
                                                    base_seed=5,
                                                    device="cpu"),
                            device="cpu")
    state, step = env.init_state(), env.step_fn()
    jenv = jg.JaxGraspEnv(1, image_size=IMG, max_attempts=3, radius=0.4,
                          bank=jg.make_scene_bank(64, image_size=IMG,
                                                  base_seed=5))
    jstate, jstep = jenv.init_state(jax.random.key(0)), jax.jit(
        jenv.step_fn())
    rows = []
    for t, hit in enumerate(plan):
      obs = state.images.numpy().copy()
      np.testing.assert_array_equal(obs, np.asarray(jstate.images))
      action = hit_action(state.targets.numpy()[0], hit)
      _, out = step(state, torch.from_numpy(action))
      jstate, jout = jstep(jstate, jnp.asarray(action), jax.random.key(t))
      for got, want in zip(out, jout):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
      rows.append((obs, action) + tuple(o.numpy() for o in out))
    seeds = _seed_stream(5)
    venv = VectorGraspEnv(1, image_size=IMG, max_attempts=3, radius=0.4)
    venv.reset([seeds()])
    for obs, action, rewards, dones, trunc in rows:
      np.testing.assert_array_equal(obs, venv.images)
      want = venv.step(action, seed_fn=seeds)
      for got, w in zip((rewards, dones, trunc), want):
        np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(
        np.concatenate([r[3] for r in rows]), [0., 1., 0., 0., 0., 1.])
    np.testing.assert_array_equal(
        np.concatenate([r[4] for r in rows]).astype(np.float32),
        [0., 0., 0., 0., 1., 0.])
    changes = [rows[i][0].tobytes() != rows[i + 1][0].tobytes()
               for i in range(len(rows) - 1)]
    assert changes == [False, True, False, False, True]

  def test_bank_rows_match_scalar_resets(self):
    bank = dg.make_scene_bank(6, image_size=IMG, base_seed=7, device="cpu")
    seeds = _seed_stream(7)
    env = GraspRetryEnv(image_size=IMG, max_attempts=3, radius=0.4)
    for j in range(6):
      env.reset(seeds())
      np.testing.assert_array_equal(bank.images[j].numpy(), env.image)
      np.testing.assert_array_equal(bank.targets[j].numpy(), env.target)
    np.testing.assert_array_equal(dg.scene_seed_stream(7, 3, start=2),
                                  [7_000_023, 7_000_024, 7_000_025])

  @pytest.mark.parametrize("image_size, scenes, base_seed",
                           [(12, 128, 11), (64, 64, 0)])
  def test_rasterizer_exact_against_oracle_and_jax(self, needs_jax,
                                                   image_size, scenes,
                                                   base_seed):
    bank = dg.make_scene_bank(scenes, image_size=image_size,
                              base_seed=base_seed, device="cpu")
    env = dg.DeviceGraspEnv(4, image_size=image_size, device="cpu")
    rendered = env.render_scenes(bank.targets).numpy()
    np.testing.assert_array_equal(rendered, bank.images.numpy())
    jrender = jax.jit(jg.JaxGraspEnv(4, image_size=image_size).render_scenes)
    np.testing.assert_array_equal(
        np.asarray(jrender(bank.targets.numpy())), rendered)

  def test_rasterizer_follows_the_oracle_on_knife_edges(self):
    """The 64 of 2M random targets at 64x64 whose disc edge passes closest
    to a pixel centre (within ~5e-6 px^2 of r^2), where float32 distance
    arithmetic flips pixels: the port still gives the oracle's images.
    (The JAX package's compensated rasterizer models a float64 centre,
    which NumPy 2's oracle no longer computes, and differs from the oracle
    on several of these; it is not held here.)"""
    size = 64
    targets = np.random.default_rng(0).uniform(
        -0.8, 0.8, (2_000_000, 2)).astype(np.float32)
    # The oracle's centres, in float32 as NumPy 2 computes them.
    px = ((targets[:, 0] + np.float32(1)) / np.float32(2)
          * np.float32(size - 1)).astype(np.float64)
    py = ((np.float32(1) - (targets[:, 1] + np.float32(1)) / np.float32(2))
          * np.float32(size - 1)).astype(np.float64)
    gap = np.full(len(targets), np.inf)
    for ox in range(-4, 5):
      for oy in range(-4, 5):
        d2 = (np.floor(px) + ox - px) ** 2 + (np.floor(py) + oy - py) ** 2
        gap = np.minimum(gap, np.abs(d2 - dg._r2(0.1, size)))
    edges = targets[np.argsort(gap)[:64]]
    oracle = np.stack([dg._base_image(size) for _ in edges])
    for image, target in zip(oracle, edges):
      pose_env.draw_disc(image, tuple(target), radius=0.1,
                         color=pose_env.TARGET_COLOR)
    env = dg.DeviceGraspEnv(4, image_size=size, device="cpu")
    np.testing.assert_array_equal(env.render_scenes(edges).numpy(), oracle)

  def test_success_follows_the_oracle_on_knife_edges(self):
    """20,000 grasps aimed at the radius's edge (the offset 0.4 at random
    angles, rounded to float32): the port's rewards are the oracle's
    ``grasp_success``, where a fused form (``torch.hypot``) disagrees on
    about a tenth of them."""
    n = 20_000
    rng = np.random.default_rng(0)
    targets = rng.uniform(-0.8, 0.8, (n, 2)).astype(np.float32)
    angle = rng.uniform(0, 2 * np.pi, n)
    actions = np.zeros((n, 4), np.float32)
    actions[:, 0] = targets[:, 0] + 0.4 * np.cos(angle)
    actions[:, 1] = targets[:, 1] + 0.4 * np.sin(angle)
    env = dg.DeviceGraspEnv(n, image_size=IMG, max_attempts=3, radius=0.4,
                            device="cpu")
    _, (rewards, _, _) = env.step_fn()(
        env.init_state(targets), torch.from_numpy(actions),
        dg.procedural_draws(0, 1, n))
    want = grasp_success(targets, actions, 0.4)
    np.testing.assert_array_equal(rewards.numpy(), want)
    assert 0 < want.mean() < 1

  def test_procedural_mode(self):
    """Distinct scenes, the same scenes from the same draws, fresh scenes
    after forced terminals; a procedural env without draws refuses. At
    16x16 the target disc covers a pixel wherever it lands."""
    env = dg.DeviceGraspEnv(4, image_size=16, max_attempts=2, radius=0.4,
                            device="cpu")
    draws = dg.procedural_draws(1, 0, 4)
    state = env.init_state(draws)
    assert not torch.equal(state.images[0], state.images[1])
    np.testing.assert_array_equal(env.init_state(draws).images.numpy(),
                                  state.images.numpy())
    np.testing.assert_array_equal(state.images.numpy(),
                                  env.render_scenes(draws).numpy())
    actions = torch.zeros(4, 4)
    actions[:, :2] = state.targets
    before = state.images.clone()
    _, (rewards, _, _) = env.step_fn()(state, actions,
                                       dg.procedural_draws(1, 1, 4))
    assert torch.all(rewards == 1.0)
    assert not torch.equal(state.images, before)
    assert int(state.episodes) == int(state.successes) == 4
    with pytest.raises(ValueError, match="procedural"):
      env.init_state()
    # Over a mesh the per-env fields split over the data axis and the
    # counters stay whole; a fleet the axis does not divide refuses.
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
    shardings = env.state_shardings(
        mesh_lib.create_mesh({"data": 2}, devices=range(2)))
    assert [tuple(getattr(shardings, name).spec) for name in (
        "images", "targets", "attempts", "next_scene", "episodes",
        "successes")] == [("data",)] * 3 + [()] * 3
    with pytest.raises(ValueError, match="fleet width 4"):
      env.state_shardings(mesh_lib.create_mesh({"data": 8},
                                               devices=range(8)))


# --- the loop against the JAX package ----------------------------------------

K = 8  # one period a dispatch: dispatch 1 collects, dispatch 2 trains once
MIN_FILL = 40


def _jax_normal_blocks(base, tick, count):
  """The JAX CEM draws of `count` states at `tick`: state j's iteration i
  is normal(fold_in(fold_in(fold_in(base, tick), j), i), (N, A))."""
  key = jax.random.fold_in(base, tick)
  keys = jax.vmap(lambda j: jax.random.fold_in(key, j))(
      jnp.arange(count, dtype=jnp.uint32))
  return np.stack([np.asarray(jax.vmap(
      lambda k, i=i: jax.random.normal(jax.random.fold_in(k, i),
                                       (CEM["num_samples"], 4)))(keys))
                   for i in range(CEM["iterations"])], axis=1)


def _jax_draws(seed, outer, size, inner_steps=K, train_every=K):
  """The JAX AnakinLoop's draws of dispatch `outer` (its key offsets and
  folds) in the port's layout, for a ring that holds `size` rows."""
  base = lambda c: jax.random.key(seed + c)  # noqa: E731
  fields = {name: [] for name in ("act_noise", "draw", "uniform", "normal",
                                  "slots", "uniforms", "label_noise")}
  for p in range(inner_steps // train_every):
    period = {name: [] for name in ("act_noise", "draw", "uniform",
                                    "normal")}
    for t in range(train_every):
      tick = outer * inner_steps + p * train_every + t
      period["act_noise"].append(_jax_normal_blocks(base(7), tick, N_ENVS))
      dkey, ukey, nkey = jax.random.split(
          jax.random.fold_in(base(555), tick), 3)
      period["draw"].append(np.asarray(jax.random.uniform(dkey, (N_ENVS,))))
      period["uniform"].append(np.asarray(jax.random.uniform(
          ukey, (N_ENVS, 4), jnp.float32, -1.0, 1.0)))
      period["normal"].append(np.asarray(jax.random.normal(
          nkey, (N_ENVS, 2), jnp.float32)))
    for name, values in period.items():
      fields[name].append(np.stack(values))
    tick = outer * inner_steps + (p + 1) * train_every - 1
    filled = min(CAPACITY, size + N_ENVS * train_every * (p + 1))
    uniform_key, remap_key = jax.random.split(
        jax.random.fold_in(base(0), tick))
    fields["slots"].append(np.asarray(jax.random.randint(
        uniform_key, (BATCH,), 0, max(filled, 1), dtype=jnp.int32)))
    fields["uniforms"].append(np.asarray(jax.random.uniform(
        remap_key, (BATCH,), jnp.float32)))
    fields["label_noise"].append(_jax_normal_blocks(base(1), tick, BATCH))
  return {name: np.stack(values) for name, values in fields.items()}


def _port_loop(model, trainer, seed=13, inner_steps=K, train_every=K,
               min_fill=MIN_FILL, bank_seed=0, bank=True, **kwargs):
  ring = device_buffer.DeviceReplayBuffer(
      loop.transition_spec(IMG, 4), CAPACITY, BATCH, seed=seed,
      prioritized=True, ingest_chunk=N_ENVS, device=trainer.device)
  env = dg.DeviceGraspEnv(
      N_ENVS, image_size=IMG, max_attempts=3, radius=0.4,
      bank=(dg.make_scene_bank(64, image_size=IMG, base_seed=bank_seed,
                               device=trainer.device) if bank else None),
      device=trainer.device)
  return ring, anakin.AnakinLoop(
      model, trainer, ring, env, action_size=4, gamma=0.8,
      inner_steps=inner_steps, train_every=train_every, min_fill=min_fill,
      seed=seed, health=True, **CEM, **kwargs)


def _ring_arrays(state):
  if isinstance(state, device_buffer.DeviceReplayState):
    return {key: value.copy() for key, value in state.arrays().items()}
  # Copies: the JAX loop donates these buffers to its next dispatch.
  out = {f"storage/{k}": np.array(v) for k, v in state.storage.items()}
  for name in ("written_at", "tree", "next_slot", "size", "append_count",
               "max_priority"):
    out[name] = np.array(getattr(state, name))
  return out


def _env_arrays(state):
  if isinstance(state, dg.DeviceGraspState):
    return state.arrays()
  return {name: np.array(getattr(state, name)) for name in (
      "images", "targets", "attempts", "next_scene", "episodes",
      "successes")}


@pytest.fixture(scope="module")
def jax_and_port():
  """Two dispatches of one period each, the JAX AnakinLoop and the port's
  from one bridged TinyQ init and the JAX draws: the first collects only
  (32 rows < MIN_FILL), the second ends in one learn. Both sides' env,
  ring and metrics after each, and each learn's targets, TD errors and
  sampled slots (the JAX side's through ``jax.debug.callback``)."""
  if jax is None:
    pytest.skip("needs JAX, the reference")
  jax_model = jax_smoke.TinyQCriticModel(
      image_size=IMG, optimizer_fn=lambda: optax.adam(LR))
  jax_trainer = JaxTrainer(jax_model, mesh=jax_mesh.create_mesh(
      {"data": 1}, devices=jax.devices()[:1]), seed=0)
  jax_state = jax_trainer.create_train_state(batch_size=BATCH)
  initial = jax.device_get(jax_state.variables())
  target = jax_export_utils.fetch_variables_to_host(
      jax_state.variables(use_ema=True))
  jax_ring = jax_db.DeviceReplayBuffer(
      jax_loop.transition_spec(IMG, 4), capacity=CAPACITY,
      sample_batch_size=BATCH, seed=13, prioritized=True,
      ingest_chunk=N_ENVS, mesh=jax_trainer.mesh)
  jax_env = jg.JaxGraspEnv(N_ENVS, image_size=IMG, max_attempts=3,
                           radius=0.4,
                           bank=jg.make_scene_bank(64, image_size=IMG,
                                                   base_seed=0))
  captured = {"jax": {}, "port": {}}

  def record(side, **values):
    captured[side].update({k: np.asarray(v) for k, v in values.items()})

  def wrap_targets(make, side, callback):
    def make_wrapped(*args, **kwargs):
      targets_fn = make(*args, **kwargs)

      def wrapped(*inner):
        targets, q_next = targets_fn(*inner)
        callback(lambda t: record(side, targets=t), targets)
        return targets, q_next

      return wrapped

    return make_wrapped

  def wrap_update(ring, side, callback):
    make = ring.update_priorities_fn

    def make_wrapped():
      update = make()

      def wrapped(state, indices, td):
        callback(lambda i, t: record(side, indices=i, td=t), indices, td)
        return update(state, indices, td)

      return wrapped

    ring.update_priorities_fn = make_wrapped

  def eager(fn, *args):
    fn(*(a.detach().clone() for a in args))

  wrap_update(jax_ring, "jax", jax.debug.callback)
  jax_learn_targets = jax_anakin.make_bellman_targets_fn
  port_learn_targets = anakin.make_bellman_targets_fn
  jax_anakin.make_bellman_targets_fn = wrap_targets(
      jax_learn_targets, "jax", jax.debug.callback)
  anakin.make_bellman_targets_fn = wrap_targets(port_learn_targets, "port",
                                                eager)
  try:
    jax_run = jax_anakin.AnakinLoop(
        jax_model, jax_trainer, jax_ring, jax_env, action_size=4,
        gamma=0.8, inner_steps=K, train_every=K, min_fill=MIN_FILL, seed=13,
        health=True, **CEM)
    jax_run.refresh(target, step=0)
    model = smoke.TinyQCriticModel(
        image_size=IMG, optimizer_fn=optimizers.create_adam_optimizer(LR))
    trainer = Trainer(model, device="cpu")
    state = trainer.create_train_state(initial)
    ring, ours = _port_loop(model, trainer)
    wrap_update(ring, "port", eager)
    ours.refresh(bridge.variables_to_state_dict(target, model.module), 0)
    out = {"jax": [], "port": []}
    for outer in range(2):
      draws = _jax_draws(13, outer, ring.size)
      if outer == 1:
        before = jax.device_get(jax_state.params)
        old = {n: p.detach().clone() for n, p in state.params.items()}
      jax_state, want = jax_run.step(jax_state)
      state, got = ours.step(state, draws=draws)
      out["jax"].append((want, _env_arrays(jax_run._env_state),
                         _ring_arrays(jax_ring.state)))
      out["port"].append((got, _env_arrays(ours.env_state),
                          _ring_arrays(ring.state)))
  finally:
    jax_anakin.make_bellman_targets_fn = jax_learn_targets
    anakin.make_bellman_targets_fn = port_learn_targets
  return dict(out, captured=captured, jax_model=jax_model, initial=initial,
              before=before, after=jax.device_get(jax_state.params),
              jax_ring=jax_ring, model=model, state=state, old=old,
              ours=ours)


def _check_env_and_ring(got, want):
  (_, got_env, got_ring), (_, want_env, want_ring) = got, want
  for key, value in want_env.items():
    np.testing.assert_array_equal(got_env[key], value, err_msg=key)
  for key, value in want_ring.items():
    if key == "storage/action":
      np.testing.assert_allclose(got_ring[key], value, rtol=0,
                                 atol=ACTION_ATOL)
    elif key != "tree" and key != "max_priority":
      np.testing.assert_array_equal(got_ring[key], value, err_msg=key)


class TestAgainstJax:

  def test_collect_only_dispatch(self, jax_and_port):
    got, want = jax_and_port["port"][0], jax_and_port["jax"][0]
    assert got[0]["trained_steps"] == want[0]["trained_steps"] == 0
    assert got[0] == {key: 0 for key in want[0]}
    _check_env_and_ring(got, want)
    np.testing.assert_allclose(got[2]["tree"], want[2]["tree"],
                               rtol=TREE_RTOL, atol=0)
    assert int(want[1]["episodes"]) > 0

  def test_one_trained_period(self, jax_and_port):
    """Targets and TD errors within 1e-5, the loss within 1e-5 relative,
    the other metrics within 1e-4 relative, the tree within 1e-5, and
    each side's update Adam's first step on its own gradient."""
    got, want = jax_and_port["port"][1], jax_and_port["jax"][1]
    assert got[0]["trained_steps"] == want[0]["trained_steps"] == 1
    _check_env_and_ring(got, want)
    ours, theirs = (jax_and_port["captured"][s] for s in ("port", "jax"))
    np.testing.assert_array_equal(ours["indices"], theirs["indices"])
    for key in ("targets", "td"):
      np.testing.assert_allclose(ours[key], theirs[key], rtol=0,
                                 atol=TARGET_ATOL, err_msg=key)
    assert set(got[0]) == set(want[0])
    for key, value in want[0].items():
      tol = (dict(rtol=LOSS_RTOL, atol=0) if key == "loss"
             else dict(rtol=1e-4, atol=TARGET_ATOL))
      np.testing.assert_allclose(got[0][key], value, err_msg=key, **tol)
    np.testing.assert_allclose(got[2]["tree"], want[2]["tree"], rtol=0,
                               atol=TARGET_ATOL)
    self._check_adam(jax_and_port, theirs["indices"], theirs["targets"])

  @staticmethod
  def _check_adam(run, indices, targets):
    storage = run["jax_ring"].state.storage
    batch = {key: np.asarray(storage[key])[indices]
             for key in ("image", "action")}
    rest = {k: v for k, v in run["initial"].items() if k != "params"}

    def loss_fn(params):
      loss, _ = run["jax_model"].model_train_fn(
          {"params": params, **rest}, jax_ts.TensorSpecStruct(batch),
          jax_ts.TensorSpecStruct({"target_q": jnp.asarray(targets)}))
      return loss

    module = run["model"].module
    want_grads = bridge.params_to_state_dict(
        jax.device_get(jax.grad(loss_fn)(run["before"])), module)
    want_update = bridge.params_to_state_dict(
        jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                               run["after"], run["before"]), module)
    for name, param in run["state"].params.items():
      grad = param.grad.numpy()
      want = want_grads[name].numpy()
      np.testing.assert_allclose(grad, want, rtol=0,
                                 atol=GRAD_SHARE * np.abs(want).max(),
                                 err_msg=name)
      np.testing.assert_allclose(
          (param.detach() - run["old"][name]).numpy(),
          -LR * grad / (np.abs(grad) + 1e-8), rtol=0, atol=1e-7,
          err_msg=name)
      large = np.abs(want) > 1e-6
      np.testing.assert_allclose(
          want_update[name].numpy()[large],
          (-LR * want / (np.abs(want) + 1e-8))[large], rtol=0, atol=1e-7,
          err_msg=name)

  def test_health_merge_and_zero_summary_match_jax(self, needs_jax):
    rng = np.random.default_rng(0)
    keys = health.SUMMARY_KEYS + ("loss", "td_error")
    stacked = {key: rng.normal(size=6).astype(np.float32) for key in keys}
    gates = [True, False, True, True, False, True]
    ours = {key: torch.zeros(()) for key in keys}
    theirs = {key: jnp.zeros((), jnp.float32) for key in keys}
    for i, gate in enumerate(gates):
      ours = health.merge_scan_metrics(
          {k: torch.tensor(v[i]) for k, v in stacked.items()}, ours,
          torch.tensor(gate))
      theirs = jax_health.merge_scan_metrics(
          {k: jnp.asarray(v[i]) for k, v in stacked.items()}, theirs,
          jnp.asarray(gate))
    for key in keys:
      assert float(ours[key]) == float(theirs[key]), key
    zeros = health.zero_summary()
    assert list(zeros) == list(jax_health.zero_summary())
    assert all(float(v) == 0.0 and v.dtype == torch.float32
               for v in zeros.values())


# --- the loop against itself ---------------------------------------------------


def _tinyq_trainer(device="cpu"):
  model = smoke.TinyQCriticModel(
      image_size=IMG, optimizer_fn=optimizers.create_adam_optimizer(LR))
  trainer = Trainer(model, seed=0, device=device)
  return model, trainer, trainer.create_train_state()


class TestAnakinLoop:

  @pytest.mark.parametrize("bank", [True, False])
  def test_dispatch_equals_its_periods_one_by_one(self, bank):
    """One dispatch of 16 control steps against four of 4 (the draws are
    keyed by the global tick, so the streams are one): env, ring, params
    and each merged metric (the running max of the spike keys, the last
    trained value of the rest) bit for bit; the first period waits for
    min_fill, so the gate runs inside the long dispatch."""
    runs = {}
    for name, inner in (("long", 16), ("short", 4)):
      model, trainer, state = _tinyq_trainer()
      ring, ours = _port_loop(model, trainer, inner_steps=inner,
                              train_every=4, min_fill=24, bank=bank)
      ours.refresh(state.variables(use_ema=True), 0)
      metrics = []
      for _ in range(16 // inner):
        state, values = ours.step(state)
        metrics.append(values)
      runs[name] = (state, ring, ours, metrics)
    (state_a, ring_a, loop_a, [long]), (state_b, ring_b, loop_b, short) = (
        runs["long"], runs["short"])
    assert long["trained_steps"] == 3 and state_a.step == state_b.step == 3
    assert [m["trained_steps"] for m in short] == [0, 1, 1, 1]
    for key, value in long.items():
      series = [m[key] for m in short[1:]]
      if key == "trained_steps":
        assert value == sum(series)
      else:
        assert value == (max(series) if key in health.SCAN_MAX_KEYS
                         else series[-1]), key
    for name, param in state_a.params.items():
      assert torch.equal(param, state_b.params[name]), name
    for key, value in ring_a.state.arrays().items():
      np.testing.assert_array_equal(ring_b.state.arrays()[key], value,
                                    err_msg=key)
    for key, value in loop_a.env_state.arrays().items():
      np.testing.assert_array_equal(loop_b.env_state.arrays()[key], value,
                                    err_msg=key)
    assert ring_a.size == ring_b.size == 64 == int(ring_a.state.size)
    assert ring_a.append_count == 64 and ring_a.compile_counts == {}
    assert loop_a.episodes == loop_b.episodes > 0
    assert loop_a.env_steps == loop_b.env_steps == 64
    assert loop_a.compile_counts == loop_b.compile_counts == {
        "anakin_step": 1}

  def test_seeded_one_build_over_refreshes(self):
    def stream(seed):
      model, trainer, state = _tinyq_trainer()
      ring, ours = _port_loop(model, trainer, seed=seed, inner_steps=8,
                              train_every=4, min_fill=8)
      ours.refresh(state.variables(use_ema=True), 0)
      out = []
      for _ in range(3):
        state, metrics = ours.step(state)
        out.append(metrics)
        pointers = [t.data_ptr() for t in ours._target_variables.values()]
        ours.refresh({k: v + 0.05 for k, v in
                      state.variables(use_ema=True).items()}, state.step)
        assert [t.data_ptr() for t in
                ours._target_variables.values()] == pointers
      assert ours.compile_counts == {"anakin_step": 1}
      assert ours.trained_steps == state.step == 6
      return out

    first = stream(0)
    assert stream(0) == first
    assert stream(1) != first

  def test_constructor_checks_and_refusals(self, tmp_path):
    model, trainer, state = _tinyq_trainer()
    ring, ours = _port_loop(model, trainer)
    env = ours._env
    with pytest.raises(ValueError, match="ingest_chunk"):
      anakin.AnakinLoop(model, trainer, device_buffer.DeviceReplayBuffer(
          loop.transition_spec(IMG, 4), 64, 8, ingest_chunk=8,
          device="cpu"), env, inner_steps=8, train_every=2)
    with pytest.raises(ValueError, match="multiple"):
      anakin.AnakinLoop(model, trainer, ring, env, inner_steps=8,
                        train_every=3)
    # ledger= is taken; the period registers at its first learning build.
    book = ExecutableLedger()
    anakin.AnakinLoop(model, trainer, ring, env, ledger=book)
    assert book.names() == []
    # The bf16 tier, once item 11's refusal, builds with its dtype name.
    assert anakin.AnakinLoop(model, trainer, ring, env,
                             precision="bf16").dtype == "bfloat16"
    with pytest.raises(ValueError, match="refresh"):
      ours.step(state)
    with pytest.raises(ValueError, match="whole number"):
      ring.advance_host_counts(3)
    assert ours.mesh_shape == {"data": 1} and ours.dtype == "float32"
    with pytest.raises(ValueError, match="capacity"):
      loop.ReplayTrainLoop(loop.ReplayLoopConfig(anakin=True, capacity=2),
                           str(tmp_path), model=smoke.TinyQCriticModel(),
                           device="cpu")

  def test_fused_resume_equals_an_uninterrupted_run(self):
    result = anakin_bench.anakin_resume_parity(2, 2, seed=0, device="cpu")
    assert result["restored_step"] == result["saved_step"] > 0
    for key in ("restored_bit_equal", "pre_crash_metrics_equal",
                "post_resume_metrics_equal", "params_bit_equal",
                "env_ring_target_bit_equal", "parity_ok"):
      assert result[key], key

  def test_a_loop_that_never_trains_raises_by_name(self, tmp_path):
    """A gate no learn passes (the Anakin loop's min_fill past the ring's
    capacity): the loop stops at its dispatch bound instead of
    spinning."""
    replay = loop.ReplayTrainLoop(
        loop.ReplayLoopConfig(anakin=True, capacity=64, min_fill=32,
                              anakin_bank_scenes=16), str(tmp_path),
        model=smoke.TinyQCriticModel(), device="cpu")
    make = replay._anakin_loop

    def never_trains():
      ours = make()
      ours.min_fill = 65
      return ours

    replay._anakin_loop = never_trains
    with pytest.raises(RuntimeError, match="anakin loop stalled"):
      replay.run(5)

  def test_checkpoints_name_their_path(self, tmp_path):
    """An Anakin checkpoint does not resume the device-resident path, nor
    a device-resident one the Anakin path: each refuses by name."""
    def replay(root, **kwargs):
      out = loop.ReplayTrainLoop(
          loop.ReplayLoopConfig(checkpoint_every=10, anakin_bank_scenes=16,
                                **kwargs), str(root),
          model=smoke.TinyQCriticModel(), device="cpu")
      out.writer.close()
      return out

    for saver, resumer, path in (
        ({"anakin": True}, {"device_resident": True}, "anakin path"),
        ({"device_resident": True}, {"anakin": True},
         "device-resident path")):
      root = tmp_path / path.split()[0]
      first = replay(root, **saver)
      state = first.trainer.create_train_state()
      carrier = (first._anakin_loop() if saver.get("anakin")
                 else first._megastep_learner())
      carrier.refresh(state.variables(use_ema=True), step=0)
      first._save_fused_checkpoint(10, state, carrier, {}, [])
      second = replay(root, resume=True, **resumer)
      other = (second._anakin_loop() if resumer.get("anakin")
               else second._megastep_learner())
      with pytest.raises(ValueError, match=path):
        second._restore_fused_checkpoint(
            second.trainer.create_train_state(), other)


# --- the CLI's smoke -----------------------------------------------------------


@pytest.fixture(scope="module")
def anakin_smoke(tmp_path_factory):
  """ONE ``run_qtopt_replay --smoke --anakin`` with its bench, shared by
  the acceptance checks (the JAX smoke's protocol)."""
  import contextlib
  import io
  logdir = tmp_path_factory.mktemp("anakin_smoke")
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    run_qtopt_replay.main(["--smoke", "--anakin", "--device", "cpu",
                           "--profile", "5,8", "--logdir", str(logdir)])
  lines = [line for line in out.getvalue().splitlines() if line.strip()]
  assert len(lines) == 1
  return dict(json.loads(lines[0]),
              traces=os.listdir(os.path.join(logdir, "profile")))


class TestAnakinSmoke:

  def test_td_reduction_meets_bar(self, anakin_smoke):
    assert anakin_smoke["anakin"] is True
    assert anakin_smoke["device_resident"] is True
    assert anakin_smoke["eval_td_reduction"] >= SMOKE_BAR, (
        anakin_smoke["eval_history"])

  def test_one_build_and_no_host_acting(self, anakin_smoke):
    ledger = anakin_smoke["compile_counts"]
    assert ledger == {"anakin_step": 1, "bellman_td_error": 1}
    assert not any(key in ledger for key in ("megastep", "train_step",
                                             "device_extend"))
    assert not any(key.startswith("cem_bucket_") for key in ledger)

  def test_collected_on_the_device(self, anakin_smoke):
    assert anakin_smoke["steps"] >= 300
    assert anakin_smoke["episodes_collected"] > 50
    assert anakin_smoke["env_steps_collected"] % 4 == 0
    assert 0 < anakin_smoke["collector_success_rate"] <= 1
    assert anakin_smoke["queue"]["enqueued"] == 0
    assert anakin_smoke["param_refreshes"] >= 10
    assert anakin_smoke["health"]["breach_count"] == 0
    assert anakin_smoke["mesh_shape"] == {"data": 1}
    assert anakin_smoke["anakin_inner"] == 40
    assert anakin_smoke["anakin_train_every"] == 8
    assert len(anakin_smoke["traces"]) == 1  # the --profile window

  def test_anakin_throughput_block(self, anakin_smoke):
    block = anakin_smoke["anakin_throughput"]
    assert set(block) == BENCH_KEYS
    assert block["dtype"] == block["anakin"]["dtype"] == "float32"
    for path, fields in (
        ("vector_fleet", ("env_steps_per_sec",
                          "collect_only_env_steps_per_sec",
                          "learner_steps_per_sec")),
        ("anakin", ("env_steps_per_sec", "train_steps_per_sec",
                    "host_blocked_fraction"))):
      for field in fields:
        assert set(block[path][field]) == {"median", "min", "max",
                                           "trials"}
    assert block["anakin"]["env_steps_per_sec"]["min"] > 0
    assert block["compile_counts"] == {"vector_cem_bucket_32": 1,
                                       "megastep": 1, "anakin_step": 1}


# --- the card ------------------------------------------------------------------


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA GPU")
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  yield torch.device("cuda")
  torch.backends.cudnn.deterministic = deterministic


@pytest.mark.cuda
def test_cuda_graph_equals_eager_periods(cuda_device):
  """The period's graph (dispatch 1 eager across min_fill, dispatch 2
  captures, dispatch 3 replays, a refresh between) against every dispatch
  eager: metrics, parameters, Adam's state, the env and the ring, bit for
  bit; one build for each."""
  runs = {}
  for graphs in (True, False):
    model, trainer, state = _tinyq_trainer(cuda_device)
    ring, ours = _port_loop(model, trainer, inner_steps=16, train_every=4,
                            min_fill=24, graphs=graphs)
    ours.refresh(state.variables(use_ema=True), 0)
    metrics = []
    for outer in range(3):
      state, values = ours.step(state)
      metrics.append(values)
      if outer == 1:
        ours.refresh(state.variables(use_ema=True), state.step)
    runs[graphs] = (state, ring, ours, metrics)
  (state_g, ring_g, loop_g, got), (state_e, ring_e, loop_e, want) = (
      runs[True], runs[False])
  assert got == want
  for name, param in state_g.params.items():
    assert torch.equal(param, state_e.params[name]), name
  for group_g, group_e in zip(state_g.opt_state.state.values(),
                              state_e.opt_state.state.values()):
    for key, value in group_g.items():
      assert torch.equal(value, group_e[key]), key
  for carried_g, carried_e in ((ring_g.state.arrays(), ring_e.state.arrays()),
                               (loop_g.env_state.arrays(),
                                loop_e.env_state.arrays())):
    for key, value in carried_g.items():
      np.testing.assert_array_equal(carried_e[key], value, err_msg=key)
  assert loop_g.compile_counts == loop_e.compile_counts == {"anakin_step": 1}
  assert loop_g._graph is not None and loop_e._graph is None


@pytest.mark.cuda
def test_cuda_env_and_rasterizer_match_the_oracle(cuda_device):
  seeds = _seed_stream(0)
  bank = dg.make_scene_bank(64, image_size=64, base_seed=0,
                            device=cuda_device)
  env = dg.DeviceGraspEnv(8, image_size=64, max_attempts=3, radius=0.4,
                          bank=bank, device=cuda_device)
  np.testing.assert_array_equal(env.render_scenes(bank.targets).cpu().numpy(),
                                bank.images.cpu().numpy())
  state, step = env.init_state(), env.step_fn()
  venv = VectorGraspEnv(8, image_size=64, max_attempts=3, radius=0.4)
  venv.reset([seeds() for _ in range(8)])
  rng = np.random.default_rng(1)
  for _ in range(20):
    np.testing.assert_array_equal(state.images.cpu().numpy(), venv.images)
    actions = rng.uniform(-1, 1, (8, 4)).astype(np.float32)
    want = venv.step(actions, seed_fn=seeds)
    _, got = step(state, torch.from_numpy(actions).to(cuda_device))
    for g, w in zip(got, want):
      np.testing.assert_array_equal(g.cpu().numpy(), w)
  assert int(state.episodes) == venv.episodes


def test_config_accepts_anakin():
  config = loop.ReplayLoopConfig(anakin=True)
  assert config.anakin and dataclasses.replace(config, seed=1).anakin
