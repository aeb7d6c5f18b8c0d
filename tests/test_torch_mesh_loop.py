"""The QT-Opt replay loop over a mesh of ranks, held against one rank's run
and against the JAX package's mesh loop.

The port's side runs in two CPU gloo ranks spawned through
``parallel.launch`` (the bodies in ``tests/torch_mesh_loop_ranks.py``,
every two-rank case in one spawn); one rank is the same code in this
process with no mesh; JAX runs its loop over {"data": 2} of the 8 virtual
CPU devices (``tests/conftest.py``). TinyQ starts from the JAX init
through the weight bridge where JAX is compared, and the port takes the
JAX package's own draws there. The contract is JAX's
(``tests/test_anakin.py::TestShardedAnakinParity``):

- before any learn, the Anakin stream at dp=2 equals one rank's bit for
  bit (ring, fleet, episode counts), and the JAX dp=2 stream: the fleet
  and the ring bit for bit but the actions, within ACTION_ATOL (CEM's
  float32 scores), and the sum tree within TREE_RTOL;
- once learns run, three dispatches' loss, TD error, bootstrap Q and
  staleness within LOSS_RTOL / LOSS_ATOL of one rank's, for the Anakin
  loop and the megastep alike (the gradient all-reduce sums float32
  partials in another order); the first update's gradients in float64
  within GRAD64_SHARE of each tensor's largest (Adam's first update is
  blind to a gradient's scale);
- the ring and the fleet really split, ZeRO-1 splits the optimizer's
  moments, tp=2 splits parameters (tp=1 none), a resume on the same mesh
  equals the run straight through bit for bit and a resume on another
  mesh refuses, and indivisible sizes refuse with JAX's messages.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:  # the reference; the GPU machine has no flax
  import jax
  import jax.numpy as jnp
  import optax
  from tensor2robot_tpu.bin import run_qtopt_replay as jax_cli
  from tensor2robot_tpu.export import export_utils as jax_export_utils
  from tensor2robot_tpu.parallel import mesh as jax_mesh
  from tensor2robot_tpu.replay import anakin as jax_anakin
  from tensor2robot_tpu.replay import device_buffer as jax_db
  from tensor2robot_tpu.replay import loop as jax_loop
  from tensor2robot_tpu.replay import smoke as jax_smoke
  from tensor2robot_tpu.research.qtopt import jax_grasping as jg
  from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
except ImportError:
  jax = None

import torch_mesh_loop_ranks as ranks  # noqa: E402
from tensor2robot_tpu_torch.bin import run_qtopt_replay  # noqa: E402
from tensor2robot_tpu_torch.parallel import launch  # noqa: E402
from tensor2robot_tpu_torch.replay import tpquant_bench  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG, N_ENVS, BATCH, CAPACITY, K = (ranks.IMG, ranks.N_ENVS, ranks.BATCH,
                                   ranks.CAPACITY, ranks.K)
CEM = ranks.CEM
ACTION_ATOL = 1e-5
TREE_RTOL = 1e-6
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6
GRAD64_SHARE = 1e-10


@pytest.fixture
def needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


# --- the JAX side ------------------------------------------------------------


def _jax_normal_blocks(base, tick, count):
  """The JAX CEM draws of `count` states at `tick`."""
  key = jax.random.fold_in(base, tick)
  keys = jax.vmap(lambda j: jax.random.fold_in(key, j))(
      jnp.arange(count, dtype=jnp.uint32))
  return np.stack([np.asarray(jax.vmap(
      lambda k, i=i: jax.random.normal(jax.random.fold_in(k, i),
                                       (CEM["num_samples"], 4)))(keys))
                   for i in range(CEM["iterations"])], axis=1)


def _jax_draws(seed, outer, size):
  """The JAX AnakinLoop's draws of dispatch `outer` (one period) in the
  port's layout, for a ring that holds `size` rows."""
  base = lambda c: jax.random.key(seed + c)  # noqa: E731
  out = {name: [] for name in ("act_noise", "draw", "uniform", "normal")}
  for t in range(K):
    tick = outer * K + t
    out["act_noise"].append(_jax_normal_blocks(base(7), tick, N_ENVS))
    dkey, ukey, nkey = jax.random.split(
        jax.random.fold_in(base(555), tick), 3)
    out["draw"].append(np.asarray(jax.random.uniform(dkey, (N_ENVS,))))
    out["uniform"].append(np.asarray(jax.random.uniform(
        ukey, (N_ENVS, 4), jnp.float32, -1.0, 1.0)))
    out["normal"].append(np.asarray(jax.random.normal(
        nkey, (N_ENVS, 2), jnp.float32)))
  draws = {name: np.stack(values)[None] for name, values in out.items()}
  tick = outer * K + K - 1
  filled = min(CAPACITY, size + N_ENVS * K)
  uniform_key, remap_key = jax.random.split(
      jax.random.fold_in(base(0), tick))
  draws["slots"] = np.asarray(jax.random.randint(
      uniform_key, (BATCH,), 0, max(filled, 1), dtype=jnp.int32))[None]
  draws["uniforms"] = np.asarray(jax.random.uniform(
      remap_key, (BATCH,), jnp.float32))[None]
  draws["label_noise"] = _jax_normal_blocks(base(1), tick, BATCH)[None]
  return draws


def _jax_pretrain_dp2():
  """One collect-only dispatch of the JAX AnakinLoop over {"data": 2}:
  its TinyQ init, target, and ring and fleet after it."""
  model = jax_smoke.TinyQCriticModel(image_size=IMG,
                                     optimizer_fn=lambda: optax.adam(1e-3))
  mesh = jax_mesh.create_mesh({"data": 2}, devices=jax.devices()[:2])
  trainer = JaxTrainer(model, mesh=mesh, seed=0, shard_optimizer_state=True)
  state = trainer.create_train_state(batch_size=BATCH)
  initial = jax.device_get(state.variables())
  target = jax_export_utils.fetch_variables_to_host(
      state.variables(use_ema=True))
  ring = jax_db.DeviceReplayBuffer(
      jax_loop.transition_spec(IMG, 4), capacity=CAPACITY,
      sample_batch_size=BATCH, seed=13, prioritized=True,
      ingest_chunk=N_ENVS, mesh=trainer.mesh)
  env = jg.JaxGraspEnv(N_ENVS, image_size=IMG, max_attempts=3, radius=0.4,
                       bank=jg.make_scene_bank(64, image_size=IMG,
                                               base_seed=0))
  fused = jax_anakin.AnakinLoop(
      model, trainer, ring, env, action_size=4, gamma=0.8, inner_steps=K,
      train_every=K, min_fill=10 ** 6, seed=13, health=True, **CEM)
  fused.refresh(target, step=0)
  state, metrics = fused.step(state)
  assert metrics["trained_steps"] == 0
  ring_arrays = {f"storage/{k}": np.array(v)
                 for k, v in ring.state.storage.items()}
  for name in ("written_at", "tree", "next_slot", "size", "append_count",
               "max_priority"):
    ring_arrays[name] = np.array(getattr(ring.state, name))
  env_arrays = {name: np.array(getattr(fused._env_state, name)) for name in (
      "images", "targets", "attempts", "next_scene", "episodes",
      "successes")}
  return initial, target, ring_arrays, env_arrays


def _jax_refusals():
  """The JAX loop's messages for the sizes ``ranks.refusals`` tries, on
  its {"data": 2} mesh."""
  model = jax_smoke.TinyQCriticModel(image_size=IMG,
                                     optimizer_fn=lambda: optax.adam(1e-3))
  mesh = jax_mesh.create_mesh({"data": 2}, devices=jax.devices()[:2])
  trainer = JaxTrainer(model, mesh=mesh, seed=0, shard_optimizer_state=True)
  spec = jax_loop.transition_spec(IMG, 4)
  out = {}
  try:
    jax_db.DeviceReplayBuffer(spec, 65, BATCH, ingest_chunk=4, mesh=mesh)
  except ValueError as e:
    out["capacity"] = str(e)
  for name, fleet, batch in (("fleet", 3, BATCH), ("batch", N_ENVS, 7)):
    ring = jax_db.DeviceReplayBuffer(spec, CAPACITY, batch,
                                     ingest_chunk=fleet, mesh=mesh)
    env = jg.JaxGraspEnv(fleet, image_size=IMG, max_attempts=3, radius=0.4,
                         bank=jg.make_scene_bank(8, image_size=IMG))
    try:
      jax_anakin.AnakinLoop(model, trainer, ring, env, inner_steps=K,
                            train_every=K, **CEM)
    except ValueError as e:
      out[name] = str(e)
  return out


# --- the runs ------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  """The two-rank spawn and its one-rank and JAX counterparts."""
  if jax is None:
    pytest.skip("needs JAX, the reference")
  tmp = str(tmp_path_factory.mktemp("mesh_loop"))
  initial, target, jax_ring, jax_env = _jax_pretrain_dp2()
  draws = [_jax_draws(13, 0, 0)]
  mesh = launch.launch(ranks.cases, 2, (draws, initial, target, tmp),
                       device="cpu", timeout_s=900)
  one = {
      "pretrain_jax_draws": ranks.run_anakin(
          draws=draws, variables=initial, target=target),
      "pretrain_own_draws": ranks.run_anakin(),
      "trained": ranks.run_anakin(min_fill=8, dispatches=3),
      "grads64": ranks.run_anakin(min_fill=8, grads=True, dtype="float64"),
      "megastep": ranks.run_megastep(),
      "tp1": ranks.run_anakin(min_fill=8, dispatches=2),
  }
  return {"mesh": mesh, "one": one, "jax_ring": jax_ring, "jax_env": jax_env,
          "jax_refusals": _jax_refusals(), "tmp": tmp}


def _assert_same(got, want, what):
  assert set(got) == set(want), what
  for key in want:
    np.testing.assert_array_equal(got[key], want[key],
                                  err_msg=f"{what}: {key}")


class TestPretrainStream:
  """Case (a): a collect-only dispatch (min_fill held shut)."""

  @pytest.mark.parametrize("case", ["pretrain_jax_draws",
                                    "pretrain_own_draws"])
  def test_bit_identical_to_one_rank(self, runs, case):
    want = runs["one"][case]
    for rank, got in enumerate(runs["mesh"]):
      got = got[case]
      assert got["metrics"][0]["trained_steps"] == 0
      _assert_same(got["env"], want["env"], f"rank {rank} env")
      _assert_same(got["ring"], want["ring"], f"rank {rank} ring")
      assert got["mesh_shape"] == {"data": 2}
    assert int(want["env"]["episodes"]) > 0  # the stream crossed resets

  def test_equals_the_jax_dp2_stream(self, runs):
    got = runs["mesh"][0]["pretrain_jax_draws"]
    _assert_same(got["env"], runs["jax_env"], "env")
    for key, value in runs["jax_ring"].items():
      if key == "storage/action":
        np.testing.assert_allclose(got["ring"][key], value, rtol=0,
                                   atol=ACTION_ATOL)
      elif key in ("tree", "max_priority"):
        np.testing.assert_allclose(got["ring"][key], value, rtol=TREE_RTOL,
                                   atol=0)
      else:
        np.testing.assert_array_equal(got["ring"][key], value, err_msg=key)


class TestTrainedDispatches:
  """Case (b): learns at dp=2 with ZeRO-1 against one rank."""

  @pytest.mark.parametrize("case", ["trained", "megastep"])
  def test_losses_within_the_collective_tolerance(self, runs, case):
    want = runs["one"][case]["metrics"]
    for got in runs["mesh"]:
      got = got[case]["metrics"]
      assert len(got) == len(want) == 3
      for mine, theirs in zip(got, want):
        assert mine.get("trained_steps") == theirs.get("trained_steps")
        for key in ranks.LOSS_KEYS:
          np.testing.assert_allclose(mine[key], theirs[key],
                                     rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                     err_msg=f"{case}: {key}")
    if case == "trained":
      assert all(m["trained_steps"] == 1 for m in want)

  @pytest.mark.parametrize("case", ["trained", "megastep"])
  def test_grad_norm_within_the_collective_tolerance(self, runs, case):
    """Each learn's global gradient norm against one rank's: a gradient
    summed over the ranks rather than averaged doubles it, which Adam's
    scale-blind update hides from the losses."""
    want = runs["one"][case]["metrics"]
    for got in runs["mesh"]:
      for mine, theirs in zip(got[case]["metrics"], want):
        assert theirs["health/grad_norm"] > 0
        np.testing.assert_allclose(
            mine["health/grad_norm"], theirs["health/grad_norm"],
            rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=case)

  def test_first_update_gradients_in_float64(self, runs):
    want = runs["one"]["grads64"]["grads"]
    for got in runs["mesh"]:
      got = got["grads64"]["grads"]
      assert set(got) == set(want)
      for key, value in want.items():
        assert got[key].dtype == np.float64
        np.testing.assert_allclose(
            got[key], value, rtol=0,
            atol=GRAD64_SHARE * np.abs(value).max(), err_msg=key)

  def test_ranks_agree_and_build_once(self, runs):
    first, second = runs["mesh"]
    for case in ("trained", "megastep"):
      assert first[case]["metrics"] == second[case]["metrics"], case
    _assert_same(first["trained"]["params"], second["trained"]["params"],
                 "params")
    assert first["trained"]["compile_counts"] == {"anakin_step": 1}
    assert first["megastep"]["compile_counts"] == {"megastep": 1}
    assert [r["is_primary"] for r in runs["mesh"]] == [True, False]


class TestPlacements:
  """Case (c): what each rank holds."""

  def test_ring_and_fleet_split_params_whole_zero1_splits(self, runs):
    for got in runs["mesh"]:
      got = got["placements"]
      assert set(got["ring_rows"].values()) == {CAPACITY // 2}
      assert got["written_at_rows"] == CAPACITY // 2
      assert got["fleet_rows"] == {"images": N_ENVS // 2,
                                   "targets": N_ENVS // 2,
                                   "attempts": N_ENVS // 2}
      assert got["params_whole"] and got["opt_split"]
      # Adam's two moments over this rank's blocks, about half of the
      # parameters (TinyQ's one-element q-head bias stays whole).
      assert got["moment_numel"] == 2 * got["block_numel"]
      assert got["block_numel"] == (got["param_numel"] + 1) // 2
      assert got["tree_len"] == 2 * CAPACITY  # the tree stays whole
    assert runs["mesh"][0]["megastep"]["rows"] == CAPACITY // 2

  def test_a_whole_ring_on_every_rank_learns_alike(self, runs):
    """shard_capacity=False keeps the whole ring on every rank: the same
    rows reach the same learns, bit for bit."""
    for got in runs["mesh"]:
      assert got["megastep_whole_ring"]["rows"] == CAPACITY
      assert (got["megastep_whole_ring"]["metrics"]
              == got["megastep"]["metrics"])
      _assert_same(got["megastep_whole_ring"]["ring"],
                   got["megastep"]["ring"], "ring")


class TestTensorParallel:
  """Case (d): tp=2 splits the parameters; tp=1 splits none."""

  def test_tinyq_tp2_equals_one_rank(self, runs):
    want = runs["one"]["tp1"]
    for got in runs["mesh"]:
      got = got["tp2"]
      assert got["mesh_shape"] == {"data": 1, "model": 2}
      assert got["compile_counts"] == {"anakin_step": 1}
      for mine, theirs in zip(got["metrics"], want["metrics"]):
        assert mine["trained_steps"] == theirs["trained_steps"] == 1
        for key in ranks.LOSS_KEYS:
          np.testing.assert_allclose(mine[key], theirs[key],
                                     rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                     err_msg=key)

  def test_flagship_ladder(self):
    """The flagship critic's ladder (``tpquant_bench``): one build a
    rung, tp=2's parameters split by the model's rules with fewer bytes a
    rank, tp=1 bitwise deterministic with none split, no scaling
    claimed."""
    got = tpquant_bench._measure_tp_ladder((1, 2), steps=4, image_size=32,
                                           device="cpu")
    assert got["tp1_oracle"] == {"bitwise_equal": True,
                                 "model_sharded_leaves": 0}
    rung = got["rungs"]["2"]
    assert rung["anakin_step_compiles"] == 1 and rung["ledger_all_one"]
    assert rung["mesh_shape"] == {"data": 1, "model": 2}
    assert rung["param_sharding"]["model_sharded_leaves"] > 0
    assert rung["replica_bytes_factor"] > 1.5
    assert got["rungs"]["1"]["param_sharding"]["model_sharded_leaves"] == 0
    assert got["colocated_ranks"] is True
    assert got["tp_scaling_efficiency"] is None


class TestCheckpoints:
  """Case (e): resume on the same mesh, and on another."""

  def test_same_mesh_resume_equals_straight_run(self, runs):
    for got in runs["mesh"]:
      straight, resumed = got["loop_straight"], got["loop_resumed"]
      assert straight["steps"] == resumed["steps"] == 8
      assert resumed["eval_history"] == straight["eval_history"]
      assert resumed["final_eval"] == straight["final_eval"]
      assert got["loop_first_half"]["steps"] == 4
    tmp = runs["tmp"]
    saved = [torch.load(os.path.join(tmp, name, "checkpoints", "8",
                                     "state.pt"), weights_only=True)
             for name in ("straight", "cut")]
    assert saved[0]["mesh"] == {"axes": {"data": 2, "model": 1},
                                "devices": 2}
    for key, value in saved[0]["params"].items():
      assert torch.equal(value, saved[1]["params"][key]), key

  def test_changed_mesh_resume_refuses(self, runs):
    cut = os.path.join(runs["tmp"], "cut")
    with pytest.raises(ValueError, match="resume mesh geometry mismatch") as e:
      ranks.run_loop("anakin", cut, 8, mesh_dp=1, resume=True,
                     checkpoint_every=4)
    message = str(e.value)
    assert "'data': 2" in message and "'data': 1" in message
    assert "data=2 x model=1" in message


class TestRefusals:
  """Case (f): JAX's messages, word for word."""

  @pytest.mark.parametrize("what", ["capacity", "fleet", "batch"])
  def test_indivisible_sizes(self, runs, what):
    want = runs["jax_refusals"][what]
    for got in runs["mesh"]:
      assert got["refusals"][what] == want
    assert {"capacity": "64 or 66", "fleet": "fleet of 2 or 4",
            "batch": "batch of 6 or 8"}[what] in want


class TestHostAndDeviceResidentPaths:
  """The collector paths over the mesh: the primary collects and hands
  its rows to the other rank, so both hold the same ring and train
  alike."""

  @pytest.mark.parametrize("path", ["device_resident", "host"])
  def test_ranks_agree(self, runs, path):
    first, second = (got[path] for got in runs["mesh"])
    assert first["mesh_shape"] == {"data": 2, "model": 1}
    assert first["zero1"] is True
    assert first["eval_history"] == second["eval_history"]
    assert first["buffer"] == second["buffer"]
    assert set(first["compile_counts"].values()) == {1}
    if path == "device_resident":
      assert first["ring_rows"] == second["ring_rows"] == CAPACITY // 2

  def test_the_primary_times_the_min_fill_gate(self, runs):
    """The primary's deadline closes the warm-up gate for both ranks at
    the same poll: each raises the gate's timeout, none waits on the
    other's broadcast."""
    for got in runs["mesh"]:
      assert got["gate"]["attempts"] == 1
      assert f"min_fill={CAPACITY} " in got["gate"]["message"]


# --- the CLI -------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["0", "2", "4,2", "1,2", "0,2", "3,0", "-1",
                                  "a", "1,2,3"])
def test_parse_mesh_is_jax(needs_jax, spec):
  def outcome(fn):
    try:
      return fn(spec)
    except ValueError as e:
      return str(e)

  assert outcome(run_qtopt_replay.parse_mesh) == outcome(jax_cli.parse_mesh)


def _free_port() -> int:
  with socket.socket() as s:
    s.bind(("localhost", 0))
    return s.getsockname()[1]


def test_cli_under_torchrun(tmp_path):
  """``--smoke --anakin --mesh 2`` in two ranks under
  ``torch.distributed.run``: the primary prints one JSON line with the
  mesh, ZeRO-1 and the parameters' layout."""
  env = {**os.environ, "PYTHONPATH": _REPO, "OMP_NUM_THREADS": "1"}
  proc = subprocess.run(
      [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
       "--master-port", str(_free_port()), "-m",
       "tensor2robot_tpu_torch.bin.run_qtopt_replay", "--smoke", "--anakin",
       "--mesh", "2", "--device", "cpu", "--steps", "6",
       "--no-anakin-bench", "--logdir", str(tmp_path)],
      capture_output=True, text=True, timeout=600, cwd=_REPO, env=env)
  assert proc.returncode == 0, proc.stderr[-4000:]
  lines = [line for line in proc.stdout.splitlines()
           if line.startswith("{")]
  assert len(lines) == 1, proc.stdout[-2000:]
  result = json.loads(lines[0])
  assert result["mesh_shape"] == {"data": 2, "model": 1}
  assert result["zero1"] is True
  assert set(result["param_sharding"]) == {
      "total_leaves", "model_sharded_leaves", "param_bytes_total",
      "param_bytes_per_replica"}
  assert result["steps"] >= 6 and result["anakin"] is True
  assert set(result["compile_counts"].values()) == {1}
