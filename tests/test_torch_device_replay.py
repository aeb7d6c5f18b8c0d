"""The port's device-resident ring and megastep learner against the JAX
package.

The sum tree's functions give the JAX sums and sampled indices bit for
bit; the ring's extend gives its bookkeeping and storage bit for bit;
``sample`` with the JAX package's own draws gives its indices and
staleness, probabilities within 1e-6 (the zero-mass remap of an
underfilled prioritized ring included); ``update_priorities`` its tree
and max priority within rtol 1e-6; the priority entropy within 1e-6. One
learn iteration, TinyQ through the weight bridge with the JAX draws and
CEM noise, gives the JAX targets and TD errors within 1e-5, its losses
within 1e-5 relative, and each side's Adam update is Adam's rule on its
own gradient. The megastep's K iterations are K learn iterations, bit for
bit; its health keys reduce as ``reduce_scanned_metrics``; the loop's
device-resident path, its CLI and its resume run on the CPU. The card
tests hold the CUDA graphs against eager iterations bit for bit.
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
  from tensor2robot_tpu.obs import health as jax_health
  from tensor2robot_tpu.parallel import mesh as jax_mesh
  from tensor2robot_tpu.replay import (
      bellman as jax_bellman,
      device_buffer as jax_db,
      loop as jax_loop,
      smoke as jax_smoke,
  )
  from tensor2robot_tpu.specs import tensorspec_utils as jax_ts
  from tensor2robot_tpu.train.trainer import Trainer as JaxTrainer
except ImportError:
  jax = None

from tensor2robot_tpu_torch import bridge  # noqa: E402
from tensor2robot_tpu_torch.bin import run_qtopt_replay  # noqa: E402
from tensor2robot_tpu_torch.obs import health  # noqa: E402
from tensor2robot_tpu_torch.obs.ledger import ExecutableLedger  # noqa: E402
from tensor2robot_tpu_torch.replay import (  # noqa: E402
    bellman,
    device_buffer,
    loop,
    smoke,
)
from tensor2robot_tpu_torch.research.qtopt import cem  # noqa: E402
from tensor2robot_tpu_torch.train.trainer import Trainer  # noqa: E402
from tensor2robot_tpu_torch.utils import optimizers  # noqa: E402

IMG = 16
LR = 3e-3
TARGET_ATOL = 1e-5
LOSS_RTOL = 1e-5
PROB_RTOL = 1e-6
GRAD_SHARE = 1e-3
CEM = dict(num_samples=8, num_elites=2, iterations=2)


@pytest.fixture
def needs_jax():
  if jax is None:
    pytest.skip("needs JAX, the reference")


def _transitions(n, seed, img=IMG):
  rng = np.random.default_rng(seed)
  return {
      "image": rng.integers(0, 256, (n, img, img, 3), np.uint8),
      "action": rng.uniform(-1, 1, (n, 4)).astype(np.float32),
      "reward": (rng.random(n) < 0.4).astype(np.float32),
      "done": (rng.random(n) < 0.3).astype(np.float32),
      "next_image": rng.integers(0, 256, (n, img, img, 3), np.uint8),
  }


def _ring(capacity, batch, chunk, prioritized=True, **kwargs):
  return device_buffer.DeviceReplayBuffer(
      loop.transition_spec(IMG, 4), capacity, batch, seed=3,
      prioritized=prioritized, ingest_chunk=chunk, device="cpu", **kwargs)


def _jax_ring(capacity, batch, chunk, prioritized=True, **kwargs):
  return jax_db.DeviceReplayBuffer(
      jax_loop.transition_spec(IMG, 4), capacity, batch, seed=3,
      prioritized=prioritized, ingest_chunk=chunk, shard_capacity=False,
      **kwargs)


def _jax_sample_draws(seed, calls, n, size):
  """The JAX buffer's ``sample`` draws: fold_in(key(seed), calls), split
  into the randint and the uniform keys."""
  key = jax.random.fold_in(jax.random.key(seed), calls)
  uniform_key, remap_key = jax.random.split(key)
  return (np.asarray(jax.random.randint(uniform_key, (n,), 0, max(size, 1),
                                        dtype=jnp.int32)),
          np.asarray(jax.random.uniform(remap_key, (n,), jnp.float32)))


def _jax_label_noise(seed, seeds, iterations, samples, action_size=4):
  """The JAX megastep's CEM draws: state b's iteration i is normal(
  fold_in(fold_in(key(seed), seeds[b]), i), (N, A))."""
  base = jax.random.key(seed)
  keys = jax.vmap(lambda s: jax.random.fold_in(base, s))(
      jnp.asarray(np.asarray(seeds, np.uint32)))
  return np.stack([np.asarray(jax.vmap(
      lambda k, i=i: jax.random.normal(jax.random.fold_in(k, i),
                                       (samples, action_size)))(keys))
                   for i in range(iterations)], axis=1), keys


def _state_arrays(state):
  if isinstance(state, device_buffer.DeviceReplayState):
    return state.arrays()
  out = {f"storage/{k}": np.asarray(v) for k, v in state.storage.items()}
  for name in ("written_at", "tree", "next_slot", "size", "append_count",
               "max_priority"):
    out[name] = np.asarray(getattr(state, name))
  return out


# --- the sum tree -------------------------------------------------------------


class TestTree:

  def test_functions_match_jax_bit_for_bit(self, needs_jax):
    capacity, depth = 37, 6
    n_leaves = 1 << depth
    rng = np.random.default_rng(0)
    leaves = rng.random(capacity).astype(np.float32)
    tree = np.zeros(2 * n_leaves, np.float32)
    tree[n_leaves:n_leaves + capacity] = leaves
    want = np.asarray(jax_db.tree_refresh_parents(jnp.asarray(tree), depth))
    got = device_buffer.tree_refresh_parents(torch.from_numpy(tree.copy()),
                                             depth)
    np.testing.assert_array_equal(got.numpy(), want)
    uniforms = np.concatenate([rng.random(200, dtype=np.float32),
                               [0.0, 1.0 - 2 ** -24]]).astype(np.float32)
    np.testing.assert_array_equal(
        device_buffer.tree_sample(got, torch.from_numpy(uniforms), depth,
                                  n_leaves, capacity).numpy(),
        np.asarray(jax_db.tree_sample(jnp.asarray(want),
                                      jnp.asarray(uniforms), depth,
                                      n_leaves, capacity)))
    idx = np.array([3, 30, 36, 0], np.int32)
    vals = np.array([0.5, 2.0, 0.0, 7.0], np.float32)
    np.testing.assert_array_equal(
        device_buffer.tree_set(got.clone(), torch.from_numpy(idx).long(),
                               torch.from_numpy(vals), depth,
                               n_leaves).numpy(),
        np.asarray(jax_db.tree_set(jnp.asarray(want), jnp.asarray(idx),
                                   jnp.asarray(vals), depth, n_leaves)))

  def test_segment_max_resolves_duplicates_as_jax(self, needs_jax):
    capacity, depth = 20, 5
    n_leaves = 1 << depth
    tree = np.zeros(2 * n_leaves, np.float32)
    tree[n_leaves:n_leaves + capacity] = 1.0
    tree = np.asarray(jax_db.tree_refresh_parents(jnp.asarray(tree), depth))
    idx = np.array([4, 9, 4, 4, 19, 9, 0], np.int32)
    vals = np.array([0.3, 5.0, 2.5, 0.1, 0.25, 1.5, 3.0], np.float32)
    want = np.asarray(jax_db.tree_set_segment_max(
        jnp.asarray(tree), jnp.asarray(idx), jnp.asarray(vals), depth,
        n_leaves, capacity))
    got = device_buffer.tree_set_segment_max(
        torch.from_numpy(tree.copy()), torch.from_numpy(idx).long(),
        torch.from_numpy(vals), depth, n_leaves, capacity)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[n_leaves + 4] == 2.5 and got[n_leaves + 9] == 5.0


# --- the ring -----------------------------------------------------------------


class TestDeviceReplayBuffer:

  def test_extend_with_wraparound_matches_jax(self, needs_jax):
    ours, theirs = _ring(24, 8, 8), _jax_ring(24, 8, 8)
    data = _transitions(43, 1)
    for start, stop in ((0, 5), (5, 19), (19, 43)):
      part = {k: v[start:stop] for k, v in data.items()}
      assert ours.extend(part) == theirs.extend(part) == stop - start
      assert ours.pending == theirs.pending
    assert ours.size == 24 and ours.append_count == 40 and ours.pending == 3
    got, want = _state_arrays(ours.state), _state_arrays(theirs.state)
    assert sorted(got) == sorted(want)
    for key in want:
      np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert ours.compile_counts == theirs.compile_counts == {
        "device_extend": 1}

  @pytest.mark.parametrize("prioritized", [True, False])
  def test_sample_with_the_jax_draws(self, needs_jax, prioritized):
    ours = _ring(32, 16, 8, prioritized)
    theirs = _jax_ring(32, 16, 8, prioritized)
    data = _transitions(48, 2)  # wraps: slots 0-15 hold the newest
    for ring in (ours, theirs):
      ring.extend(data)
      if prioritized:
        ring.update_priorities(np.arange(0, 32, 3),
                               np.linspace(0.0, 2.0, 11, dtype=np.float32))
    for calls in (1, 2, 3):
      want_batch, want = theirs.sample()
      got_batch, got = ours.sample(
          draws=_jax_sample_draws(3, calls, 16, theirs.size))
      np.testing.assert_array_equal(got.indices, want.indices)
      np.testing.assert_array_equal(got.staleness, want.staleness)
      np.testing.assert_allclose(got.probabilities, want.probabilities,
                                 rtol=PROB_RTOL, atol=0)
      assert got.probabilities.dtype == np.float32
      for key in want_batch:
        np.testing.assert_array_equal(got_batch[key], want_batch[key])

  def test_zero_mass_remap_of_an_underfilled_ring(self, needs_jax,
                                                  monkeypatch):
    """Uniforms at the top edge descend past the filled prefix onto
    zero-mass leaves; both rings remap those picks to the uniform draw and
    report 1/size (JAX's own draws injected into its sample body)."""
    ours, theirs = _ring(24, 6, 8), _jax_ring(24, 6, 8)
    data = _transitions(8, 3)
    ours.extend(data)
    theirs.extend(data)
    idx = np.array([5, 1, 7, 0, 3, 2], np.int32)
    uniforms = np.array([1.0, 0.5, 1.0, 0.0, 0.999, 1.0], np.float32)
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(idx))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(uniforms))
    _, want_idx, want_p, want_age = theirs.sample_fn()(theirs.state,
                                                       jax.random.key(0))
    _, got = ours.sample(draws=(idx, uniforms))
    zero = uniforms == 1.0
    np.testing.assert_array_equal(got.indices, np.asarray(want_idx))
    np.testing.assert_array_equal(got.indices[zero], idx[zero])
    np.testing.assert_array_equal(got.staleness, np.asarray(want_age))
    np.testing.assert_allclose(got.probabilities, np.asarray(want_p),
                               rtol=PROB_RTOL, atol=0)
    np.testing.assert_array_equal(got.probabilities[zero],
                                  np.float32(1 / 8))

  def test_update_priorities_and_entropy_match_jax(self, needs_jax):
    ours, theirs = _ring(40, 8, 8), _jax_ring(40, 8, 8)
    data = _transitions(32, 4)
    rng = np.random.default_rng(5)
    for ring in (ours, theirs):
      ring.extend(data)
    for _ in range(3):
      idx = rng.integers(0, 32, 12)  # with repeats
      td = rng.normal(0, 1.5, 12).astype(np.float32)
      ours.update_priorities(idx, td)
      theirs.update_priorities(idx, td)
    np.testing.assert_allclose(ours.state.tree.numpy(),
                               np.asarray(theirs.state.tree), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(float(ours.state.max_priority),
                               float(theirs.state.max_priority), rtol=1e-6)
    np.testing.assert_allclose(ours.priorities(idx), theirs.priorities(idx),
                               rtol=1e-6)
    assert ours.priority_entropy() == pytest.approx(
        theirs.priority_entropy(), abs=1e-6)
    assert float(ours.priority_entropy_fn()(ours.state)) == pytest.approx(
        float(theirs.priority_entropy_fn()(theirs.state)), abs=1e-6)
    assert ours.metrics() == pytest.approx(theirs.metrics(), abs=1e-6)

  def test_host_surface_and_refusals(self):
    ring = _ring(16, 4, 8)
    with pytest.raises(ValueError, match="empty"):
      ring.sample()
    ring.append({k: v[0] for k, v in _transitions(1, 6).items()})
    assert ring.pending == 1 and ring.size == 0
    with pytest.raises(RuntimeError, match="host rows staged"):
      ring.extend_device_chunk({k: torch.from_numpy(v) for k, v in
                                _transitions(8, 7).items()})
    ring.extend(_transitions(7, 8))
    assert ring.size == 8 and ring.pending == 0
    assert ring.extend_device_chunk({k: torch.from_numpy(v) for k, v in
                                     _transitions(8, 9).items()}) == 8
    batch, info = ring.sample()
    assert batch["image"].shape == (4, IMG, IMG, 3)
    assert info.indices.dtype == np.int64 and info.probabilities.dtype == (
        np.float32)
    with pytest.raises(ValueError, match="shape"):
      ring.extend_device_chunk({k: torch.from_numpy(v) for k, v in
                                _transitions(4, 9).items()})
    with pytest.raises(ValueError, match="no priorities"):
      _ring(16, 4, 8, prioritized=False).priorities([0])
    # mesh= splits the capacity over the data axis (over ranks in
    # tests/test_torch_mesh_loop.py): an indivisible capacity refuses with
    # the nearest fixes, a mesh without this process's ranks refuses, and
    # one rank keeps the whole ring whatever the axis is named.
    from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
    with pytest.raises(ValueError, match=r"capacity 16 .*\(15 or 18\)"):
      _ring(16, 4, 8, mesh=mesh_lib.create_mesh({"data": 3},
                                                devices=range(3)))
    with pytest.raises(ValueError, match="no process groups"):
      _ring(16, 4, 8, mesh=mesh_lib.create_mesh({"data": 2},
                                                devices=range(2)))
    assert _ring(16, 4, 8, data_axis="replica").rows == 16
    # ledger= registers each ring function at its first use, with the JAX
    # shapes, and records each host call.
    book = ExecutableLedger()
    ring = _ring(16, 4, 8, ledger=book)
    ring.extend(_transitions(8, 9))
    _, info = ring.sample()
    ring.update_priorities(info.indices, np.ones(4, np.float32))
    shapes = {"capacity": 16, "chunk": 8, "batch": 4}
    rows = {row["name"]: row for row in book.attribution()["executables"]}
    assert sorted(rows) == ["device_extend", "device_sample",
                            "device_update_priorities_n4"]
    for row in rows.values():
      assert (row["compiles"], row["dispatches"], row["shapes"]) == (
          1, 1, shapes), row


# --- one learn iteration and the megastep ------------------------------------


def _tinyq(seed=0):
  return smoke.TinyQCriticModel(
      image_size=IMG, optimizer_fn=optimizers.create_adam_optimizer(LR))


def _learn_fn(model, trainer, ring, health_keys=True):
  targets_fn = bellman.make_bellman_targets_fn(
      model, 4, 0.8, CEM["num_samples"], CEM["num_elites"],
      CEM["iterations"], True)
  return device_buffer.make_learn_iteration_fn(
      model, lambda s, f, l: trainer.train_step(s, f, l, with_health=True),
      ring.sample_fn(), ring.update_priorities_fn(), targets_fn, "target_q",
      True, health_entropy_fn=ring.priority_entropy_fn()
      if health_keys else None)


class TestLearnIteration:

  def test_one_iteration_matches_jax(self, needs_jax):
    """The same bridged init, ring content, sample draws and CEM noise:
    targets and TD within TARGET_ATOL, losses within LOSS_RTOL, the
    priorities written back, the health keys, and each side's update Adam's
    first step on its own gradient."""
    batch_size = 16
    jax_model = jax_smoke.TinyQCriticModel(
        image_size=IMG, optimizer_fn=lambda: optax.adam(LR))
    jax_trainer = JaxTrainer(
        jax_model, mesh=jax_mesh.create_mesh(devices=jax.devices()[:1]),
        seed=0)
    jax_state = jax_trainer.create_train_state(batch_size=batch_size)
    initial = jax.device_get(jax_state.variables())
    model = _tinyq()
    trainer = Trainer(model, device="cpu")
    state = trainer.create_train_state(initial)
    target = bridge.variables_to_state_dict(initial, model.module)
    data = _transitions(64, 10)
    ours = _ring(64, batch_size, 64)
    theirs = _jax_ring(64, batch_size, 64, mesh=jax_trainer.mesh)
    for ring in (ours, theirs):
      ring.extend(data)

    captured = {}
    jax_targets = jax_bellman.make_bellman_targets_fn(
        jax_model, 4, 0.8, CEM["num_samples"], CEM["num_elites"],
        CEM["iterations"], True)
    jax_update = theirs.update_priorities_fn()

    def targets_fn(*args):
      captured["targets"], q_next = jax_targets(*args)
      return captured["targets"], q_next

    def update(buffer_state, indices, td):
      captured["td"] = td
      return jax_update(buffer_state, indices, td)

    jax_learn = jax_db.make_learn_iteration_fn(
        jax_model, jax_trainer.train_step_fn(with_health=True),
        theirs.sample_fn(), update, targets_fn, "target_q", True,
        health_entropy_fn=theirs.priority_entropy_fn())

    def jax_iteration(ts, bs, tv, key, keys):
      ts, bs, metrics = jax_learn(ts, bs, tv, key, keys)
      return ts, bs, metrics, captured["targets"], captured["td"]

    sample_key = jax.random.key(7)
    noise, label_keys = _jax_label_noise(21, np.arange(batch_size),
                                         CEM["iterations"],
                                         CEM["num_samples"])
    before = jax.device_get(jax_state.params)
    jax_state, jax_bs, want, want_targets, want_td = jax.jit(jax_iteration)(
        jax_state, theirs.state, initial, sample_key, label_keys)
    want = jax.device_get(want)

    uniform_key, remap_key = jax.random.split(sample_key)
    draws = (torch.from_numpy(np.array(jax.random.randint(
        uniform_key, (batch_size,), 0, 64, dtype=jnp.int32))).long(),
             torch.from_numpy(np.array(jax.random.uniform(
                 remap_key, (batch_size,), jnp.float32))))
    captured_ours = {}
    learn_targets = bellman.make_bellman_targets_fn(
        model, 4, 0.8, CEM["num_samples"], CEM["num_elites"],
        CEM["iterations"], True)
    update_ours = ours.update_priorities_fn()

    def our_targets(*args):
      captured_ours["targets"], q_next = learn_targets(*args)
      return captured_ours["targets"], q_next

    def our_update(buffer_state, indices, td):
      captured_ours["td"] = td
      return update_ours(buffer_state, indices, td)

    learn = device_buffer.make_learn_iteration_fn(
        model, lambda s, f, l: trainer.train_step(s, f, l, with_health=True),
        ours.sample_fn(), our_update, our_targets, "target_q", True,
        health_entropy_fn=ours.priority_entropy_fn())
    old = {n: p.detach().clone() for n, p in state.params.items()}
    state, _, got = learn(state, ours.state, target, draws,
                          torch.from_numpy(noise))

    np.testing.assert_allclose(captured_ours["targets"].numpy(),
                               np.asarray(want_targets), rtol=0,
                               atol=TARGET_ATOL)
    np.testing.assert_allclose(captured_ours["td"].numpy(),
                               np.asarray(want_td), rtol=0, atol=TARGET_ATOL)
    assert sorted(got) == sorted(want)
    assert set(health.SUMMARY_KEYS) <= set(got)
    for key in want:
      tol = (dict(rtol=LOSS_RTOL, atol=0) if key in ("loss",)
             else dict(rtol=1e-4, atol=TARGET_ATOL))
      np.testing.assert_allclose(float(got[key]), float(want[key]),
                                 err_msg=key, **tol)
    np.testing.assert_allclose(ours.state.tree.numpy()[64:],
                               np.asarray(jax_bs.tree)[64:], rtol=0,
                               atol=TARGET_ATOL)
    self._check_adam(jax_model, before, initial, theirs, sample_key,
                     np.asarray(want_targets),
                     jax.device_get(jax_state.params), model, state, old)

  @staticmethod
  def _check_adam(jax_model, before, initial, theirs, sample_key, targets,
                  after, model, state, old):
    batch, _, _, _ = theirs.sample_fn()(theirs.state, sample_key)
    rest = {k: v for k, v in initial.items() if k != "params"}

    def loss_fn(params):
      loss, _ = jax_model.model_train_fn(
          {"params": params, **rest},
          jax_ts.TensorSpecStruct({"image": batch["image"],
                                   "action": batch["action"]}),
          jax_ts.TensorSpecStruct({"target_q": jnp.asarray(targets)}))
      return loss

    want_grads = bridge.params_to_state_dict(
        jax.device_get(jax.grad(loss_fn)(before)), model.module)
    want_update = bridge.params_to_state_dict(
        jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                               after, before), model.module)
    for name, param in state.params.items():
      grad = param.grad.numpy()
      want = want_grads[name].numpy()
      np.testing.assert_allclose(grad, want, rtol=0,
                                 atol=GRAD_SHARE * np.abs(want).max(),
                                 err_msg=name)
      np.testing.assert_allclose(
          (param.detach() - old[name]).numpy(),
          -LR * grad / (np.abs(grad) + 1e-8), rtol=0, atol=1e-7,
          err_msg=name)
      large = np.abs(want) > 1e-6
      np.testing.assert_allclose(
          want_update[name].numpy()[large],
          (-LR * want / (np.abs(want) + 1e-8))[large], rtol=0, atol=1e-7,
          err_msg=name)

  def test_scan_reduction_matches_jax(self, needs_jax):
    rng = np.random.default_rng(0)
    stacked = {key: rng.normal(size=5).astype(np.float32)
               for key in health.SUMMARY_KEYS + ("loss", "td_error")}
    got = health.reduce_scanned_metrics(
        {k: torch.from_numpy(v) for k, v in stacked.items()})
    want = jax_health.reduce_scanned_metrics(
        {k: jnp.asarray(v) for k, v in stacked.items()})
    assert health.SUMMARY_KEYS == jax_health.SUMMARY_KEYS
    assert health.SCAN_MAX_KEYS == jax_health.SCAN_MAX_KEYS
    for key in stacked:
      assert float(got[key]) == float(want[key]), key


def _megastep(seed=0, inner_steps=4, capacity=64, batch=16, **kwargs):
  model = _tinyq()
  trainer = Trainer(model, seed=0, device="cpu")
  state = trainer.create_train_state()
  ring = _ring(capacity, batch, capacity)
  ring.extend(_transitions(capacity, 11))
  learner = device_buffer.MegastepLearner(
      model, trainer, ring, action_size=4, gamma=0.8, inner_steps=inner_steps,
      seed=seed, health=True, **CEM, **kwargs)
  learner.refresh(state.variables(use_ema=True), step=0)
  return model, trainer, state, ring, learner


class TestMegastepLearner:

  def test_k_iterations_equal_k_learn_iterations(self):
    k, batch = 4, 16
    _, _, state, ring, learner = _megastep(seed=5, inner_steps=k)
    state, got = learner.step(state)
    model, trainer, control, control_ring, _ = _megastep(seed=5,
                                                         inner_steps=k)
    target = {key: value.clone()
              for key, value in control.variables(use_ema=True).items()}
    learn = _learn_fn(model, trainer, control_ring)
    per_step = []
    noise = cem.seeded_noise(6, np.arange(k * batch), CEM["iterations"],
                             CEM["num_samples"], 4)
    for i in range(k):
      idx, uniforms = device_buffer.sample_draws(5, i, batch, 64)
      control, _, metrics = learn(
          control, control_ring.state, target,
          (torch.from_numpy(idx), torch.from_numpy(uniforms)),
          torch.from_numpy(noise[i * batch:(i + 1) * batch]))
      per_step.append(metrics)
    assert state.step == control.step == k
    for name, param in state.params.items():
      assert torch.equal(param, control.params[name]), name
    assert torch.equal(ring.state.tree, control_ring.state.tree)
    for key, value in got.items():
      series = [float(m[key]) for m in per_step]
      want = max(series) if key in health.SCAN_MAX_KEYS else series[-1]
      assert value == want, key
    assert set(got) == {"loss", "td_error", "q_next", "staleness",
                        *health.SUMMARY_KEYS}

  def test_seeded_metrics_and_one_build_over_refreshes(self):
    def stream(seed):
      _, _, state, _, learner = _megastep(seed=seed, inner_steps=2)
      out = []
      for step in (2, 4, 6):
        state, metrics = learner.step(state)
        out.append(metrics)
        pointers = [t.data_ptr() for t in learner._target_variables.values()]
        before = learner._target_variables["q_head.bias"].clone()
        bumped = {key: value + 0.05 for key, value in
                  state.variables(use_ema=True).items()}
        learner.refresh(bumped, step)
        # The refresh copies into the target's own tensors.
        assert [t.data_ptr() for t in
                learner._target_variables.values()] == pointers
        assert not torch.equal(learner._target_variables["q_head.bias"],
                               before)
      assert learner.compile_counts == {"megastep": 1}
      assert learner.target_lag(10) == 4 and learner.refresh_count == 4
      return out

    first = stream(0)
    assert stream(0) == first
    assert stream(1) != first

  def test_compiled_builds_once(self):
    _, _, state, _, learner = _megastep(inner_steps=2)
    body = learner.compiled(state)
    state, _ = learner.step(state)
    assert learner.compiled(state) is body
    assert learner.compile_counts == {"megastep": 1}

  def test_priorities_move(self):
    _, _, state, ring, learner = _megastep(inner_steps=4)
    before = ring.priorities(np.arange(64))
    learner.step(state)
    assert not np.allclose(before, ring.priorities(np.arange(64)))
    assert float(ring.state.max_priority) >= 1.0

  def test_inner_steps_and_refusals(self):
    with pytest.raises(ValueError, match="inner_steps"):
      _megastep(inner_steps=0)
    model, trainer, state, ring, _ = _megastep()
    # One rank adds no mesh hooks; the body takes a mesh's (held over two
    # ranks in tests/test_torch_mesh_loop.py).
    assert device_buffer.mesh_hooks(trainer) == {}
    assert callable(device_buffer.make_learn_iteration_fn(
        None, None, None, None, None, "target_q", True,
        constrain_batch=lambda tree: tree, gather_rows=lambda rows: rows))
    cold = device_buffer.MegastepLearner(model, trainer, ring)
    with pytest.raises(ValueError, match="refresh"):
      cold.step(state)
    # ledger= registers the megastep at its build with the FLOPs of one
    # dispatch, and records every dispatch.
    book = ExecutableLedger()
    _, _, state, _, learner = _megastep(inner_steps=2, ledger=book)
    for _ in range(2):
      state, _ = learner.step(state)
    row, = book.attribution()["executables"]
    assert (row["name"], row["compiles"], row["dispatches"], row["dtype"],
            row["shapes"]) == ("megastep", 1, 2, "f32",
                               {"inner_steps": 2, "batch": 16})
    assert row["flops_per_dispatch"] > 0


# --- the loop's device-resident path ------------------------------------------


def _loop_config(**kwargs):
  return loop.ReplayLoopConfig(
      device_resident=True, capacity=64, min_fill=32, batch_size=8,
      megastep_inner=5, ingest_chunk=16, refresh_every=10, eval_every=10,
      log_every=5, eval_batches=1, **kwargs)


class TestDeviceResidentLoop:

  @pytest.mark.parametrize("vector_actors", [False, True])
  def test_loop_structure(self, tmp_path, vector_actors):
    replay = loop.ReplayTrainLoop(_loop_config(vector_actors=vector_actors),
                                  str(tmp_path), model=smoke.TinyQCriticModel(),
                                  device="cpu")
    assert isinstance(replay.buffer, device_buffer.DeviceReplayBuffer)
    result = replay.run(12)  # rounds up to whole dispatches
    assert result["steps"] == 15 and result["device_resident"]
    assert result["megastep_inner"] == 5
    ledger = result["compile_counts"]
    assert ledger.pop("megastep") == ledger.pop("device_extend") == 1
    assert ledger.pop("bellman_td_error") == 1 and "train_step" not in ledger
    assert list(ledger) == ["cem_bucket_4"]
    assert [e["step"] for e in result["eval_history"]] == [0, 10, 15]
    assert result["param_refreshes"] == 1
    assert result["buffer"]["replay/size"] >= 32
    queue = result["queue"]
    # Every row the feeder took is in the ring or staged for its next chunk.
    assert queue["dequeued"] == replay.buffer.append_count + (
        replay.buffer.pending)
    assert queue["enqueued"] == queue["dequeued"] + queue["pending"] + (
        queue["dropped"])
    assert result["health"]["observations"] == 3
    assert result["health"]["breach_count"] == 0

  def test_refusals_that_stay(self, tmp_path):
    assert loop.ReplayLoopConfig(device_resident=True).device_resident
    # The mesh knobs configure; a mesh larger than the ranks present
    # refuses at the loop, naming both, rather than shrinking.
    config = loop.ReplayLoopConfig(device_resident=True, mesh_dp=2,
                                   zero1=True)
    with pytest.raises(ValueError, match=r"needs 2 rank\(s\), have 1"):
      loop.ReplayTrainLoop(config, str(tmp_path), model=_tinyq(),
                           device="cpu")
    # The scoring tiers, once item 11's refusal, take the fused path.
    assert loop.ReplayLoopConfig(device_resident=True,
                                 precision="bf16").precision == "bf16"

  def test_fused_resume_equals_an_uninterrupted_run(self):
    """Through the loop's own save and restore, on a frozen ring: two
    dispatches, a checkpoint, a fresh loop that restores it and takes two
    more, against four straight through (a refresh between), bit for
    bit."""
    from tensor2robot_tpu_torch.replay import learner_bench
    result = learner_bench.fused_resume_parity(2, 2, seed=0, device="cpu")
    assert result["restored_step"] == 10
    assert result["ring_restored_bit_equal"] and result["params_bit_equal"]
    assert result["pre_crash_metrics_equal"]
    assert result["post_resume_metrics_equal"] and result["ring_bit_equal"]
    assert result["max_post_resume_metric_delta"] == 0.0
    assert result["parity_ok"]

  def test_loop_resumes_at_its_checkpoint(self, tmp_path):
    model = smoke.TinyQCriticModel()
    config = _loop_config(checkpoint_every=10)
    first = loop.ReplayTrainLoop(config, str(tmp_path), model=model,
                                 device="cpu").run(10)
    resumed = loop.ReplayTrainLoop(
        dataclasses.replace(config, resume=True), str(tmp_path),
        model=smoke.TinyQCriticModel(), device="cpu").run(20)
    assert [e["step"] for e in resumed["eval_history"]] == [0, 10, 20]
    assert resumed["initial_eval"] == first["initial_eval"]
    # A host-path checkpoint of the same shapes is refused by name.
    loop.ReplayTrainLoop(
        dataclasses.replace(config, device_resident=False),
        str(tmp_path / "host"), model=smoke.TinyQCriticModel(),
        device="cpu").run(10)
    with pytest.raises(ValueError, match="host path"):
      loop.ReplayTrainLoop(
          dataclasses.replace(config, resume=True, checkpoint_dir=str(
              tmp_path / "host" / "checkpoints")),
          str(tmp_path / "device"), model=smoke.TinyQCriticModel(),
          device="cpu").run(20)

  def test_fused_restore_refuses_a_mismatched_step(self, tmp_path):
    """A step directory whose state file holds another step than its name:
    the fused restore refuses it, as the host path's does."""
    config = _loop_config(checkpoint_every=10)
    first = loop.ReplayTrainLoop(config, str(tmp_path),
                                 model=smoke.TinyQCriticModel(), device="cpu")
    first.writer.close()
    state = first.trainer.create_train_state()
    learner = first._megastep_learner()
    learner.refresh(state.variables(use_ema=True), step=0)
    first._save_fused_checkpoint(3, state, learner, {}, [])
    state_file = os.path.join(first.checkpoint_root, "3", "state.pt")
    payload = torch.load(state_file, weights_only=True)
    payload["step"] = 0
    torch.save(payload, state_file)
    resumed = loop.ReplayTrainLoop(
        dataclasses.replace(config, resume=True), str(tmp_path),
        model=smoke.TinyQCriticModel(), device="cpu")
    resumed.writer.close()
    with pytest.raises(ValueError, match="TrainState.step 0 != checkpoint "
                       "step 3"):
      resumed._restore_fused_checkpoint(resumed.trainer.create_train_state(),
                                        resumed._megastep_learner())

  def test_cli_device_resident_line(self, tmp_path, capsys):
    run_qtopt_replay.main([
        "--smoke", "--device-resident", "--no-learner-bench", "--steps",
        "20", "--device", "cpu", "--logdir", str(tmp_path)])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 1
    obj = json.loads(lines[0])
    assert obj["device_resident"] and obj["megastep_inner"] == 10
    assert obj["steps"] == 20 and "learner_throughput" not in obj
    assert obj["compile_counts"]["megastep"] == 1

  def test_learner_bench_blocks(self):
    from tensor2robot_tpu_torch.replay import learner_bench
    result = learner_bench.measure_learner_throughput(
        steps_per_trial=4, inner_steps=2, trials=2, capacity=64,
        device="cpu")
    for name in ("host_path", "device_megastep"):
      assert set(result[name]) == {"train_steps_per_sec",
                                   "transitions_per_sec",
                                   "host_blocked_fraction"}
      assert result[name]["train_steps_per_sec"]["trials"] == 2
    assert set(result["speedup"]) == {"median", "min", "max", "trials"}
    assert result["compile_counts"] == {
        "bellman_targets": 1, "td_error": 1, "megastep": 1,
        "device_extend": 1}
    with pytest.raises(ValueError, match="multiple"):
      learner_bench.measure_learner_throughput(steps_per_trial=5,
                                               inner_steps=2, device="cpu")


# --- the card -------------------------------------------------------------------


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA GPU")
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  yield torch.device("cuda")
  torch.backends.cudnn.deterministic = deterministic


def _card_learner(device, graphs, inner_steps=4):
  model = _tinyq()
  trainer = Trainer(model, seed=0, device=device)
  state = trainer.create_train_state()
  ring = device_buffer.DeviceReplayBuffer(
      loop.transition_spec(IMG, 4), 64, 16, seed=3, prioritized=True,
      ingest_chunk=64, device=device)
  ring.extend(_transitions(64, 11))
  learner = device_buffer.MegastepLearner(
      model, trainer, ring, gamma=0.8, inner_steps=inner_steps, seed=5,
      health=True, graphs=graphs, **CEM)
  learner.refresh(state.variables(use_ema=True), step=0)
  return state, ring, learner


def _same_learners(a, b):
  (state_a, ring_a, _), (state_b, ring_b, _) = a, b
  for name, param in state_a.params.items():
    assert torch.equal(param, state_b.params[name]), name
  for group_a, group_b in zip(state_a.opt_state.state.values(),
                              state_b.opt_state.state.values()):
    for key, value in group_a.items():
      assert torch.equal(value, group_b[key]), key
  for key, value in _state_arrays(ring_a.state).items():
    np.testing.assert_array_equal(_state_arrays(ring_b.state)[key], value,
                                  err_msg=key)


@pytest.mark.cuda
def test_cuda_graph_equals_eager_iterations(cuda_device):
  """The megastep's graphs (the first dispatch eager, the next two
  replays) against every dispatch eager: parameters, Adam's state, the
  ring, the tree and the metrics, bit for bit."""
  graphed = list(_card_learner(cuda_device, True))
  eager = list(_card_learner(cuda_device, False))
  for _ in range(3):
    graphed[0], got = graphed[2].step(graphed[0])
    eager[0], want = eager[2].step(eager[0])
    assert got == want
  _same_learners(graphed, eager)
  assert graphed[2].compile_counts == {"megastep": 1}
  assert graphed[2]._graph is not None and eager[2]._graph is None


@pytest.mark.cuda
def test_cuda_graph_reads_the_refreshed_target(cuda_device):
  """A refresh after the capture: the graph's next dispatch equals an
  eager learner refreshed the same way, and differs from one that kept
  its old target."""
  runs = {name: list(_card_learner(cuda_device, graphs))
          for name, graphs in (("graphed", True), ("eager", False),
                               ("stale", True))}
  out = {}
  for name, run in runs.items():
    for _ in range(2):
      run[0], _ = run[2].step(run[0])
    if name != "stale":
      run[2].refresh({k: v + 0.05 for k, v in
                      run[0].variables(use_ema=True).items()}, step=8)
    run[0], out[name] = run[2].step(run[0])
  assert out["graphed"] == out["eager"] != out["stale"]
  assert runs["graphed"][2].compile_counts == {"megastep": 1}
  _same_learners(runs["graphed"], runs["eager"])
